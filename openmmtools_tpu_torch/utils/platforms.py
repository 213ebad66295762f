"""Devices as platforms (counterpart of ``utils/platforms.py``).

openmmtools' ``get_available_platforms`` / ``get_fastest_platform`` and its
precision check, mapped onto torch devices: "CUDA" (an NVIDIA card, where
the port's kernels run) and "CPU" (the kernels' plain versions).
"""
from __future__ import annotations

from typing import List

import torch

_PRECISIONS = ("single", "double", "mixed")


def get_available_platforms() -> List[str]:
    """The usable platforms, fastest first: "CUDA" when a card is
    present, then "CPU"."""
    platforms = []
    if torch.cuda.is_available():
        platforms.append("CUDA")
    platforms.append("CPU")
    return platforms


def get_fastest_platform() -> str:
    """The fastest available platform."""
    return get_available_platforms()[0]


def platform_supports_precision(platform: str, precision: str) -> bool:
    """Whether ``platform`` runs ``precision`` ('single', 'double' or
    'mixed'). The CPU runs every dtype. On the card the kernels are
    float32 and sweep mode sums the energy parts in float64 (mixed); a
    float64 system there takes the plain PyTorch path, so 'double' is
    supported too."""
    precision = precision.lower()
    if precision not in _PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    platform = platform.upper()
    if platform not in ("CPU", "CUDA"):
        raise ValueError(f"unknown platform {platform!r}")
    return platform == "CPU" or torch.cuda.is_available()


def device_report() -> dict:
    """The platforms, the torch and CUDA versions, and each card's name,
    memory and compute capability."""
    report = {
        "platforms": get_available_platforms(),
        "fastest": get_fastest_platform(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "devices": ["cpu"],
    }
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        report["devices"].append({
            "index": i, "name": p.name,
            "memory_gib": round(p.total_memory / 2 ** 30, 2),
            "capability": f"{p.major}.{p.minor}",
            "multiprocessors": p.multi_processor_count})
    return report
