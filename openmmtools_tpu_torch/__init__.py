"""openmmtools_tpu_torch — the PyTorch/CUDA port of openmmtools_tpu.

The same systems, states, integrators and MCMC moves as the JAX package, on
tensors: a ``System`` is a frozen dataclass of tensors with pure energy
terms, the Langevin splitting integrators run as step programs, and the
moves of :mod:`openmmtools_tpu_torch.mcmc` drive them, and the samplers of
:mod:`openmmtools_tpu_torch.multistate` drive many replicas. Every Pallas TPU kernel
of the JAX package becomes a kernel written by hand for the NVIDIA H100
(``csrc/``, built at first use by ``ops/_build.py``), beside a plain PyTorch
version of the same function that serves CPU tensors and the tests.

Dtype policy: float32 on CUDA; float64 is allowed on the CPU, where the
tests hold the port against the JAX package. TF32 is switched off for
matrix products and cuDNN, because TF32 keeps about three decimal digits and
the force tolerances here are 2e-4 of scale or tighter.

This package never imports JAX or ``openmmtools_tpu``.
"""

import torch as _torch

__version__ = "0.1.0"

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from openmmtools_tpu_torch import constants  # noqa: E402,F401
from openmmtools_tpu_torch.states import (  # noqa: E402,F401
    CompoundThermodynamicState,
    GlobalParameterState,
    SamplerState,
    ThermodynamicState,
)
from openmmtools_tpu_torch.system import (  # noqa: E402,F401
    Constraints,
    NonbondedTerm,
    System,
    kinetic_energy,
    make_energy_fn,
    make_energy_force_fn,
    make_force_fn,
    no_constraints,
    volume,
)
from openmmtools_tpu_torch import mcmc  # noqa: E402,F401
from openmmtools_tpu_torch import multistate  # noqa: E402,F401
