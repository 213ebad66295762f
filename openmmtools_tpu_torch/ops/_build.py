"""Build the package's CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (H100) into
a shared library of its own with a plain C interface, all sources at once in
parallel processes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/lib<source>_<hash>.so csrc/<source>.cu

The libraries land in ``build/kernels/`` at the root of the checkout, under
names keyed by a hash of the source, the headers and the flags, so a changed
source rebuilds. Nothing here runs at import: the package imports on a
machine without ``nvcc``, and only the first CUDA launch needs a library. A
failed build raises with nvcc's stderr.

The host code of ``native/*.cpp`` (the prmtop parser) builds the same way
with the host C++ compiler (:func:`host_library`: ``g++ -O2 -shared
-fPIC``), on both machines, at its first use.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import types
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NATIVE = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

HOST_FLAGS = ("-O2", "-shared", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U64 = ctypes.c_uint64

# argtypes of every C entry point; all return cudaError_t as an int
SIGNATURES = {
    # (x, n, L, rc2, sig2, eps4, eps24, r_switch, inv_span, use_switch,
    #  F, u_partial, ticket, U, stream)
    "lj_forces_f32": (_P, _I, _P, _F, _F, _F, _F, _F, _F, _I,
                      _P, _P, _P, _P, _P),
    # (x, v, xb, F, u_partial, U, L, kT, n, n_steps, table, n_items, rc2,
    #  sig2, eps4, eps24, r_switch, inv_span, use_switch, h_R, hv_inv_m,
    #  ou_a, ou_b, inv_m, seed, stream)
    "lj_chunk_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _I, _F, _F,
                     _F, _F, _F, _F, _I, _F, _F, _F, _F, _F, _U64, _P),
    # (x, n, n_pad, R, L, w2, bs, rebuild, bound, arcs, words, nblk,
    #  launches, stream)
    "sweep_bound_f32": (_P, _I, _I, _I, _P, _F, _I, _P, _P, _P, _P, _P, _P,
                        _P),
    # (x, par, excl, n, n_pad, mask_rows, bs, L, nblk, B, rep, rc2,
    #  coulomb_rf, alpha, k_rf, c_rf, use_switch, switch_coulomb, r_switch,
    #  inv_span, ke, e_part, ticket, F, U, launches, stream)
    "sweep_forces_f32": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _P, _F, _I,
                         _F, _F, _F, _I, _I, _F, _F, _F, _P, _P, _P, _P, _P,
                         _P),
    # (the same arguments up to ke, then lam, n_regions, coulomb_plain,
    #  e_part, ticket, F, U, launches, stream)
    "sweep_forces_alch_f32": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _P, _F,
                              _I, _F, _F, _F, _I, _I, _F, _F, _F, _P, _I, _I,
                              _P, _P, _P, _P, _P, _P),
    # (x, occ, n_side, M, rows, L, rc2, sig2, eps4, eps24, r_switch,
    #  inv_span, use_switch, F, stream)
    "cell_forces_f32": (_P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _I,
                        _P, _P),
    # (x, xb, v, F, occ, kT, n_side, M, rows, L, n_steps, rc2, sig2, eps4,
    #  eps24, r_switch, inv_span, use_switch, half_dt, kick, ou_a, ou_b,
    #  inv_m, seed, stream)
    "cell_chunk_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _F, _F, _F,
                       _F, _F, _F, _I, _F, _F, _F, _F, _F, _U64, _P),
    # (x, x_ref or v, out, a, b, c, tab, n, W, B, launches, stream)
    **{f"settle_{what}_{t}": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P)
       for what in ("positions", "velocities") for t in ("f32", "f64")},
}


class KernelBuildError(RuntimeError):
    pass


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels cannot be built")
    return nvcc


def find_cxx() -> str:
    """The host C++ compiler: ``$CXX``, else g++ or c++ on PATH."""
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise KernelBuildError(
        "no host C++ compiler ($CXX, g++ or c++ on PATH); the native "
        "sources cannot be built")


def host_library(name: str) -> Path:
    """The shared library of ``native/<name>.cpp``, built by the host C++
    compiler at its first use into ``build/kernels/`` under a name keyed by
    a hash of the source and the flags. A failed build raises
    :class:`KernelBuildError` with the compiler's stderr."""
    source = NATIVE / f"{name}.cpp"
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    h.update(source.read_bytes())
    out = BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_cxx(), *HOST_FLAGS, "-o", tmp, str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelBuildError(
            f"build failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builds each rename a whole one
    return out


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise KernelBuildError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path(source: Path) -> Path:
    """Where the library of one source lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [source] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:16]}.so"


def build() -> list:
    """Compile every source whose library does not exist yet, all in
    parallel; return the libraries' paths."""
    outs = [library_path(src) for src in _sources()]
    jobs = []
    for src, out in zip(_sources(), outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
        jobs.append((cmd, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failures = []
    for cmd, tmp, out, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    if failures:
        raise KernelBuildError("\n".join(failures))
    return outs


@functools.lru_cache(maxsize=None)
def load_library() -> types.SimpleNamespace:
    """Build if needed, load every library, and declare every entry point's
    types; the entry points are attributes of the returned namespace."""
    libs = [ctypes.CDLL(str(path)) for path in build()]
    fns = {}
    for name, argtypes in SIGNATURES.items():
        owners = [lib for lib in libs if hasattr(lib, name)]
        if len(owners) != 1:
            raise KernelBuildError(
                f"entry point {name} is in {len(owners)} libraries, not 1")
        fn = getattr(owners[0], name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        fns[name] = fn
    return types.SimpleNamespace(libraries=libs, **fns)


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError_t {err}")


def kernels_for(t, kernel: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run its plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no {kernel} for device {t.device}")


def check_input(t, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape``: what a kernel's C entry point takes."""
    if (t.device.type != "cuda" or t.dtype != dtype
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
        name = str(dtype).replace("torch.", "")
        raise ValueError(
            f"kernel input must be a contiguous CUDA {name} tensor of shape "
            f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)} on {t.device}")
