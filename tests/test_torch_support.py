"""Shared helpers of the port's parity tests, and tests of the converters.

The JAX package and the port meet only as numpy: ``numpy_tree`` turns a JAX
object (a tree of frozen dataclasses of arrays) into the plain numpy form
that ``openmmtools_tpu_torch.utils.convert`` reads.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmmtools_tpu.models import HarmonicOscillator as JaxHO
from openmmtools_tpu.models import LennardJonesFluid as JaxLJ
from openmmtools_tpu_torch.models import HarmonicOscillator, LennardJonesFluid
from openmmtools_tpu_torch.utils.convert import (
    from_numpy,
    integrator_state_from_numpy,
    sampler_state_from_numpy,
    system_from_numpy,
)

# The suite runs in several worker processes on a few cores, and these tests'
# tensors are small (N <= 2048): one intra-op thread a worker avoids
# oversubscribing the cores, which multiplied these tests' time several-fold.
torch.set_num_threads(1)


def numpy_tree(obj):
    """The numpy form of a JAX object: dataclasses become dicts with their
    class name under "type", arrays become numpy arrays."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {"type": type(obj).__name__}
        for f in dataclasses.fields(obj):
            out[f.name] = numpy_tree(getattr(obj, f.name))
        return out
    if isinstance(obj, (tuple, list)):
        return type(obj)(numpy_tree(v) for v in obj)
    if isinstance(obj, dict):
        return {k: numpy_tree(v) for k, v in obj.items()}
    if obj is None or isinstance(obj, (str, bool, int, float)):
        return obj
    return np.asarray(obj)


def jax_f64(tree):
    """A JAX pytree with every floating leaf cast to float64 numpy."""
    import jax

    def cast(a):
        a = np.asarray(a)
        return a.astype(np.float64) if np.issubdtype(a.dtype, np.floating) else a

    return jax.tree.map(cast, tree)


def port_system(jax_system, dtype=torch.float64, device="cpu"):
    """The port's System built from a JAX System's numpy leaves."""
    return system_from_numpy(numpy_tree(jax_system), device=device,
                             dtype=dtype)


@functools.lru_cache(maxsize=None)
def minimized_fluid(n=256, seed=11, temperature=120.0):
    """LJ fluid at reduced density 0.5, FIRE-minimized by the JAX package,
    with Maxwell-Boltzmann velocities drawn by numpy: (x, v, box, kT,
    physics) as float32 numpy, the shared start of the trajectory tests."""
    from openmmtools_tpu.constants import kB
    from openmmtools_tpu.integrators.minimize import fire_minimize

    f = JaxLJ(nparticles=n, reduced_density=0.5)
    t = f.system.terms[0]
    box = f.system.default_box
    x, _ = fire_minimize(f.system, f.positions, box)
    mass = float(np.asarray(f.system.masses)[0])
    kT = kB * temperature
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3)) * np.sqrt(kT / mass)
    physics = dict(cutoff=float(t.cutoff), switch_width=t.switch_width,
                   sigma=float(np.asarray(t.sigma)[0]),
                   epsilon=float(np.asarray(t.epsilon)[0]), mass=mass)
    return (np.array(x, np.float32), v.astype(np.float32),
            np.array(box, np.float32), kT, physics)


def wrapped_distance(a, b, L):
    """Largest per-coordinate distance between two position sets, modulo the
    box edge L (the fused kernels wrap positions into the box)."""
    d = np.abs(np.mod(np64(a), L) - np.mod(np64(b), L))
    return float(np.minimum(d, np.abs(d - L)).max())


def np64(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def fluid_with_exceptions(jsys, positions):
    """A JAX system (the charged LJ fluid) with three exceptions inside
    the cutoff of nonzero parameters: the nearest pairs of atoms 0-23 with
    each other, with the rest, and of the rest."""
    from openmmtools_tpu.system import NonbondedTerm

    idx = next(i for i, t in enumerate(jsys.terms) if type(t) is NonbondedTerm)
    pos = np.asarray(positions)
    box = np.diag(np.asarray(jsys.default_box))
    d = pos[:, None, :] - pos[None, :, :]
    d -= box * np.round(d / box)
    r = np.linalg.norm(d, axis=-1)
    np.fill_diagonal(r, np.inf)
    alch = np.zeros(pos.shape[0], bool)
    alch[:24] = True

    def closest(mask):
        rr = np.where(mask, r, np.inf)
        return np.unravel_index(np.argmin(rr), rr.shape)

    pairs = np.asarray([closest(alch[:, None] & alch[None, :]),
                        closest(alch[:, None] & ~alch[None, :]),
                        closest(~alch[:, None] & ~alch[None, :])], np.int32)
    term = jsys.terms[idx].replace(
        exception_index=jnp.asarray(pairs),
        exception_chargeprod=jnp.asarray([0.02, -0.01, 0.015], jnp.float32),
        exception_sigma=jnp.asarray([0.3, 0.31, 0.3], jnp.float32),
        exception_epsilon=jnp.asarray([0.4, 0.2, 0.3], jnp.float32))
    return jsys.replace_term(idx, term)


def two_regions(module, interacting):
    """Regions a (atoms 0-11, annihilated sterics) and b (12-23, decoupled
    electrostatics) of ``module``'s alchemy, and their interactions."""
    regions = [module.AlchemicalRegion(alchemical_atoms=list(range(12)),
                                       name="a", annihilate_sterics=True),
               module.AlchemicalRegion(alchemical_atoms=list(range(12, 24)),
                                       name="b",
                                       annihilate_electrostatics=False)]
    return regions, ({("a", "b")} if interacting else frozenset())


def test_numpy_form_round_trips_lj_fluid():
    """A converted JAX LJ fluid is the port's own build, tensor for tensor:
    same fingerprint at float32."""
    converted = port_system(JaxLJ(nparticles=64).system, dtype=None)
    native = LennardJonesFluid(nparticles=64, device="cpu").system
    assert converted.fingerprint == native.fingerprint
    assert converted.terms[0].cutoff == native.terms[0].cutoff


def test_numpy_form_round_trips_harmonic_oscillator():
    converted = port_system(JaxHO().system, dtype=None)
    native = HarmonicOscillator(device="cpu").system
    assert converted.fingerprint == native.fingerprint


def test_from_numpy_rejects_unported_terms():
    # every term class of the JAX package has its counterpart now: a term
    # of neither package stands for one the port lacks
    with pytest.raises(NotImplementedError, match="CMAPTorsionTerm"):
        from_numpy({"type": "CMAPTorsionTerm", "charge": np.ones(1)},
                   device="cpu")


def test_state_converters_carry_arrays_and_dtype():
    rng = np.random.default_rng(0)
    x, v = rng.normal(size=(5, 3)), rng.normal(size=(5, 3))
    box = np.eye(3) * 2.0
    ss = sampler_state_from_numpy(x, v, box, device="cpu",
                                  dtype=torch.float32)
    assert ss.positions.dtype == torch.float32
    np.testing.assert_array_equal(np64(ss.velocities), v.astype(np.float32))
    st = integrator_state_from_numpy(x, v, box, 0.5, device="cpu",
                                     dtype=torch.float64)
    np.testing.assert_array_equal(np64(st.positions), x)
    assert float(st.kT) == 0.5 and st.forces == ()
