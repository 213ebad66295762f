"""K3's port: ``FusedDenseBAOAB``'s plain chunk against the JAX kernel.

On the CPU the JAX side is ``FusedDenseBAOAB`` in Pallas interpret mode at
collision_rate 0, as tests/test_pallas_baoab.py runs it (the TPU's random
bits exist only on a TPU, so noise cannot match). Both sides work in
float32, so the tolerances are the JAX package's for its own kernel: U
within 2e-4 relative and F within 2e-4 of scale
(tests/test_pallas_baoab.py:53-54); for a 40-step trajectory dx < 5e-4
modulo L, dv < 5e-3 of the velocity scale and U within 2e-4 (:95-98).
Within the port, ``FusedDenseBAOAB.run`` on CPU tensors is K1's plain chunk
for "V R O R V" bit for bit, noise included. The CUDA kernel itself is held
against that plain chunk in tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmmtools_tpu.models import LennardJonesFluid as JaxLJ
from openmmtools_tpu.ops.pallas_baoab import FusedDenseBAOAB as JaxK3
from openmmtools_tpu_torch.ops.fused_langevin import (
    FusedDenseBAOAB,
    FusedSortedLangevin,
    draw_seed,
    fused_langevin_reference,
)

from test_torch_support import minimized_fluid, np64, wrapped_distance


def _physics(f):
    t = f.system.terms[0]
    return dict(cutoff=float(t.cutoff), switch_width=t.switch_width,
                sigma=float(np.asarray(t.sigma)[0]),
                epsilon=float(np.asarray(t.epsilon)[0]),
                mass=float(np.asarray(f.system.masses)[0]))


def _args(p, collision_rate):
    return (p["cutoff"], p["switch_width"], p["sigma"], p["epsilon"],
            p["mass"], 0.002, collision_rate)


@pytest.mark.parametrize("n", [256, 200])
def test_plain_chunk_forces_match_jax_kernel(n):
    """n_steps = 0: F and U of the wrapped start against the JAX kernel in
    interpret mode (N = 200 pads the TPU kernel's ring)."""
    f = JaxLJ(nparticles=n, reduced_density=0.5)
    p = _physics(f)
    box = np.asarray(f.system.default_box, np.float32)
    x = np.asarray(f.positions, np.float32)
    v = np.zeros_like(x)
    k = JaxK3(n, *_args(p, 0.0), interpret=True)
    _, _, F_k, U_k, _ = k.run(jnp.asarray(x), jnp.asarray(v), box, 1.0,
                              jax.random.PRNGKey(0), 0)

    port = FusedDenseBAOAB(n, *_args(p, 0.0), device="cpu")
    xo, vo, F, U = port.run(x, v, box, 1.0, torch.Generator(), 0)
    assert F.dtype == torch.float32 and F.shape == (n, 3) and U.shape == ()
    f_scale = float(np.abs(np64(F_k)).max())
    assert abs(float(U) - float(U_k)) <= 2e-4 * abs(float(U_k))
    assert np.abs(np64(F) - np64(F_k)).max() <= 2e-4 * f_scale
    # zero steps: the start, wrapped into the box, and untouched velocities
    L = float(box[0, 0])
    assert float(xo.min()) >= 0.0 and float(xo.max()) < L
    assert wrapped_distance(xo, x, L) == 0.0
    assert not torch.any(vo)


def test_plain_chunk_trajectory_matches_jax_kernel():
    """gamma = 0, 40 steps from a FIRE-minimized start with thermal
    velocities: the port's chunk against the JAX kernel."""
    x, v, box, kT, p = minimized_fluid()
    n = x.shape[0]
    L = float(box[0, 0])
    k = JaxK3(n, *_args(p, 0.0), interpret=True)
    xk, vk, _, Uk, _ = k.run(jnp.asarray(x), jnp.asarray(v), box, kT,
                             jax.random.PRNGKey(0), 40)
    port = FusedDenseBAOAB(n, *_args(p, 0.0), device="cpu")
    xo, vo, _, U = port.run(x, v, box, kT, torch.Generator(), 40)
    v_scale = float(np.abs(np64(vk)).max())
    assert wrapped_distance(xo, xk, L) < 5e-4
    assert np.abs(np64(vo) - np64(vk)).max() < 5e-3 * v_scale
    assert abs(float(U) - float(Uk)) <= 2e-4 * abs(float(Uk))
    # the chunk really moved the fluid
    assert wrapped_distance(xo, x, L) > 1e-3


def test_run_on_cpu_is_k1_plain_baoab_chunk():
    """With noise on: run on CPU tensors equals K1's plain chunk for
    "V R O R V" on the seed the generator gives, bit for bit."""
    x, v, box, kT, p = minimized_fluid()
    n = x.shape[0]
    port = FusedDenseBAOAB(n, *_args(p, 5.0), device="cpu")
    out = port.run(x, v, box, kT, torch.Generator().manual_seed(3), 15)
    k1 = FusedSortedLangevin(n, *_args(p, 5.0),
                             tokens=("V", "R", "O", "R", "V"))
    seed = draw_seed(torch.Generator().manual_seed(3))
    ref = fused_langevin_reference(k1, torch.as_tensor(x), torch.as_tensor(v),
                                   torch.as_tensor(box), kT, seed, 15)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    # the noise acted: a gamma = 0 chunk ends elsewhere
    quiet = FusedDenseBAOAB(n, *_args(p, 0.0), device="cpu")
    assert not torch.equal(
        out[1], quiet.run(x, v, box, kT, torch.Generator(), 15)[1])
    assert port.launches == {"dense_baoab": 0}


def test_dense_wrapper_refuses_devices_without_a_kernel():
    port = FusedDenseBAOAB(4, 1.0, None, 0.3, 1.0, 1.0, 0.002, 1.0,
                           device="meta")
    x = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="no dense BAOAB kernel"):
        port.run(x, x, torch.eye(3), 1.0, torch.Generator(), 1)
