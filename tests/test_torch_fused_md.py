"""K4's port: the cell grid, its binning, forces and BAOAB loop
(``ops/fused_md.py``) against the JAX package's ``ops/pallas_md.py``.

Inputs are the JAX package's own LJ fluids (numpy positions, numpy
velocities from a seed). Tolerances: the grid spec and the slot assignment
are integers and must be equal; binned positions are copies (1e-6); forces
against the JAX kernel in interpret mode within 1e-4 of scale, the JAX
package's own tolerance for its kernel against the dense sum
(tests/test_pallas_md.py:67-69), and against the port's dense forces within
2e-4 of scale (float32, another summation order); the gamma = 0 trajectory
at the trajectory tolerances of tests/test_pallas_baoab.py:95-98 (dx < 5e-4
modulo L, dv < 5e-3 of the velocity scale). The CUDA kernels are held
against these plain versions in tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from openmmtools_tpu.integrators import BAOABIntegrator as JaxBAOAB
from openmmtools_tpu.models import LennardJonesFluid as JaxLJ
from openmmtools_tpu.ops import pallas_md as P
from openmmtools_tpu.states import SamplerState as JaxSamplerState
from openmmtools_tpu_torch.ops import fused_md as T
from openmmtools_tpu_torch.ops.fused_langevin import lj_forces_reference
from openmmtools_tpu_torch.utils.convert import grid_spec

from test_torch_support import minimized_fluid, np64, wrapped_distance


def _fluid_spec(module, n, reduced_density=0.05, collision_rate=1.0, **kw):
    """A JAX LJ fluid of n particles and ``module``'s grid spec for it."""
    f = JaxLJ(nparticles=n, reduced_density=reduced_density)
    t = f.system.terms[0]
    spec = module.make_grid_spec(
        n, f.box_edge, float(t.cutoff), t.switch_width,
        float(np.asarray(t.sigma)[0]), float(np.asarray(t.epsilon)[0]),
        float(np.asarray(f.system.masses)[0]), 0.002, collision_rate, **kw)
    return f, spec


def _velocities(n, seed=3):
    return np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)


GRIDS = [(64, dict(skin_fraction=0.1, capacity=8)), (512, {}), (2048, {}),
         (16384, {})]


@pytest.mark.parametrize("n,kw", GRIDS, ids=[str(n) for n, _ in GRIDS])
def test_grid_spec_matches_jax(n, kw):
    """Every field, carried across by convert.grid_spec and made by the
    port's own make_grid_spec, equals the JAX package's."""
    _, jspec = _fluid_spec(P, n, **kw)
    _, tspec = _fluid_spec(T, n, **kw)
    carried = grid_spec(jspec)
    assert isinstance(carried, T.LJGridSpec)
    assert tuple(carried) == tuple(jspec) == tuple(tspec)
    assert (carried.g_side, carried.n_cells, carried.g_cells) == (
        jspec.g_side, jspec.n_cells, jspec.g_cells)
    assert jspec.cell_edge >= jspec.cutoff
    interval = T.FusedLJBAOAB(tspec, n, temperature=120.0,
                              device="cpu").rebuild_interval
    assert interval == P.FusedLJBAOAB(jspec, n,
                                      temperature=120.0).rebuild_interval
    if n == 2048:   # LJ-2048, the cell list's main path
        assert (tspec.n_side, tspec.capacity, tspec.g_cells, interval) == (
            8, 16, 1000, 175)


def test_grid_spec_refuses_cells_below_the_cutoff():
    """N = 256 at reduced density 0.5: a 2.72 nm box, where the JAX package
    makes 3 cells a side of 0.907 nm under the 1.02 nm cutoff."""
    _, jspec = _fluid_spec(P, 256, reduced_density=0.5)
    assert jspec.cell_edge < jspec.cutoff
    with pytest.raises(ValueError, match="cutoff"):
        _fluid_spec(T, 256, reduced_density=0.5)


@pytest.mark.parametrize("n", [64, 2048])
@pytest.mark.parametrize("kind", ["sort", "matmul"])
def test_binning_matches_jax(n, kind):
    kw = dict(skin_fraction=0.1, capacity=8) if n == 64 else {}
    f, spec = _fluid_spec(P, n, **kw)
    x = np.asarray(f.positions, np.float32)
    v = _velocities(n)
    tspec = grid_spec(spec)
    if kind == "sort":
        jx, jv, jvalid, jsp, jmo = P.bin_particles(jnp.asarray(x),
                                                   jnp.asarray(v), spec)
        tx, tv, tvalid, tsp, tmo = T.bin_particles(torch.as_tensor(x),
                                                   torch.as_tensor(v), tspec)
        np.testing.assert_array_equal(tsp.numpy(), np.asarray(jsp))
    else:
        jx, jv, jvalid, je, jmo = P.bin_particles_matmul(
            jnp.asarray(x), jnp.asarray(v), spec)
        tx, tv, tvalid, te, tmo = T.bin_particles_matmul(
            torch.as_tensor(x), torch.as_tensor(v), tspec)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert int(tmo) == int(jmo) <= spec.capacity
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    assert tx.dtype == tv.dtype == tvalid.dtype == torch.float32
    assert np.abs(np64(tx) - np64(jx)).max() <= 1e-6
    assert np.abs(np64(tv) - np64(jv)).max() <= 1e-6


@pytest.mark.parametrize("kind", ["sort", "matmul"])
def test_unbin_round_trip_is_exact(kind):
    f, spec = _fluid_spec(T, 2048)
    x = torch.as_tensor(np.asarray(f.positions, np.float32))
    v = torch.as_tensor(_velocities(2048))
    L = spec.box_edge
    if kind == "sort":
        xs, vs, _, sp, _ = T.bin_particles(x, v, spec)
        xr, vr = T.unbin_particles(xs, vs, sp, 2048)
    else:
        xs, vs, _, e, _ = T.bin_particles_matmul(x, v, spec)
        xr, vr = T.unbin_particles_matmul(xs, vs, e)
    assert torch.equal(xr, x - L * torch.floor(x / L))
    assert torch.equal(vr, v)


@pytest.fixture(scope="module")
def jax_forces():
    """The JAX kernel's forces_only variant in interpret mode at N = 64 (the
    fixture of tests/test_pallas_md.py), made once: (spec, x, slots, F)."""
    f, spec = _fluid_spec(P, 64, collision_rate=0.0, skin_fraction=0.1,
                          capacity=8)
    x = np.asarray(f.positions, np.float32)
    xs, vs, valid, _, mo = P.bin_particles(jnp.asarray(x),
                                           jnp.zeros_like(jnp.asarray(x)),
                                           spec)
    m, g = spec.capacity, spec.g_cells
    fn = pl.pallas_call(
        P._make_kernel(spec, 1, forces_only=True), grid=(),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)] * 3
        + [pl.BlockSpec(memory_space=pltpu.VMEM)] * 3,
        out_specs=(pl.BlockSpec(memory_space=pltpu.VMEM),) * 2,
        out_shape=(jax.ShapeDtypeStruct((3, m, g), jnp.float32),) * 2,
        interpret=True)
    F, _ = fn(jnp.asarray([1], jnp.int32), jnp.asarray([1.0], jnp.float32),
              jnp.asarray([int(mo)], jnp.int32), xs, vs, valid)
    return spec, x, np.asarray(F)


def test_forces_match_jax_kernel(jax_forces):
    spec, x, F_jax = jax_forces
    tspec = grid_spec(spec)
    xs, _, valid, _, _ = T.bin_particles(torch.as_tensor(x),
                                         torch.zeros((64, 3)), tspec)
    F = T.cell_forces_reference(xs, valid, tspec)
    scale = float(np.abs(F_jax).max())
    assert scale > 1.0
    assert np.abs(np64(F) - F_jax.astype(np.float64)).max() <= 1e-4 * scale
    # zero in the empty and the ghost slots, as the kernel's
    assert not torch.any(F * (1.0 - valid))


def _dense_forces(x, spec):
    L = torch.full((3,), spec.box_edge, dtype=torch.float32)
    F, _ = lj_forces_reference(x.t().contiguous(), L, cutoff=spec.cutoff,
                               switch_width=spec.switch_width,
                               sigma=spec.sigma, epsilon=spec.epsilon)
    return F.t()


def test_forces_match_dense_at_lj2048():
    f, spec = _fluid_spec(T, 2048)
    x = torch.as_tensor(np.asarray(f.positions, np.float32))
    xs, vs, valid, sp, _ = T.bin_particles(x, torch.zeros_like(x), spec)
    F_slots = T.cell_forces_reference(xs, valid, spec)
    F, _ = T.unbin_particles(F_slots, F_slots, sp, 2048)
    F_dense = _dense_forces(x, spec)
    scale = float(F_dense.abs().max())
    assert float((F - F_dense).abs().max()) <= 2e-4 * scale


@pytest.mark.parametrize("n", [64, 2048])
def test_occupied_slots_only_equal_all_slots(n):
    """Visiting the slot rows below the largest occupancy (the kernels'
    per-cell occupancy bound) gives the forces of all M rows."""
    kw = dict(skin_fraction=0.1, capacity=8) if n == 64 else {}
    f, spec = _fluid_spec(T, n, **kw)
    x = torch.as_tensor(np.asarray(f.positions, np.float32))
    xs, _, valid, _, mo = T.bin_particles(x, torch.zeros_like(x), spec)
    assert int(mo) < spec.capacity
    full = T.cell_forces_reference(xs, valid, spec)
    gated = T.cell_forces_reference(xs, valid, spec, rows=int(mo))
    assert float((gated - full).abs().max()) <= 1e-5


def test_trajectory_matches_jax_baoab():
    """gamma = 0, 25 steps with a rebin every 10, from a FIRE-minimized
    N = 512 start (reduced density 0.5, 3 cells a side of 1.14 nm): the
    port's FusedLJBAOAB against the JAX package's generic BAOAB program."""
    x, v, box, kT, p = minimized_fluid(n=512)
    n = x.shape[0]
    L = float(box[0, 0])
    f, jspec = _fluid_spec(P, n, reduced_density=0.5, collision_rate=0.0)
    bound = JaxBAOAB(temperature=120.0, collision_rate=0.0, timestep=0.002,
                     neighborlist=None).bind(f.system)
    st = bound.initial_state(
        JaxSamplerState(positions=jnp.asarray(x), velocities=jnp.asarray(v),
                        box_vectors=jnp.asarray(box)),
        jax.random.PRNGKey(1))
    st = bound.run(st, 25)

    k4 = T.FusedLJBAOAB(grid_spec(jspec), n, rebuild_interval=10,
                        device="cpu")
    xo, vo = k4.run(x, v, kT, torch.Generator(), 25)
    v_scale = float(np.abs(np64(st.velocities)).max())
    assert wrapped_distance(xo, st.positions, L) < 5e-4
    assert np.abs(np64(vo) - np64(st.velocities)).max() < 5e-3 * v_scale
    assert wrapped_distance(xo, x, L) > 1e-3
    assert k4.capacity_bumps == 0 and k4.launches == {
        "cell_forces": 0, "cell_chunk": 0}


def test_overflow_raises_the_capacity_and_changes_nothing():
    """A dense cluster (the minimized N = 256 fluid at reduced density 0.5)
    in the corner of the reduced density 0.05 box overflows capacity 8; the
    run rebins at a larger capacity before each chunk, and with noise
    on the run equals one started at a capacity large enough."""
    x, _, _, kT, _ = minimized_fluid()
    v = _velocities(256)
    _, spec = _fluid_spec(T, 256, collision_rate=5.0)
    small = T.FusedLJBAOAB(spec._replace(capacity=8), 256,
                           rebuild_interval=10, device="cpu")
    large = T.FusedLJBAOAB(spec._replace(capacity=64), 256,
                           rebuild_interval=10, device="cpu")
    xa, va = small.run(x, v, kT, torch.Generator().manual_seed(9), 20)
    xb, vb = large.run(x, v, kT, torch.Generator().manual_seed(9), 20)
    assert small.capacity_bumps >= 1 and large.capacity_bumps == 0
    assert 8 < small.max_occupancy <= small.spec.capacity < 64
    assert small.max_occupancy == large.max_occupancy
    assert torch.equal(xa, xb) and torch.equal(va, vb)
    assert torch.isfinite(xa).all()


def test_cell_wrapper_refuses_devices_without_a_kernel():
    _, spec = _fluid_spec(T, 64, skin_fraction=0.1, capacity=8)
    k4 = T.FusedLJBAOAB(spec, 64, device="cpu")
    slots = torch.zeros((3, 8, spec.g_cells), device="meta")
    with pytest.raises(ValueError, match="no cell-grid LJ kernel"):
        k4.forces(slots, slots[0])
