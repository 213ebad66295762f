"""Neighbour lists (``ops/neighborlist.py``), ``energy_neighbors`` and
neighbour mode against the JAX package: the list entry for entry, the
blocked build equal to the one-shot one, the energies at float64, neighbour
mode's parameters and a gamma = 0 run across rebuilds, and the MCMC move's
overflow check.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmmtools_tpu.integrators import BAOABIntegrator as JaxBAOAB
from openmmtools_tpu.models import LennardJonesFluid as JaxLJ
from openmmtools_tpu.ops import neighborlist as jnl
from openmmtools_tpu.states import SamplerState as JaxSamplerState
from openmmtools_tpu_torch.integrators import BAOABIntegrator
from openmmtools_tpu_torch.mcmc import LangevinDynamicsMove, MCMCMoveError
from openmmtools_tpu_torch.models import LennardJonesFluid
from openmmtools_tpu_torch.ops import neighborlist as tnl
from openmmtools_tpu_torch.states import SamplerState
from openmmtools_tpu_torch.system import make_energy_fn
from openmmtools_tpu_torch.utils.convert import neighbor_list_from_numpy

from test_torch_support import fluid_with_exceptions, jax_f64, np64, port_system


def _cloud(n=150, edge=2.3, seed=5, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, edge, (n, 3)).astype(dtype),
            np.diag([edge, edge * 1.1, edge * 0.9]).astype(dtype))


def _block_rows(monkeypatch, rows, n=150):
    """Make the build take blocks of ``rows`` rows of an n-particle
    plane."""
    monkeypatch.setattr(tnl, "_BLOCK_ENTRIES", rows * n)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k_max", [60, 12])
def test_build_matches_jax_entry_for_entry(k_max, dtype, monkeypatch):
    """idx and mask equal to the JAX list's; overflow equal, set at the
    smaller capacity."""
    x, box = _cloud(dtype=dtype)
    r_list = 0.61
    j = jnl.build_neighbor_list(jnp.asarray(x), jnp.asarray(box), r_list,
                                k_max)
    _block_rows(monkeypatch, 37)
    t = tnl.build_neighbor_list(torch.as_tensor(x), torch.as_tensor(box),
                                r_list, k_max)
    np.testing.assert_array_equal(t.idx.numpy(), np.asarray(j.idx))
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    assert bool(t.overflow) == bool(j.overflow) == (k_max == 12)
    assert t.idx.dtype == torch.int32


@pytest.mark.parametrize("rows", [1, 7, 64, 149])
def test_blocked_build_equals_one_shot(rows, monkeypatch):
    x, box = _cloud()
    x, box = torch.as_tensor(x), torch.as_tensor(box)
    _block_rows(monkeypatch, 150)
    one = tnl.build_neighbor_list(x, box, 0.61, 20)
    _block_rows(monkeypatch, rows)
    blk = tnl.build_neighbor_list(x, box, 0.61, 20)
    assert torch.equal(one.idx, blk.idx) and torch.equal(one.mask, blk.mask)
    assert bool(one.overflow) == bool(blk.overflow)


def test_neighbor_energy_matches_jax_on_the_jax_list():
    """The port's neighbor_energy over the JAX list (carried across as
    numpy) equals the JAX sum at float64."""
    x, box = _cloud()
    j = jnl.build_neighbor_list(jnp.asarray(x), jnp.asarray(box), 0.61, 60)
    t = neighbor_list_from_numpy(np.asarray(j.idx), np.asarray(j.mask),
                                 np.asarray(j.overflow), j.r_list,
                                 device="cpu")
    rng = np.random.default_rng(1)
    w = rng.uniform(0.5, 1.5, x.shape[0])

    def j_pair(r2, i, jj):
        return jnp.asarray(w)[i] * jnp.asarray(w)[jj] / r2

    def t_pair(r2, i, jj):
        tw = torch.as_tensor(w)
        return tw[i] * tw[jj] / r2

    u_j = float(jnl.neighbor_energy(jnp.asarray(x), jnp.asarray(box), j,
                                    j_pair))
    u_t = float(tnl.neighbor_energy(torch.as_tensor(x), torch.as_tensor(box),
                                    t, t_pair))
    assert abs(u_t - u_j) <= 1e-10 * abs(u_j)


@pytest.mark.parametrize("scaled", [False, True])
def test_energy_neighbors_matches_jax(scaled):
    """The charged (PME) LJ fluid with exceptions, at a global LJ and
    charge scale: energy_neighbors of both packages at float64, and both
    equal to the dense energy."""
    jf = JaxLJ(nparticles=200, reduced_density=0.3, charge=0.1)
    jsys = fluid_with_exceptions(jf.system, jf.positions)
    params_j, params_t = None, None
    if scaled:
        term = jsys.terms[0].replace(lj_scale_param="lj_scale",
                                     charge_scale_param="q_scale")
        jsys = jsys.replace_term(0, term)
        params_j = {"lj_scale": jnp.float64(0.7), "q_scale": jnp.float64(0.4)}
        params_t = {k: torch.tensor(float(v), dtype=torch.float64)
                    for k, v in params_j.items()}
    jsys = jax_f64(jsys)
    psys = port_system(jsys)
    x = np.asarray(jf.positions, np.float64)
    cutoff = jsys.terms[0].cutoff
    j = jnl.build_neighbor_list(jnp.asarray(x), jsys.default_box,
                                cutoff + 0.1, 199)
    t = tnl.build_neighbor_list(torch.as_tensor(x), psys.default_box,
                                cutoff + 0.1, 199)
    assert not bool(t.overflow)
    u_j = float(jsys.terms[0].energy_neighbors(jnp.asarray(x),
                                               jsys.default_box, params_j, j))
    u_t = float(psys.terms[0].energy_neighbors(torch.as_tensor(x),
                                               psys.default_box, params_t, t))
    assert abs(u_t - u_j) <= 1e-10 * abs(u_j)
    u_dense = float(psys.terms[0].energy(torch.as_tensor(x),
                                         psys.default_box, params_t))
    assert abs(u_t - u_dense) <= 1e-10 * abs(u_dense)


def _bound_pair(n, **kw):
    jf = JaxLJ(nparticles=n)
    tf = LennardJonesFluid(nparticles=n, device="cpu")
    return (JaxBAOAB(temperature=120.0, **kw).bind(jf.system),
            BAOABIntegrator(temperature=120.0, **kw).bind(tf.system))


@pytest.mark.parametrize("n", [127, 128, 300])
def test_neighbor_mode_engages_as_in_jax(n):
    jb, tb = _bound_pair(n, collision_rate=1.0, timestep=0.002)
    assert tb.neighbor_mode == jb.neighbor_mode == (n >= 128)
    if n >= 128:
        assert tb.force_path.k_max == jb.neighbor_k_max
        assert tb.force_path.r_list == pytest.approx(jb.neighbor_r_list,
                                                   rel=1e-15)
        assert tb.force_path.refresh_interval == jb.neighbor_rebuild_interval
    off = BAOABIntegrator(neighborlist=None).bind(
        LennardJonesFluid(nparticles=300, device="cpu").system)
    assert not off.neighbor_mode


def test_gamma_zero_run_across_rebuilds_matches_jax(monkeypatch):
    """gamma = 0 (no noise): 25 steps with a rebuild every 10, both
    packages at float64 from the same positions and velocities; the port
    builds no second list at the first chunk's start."""
    jf = JaxLJ(nparticles=256, reduced_density=0.3)
    tf = LennardJonesFluid(nparticles=256, reduced_density=0.3,
                           device="cpu")
    kw = dict(temperature=120.0, collision_rate=0.0, timestep=0.002,
              neighbor_rebuild_interval=10)
    jb = JaxBAOAB(**kw).bind(jax_f64(jf.system))
    tb = BAOABIntegrator(**kw).bind(tf.system.to(dtype=torch.float64))
    assert jb.neighbor_mode and tb.neighbor_mode
    x = np.asarray(jf.positions, np.float64)
    v = np.random.default_rng(3).normal(scale=0.1, size=x.shape)
    box = np.asarray(jf.system.default_box, np.float64)
    js = jb.initial_state(
        JaxSamplerState(positions=jnp.asarray(x), velocities=jnp.asarray(v),
                        box_vectors=jnp.asarray(box)),
        jax.random.PRNGKey(0), temperature=120.0)
    js = jb.run(js, 25)
    ts = tb.initial_state(
        SamplerState(positions=torch.as_tensor(x),
                     velocities=torch.as_tensor(v),
                     box_vectors=torch.as_tensor(box)),
        torch.Generator().manual_seed(0), temperature=120.0)
    builds = []
    build = tnl.build_neighbor_list

    def counted(*a, **k):
        builds.append(1)
        return build(*a, **k)

    monkeypatch.setattr(tnl, "build_neighbor_list", counted)
    ts = tb.run(ts, 25)
    # initial_state's list serves the first interval, so the run builds at
    # steps 10 and 20 only (the JAX package builds at step 0 a second time)
    assert len(builds) == 2
    np.testing.assert_array_equal(ts.nbr_idx.numpy(), np.asarray(js.nbr_idx))
    np.testing.assert_array_equal(ts.nbr_mask.numpy(),
                                  np.asarray(js.nbr_mask))
    assert not bool(ts.nbr_overflow) and not bool(js.nbr_overflow)
    dx = np.abs(np64(ts.positions) - np.asarray(js.positions)).max()
    assert dx <= 1e-10, dx
    u_j = float(js.potentials[0])
    assert abs(float(ts.potentials[0]) - u_j) <= 1e-10 * abs(u_j)
    # the final potential is the dense energy at the final positions
    u_dense = float(make_energy_fn(tb.system)(ts.positions))
    assert abs(float(ts.potentials[0]) - u_dense) <= 1e-10 * abs(u_dense)


def test_overflowing_move_raises():
    """A configuration denser than the list's capacity allows sets the
    sticky overflow flag, and the integrator move raises MCMCMoveError."""
    tf = LennardJonesFluid(nparticles=200, device="cpu")
    ts = tf.thermodynamic_state(120.0)
    move = LangevinDynamicsMove(timestep=0.001, n_steps=3)
    bound = move._bound(ts)
    assert bound.neighbor_mode
    # every particle inside one list radius of the origin
    x = tf.positions * (0.5 * bound.force_path.r_list / tf.box_edge)
    ss = SamplerState(positions=x, box_vectors=tf.system.default_box)
    with pytest.raises(MCMCMoveError, match="neighbor-list capacity"):
        move.apply(ts, ss)
