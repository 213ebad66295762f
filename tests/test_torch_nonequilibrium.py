"""The port's nonequilibrium (NCMC) integrators against the JAX package's,
at float64 and collision rate 0 (deterministic; the noise streams differ):

* H-step protocol work, lambda and the per-cycle reset, step by step, on a
  harmonic oscillator whose protocol moves K (rel 1e-12) and on the
  alchemical water box in sweep mode against the JAX dense path (rel 1e-9);
* the H-inside-a-Metropolis-block branch: at a reckless time step every
  block is rejected, positions revert, velocities flip, and the force and
  energy caches are recomputed at the current parameters;
* ``perturb``: the work equals the energy differences at fixed positions,
  summed, and the JAX package's;
* the schedules (float32 arithmetic, as in the JAX package) and the
  instantaneous-switching identity.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmmtools_tpu import integrators as jint
from openmmtools_tpu.models import HarmonicOscillator as JaxHO
from openmmtools_tpu.models import water as jwater
from openmmtools_tpu.states import SamplerState as JaxSamplerState
from openmmtools_tpu_torch import integrators as tint
from openmmtools_tpu_torch.constants import kB
from openmmtools_tpu_torch.states import SamplerState

from test_torch_support import jax_f64, np64, port_system

T298 = 298.0
SIGMA = 0.1
K_REF = kB * T298 / SIGMA ** 2
MASS = 39.948
PERIOD = math.sqrt(MASS / K_REF)
DT_REF = 0.05 * PERIOD
K = "testsystems_HarmonicOscillator_K"
X0 = [[0.13, -0.07, 0.11]]
V0 = [[0.4, 0.1, -0.3]]


def _pair(name, **kw):
    """The same integrator class of both packages, bound to the same
    harmonic oscillator at float64."""
    jho = JaxHO(K=K_REF, mass=MASS)
    ji = getattr(jint, name)(temperature=T298, **kw)
    ti = getattr(tint, name)(temperature=T298, **kw)
    return (ji.bind(jax_f64(jho.system)), ti.bind(port_system(jho.system)),
            ji, ti)


def _start(jb, tb, params, x=X0, v=V0):
    js = jb.initial_state(JaxSamplerState(positions=jnp.asarray(x),
                                          velocities=jnp.asarray(v)),
                          jax.random.PRNGKey(0), temperature=T298,
                          global_params=params)
    ts = tb.initial_state(SamplerState(
        positions=torch.tensor(x, dtype=torch.float64),
        velocities=torch.tensor(v, dtype=torch.float64)),
                          torch.Generator().manual_seed(0), temperature=T298,
                          global_params=params)
    return js, ts


def _close(a, b, rel=1e-12):
    a, b = np64(a), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= rel * max(np.abs(b).max(), 1e-30), (a, b)


@pytest.mark.parametrize("splitting", ["O V R H R V O", "H V R O R V H"])
def test_h_work_and_cycle_reset_match_jax(splitting):
    # four H steps a protocol: every lambda a multiple of 1/4, exact in
    # float32 however the division is compiled (XLA may multiply by the
    # rounded reciprocal, which moves 5/6 by one float32 ulp)
    n_H = splitting.count("H")
    cycle = 4 // n_H
    funcs = {K: f"{K_REF} + lambda*{3 * K_REF}"}
    jb, tb, ji, ti = _pair("AlchemicalNonequilibriumLangevinIntegrator",
                           alchemical_functions=funcs, splitting=splitting,
                           collision_rate=0.0, timestep=DT_REF,
                           n_steps_neq=cycle)
    assert tb.n_H == n_H
    js, ts = _start(jb, tb, ti.initial_params())
    assert ts.lambda_step == 0 and float(ts.lambda_) == 0.0
    for step in range(2 * cycle + 1):   # two cycles and one step of a third
        js, ts = jb.run(js, 1), tb.run(ts, 1)
        assert ts.lambda_step == int(js.lambda_step), step
        assert float(ts.lambda_) == float(js.lambda_), step
        _close(ts.protocol_work, js.protocol_work)
        _close(ts.positions, js.positions)
        _close(ts.velocities, js.velocities)
        _close(ts.global_params[K], js.global_params[K])
        _close(ts.potentials[0], js.potentials[0])
        assert ts.step_count == step + 1
    # the third cycle restarted: one step of work
    assert ts.lambda_step == n_H and float(ts.lambda_) == n_H / 4


def test_h_in_block_rejection_matches_jax():
    """'{ V R H R V }' at 40x the time step (32 H steps a protocol, so
    every lambda is exact in float32): every block is rejected
    (exp(-shadow work / kT) underflows), so each step reverts the positions,
    flips the velocities and, lambda having moved inside the block,
    recomputes the energy and forces at the current parameters."""
    funcs = {K: f"{K_REF} + lambda*{40 * K_REF}"}
    jb, tb, ji, ti = _pair("AlchemicalNonequilibriumLangevinIntegrator",
                           alchemical_functions=funcs,
                           splitting="{ V R H R V }", collision_rate=0.0,
                           timestep=40.0 * DT_REF, n_steps_neq=32)
    js, ts = _start(jb, tb, ti.initial_params())
    for step in range(4):
        js, ts = jb.run(js, 1), tb.run(ts, 1)
        assert int(ts.n_accepted) == int(js.n_accepted) == 0
        assert int(ts.n_proposed) == step + 1
        _close(ts.positions, X0)
        _close(ts.velocities, js.velocities)
        _close(ts.protocol_work, js.protocol_work)
        _close(ts.global_params[K], js.global_params[K])
        # the caches are a fresh evaluation at the current parameters
        u, f = tb.force_path.ef_fns[None](ts.positions, None, ts.global_params)
        _close(ts.potentials[0], u)
        _close(ts.forces[0], f)
        _close(ts.potentials[0], js.potentials[0])
    assert np.all(np64(ts.velocities) == np.asarray(V0) * (1, 1, 1))


def test_perturb_on_the_neighbour_path_takes_the_dense_sum():
    """The neighbour list serves the step; a perturbation's energies, and
    the forces it leaves for the next step, are the dense sum's, as every
    whole-state energy is on that path (the list's forces differ from the
    dense ones in their last bits)."""
    from openmmtools_tpu_torch.models import LennardJonesFluid

    lj = LennardJonesFluid(nparticles=256, device="cpu")
    bound = tint.ExternalPerturbationLangevinIntegrator(
        temperature=120.0, timestep=0.002).bind(lj.system)
    assert bound.force_path.name == "neighbour list"
    state = bound.run(bound.initial_state(
        SamplerState(positions=lj.positions),
        torch.Generator().manual_seed(3)), 3)
    u, f = bound.force_path.ef_fns[None](state.positions, state.box, {})
    assert not torch.equal(state.forces[0], f)
    new = bound.perturb(state, {})
    assert torch.equal(new.forces[0], f)
    assert torch.equal(new.potentials[0], u)
    assert float(new.protocol_work) == 0.0


def test_perturb_identity_matches_jax():
    jb, tb, ji, ti = _pair("ExternalPerturbationLangevinIntegrator",
                           splitting="V R O R V", collision_rate=0.0,
                           timestep=DT_REF)
    assert isinstance(tb, tint.BoundNonequilibriumIntegrator)
    assert tint.ExternalPerturbationLangevinIntegrator is \
        tint.NonequilibriumLangevinIntegrator
    params0 = {K: K_REF, "testsystems_HarmonicOscillator_x0": 0.0,
               "testsystems_HarmonicOscillator_U0": 0.0}
    js, ts = _start(jb, tb, params0)
    js, ts = jb.run(js, 5), tb.run(ts, 5)
    assert float(ts.protocol_work) == 0.0
    expected = 0.0
    for knew in (2.0 * K_REF, 0.5 * K_REF, 1.3 * K_REF):
        x = np64(ts.positions)
        kold = float(ts.global_params[K])
        expected += 0.5 * (knew - kold) * float((x ** 2).sum())
        new = {**params0, K: knew}
        js, ts = jb.perturb(js, new), tb.perturb(ts, new)
        assert math.isclose(float(ts.protocol_work), expected, rel_tol=1e-12)
        _close(ts.potentials[0], js.potentials[0])
        js, ts = jb.run(js, 3), tb.run(ts, 3)    # plain steps: no work
        _close(ts.protocol_work, js.protocol_work)
        _close(ts.positions, js.positions)
    assert math.isclose(float(ts.protocol_work), expected, rel_tol=1e-12)


def _water_pair(name, sweep, **kw):
    jw = jwater.AlchemicalWaterBox(box_edge=1.9, cutoff=0.9)
    ji = getattr(jint, name)(temperature=300.0, collision_rate=0.0,
                             timestep=0.001, sweep=None, neighborlist=None,
                             **kw)
    ti = getattr(tint, name)(temperature=300.0, collision_rate=0.0,
                             timestep=0.001, sweep=sweep,
                             sweep_sort_interval=2, **kw)
    system = port_system(jw.system)
    jb, tb = ji.bind(jax_f64(jw.system)), ti.bind(system)
    x = np.asarray(jw.positions, np.float64)
    masses = np.asarray(jw.system.masses, np.float64)
    v = (np.random.default_rng(2).normal(size=x.shape)
         * np.sqrt(kB * 300.0 / masses)[:, None])
    box = np.asarray(jw.system.default_box, np.float64)
    js = jb.initial_state(JaxSamplerState(positions=jnp.asarray(x),
                                          velocities=jnp.asarray(v),
                                          box_vectors=jnp.asarray(box)),
                          jax.random.PRNGKey(0),
                          global_params={"lambda_electrostatics": 1.0,
                                         "lambda_sterics": 1.0})
    ts = tb.initial_state(SamplerState(positions=torch.as_tensor(x),
                                       velocities=torch.as_tensor(v),
                                       box_vectors=torch.as_tensor(box)),
                          torch.Generator(),
                          global_params={"lambda_electrostatics": 1.0,
                                         "lambda_sterics": 1.0})
    return jb, tb, js, ts


def test_ncmc_alchemical_water_sweep_matches_jax_dense():
    """NCMC on the alchemical water box: lambda_electrostatics 1 -> 0 over
    2 steps of 'V R H R V', run for 3 (the third starts a new cycle), the
    port in sweep mode and the JAX package on its dense path."""
    jb, tb, js, ts = _water_pair(
        "AlchemicalNonequilibriumLangevinIntegrator", "force",
        alchemical_functions={"lambda_electrostatics": "1 - lambda"},
        splitting="V R H R V", n_steps_neq=2)
    assert tb.sweep_mode and tb.force_path.alch is not None
    for step in range(3):
        js, ts = jb.run(js, 1), tb.run(ts, 1)
        _close(ts.protocol_work, js.protocol_work, rel=1e-9)
        _close(ts.positions, js.positions, rel=1e-9)
        _close(ts.global_params["lambda_electrostatics"],
               js.global_params["lambda_electrostatics"])
    assert float(ts.protocol_work) != 0.0


def test_perturb_alchemical_water_sweep_matches_jax_dense():
    jb, tb, js, ts = _water_pair("ExternalPerturbationLangevinIntegrator",
                                 "force")
    assert tb.sweep_mode
    same = 0.0
    for lam in (0.6, 0.2, 0.0):
        old = dict(ts.global_params)
        new = {"lambda_electrostatics": lam, "lambda_sterics": 1.0}
        sw = tb.force_path.context(ts)
        u_new = tb.force_path.evaluate(None, ts.positions, ts.box, new, sw)
        u_old = tb.force_path.evaluate(None, ts.positions, ts.box, old, sw)
        same += float(u_new[0] - u_old[0])
        js, ts = jb.perturb(js, new), tb.perturb(ts, new)
        # the same evaluation path: exact to rounding
        assert math.isclose(float(ts.protocol_work), same, rel_tol=1e-12)
        _close(ts.protocol_work, js.protocol_work, rel=1e-9)
        js, ts = jb.run(js, 1), tb.run(ts, 1)
        _close(ts.positions, js.positions, rel=1e-9)
    assert abs(float(ts.protocol_work)) > 1.0


def test_schedules_match_jax():
    kw = dict(alchemical_functions={"lambda_sterics": "min(1, 2*lambda)"},
              temperature=T298)
    for cls, extra in (("AlchemicalNonequilibriumLangevinIntegrator",
                        dict(n_steps_neq=7)),
                       ("AlchemicalNonequilibriumLangevinIntegrator",
                        dict(n_steps_neq=0)),
                       ("PeriodicNonequilibriumIntegrator",
                        dict(n_steps_eq=3, n_steps_neq=5))):
        ji = getattr(jint, cls)(**kw, **extra)
        ti = getattr(tint, cls)(**kw, **extra)
        assert ti._n_steps_per_cycle() == ji._n_steps_per_cycle()
        for n_H in (1, 2):
            for s in range(2 * ti._n_steps_per_cycle() * n_H + 2):
                assert ti._schedule(s, n_H) == float(ji._schedule(s, n_H))
        assert ti.initial_params() == ji.initial_params()


def test_instantaneous_switching_identity():
    """n_steps_neq = 0 with a pure H splitting: one step is the whole
    protocol, and its work is U(lambda=1, x) - U(lambda=0, x)."""
    funcs = {"testsystems_HarmonicOscillator_x0": f"lambda*{2 * SIGMA}",
             "testsystems_HarmonicOscillator_U0": f"lambda*{kB * T298}"}
    integ = tint.AlchemicalNonequilibriumLangevinIntegrator(
        alchemical_functions=funcs, splitting="H", temperature=T298,
        timestep=DT_REF, n_steps_neq=0)
    tb = integ.bind(port_system(JaxHO(K=K_REF, mass=MASS).system))
    x = [[0.05, -0.03, 0.08]]
    ts = tb.initial_state(SamplerState(
        positions=torch.tensor(x, dtype=torch.float64)),
        torch.Generator(), temperature=T298,
                          global_params=integ.initial_params())
    k = float(tb.system.terms[0].global_defaults[K])   # float32 K_REF
    du = 0.5 * k * ((x[0][0] - 2 * SIGMA) ** 2 - x[0][0] ** 2) + kB * T298
    for _ in range(2):           # the second step is a new cycle
        ts = tb.run(ts, 1)
        assert math.isclose(float(ts.protocol_work), du, rel_tol=1e-12)
        assert float(ts.lambda_) == 1.0


def test_nonequilibrium_validation():
    with pytest.raises(tint.IntegratorError, match="H step"):
        tint.AlchemicalNonequilibriumLangevinIntegrator(splitting="V R O R V")
    with pytest.raises(tint.IntegratorError, match="n_steps_neq"):
        tint.AlchemicalNonequilibriumLangevinIntegrator(n_steps_neq=-1)
    integ = tint.AlchemicalNonequilibriumLangevinIntegrator()
    assert integ.splitting == "O { V R H R V } O"
    with pytest.raises(tint.IntegratorError, match="nonequilibrium"):
        tint.LangevinIntegrator(splitting="V R H R V").bind(
            port_system(JaxHO().system)).run(
            tint.LangevinIntegrator(splitting="V R H R V").bind(
                port_system(JaxHO().system)).initial_state(
                SamplerState(positions=torch.zeros((1, 3),
                                                   dtype=torch.float64)),
                torch.Generator()), 1)
