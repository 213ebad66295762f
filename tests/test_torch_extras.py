"""The integrators outside the splitting language against the JAX
package's, at float64 on the CPU, and the rule that keeps them off the
fused kernel and sweep mode.

* Nosé–Hoover and MTS are deterministic: 50 steps from the same
  velocities, held at rel 1e-8 (positions, velocities, the chain's state);
  the Nosé–Hoover conserved energy drifts by under 5 % of its scale.
* Andersen, HMC and Metropolis MC: one step given the JAX package's own
  draws (the test computes them from the JAX key), the same positions,
  velocities and accept at rel 1e-8; Andersen's <U> = 3/2 kT on the
  harmonic oscillator by statistics (its noise stream is the port's own).
* The no-op moves nothing in either package.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmmtools_tpu.integrators as jint
import openmmtools_tpu_torch.integrators as tint
from openmmtools_tpu.integrators.langevin import (
    thermalize_velocities as jax_thermalize,
)
from openmmtools_tpu.models import testsystems as jts
from openmmtools_tpu.states import SamplerState as JaxSamplerState
from openmmtools_tpu_torch.constants import kB
from openmmtools_tpu_torch.integrators.langevin import BoundIntegrator
from openmmtools_tpu_torch.models import testsystems as tts
from openmmtools_tpu_torch.ops.fused_langevin import brings_own_step
from openmmtools_tpu_torch.states import SamplerState

from test_torch_support import jax_f64

REL = 1e-8
TEMP = 300.0
EXTRAS = ["AndersenVelocityVerletIntegrator", "HMCIntegrator",
          "MetropolisMonteCarloIntegrator",
          "NoseHooverChainVelocityVerletIntegrator", "DummyIntegrator"]


def _close(got, want, rel=REL, floor=1e-30):
    """max |got - want| <= rel max(|want|, floor)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))), floor)
    assert float(np.max(np.abs(got - want))) <= rel * scale


def _system(name, **kwargs):
    js = getattr(jts, name)(**kwargs)
    ps = getattr(tts, name)(device="cpu", **kwargs)
    return js, jax_f64(js.system), ps.system.to(dtype=torch.float64)


def _start(js, seed=0):
    rng = np.random.default_rng(seed)
    x = np.asarray(js.positions, np.float64)
    x = x + rng.normal(scale=0.01, size=x.shape)
    m = np.asarray(js.system.masses, np.float64)
    v = rng.normal(size=x.shape) * np.sqrt(kB * TEMP / m)[:, None]
    return x, v


def _bind_both(jinteg, tinteg, jsys, psys, x, v):
    jb, tb = jinteg.bind(jsys), tinteg.bind(psys)
    js = jb.initial_state(JaxSamplerState(positions=jnp.asarray(x),
                                          velocities=jnp.asarray(v)),
                          jax.random.PRNGKey(0), temperature=TEMP)
    ts = tb.initial_state(SamplerState(positions=torch.as_tensor(x),
                                       velocities=torch.as_tensor(v)),
                          torch.Generator().manual_seed(0), temperature=TEMP)
    return jb, tb, js, ts


def test_nose_hoover_matches_jax():
    js_, jsys, psys = _system("HarmonicOscillatorArray", N=4)
    x, v = _start(js_)
    kw = dict(temperature=TEMP, timestep=0.001, collision_frequency=50.0,
              chain_length=3, n_ys=3, n_mts=2)
    jb, tb, js, ts = _bind_both(
        jint.NoseHooverChainVelocityVerletIntegrator(**kw),
        tint.NoseHooverChainVelocityVerletIntegrator(**kw), jsys, psys, x, v)
    js, ts = jb.run(js, 50), tb.run(ts, 50)
    _close(ts.positions, js.positions)
    _close(ts.velocities, js.velocities)
    for key in js.global_params:
        _close(ts.global_params[key], js.global_params[key])
    ke_j, pe_j = jb.bath_energy(js)
    ke_t, pe_t = tb.bath_energy(ts)
    _close(ke_t, ke_j)
    _close(pe_t, pe_j)


def test_nose_hoover_conserves_its_extended_energy():
    _, _, psys = _system("HarmonicOscillatorArray", N=5)
    arr = tts.HarmonicOscillatorArray(N=5, device="cpu")
    integ = tint.NoseHooverChainVelocityVerletIntegrator(
        temperature=TEMP, timestep=0.001, collision_frequency=50.0,
        chain_length=3, n_ys=3, n_mts=1)
    bound = integ.bind(psys)
    s = bound.initial_state(
        SamplerState(positions=arr.positions.to(torch.float64)),
        torch.Generator().manual_seed(1), temperature=TEMP)

    def conserved(s):
        ke_b, pe_b = bound.bath_energy(s)
        ke = 0.5 * float(torch.sum(psys.masses[:, None] * s.velocities**2))
        return float(s.potentials[0]) + ke + float(ke_b) + float(pe_b)

    s = bound.run(s, 50)
    e0 = conserved(s)
    s = bound.run(s, 400)
    e1 = conserved(s)
    assert abs(e1 - e0) < 0.05 * max(abs(e0), 5 * kB * TEMP), (e0, e1)


def test_mts_matches_jax():
    """r-RESPA on two force groups (the splitting language's numbered
    tokens): the same splitting string and 50 steps at rel 1e-8."""
    kw = dict(energy_expressions=("0.75*(x**2+y**2+z**2)",
                                  "0.25*(x**4+y**2+z**2)"), n_particles=5)
    js_, jsys, psys = _system("CustomExternalForcesTestSystem", **kw)
    x, v = _start(js_)
    jinteg = jint.MTSIntegrator(timestep=0.002, groups=[(0, 1), (1, 4)],
                                temperature=TEMP)
    tinteg = tint.MTSIntegrator(timestep=0.002, groups=[(0, 1), (1, 4)],
                                temperature=TEMP)
    assert tinteg.splitting == jinteg.splitting
    jb, tb, js, ts = _bind_both(jinteg, tinteg, jsys, psys, x, v)
    js, ts = jb.run(js, 50), tb.run(ts, 50)
    _close(ts.positions, js.positions)
    _close(ts.velocities, js.velocities)


@pytest.mark.parametrize("name,kwargs,dt,accepted", [
    ("LennardJonesCluster", dict(nx=2, ny=2, nz=2), 0.002, 1),
    ("LennardJonesCluster", dict(nx=2, ny=2, nz=2), 0.12, 0),
    ("Diatom", dict(constraint=True), 0.002, 1),
], ids=["cluster-accept", "cluster-reject", "constrained-diatom"])
def test_hmc_step_matches_jax(name, kwargs, dt, accepted):
    """One HMC step of the port's core fed the JAX step's own velocities
    and uniform: the same positions, velocities and accept (a rejection
    keeps x and flips v)."""
    js_, jsys, psys = _system(name, **kwargs)
    x, v = _start(js_)
    kw = dict(temperature=TEMP, nsteps=5, timestep=dt)
    jb, tb, js, ts = _bind_both(jint.HMCIntegrator(**kw),
                                tint.HMCIntegrator(**kw), jsys, psys, x, v)
    _, kv, ka = jax.random.split(js.rng_key, 3)
    v_draw = jax_thermalize(jsys.masses, js.kT, kv, dtype=jnp.float64)
    u_draw = jax.random.uniform(ka, dtype=jnp.float64)
    js1 = jb._step_fn(js)
    ts1 = tb.hmc_step(ts, torch.as_tensor(np.asarray(v_draw)),
                      torch.as_tensor(np.asarray(u_draw)))
    assert int(ts1.n_accepted) == int(js1.n_accepted) == accepted
    assert int(ts1.n_proposed) == int(js1.n_proposed) == 1
    _close(ts1.positions, js1.positions)
    _close(ts1.velocities, js1.velocities)
    _close(ts1.potentials[0], js1.potentials[0], floor=kB * TEMP)


@pytest.mark.parametrize("seed", [0, 3])   # a rejection, an acceptance
def test_metropolis_mc_step_matches_jax(seed):
    js_, jsys, psys = _system("HarmonicOscillator")
    x, v = _start(js_, seed)
    kw = dict(temperature=TEMP, displacement_sigma=0.01)
    jb, tb, js, ts = _bind_both(jint.MetropolisMonteCarloIntegrator(**kw),
                                tint.MetropolisMonteCarloIntegrator(**kw),
                                jsys, psys, x, v)
    js = js.replace(rng_key=jax.random.PRNGKey(seed))
    _, k1, k2 = jax.random.split(js.rng_key, 3)
    z = jax.random.normal(k1, js.positions.shape, dtype=jnp.float64)
    u = jax.random.uniform(k2, dtype=jnp.float64)
    js1 = jb._step_fn(js)
    ts1 = tb.metropolis_step(ts, torch.as_tensor(np.asarray(z)),
                             torch.as_tensor(np.asarray(u)))
    assert int(ts1.n_accepted) == int(js1.n_accepted)
    _close(ts1.positions, js1.positions)
    _close(ts1.potentials[0], js1.potentials[0])


def test_andersen_step_matches_jax():
    """One Andersen step fed the JAX step's fresh velocities and collision
    uniforms (nu dt = 0.5: about 40 % of the particles collide)."""
    js_, jsys, psys = _system("LennardJonesCluster", nx=2, ny=2, nz=2)
    x, v = _start(js_)
    kw = dict(temperature=TEMP, collision_rate=250.0, timestep=0.002)
    jb, tb, js, ts = _bind_both(jint.AndersenVelocityVerletIntegrator(**kw),
                                tint.AndersenVelocityVerletIntegrator(**kw),
                                jsys, psys, x, v)
    _, k1, k2 = jax.random.split(js.rng_key, 3)
    fresh = jax_thermalize(jsys.masses, js.kT, k1, dtype=jnp.float64)
    uniforms = jax.random.uniform(k2, (8, 1), dtype=jnp.float64)
    js1 = jb._step_fn(js)
    ts1 = tb.andersen_step(ts, torch.as_tensor(np.asarray(fresh)),
                           torch.as_tensor(np.asarray(uniforms)))
    collided = np.asarray(uniforms)[:, 0] < 1.0 - np.exp(-0.5)
    assert 0 < collided.sum() < 8
    _close(ts1.positions, js1.positions)
    _close(ts1.velocities, js1.velocities)
    _close(ts1.potentials[0], js1.potentials[0], floor=kB * TEMP)


def test_andersen_samples_the_oscillator():
    ho = tts.HarmonicOscillator(device="cpu")
    bound = tint.AndersenVelocityVerletIntegrator(
        temperature=TEMP, timestep=0.002).bind(ho.system)
    s = bound.initial_state(SamplerState(positions=ho.positions),
                            torch.Generator().manual_seed(0),
                            temperature=TEMP)
    s = bound.run(s, 300)
    us = []
    for _ in range(150):
        s = bound.run(s, 20)
        us.append(float(s.potentials[0]))
    expected = 1.5 * kB * TEMP
    stderr = np.std(us) / np.sqrt(len(us) / 4.0)
    assert abs(np.mean(us) - expected) < max(6 * stderr, 0.15 * expected)


def test_hmc_and_metropolis_accept_on_the_oscillator():
    ho = tts.HarmonicOscillator(device="cpu")
    for integ in (tint.HMCIntegrator(temperature=TEMP, nsteps=10,
                                     timestep=0.001),
                  tint.MetropolisMonteCarloIntegrator(
                      temperature=TEMP, displacement_sigma=0.005)):
        bound = integ.bind(ho.system)
        s = bound.initial_state(SamplerState(positions=ho.positions),
                                torch.Generator().manual_seed(3),
                                temperature=TEMP)
        s = bound.run(s, 100)
        assert int(s.n_proposed) == 100 and int(s.n_accepted) > 10
        assert torch.isfinite(s.positions).all()


def test_dummy_integrator_moves_nothing_like_jax():
    js_, jsys, psys = _system("HarmonicOscillator")
    x, v = _start(js_)
    jb, tb, js, ts = _bind_both(jint.DummyIntegrator(),
                                tint.DummyIntegrator(), jsys, psys, x, v)
    js1, ts1 = jb.run(js, 7), tb.run(ts, 7)
    assert ts1.step_count == int(js1.step_count) == 7
    _close(ts1.positions, js1.positions)
    _close(ts1.velocities, js1.velocities)
    assert torch.equal(ts1.positions, ts.positions)


# ---------------------------------------------------------------------------
# the rule: a class with its own step keeps the generic program
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", EXTRAS)
def test_extras_bring_their_own_step(name):
    assert brings_own_step(getattr(tint, name)._bound_class)


@pytest.mark.parametrize("cls", [
    "BAOABIntegrator", "GHMCIntegrator", "MTSIntegrator",
    "AlchemicalNonequilibriumLangevinIntegrator"])
def test_splitting_integrators_run_the_step_program(cls):
    assert not brings_own_step(getattr(tint, cls)._bound_class)
    assert not brings_own_step(BoundIntegrator)


class _OwnStep(BoundIntegrator):
    def step(self, state, skip_trailing_vproj=False):
        return state.replace(step_count=state.step_count + 1)


class _OwnStepIntegrator(tint.BAOABIntegrator):
    _bound_class = _OwnStep


@pytest.fixture
def as_if_on_the_card(monkeypatch):
    """The fused path's device test reads ``System.device``; reporting a
    CUDA device lets a CPU system pass every test of ``FusedPath.build`` (its
    constructor launches nothing)."""
    from openmmtools_tpu_torch.system import System

    monkeypatch.setattr(System, "device",
                        property(lambda self: torch.device("cuda")))


@pytest.mark.parametrize("name", EXTRAS + ["_OwnStepIntegrator"])
def test_own_step_is_refused_the_fused_kernel(as_if_on_the_card, name):
    """On an LJ fluid that takes the chunk kernel under BAOAB, an integrator
    with its own step (whatever its R/V/O splitting) keeps its step."""
    fluid = tts.LennardJonesFluid(nparticles=256, device="cpu")
    assert tint.BAOABIntegrator(temperature=120.0).bind(
        fluid.system).force_path.name == "K1"
    integ = (_OwnStepIntegrator(temperature=120.0)
             if name == "_OwnStepIntegrator"
             else getattr(tint, name)(temperature=120.0))
    bound = integ.bind(fluid.system)
    assert bound.force_path.name != "K1" and not bound.sweep_mode


def test_own_step_is_refused_the_trailing_projection_skip():
    """On rigid water the BAOAB program drops its trailing velocity
    projection inside a run; a class with its own step does not."""
    from openmmtools_tpu_torch.models import WaterBox

    water = WaterBox(box_edge=1.5, cutoff=0.6, device="cpu")
    assert tint.BAOABIntegrator().bind(water.system)._vproj_skip
    assert not _OwnStepIntegrator().bind(water.system)._vproj_skip


def test_own_step_keeps_sweep_mode_off():
    """With sweep mode forced, BAOAB takes it and a class with its own step
    does not: its step and its initial state both evaluate densely."""
    fluid = tts.LennardJonesFluid(nparticles=1024, device="cpu")
    assert tint.BAOABIntegrator(sweep="force").bind(fluid.system).sweep_mode
    for name in EXTRAS:
        bound = getattr(tint, name)(sweep="force").bind(fluid.system)
        assert not bound.sweep_mode
