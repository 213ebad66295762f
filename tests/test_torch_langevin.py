"""The generic Langevin splitting program: the port against the JAX package.

At collision_rate 0 the programs are deterministic, so trajectories of the
same float64 inputs must agree to rounding (dx, dv below 1e-9 of scale after
25 steps). With noise the streams differ (threefry against torch's
generator), so the port is held to sampled statistics instead.
"""
import math

import jax
import numpy as np
import pytest
import torch

from openmmtools_tpu.integrators import LangevinIntegrator as JaxLangevin
from openmmtools_tpu.integrators import parse_splitting as jax_parse
from openmmtools_tpu.integrators.langevin import IntegratorError as JaxError
from openmmtools_tpu.integrators.minimize import fire_minimize as jax_fire
from openmmtools_tpu.models import LennardJonesFluid as JaxLJ
from openmmtools_tpu.states import SamplerState as JaxSamplerState
from openmmtools_tpu_torch.constants import kB
from openmmtools_tpu_torch.integrators import (
    BAOABIntegrator,
    GHMCIntegrator,
    IntegratorError,
    LangevinIntegrator,
    VVVRIntegrator,
    fire_minimize,
    parse_splitting,
)
from openmmtools_tpu_torch.models import HarmonicOscillator
from openmmtools_tpu_torch.states import SamplerState
from openmmtools_tpu_torch.system import kinetic_energy

from test_torch_support import jax_f64, minimized_fluid, np64, port_system

SPLITTINGS = ["V R O R V", "O V R V O", "V R R O R R V", "V R V"]

SPLITTING_MATRIX = [
    "V R O R V", "O { V R V } O", "V0 V1 R O R V1 V0", "v r o r v", "H V R",
    "V R X", "{ O }", "V { R", "V } R", "V V0 R O", "{ V } { V }",
    "{ V { R } }", "V32 R", "", "   ",
]


@pytest.mark.parametrize("splitting", SPLITTING_MATRIX)
def test_parse_splitting_agrees_with_jax(splitting):
    try:
        want = jax_parse(splitting)
    except JaxError:
        with pytest.raises(IntegratorError):
            parse_splitting(splitting)
    else:
        assert parse_splitting(splitting) == want


@pytest.fixture(scope="module")
def fluid64():
    x, v, box, kT, _ = minimized_fluid()
    jsys = jax_f64(JaxLJ(nparticles=x.shape[0], reduced_density=0.5).system)
    return (x.astype(np.float64), v.astype(np.float64),
            box.astype(np.float64), jsys)


@pytest.mark.parametrize("splitting", SPLITTINGS)
def test_generic_trajectory_matches_jax(fluid64, splitting):
    x, v, box, jsys = fluid64
    jb = JaxLangevin(temperature=120.0, collision_rate=0.0, timestep=0.002,
                     splitting=splitting, neighborlist=None,
                     sweep=None).bind(jsys)
    js = jb.initial_state(JaxSamplerState(positions=x, velocities=v,
                                          box_vectors=box),
                          jax.random.PRNGKey(0))
    js = jb.run(js, 25)

    tb = LangevinIntegrator(temperature=120.0, collision_rate=0.0,
                            timestep=0.002, splitting=splitting,
                            neighborlist=None).bind(port_system(jsys))
    ts = tb.initial_state(SamplerState(
        positions=torch.as_tensor(x), velocities=torch.as_tensor(v),
        box_vectors=torch.as_tensor(box)), torch.Generator())
    ts = tb.run(ts, 25)

    assert ts.step_count == 25
    for port, ref in ((ts.positions, js.positions),
                      (ts.velocities, js.velocities),
                      (ts.forces[0], js.forces[0])):
        assert np.abs(np64(port) - np64(ref)).max() <= 1e-9 * np.abs(np64(ref)).max()
    assert abs(float(ts.potentials[0]) - float(js.potentials[0])) <= \
        1e-9 * abs(float(js.potentials[0]))
    # the fluid moved: the comparison is not of a resting state
    assert np.abs(np64(ts.positions) - x).max() > 1e-3


def test_fire_minimize_matches_jax(fluid64):
    jf = JaxLJ(nparticles=64, reduced_density=0.5)
    jsys = jax_f64(jf.system)
    x0 = np.asarray(jf.positions, np.float64)
    xj, uj = jax_fire(jsys, x0, jsys.default_box, max_steps=60)
    system = port_system(jf.system)
    xt, ut = fire_minimize(system, torch.as_tensor(x0), system.default_box,
                           max_steps=60)
    assert float(ut) < float(system.energy(torch.as_tensor(x0)))
    assert abs(float(ut) - float(uj)) <= 1e-9 * abs(float(uj))
    assert np.abs(np64(xt) - np64(xj)).max() <= 1e-9


def _mean_potential(integrator, n_burn=500, n_samples=60, stride=50,
                    seed=0, temperature=300.0):
    ho = HarmonicOscillator(device="cpu")
    bound = integrator.bind(ho.system.to(dtype=torch.float64))
    state = bound.initial_state(
        SamplerState(positions=ho.positions.double()),
        torch.Generator().manual_seed(seed), temperature=temperature)
    state = bound.run(state, n_burn)
    us = []
    for _ in range(n_samples):
        state = bound.run(state, stride)
        us.append(float(state.potentials[0]))
    return np.mean(us), np.std(us) / math.sqrt(len(us)), state


@pytest.mark.parametrize("integrator_class", [BAOABIntegrator, VVVRIntegrator])
def test_harmonic_oscillator_samples_boltzmann(integrator_class):
    """<U> = (3/2) kT on the harmonic oscillator at 300 K. Samples 50 steps
    (~3 periods, gamma = 20/ps) apart are near independent; with 60 of them
    the standard error of <U> is ~0.2 kT, and the bound is 4 of those."""
    integ = integrator_class(temperature=300.0, collision_rate=20.0,
                             timestep=0.002)
    mean_u, stderr, _ = _mean_potential(integ, seed=3)
    expected = 1.5 * kB * 300.0
    assert abs(mean_u - expected) < 4 * max(stderr, 0.05 * expected), (
        mean_u, expected, stderr)


def test_ghmc_accepts_and_samples():
    integ = GHMCIntegrator(temperature=300.0, collision_rate=20.0,
                           timestep=0.004)
    mean_u, stderr, state = _mean_potential(integ, seed=4)
    expected = 1.5 * kB * 300.0
    assert abs(mean_u - expected) < 4 * max(stderr, 0.05 * expected)
    assert int(state.n_proposed) == 500 + 60 * 50
    assert 0.5 < float(LangevinIntegrator.acceptance_rate(state)) <= 1.0


def test_mts_groups_and_shadow_work_match_jax(fluid64):
    """Numbered Vn kicks per force group (MTS) with shadow-work bookkeeping
    at collision_rate 0: the LJ fluid in group 0 plus a weak harmonic
    tether in group 1, port against JAX at float64."""
    from openmmtools_tpu.system import CustomExternalTerm as JaxExternal

    x, v, box, jsys = fluid64
    n = x.shape[0]
    tether = JaxExternal(
        particles=np.arange(n, dtype=np.int32),
        global_defaults={"k_tether": np.asarray(50.0)},
        expression="k_tether*((x-1.3)**2 + (y-1.3)**2 + (z-1.3)**2)",
        force_group=1)
    jsys = jsys.replace(terms=(jsys.terms[0], tether))
    splitting = "V0 V1 R V1 R V1 V0"
    jb = JaxLangevin(temperature=120.0, collision_rate=0.0, timestep=0.002,
                     splitting=splitting, measure_shadow_work=True,
                     neighborlist=None, sweep=None).bind(jsys)
    js = jb.run(jb.initial_state(JaxSamplerState(
        positions=x, velocities=v, box_vectors=box), jax.random.PRNGKey(0)), 20)
    tb = LangevinIntegrator(temperature=120.0, collision_rate=0.0,
                            timestep=0.002, splitting=splitting,
                            measure_shadow_work=True).bind(port_system(jsys))
    assert tb.groups == [0, 1] and tb.force_path.name != "K1"
    ts = tb.run(tb.initial_state(SamplerState(
        positions=torch.as_tensor(x), velocities=torch.as_tensor(v),
        box_vectors=torch.as_tensor(box)), torch.Generator()), 20)
    for port, ref in ((ts.positions, js.positions),
                      (ts.velocities, js.velocities)):
        assert np.abs(np64(port) - np64(ref)).max() <= 1e-9 * np.abs(np64(ref)).max()
    for g in range(2):
        assert abs(float(ts.potentials[g]) - float(js.potentials[g])) <= \
            1e-9 * abs(float(js.potentials[g]))
    assert abs(float(ts.shadow_work) - float(js.shadow_work)) <= \
        1e-8 * max(1.0, abs(float(js.shadow_work)))


def test_heat_and_shadow_work_balance_the_energy():
    """Total energy change = heat + shadow work under BAOAB with noise on
    the harmonic oscillator (openmmtools' bookkeeping identity)."""
    ho = HarmonicOscillator(device="cpu")
    integ = BAOABIntegrator(temperature=300.0, collision_rate=5.0,
                            timestep=0.002, measure_heat=True,
                            measure_shadow_work=True)
    bound = integ.bind(ho.system.to(dtype=torch.float64))
    state = bound.initial_state(SamplerState(positions=ho.positions.double()),
                                torch.Generator().manual_seed(4))

    def total(s):
        return float(s.potentials[0]) + float(
            kinetic_energy(bound.masses, s.velocities))

    e0 = total(state)
    state = bound.run(state, 500)
    budget = float(state.heat) + float(state.shadow_work)
    assert abs(float(state.heat)) > 0.0
    assert abs((total(state) - e0) - budget) < 1e-9 * max(1.0, abs(budget))
