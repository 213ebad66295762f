"""The minimizers against the JAX package's, at float64 on the CPU.

Gradient descent and L-BFGS are deterministic: the same start gives the
same trajectory, held at rel 1e-8 (positions) after their full loops.
``minimize``'s policy is held with the minimizers it calls replaced: the
fallback chain on a non-finite result, the never-worse rule, and the SHAKE
projection of a constrained result.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmmtools_tpu.models import testsystems as jts
from openmmtools_tpu.states import SamplerState as JaxSamplerState
from openmmtools_tpu.states import ThermodynamicState as JaxState
from openmmtools_tpu_torch.models import testsystems as tts
from openmmtools_tpu_torch.states import SamplerState, ThermodynamicState

from test_torch_support import jax_f64

# the modules (the packages' integrators/__init__ export a function
# ``minimize`` under the same name)
jmin = importlib.import_module("openmmtools_tpu.integrators.minimize")
tmin = importlib.import_module("openmmtools_tpu_torch.integrators.minimize")
REL = 1e-8


def _start(js, scale=0.02, seed=4):
    x = np.asarray(js.positions, np.float64)
    return x + np.random.default_rng(seed).normal(scale=scale, size=x.shape)


def _pair(name, **kwargs):
    js = getattr(jts, name)(**kwargs)
    ps = getattr(tts, name)(device="cpu", **kwargs)
    return js, jax_f64(js.system), ps.system.to(dtype=torch.float64)


def _close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert float(np.max(np.abs(got - want))) <= rel * scale


@pytest.mark.parametrize("name", ["LennardJonesCluster", "Diatom"])
def test_gradient_descent_matches_jax(name):
    js, jsys, psys = _pair(name)
    x = _start(js)
    xj, uj = jmin.gradient_descent_minimize(jsys, jnp.asarray(x),
                                            max_steps=60)
    xp, up = tmin.gradient_descent_minimize(psys, torch.as_tensor(x),
                                            max_steps=60)
    _close(xp, xj)
    assert abs(float(up) - float(uj)) <= REL * max(abs(float(uj)), 1.0)


@pytest.mark.parametrize("name", ["LennardJonesCluster", "Diatom"])
def test_lbfgs_matches_jax(name):
    js, jsys, psys = _pair(name)
    x = _start(js)
    xj, uj = jmin.lbfgs_minimize(jsys, jnp.asarray(x), max_steps=25)
    xp, up = tmin.lbfgs_minimize(psys, torch.as_tensor(x), max_steps=25)
    _close(xp, xj)
    assert abs(float(up) - float(uj)) <= REL * max(abs(float(uj)), 1.0)
    # and it minimizes
    assert float(up) < float(psys.energy(torch.as_tensor(x)))


def _states(js, jsys, psys, x):
    jstate = JaxState(system=jsys, temperature=np.float64(300.0))
    pstate = ThermodynamicState(system=psys, temperature=300.0)
    return (jstate, JaxSamplerState(positions=jnp.asarray(x)), pstate,
            SamplerState(positions=torch.as_tensor(x)))


def _nan_minimizer(system, x, box=None, params=None, **kwargs):
    return x, x[0, 0] * float("nan")


@pytest.mark.parametrize("failing", [("fire_minimize",),
                                     ("fire_minimize", "lbfgs_minimize")])
def test_minimize_falls_back_on_a_non_finite_result(monkeypatch, failing):
    """FIRE, then L-BFGS, then gradient descent from the input, while the
    result is not finite: with the first ones made to fail, both packages
    return the next one's minimum."""
    js, jsys, psys = _pair("LennardJonesCluster")
    x = _start(js)
    jstate, jss, pstate, pss = _states(js, jsys, psys, x)
    for name in failing:
        monkeypatch.setattr(jmin, name, _nan_minimizer)
        monkeypatch.setattr(tmin, name, _nan_minimizer)
    out_j = jmin.minimize(jstate, jss, max_iterations=30)
    out_p = tmin.minimize(pstate, pss, max_iterations=30)
    _close(out_p.positions, out_j.positions)
    assert not np.allclose(out_p.positions.numpy(), x)
    u0 = float(pstate.potential_energy(pss))
    assert float(pstate.potential_energy(out_p)) < u0


def test_minimize_never_returns_a_worse_state(monkeypatch):
    """A minimizer whose result is above the input's energy (or not finite
    after every fallback) leaves the input as it was."""
    js, jsys, psys = _pair("LennardJonesCluster")
    x = _start(js)
    jstate, jss, pstate, pss = _states(js, jsys, psys, x)

    def uphill(system, x, box=None, params=None, **kwargs):
        x = x * 0.8   # squeezes the lattice: the energy rises
        return x, tmin.make_energy_fn(system)(x, box, params)

    def uphill_jax(system, x, box=None, params=None, **kwargs):
        x = x * 0.8
        return x, jmin.make_energy_fn(system)(x, box, params)

    monkeypatch.setattr(tmin, "fire_minimize", uphill)
    monkeypatch.setattr(jmin, "fire_minimize", uphill_jax)
    assert tmin.minimize(pstate, pss) is pss
    assert jmin.minimize(jstate, jss) is jss
    for name in ("fire_minimize", "lbfgs_minimize",
                 "gradient_descent_minimize"):
        monkeypatch.setattr(tmin, name, _nan_minimizer)
        monkeypatch.setattr(jmin, name, _nan_minimizer)
    assert tmin.minimize(pstate, pss) is pss
    assert jmin.minimize(jstate, jss) is jss


def test_minimize_projects_onto_the_constraints():
    """On a constrained system the result is SHAKE-projected before the
    acceptance check: the constrained diatom ends at its bond length, at
    the JAX package's positions."""
    js, jsys, psys = _pair("Diatom", constraint=True)
    x = _start(js, scale=0.03)
    jstate, jss, pstate, pss = _states(js, jsys, psys, x)
    out_j = jmin.minimize(jstate, jss, max_iterations=40)
    out_p = tmin.minimize(pstate, pss, max_iterations=40)
    assert out_p is not pss
    _close(out_p.positions, out_j.positions)
    r = float(torch.linalg.norm(out_p.positions[0] - out_p.positions[1]))
    assert r == pytest.approx(js.r0, rel=1e-7)


def test_minimizer_classes_carry_the_functions():
    js, jsys, psys = _pair("LennardJonesCluster")
    x = _start(js)
    xf, uf = tmin.FIREMinimizationIntegrator(timestep=2e-3).minimize(
        psys, torch.as_tensor(x), max_steps=20)
    xg, ug = tmin.GradientDescentMinimizationIntegrator(
        initial_step_size=2e-4).minimize(psys, torch.as_tensor(x),
                                         max_steps=20)
    jf = jmin.FIREMinimizationIntegrator(timestep=2e-3).minimize(
        jsys, jnp.asarray(x), max_steps=20)
    jg = jmin.GradientDescentMinimizationIntegrator(
        initial_step_size=2e-4).minimize(jsys, jnp.asarray(x), max_steps=20)
    _close(xf, jf[0])
    _close(xg, jg[0])
