"""The port's states against the JAX package: GlobalParameterState,
AlchemicalState, CompoundThermodynamicState, the state protocols and the
reduced potentials (float64, rel 1e-12 where a number is compared)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmmtools_tpu import alchemy as jalch
from openmmtools_tpu import states as jstates
from openmmtools_tpu.models import HarmonicOscillator as JaxHO
from openmmtools_tpu.models import water as jwater
from openmmtools_tpu_torch import alchemy as talch
from openmmtools_tpu_torch import states as tstates

from test_torch_support import jax_f64, port_system

REL = 1e-12


def _non_negative(state, value):
    if value < 0:
        raise ValueError("negative beta")
    return value


class Thing(tstates.GlobalParameterState):
    """A composable state of two parameters, one validated."""

    alpha = tstates.GlobalParameter("alpha", 1.0)
    beta = tstates.GlobalParameter("beta", 0.5, _non_negative)


def test_global_parameter_state_access_suffix_and_functions():
    s = Thing(alpha=0.2)
    assert s.alpha == 0.2 and s.beta is None
    assert s.parameters == {"alpha": 0.2}
    s.beta = 0.7
    assert s.get_parameter("beta") == 0.7
    with pytest.raises(ValueError, match="negative"):
        s.beta = -1.0
    with pytest.raises(tstates.GlobalParameterError, match="unknown"):
        Thing(gamma=1.0)
    # a suffixed state controls "<name>_<suffix>"
    r = Thing(parameters_name_suffix="ligand", alpha=0.3)
    assert r.parameters == {"alpha_ligand": 0.3}
    assert r.alpha == 0.3 and r.parameters_name_suffix == "ligand"
    r.set_parameter("alpha_ligand", 0.4)
    assert r.get_parameter("alpha") == 0.4
    with pytest.raises(tstates.GlobalParameterError):
        r.set_parameter("gamma", 1.0)
    # an enslaved parameter follows its function variable
    f = Thing(alpha=tstates.GlobalParameterFunction("lambda**2"))
    f.set_function_variable("lambda", 0.5)
    assert f.alpha == 0.25 and f.parameters == {"alpha": 0.25}
    assert f.get_function_variable("lambda") == 0.5
    # equality compares resolved values
    assert f == Thing(alpha=0.25)
    assert f != Thing(alpha=0.25, beta=0.1)
    assert "alpha" in repr(f)


def test_alchemical_state_matches_jax():
    t = talch.AlchemicalState(lambda_sterics=0.5, lambda_electrostatics=0.0)
    j = jalch.AlchemicalState(lambda_sterics=0.5, lambda_electrostatics=0.0)
    assert t.parameters == j.parameters
    for bad in (-0.1, 1.5):
        with pytest.raises(ValueError, match="lambda"):
            talch.AlchemicalState(lambda_sterics=bad)
    t.set_alchemical_parameters(0.25)
    j.set_alchemical_parameters(0.25)
    assert t.parameters == j.parameters == {
        "lambda_sterics": 0.25, "lambda_electrostatics": 0.25}
    with pytest.raises(ValueError):
        t.set_alchemical_parameters(2.0)
    f = talch.AlchemicalState(
        lambda_sterics=talch.AlchemicalFunction("2*lambda"))
    f.set_function_variable("lambda", 0.3)
    assert f.lambda_sterics == pytest.approx(0.6)


def _alchemical_water():
    jw = jwater.AlchemicalWaterBox(box_edge=1.9, cutoff=0.9)
    return jw, port_system(jw.system)


def test_from_system_and_consistency_match_jax():
    jw, system = _alchemical_water()
    t = talch.AlchemicalState.from_system(system)
    j = jalch.AlchemicalState.from_system(jw.system)
    assert t.parameters == j.parameters == {
        "lambda_sterics": 1.0, "lambda_electrostatics": 1.0}
    t.check_system_consistency(system)
    t.lambda_sterics = 0.5
    with pytest.raises(tstates.GlobalParameterError, match="lambda_sterics"):
        t.check_system_consistency(system)
    with pytest.raises(tstates.GlobalParameterError, match="none of"):
        Thing.from_system(system)
    extra = talch.AlchemicalState(lambda_sterics=1.0, lambda_electrostatics=1.0,
                                  lambda_bonds=1.0)
    with pytest.raises(tstates.GlobalParameterError, match="lambda_bonds"):
        extra.check_system_consistency(system)
    missing = talch.AlchemicalState(lambda_sterics=1.0)
    with pytest.raises(tstates.GlobalParameterError, match="undefined"):
        missing.check_system_consistency(system)


def _compound(system, module, states_module, **lams):
    base = states_module.ThermodynamicState(system=system, temperature=300.0)
    return states_module.CompoundThermodynamicState(
        base_state=base, composable_states=(module.AlchemicalState(**lams),))


def test_compound_state_and_reduced_potential_match_jax():
    jw, system = _alchemical_water()
    lams = dict(lambda_sterics=0.5, lambda_electrostatics=0.0)
    tc = _compound(system, talch, tstates, **lams)
    jc = _compound(jax_f64(jw.system), jalch, jstates, **lams)
    assert tc.global_params == jc.global_params == lams
    assert tc.lambda_sterics == 0.5 and tc.temperature == 300.0
    assert tc.kT == pytest.approx(jc.kT) and tc.beta == pytest.approx(jc.beta)
    assert tc.system is system and tc.pressure is None
    assert tc.n_particles == system.n_particles     # from the base state
    with pytest.raises(AttributeError):
        tc.no_such_attribute
    x = np.asarray(jw.positions, np.float64)
    box = np.asarray(jw.system.default_box, np.float64)
    ts = tstates.SamplerState(positions=torch.as_tensor(x),
                              box_vectors=torch.as_tensor(box))
    js = jstates.SamplerState(positions=jnp.asarray(x),
                              box_vectors=jnp.asarray(box))
    u_t = float(tc.reduced_potential(ts))
    u_j = float(jc.reduced_potential(js))
    assert abs(u_t - u_j) <= REL * abs(u_j)
    assert float(tc.potential_energy(ts)) == pytest.approx(
        float(tc.resolve().potential_energy(ts)), rel=REL)


def test_reduced_potential_pressure_and_surface_tension_match_jax():
    jho = JaxHO(K=400.0)
    system = port_system(jho.system)
    x = np.array([[0.1, -0.2, 0.05]])
    box = np.diag([2.0, 2.5, 3.0])
    for kw in (dict(pressure=1.0), dict(pressure=1.0, surface_tension=40.0),
               {}):
        t = tstates.ThermodynamicState(system=system, temperature=310.0, **kw)
        j = jstates.ThermodynamicState(system=jax_f64(jho.system),
                                       temperature=310.0, **kw)
        u_t = float(t.reduced_potential(tstates.SamplerState(
            positions=torch.as_tensor(x), box_vectors=torch.as_tensor(box))))
        u_j = float(j.reduced_potential(jstates.SamplerState(
            positions=jnp.asarray(x), box_vectors=jnp.asarray(box))))
        assert abs(u_t - u_j) <= REL * abs(u_j), kw
    assert float(tstates.compute_reduced_potential(2.0, 0.5)) == 1.0


def test_protocol_and_reduced_potentials_at_states_match_jax():
    jw, system = _alchemical_water()
    lams = dict(lambda_sterics=1.0, lambda_electrostatics=1.0)
    protocol = {"lambda_electrostatics": [1.0, 0.5, 0.0, 0.0],
                "lambda_sterics": [1.0, 1.0, 0.6, 0.2]}
    t_states = tstates.create_thermodynamic_state_protocol(
        _compound(system, talch, tstates, **lams), protocol,
        constants={"temperature": 310.0})
    j_states = jstates.create_thermodynamic_state_protocol(
        _compound(jax_f64(jw.system), jalch, jstates, **lams), protocol,
        constants={"temperature": 310.0})
    assert len(t_states) == 4
    for t, j in zip(t_states, j_states):
        assert t.global_params == j.global_params
        assert float(t.temperature) == float(j.temperature) == 310.0
    x = np.asarray(jw.positions, np.float64)
    box = np.asarray(jw.system.default_box, np.float64)
    rng = np.random.default_rng(3)
    configs = [x, x + rng.normal(scale=2e-3, size=x.shape)]
    t_ss = [tstates.SamplerState(positions=torch.as_tensor(c),
                                 box_vectors=torch.as_tensor(box))
            for c in configs]
    j_ss = jstates.stack_sampler_states(
        [jstates.SamplerState(positions=jnp.asarray(c),
                              box_vectors=jnp.asarray(box)) for c in configs])
    u_t = tstates.reduced_potential_matrix(t_ss, t_states).numpy()
    u_j = np.asarray(jax.jit(jstates.reduced_potential_matrix)(
        j_ss, jstates.stack_thermodynamic_states(j_states)))
    assert u_t.shape == (2, 4)
    np.testing.assert_allclose(u_t, u_j, rtol=REL, atol=0)
    row = tstates.reduced_potential_at_states(t_ss[0], t_states).numpy()
    np.testing.assert_allclose(row, u_t[0], rtol=REL, atol=0)
    with pytest.raises(ValueError, match="different lengths"):
        tstates.create_thermodynamic_state_protocol(
            t_states[0], {"a": [1, 2], "b": [1]})
    with pytest.raises(ValueError, match="empty"):
        tstates.create_thermodynamic_state_protocol(t_states[0], {"a": []})


def test_sampler_state_checks():
    with pytest.raises(tstates.SamplerStateError, match="velocities"):
        tstates.SamplerState(positions=torch.zeros((3, 3)),
                             velocities=torch.zeros((2, 3)))
    s = tstates.SamplerState(positions=torch.tensor([[0.0, float("nan"), 0]]))
    assert bool(s.has_nan()) and s.volume is None and s.n_particles == 1
