"""Test systems: the port's own builds against the JAX package's.

Each system is built three ways: by the JAX package, by the port, and by
the port's converter from the JAX object's numpy leaves. All three must hold
the same positions, box, sigma, epsilon, masses and cutoff, bit for bit, and
give the same energy at float64.
"""
import numpy as np
import pytest
import torch

from openmmtools_tpu.models import testsystems as jts
from openmmtools_tpu.system import make_energy_fn as jax_energy_fn
from openmmtools_tpu_torch.models import testsystems as tts
from openmmtools_tpu_torch.system import make_energy_fn

from test_torch_support import jax_f64, np64, port_system

LJ_VARIANTS = ["LennardJonesFluidTruncated", "LennardJonesFluidSwitched"]


def _same_leaves(jax_system, port):
    jt, pt = jax_system.terms[0], port.terms[0]
    for a, b in ((jax_system.masses, port.masses),
                 (jax_system.default_box, port.default_box),
                 (jt.sigma, pt.sigma), (jt.epsilon, pt.epsilon),
                 (jt.charge, pt.charge)):
        b = b.detach().cpu().numpy()
        assert b.dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(b, np.asarray(a))
    assert (jt.cutoff, jt.switch_width, jt.method,
            jt.use_dispersion_correction) == (
        pt.cutoff, pt.switch_width, pt.method, pt.use_dispersion_correction)


@pytest.mark.parametrize("n", [256, 2048])
@pytest.mark.parametrize("variant", LJ_VARIANTS)
def test_lj_fluid_matches_jax(variant, n):
    jf = getattr(jts, variant)(nparticles=n)
    tf = getattr(tts, variant)(nparticles=n, device="cpu")
    converted = port_system(jf.system, dtype=None)
    _same_leaves(jf.system, tf.system)
    _same_leaves(jf.system, converted)
    assert converted.fingerprint == tf.system.fingerprint
    np.testing.assert_array_equal(tf.positions.numpy(), np.asarray(jf.positions))

    x = np.asarray(jf.positions, np.float64)
    u_jax = float(jax_energy_fn(jax_f64(jf.system))(x))
    u_port = float(make_energy_fn(tf.system.to(dtype=torch.float64))(
        torch.as_tensor(x)))
    assert abs(u_port - u_jax) <= 1e-10 * abs(u_jax)


def test_default_lj_fluid_is_the_bench_configuration():
    """LennardJonesFluid() defaults: density 0.05, cutoff 3 sigma, switch over
    the last sigma, no dispersion correction with the switch."""
    tf = tts.LennardJonesFluid(nparticles=2048, device="cpu")
    t = tf.system.terms[0]
    assert t.cutoff == pytest.approx(3 * 0.34)
    assert t.switch_width == pytest.approx(0.34)
    assert not t.use_dispersion_correction
    assert tf.box_edge ** 3 == pytest.approx(2048 * 0.34 ** 3 / 0.05)


def test_harmonic_oscillator_matches_jax():
    jo, to = jts.HarmonicOscillator(), tts.HarmonicOscillator(device="cpu")
    converted = port_system(jo.system, dtype=None)
    assert converted.fingerprint == to.system.fingerprint
    np.testing.assert_array_equal(to.system.masses.numpy(),
                                  np.asarray(jo.system.masses))
    x = np.random.default_rng(3).normal(scale=0.05, size=(1, 3))
    params = {"testsystems_HarmonicOscillator_x0": 0.01}
    u_jax = float(jax_energy_fn(jax_f64(jo.system))(x, None, params))
    u_port = float(make_energy_fn(to.system.to(dtype=torch.float64))(
        torch.as_tensor(x), None,
        {"testsystems_HarmonicOscillator_x0": torch.tensor(0.01,
                                                           dtype=torch.float64)}))
    assert abs(u_port - u_jax) <= 1e-12 * abs(u_jax)
    state = to.thermodynamic_state(300.0)
    assert to.get_potential_expectation(state) == pytest.approx(
        jo.get_potential_expectation(jo.thermodynamic_state(300.0)))


def test_lennard_jones_pair_matches_jax():
    jp, tp = jts.LennardJonesPair(), tts.LennardJonesPair(device="cpu")
    np.testing.assert_array_equal(tp.positions.numpy(), np.asarray(jp.positions))
    x = np64(tp.positions)
    u_jax = float(jax_energy_fn(jax_f64(jp.system))(x))
    u_port = float(make_energy_fn(tp.system.to(dtype=torch.float64))(
        torch.as_tensor(x)))
    # at the minimum separation the pair energy is -epsilon
    assert u_port == pytest.approx(-tp.epsilon, rel=1e-6)
    assert abs(u_port - u_jax) <= 1e-12 * abs(u_jax)
    assert tp.get_b2_virial(300.0) == pytest.approx(jp.get_b2_virial(300.0))
    assert tp.get_binding_free_energy(300.0) == pytest.approx(
        jp.get_binding_free_energy(300.0))


@pytest.mark.parametrize("kwargs", [dict(lattice=True), dict(shift=True),
                                    dict(reduced_density=0.5, cutoff=0.9)])
def test_lj_fluid_options_match_jax(kwargs):
    """Lattice placement, the shifted (unswitched) form with its dispersion
    correction, and a non-default density and cutoff."""
    jf = jts.LennardJonesFluid(nparticles=125, **kwargs)
    tf = tts.LennardJonesFluid(nparticles=125, device="cpu", **kwargs)
    _same_leaves(jf.system, tf.system)
    np.testing.assert_array_equal(tf.positions.numpy(), np.asarray(jf.positions))
    x = np.asarray(jf.positions, np.float64)
    u_jax = float(jax_energy_fn(jax_f64(jf.system))(x))
    # the port's ThermodynamicState evaluates the same energy
    state = tf.thermodynamic_state(120.0)
    tf64 = tf.system.to(dtype=torch.float64)
    u_port = float(state.replace(system=tf64).potential_energy(
        tts.SamplerState(positions=torch.as_tensor(x),
                         box_vectors=tf64.default_box)))
    assert abs(u_port - u_jax) <= 1e-10 * abs(u_jax)


def test_models_default_to_the_card():
    """Every model is built on the card unless the caller names another
    device; without a card, building one with no device raises, and nothing
    falls back to the CPU. Whether there is a card is decided here, in the
    test."""
    from openmmtools_tpu_torch.models import PMEWaterBox

    for build in (lambda: tts.LennardJonesFluid(nparticles=64),
                  tts.HarmonicOscillator,
                  lambda: PMEWaterBox(box_edge=1.9, cutoff=0.9)):
        if torch.cuda.is_available():
            assert build().system.device.type == "cuda"
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                build()


# ---------------------------------------------------------------------------
# the analytic systems, the LJ cluster, the WCA fluid and the charged fluid
# ---------------------------------------------------------------------------

# each system's constructor arguments, the same in both packages
SYSTEMS = {
    "PowerOscillator": dict(b=4),
    "HarmonicOscillatorArray": dict(N=4),
    "CustomExternalForcesTestSystem": dict(
        energy_expressions=("0.75*(x**2+y**2+z**2)", "x**4 + 0.5*y*z"),
        n_particles=6),
    "Diatom": dict(use_central_potential=True),
    "DiatomConstrained": dict(constraint=True),
    "IdealGas": dict(nparticles=16),
    "LennardJonesCluster": dict(nx=2, ny=3, nz=2),
    "LennardJonesClusterCutoff": dict(cutoff=0.9, switch_width=0.1),
    "WCAFluid": dict(nparticles=64),
    "LennardJonesFluidCharged": dict(nparticles=64, reduced_density=0.5,
                                     charge=0.3, cutoff=0.7),
}
CLASS_OF = {"DiatomConstrained": "Diatom",
            "LennardJonesClusterCutoff": "LennardJonesCluster",
            "LennardJonesFluidCharged": "LennardJonesFluid"}


def _both(name):
    cls = CLASS_OF.get(name, name)
    kwargs = SYSTEMS[name]
    return (getattr(jts, cls)(**kwargs),
            getattr(tts, cls)(device="cpu", **kwargs))


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_system_matches_jax(name):
    """Bit-identical leaves (the port's own build and the converter's from
    the JAX leaves hash alike), the same positions, and the float64 energy
    at a perturbed configuration to rel 1e-10."""
    js, ps = _both(name)
    converted = port_system(js.system, dtype=None)
    assert converted.fingerprint == ps.system.fingerprint
    np.testing.assert_array_equal(ps.positions.numpy(),
                                  np.asarray(js.positions))
    x = np.asarray(js.positions, np.float64)
    x = x + np.random.default_rng(5).normal(scale=0.01, size=x.shape)
    box = (None if js.system.default_box is None
           else np.asarray(js.system.default_box, np.float64))
    u_jax = float(jax_energy_fn(jax_f64(js.system))(x, box))
    p64 = ps.system.to(dtype=torch.float64)
    u_port = float(make_energy_fn(p64)(
        torch.as_tensor(x), None if box is None else torch.as_tensor(box)))
    assert abs(u_port - u_jax) <= 1e-10 * max(abs(u_jax), 1.0), (u_port,
                                                                u_jax)
    assert ps.analytical_properties == js.analytical_properties


@pytest.mark.parametrize("name", sorted(SYSTEMS))
@pytest.mark.parametrize("pressure", [None, 2.0])
def test_expectations_match_jax(name, pressure):
    """Every analytic expectation and standard deviation, NVT and NPT, at
    rel 1e-10 (the JAX state's temperature and pressure as float64: its
    own constructor stores float32)."""
    js, ps = _both(name)
    jstate = js.thermodynamic_state(250.0, pressure=pressure).replace(
        temperature=np.float64(250.0),
        pressure=None if pressure is None else np.float64(pressure))
    pstate = ps.thermodynamic_state(250.0, pressure=pressure)
    for prop in js.analytical_properties:
        want = float(getattr(js, "get_" + prop)(jstate))
        got = float(getattr(ps, "get_" + prop)(pstate))
        assert abs(got - want) <= 1e-10 * max(abs(want), 1e-30), prop


def test_oscillator_free_energy_matches_jax():
    jo, to = jts.HarmonicOscillator(), tts.HarmonicOscillator(device="cpu")
    assert to.configurational_free_energy(300.0) == pytest.approx(
        jo.configurational_free_energy(300.0), rel=1e-12)
    jstate = jo.thermodynamic_state(300.0).replace(
        temperature=np.float64(300.0))
    assert to.get_potential_standard_deviation(
        to.thermodynamic_state(300.0)) == pytest.approx(
        jo.get_potential_standard_deviation(jstate), rel=1e-10)


def test_array_spring_constant_is_a_global_parameter():
    """HarmonicWellArrayTerm reads K from the global parameters when they
    name it, as the JAX term does."""
    js, ps = _both("HarmonicOscillatorArray")
    x = np.random.default_rng(2).normal(scale=0.05, size=(4, 3))
    name = "testsystems_HarmonicOscillatorArray_K"
    u_jax = float(jax_energy_fn(jax_f64(js.system))(x, None, {name: 123.0}))
    u_port = float(make_energy_fn(ps.system.to(dtype=torch.float64))(
        torch.as_tensor(x), None,
        {name: torch.tensor(123.0, dtype=torch.float64)}))
    assert abs(u_port - u_jax) <= 1e-12 * abs(u_jax)


def test_available_testsystems_are_the_jax_list_less_the_unported():
    """The port lists exactly the JAX package's systems: the prmtop systems
    (``models/amber.py``) are ported too, so nothing is left unported."""
    import openmmtools_tpu_torch.models as tmodels

    port = tts.get_available_testsystems()
    assert port == jts.get_available_testsystems()
    for name in port:
        assert issubclass(getattr(tmodels, name), tts.TestSystem)


def test_wca_gradient_is_finite_at_coincident_particles():
    """The double where keeps the masked self-pairs out of the gradient."""
    from openmmtools_tpu_torch.system import value_and_grad

    wca = tts.WCAFluid(nparticles=8, device="cpu")
    x = wca.positions.to(torch.float64).clone()
    x[1] = x[0] + 1e-3
    system = wca.system.to(dtype=torch.float64)
    u, g = value_and_grad(
        lambda xx: make_energy_fn(system)(xx, system.default_box), x)
    assert torch.isfinite(u) and torch.isfinite(g).all()
