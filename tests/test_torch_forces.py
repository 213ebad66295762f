"""The port's forces.py against the JAX package's, on the CPU at float64.

* Every restraint's energy (and its controlling parameter) on the same
  numpy positions, at rel 1e-10; autograd forces likewise.
* Restraint volumes and standard-state corrections of both packages over
  the square-well x energy-cutoff x radius-cutoff matrix, at rel 1e-10
  (the same scipy quadrature on both sides), and the numeric volume
  against the analytic one as ``tests/test_forces.py`` holds them.
* ``find_forces``; ``restrain_atoms`` against the JAX package's (the same
  float32 spring constant); ``restrain_atoms_by_dsl`` with a stub topology
  (any object with ``select``); the restraints carried across by the
  converter.
* ``replace_reaction_field`` on a cutoff_periodic water box: the rewritten
  term and the energy against the JAX package's at rel 1e-10, and sweep
  mode (forced, plain versions) on it against the dense sum.
* The analyzer's restraint unbiasing driven by the port's own restraint
  (skipped without h5py).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmmtools_tpu import forces as jforces
from openmmtools_tpu.models import water as jwater
from openmmtools_tpu.system import make_energy_fn as jax_energy_fn
from openmmtools_tpu_torch import forces as tforces
from openmmtools_tpu_torch.constants import STANDARD_STATE_VOLUME, kB
from openmmtools_tpu_torch.integrators import BAOABIntegrator
from openmmtools_tpu_torch.models import LennardJonesPair
from openmmtools_tpu_torch.models import water as twater
from openmmtools_tpu_torch.states import SamplerState, ThermodynamicState
from openmmtools_tpu_torch.system import NonbondedTerm, make_energy_fn

from test_torch_support import jax_f64, port_system

REL = 1e-10
T = 300.0
RNG = np.random.default_rng(21)
X = RNG.normal(scale=0.6, size=(6, 3))


def _restraints(module, array):
    """The four radial restraints of a package, built from the same
    numbers (``array`` makes its arrays)."""
    i32 = dict(dtype=jnp.int32) if module is jforces else dict(
        dtype=torch.int32)
    return [
        module.HarmonicRestraintForce(
            spring_constant=array(200.0), group1=array([0, 1, 2], **i32),
            group2=array([3, 4], **i32)),
        module.HarmonicRestraintBondForce(spring_constant=array(400.0),
                                          atom1=1, atom2=4),
        module.FlatBottomRestraintForce(
            spring_constant=array(100.0), well_radius=array(0.3),
            group1=array([0, 5], **i32), group2=array([2, 3], **i32)),
        module.FlatBottomRestraintBondForce(
            spring_constant=array(100.0), well_radius=array(0.2),
            atom1=0, atom2=3),
    ]


def _jax_array(v, dtype=jnp.float64):
    return jnp.asarray(v, dtype=dtype)


def _torch_array(v, dtype=torch.float64):
    return torch.as_tensor(v, dtype=dtype)


JAX_R = _restraints(jforces, _jax_array)
PORT_R = _restraints(tforces, _torch_array)
NAMES = [type(r).__name__ for r in PORT_R]


@pytest.mark.parametrize("i", range(4), ids=NAMES)
@pytest.mark.parametrize("params", [None, {"lambda_restraints": 0.37},
                                    {"other": 2.0}])
def test_restraint_energy_and_forces(i, params):
    jr, tr = JAX_R[i], PORT_R[i]
    jp = None if params is None else {k: jnp.float64(v)
                                      for k, v in params.items()}
    u_j, g_j = jax.value_and_grad(lambda x: jr.energy(x, None, jp))(
        jnp.asarray(X))
    x = torch.as_tensor(X).requires_grad_(True)
    u_t = tr.energy(x, None, params)
    (g_t,) = torch.autograd.grad(u_t, x)
    assert float(u_j) > 0.0
    assert abs(float(u_t.detach()) - float(u_j)) <= REL * abs(float(u_j))
    assert np.abs(g_t.numpy() - np.asarray(g_j)).max() <= \
        REL * np.abs(np.asarray(g_j)).max()


def test_flat_bottom_is_flat_inside_and_controlled():
    f = tforces.FlatBottomRestraintBondForce(
        spring_constant=torch.tensor(100.0), well_radius=torch.tensor(0.2))
    x_in = torch.tensor([[0.0, 0.0, 0.0], [0.1, 0.0, 0.0]])
    assert float(f.energy(x_in, None)) == 0.0
    with pytest.raises(ValueError):
        f.distance_at_energy(0.0)
    assert f.distance_at_energy(0.5 * 100.0 * 0.09) == pytest.approx(0.5)


VOLUME_CASES = [(sw, rc, ec) for sw in (False, True)
                for rc, ec in [(None, None), (None, 0.0), (None, 5.0),
                               (0.05, None), (0.6, None), (2.0, None),
                               (0.05, 0.0), (0.6, 5.0), (2.0, 10.0),
                               (2.0, 0.0), (0.05, 10.0)]]


@pytest.mark.parametrize("i", [1, 3], ids=[NAMES[1], NAMES[3]])
@pytest.mark.parametrize("square_well,radius_cutoff,energy_cutoff",
                         VOLUME_CASES)
def test_volumes_and_ssc_match_jax(i, square_well, radius_cutoff,
                                   energy_cutoff):
    jr, tr = JAX_R[i], PORT_R[i]
    args = (T, square_well, radius_cutoff, energy_cutoff)
    v_j = jr.compute_restraint_volume(*args)
    v_t = tr.compute_restraint_volume(*args)
    assert v_t == pytest.approx(v_j, rel=REL)
    if square_well and radius_cutoff is None and energy_cutoff is None:
        with pytest.raises(ValueError):
            tr.compute_standard_state_correction(*args)
        args = args + (1.0,)
    elif v_j == 0.0:   # a zero energy wall leaves no volume: ln 0
        for r in (jr, tr):
            with pytest.raises(ZeroDivisionError):
                r.compute_standard_state_correction(*args)
        return
    s_j = jr.compute_standard_state_correction(*args)
    s_t = tr.compute_standard_state_correction(*args)
    assert s_t == pytest.approx(s_j, rel=REL, abs=1e-14)


def test_ssc_closed_forms():
    """The harmonic correction against its closed form; a stiff flat
    bottom against its well's sphere; the max_volume bound."""
    K = 400.0
    f = tforces.HarmonicRestraintBondForce(spring_constant=torch.tensor(K))
    v = (2.0 * math.pi * kB * T / K) ** 1.5
    assert f.compute_standard_state_correction(T) == pytest.approx(
        -math.log(STANDARD_STATE_VOLUME / v), rel=1e-6)
    assert f.compute_standard_state_correction(T, max_volume=1e-6) == \
        pytest.approx(-math.log(STANDARD_STATE_VOLUME / 1e-6), rel=REL)
    fb = tforces.FlatBottomRestraintBondForce(
        spring_constant=torch.tensor(1e6), well_radius=torch.tensor(0.5))
    v_well = 4.0 / 3.0 * math.pi * 0.5 ** 3
    assert fb.compute_standard_state_correction(T) == pytest.approx(
        -math.log(STANDARD_STATE_VOLUME / v_well), abs=0.02)


@pytest.mark.parametrize("i", [1, 3], ids=[NAMES[1], NAMES[3]])
def test_integrated_volume_matches_analytic(i):
    """The shortcut-free quadrature against the classes' volumes."""
    r = PORT_R[i]
    r_hi = float(getattr(r, "well_radius", 0.0)) + 20.0 * math.sqrt(
        kB * T / float(r.spring_constant))
    for sw in (False, True):
        for rc, ec in [(None, 5.0), (0.6, None), (2.0, 10.0)]:
            analytic = r.compute_restraint_volume(T, sw, rc, ec)
            integrated = tforces.integrate_restraint_volume(
                r.radial_potential, T, square_well=sw, radius_cutoff=rc,
                energy_cutoff=100.0 if ec is None else ec, r_max=r_hi)
            assert integrated == pytest.approx(analytic, rel=1e-2, abs=1e-9)


def test_find_forces():
    pair = LennardJonesPair(device="cpu")
    assert len(tforces.find_forces(pair.system, NonbondedTerm)) == 1
    i, term = tforces.find_forces(pair.system, NonbondedTerm, only_one=True)
    assert isinstance(term, NonbondedTerm)
    with pytest.raises(tforces.NoForceFoundError):
        tforces.find_forces(pair.system, tforces.HarmonicRestraintForce,
                            only_one=True)
    assert len(tforces.find_forces(pair.system, "Nonbonded.*")) == 1
    doubled = pair.system.replace(terms=pair.system.terms * 2)
    with pytest.raises(tforces.MultipleForcesError):
        tforces.find_forces(doubled, NonbondedTerm, only_one=True)
    assert len(tforces.find_forces(doubled, object,
                                   include_subclasses=False)) == 0


def _water_pair(**kwargs):
    kw = dict(box_edge=1.5, cutoff=0.7, **kwargs)
    jw = jwater.WaterBox(**kw)
    tw = twater.WaterBox(device="cpu", **kw)
    return jw, tw


def test_restrain_atoms_matches_jax():
    jw, tw = _water_pair()
    atoms = list(range(0, 375, 3))
    x0 = np.asarray(jw.positions, np.float64)
    jsys = jforces.restrain_atoms(jax_f64(jw.system), jnp.asarray(x0), atoms,
                                  sigma=0.2)
    tsys = tforces.restrain_atoms(tw.system.to(dtype=torch.float64),
                                  torch.as_tensor(x0), atoms, sigma=0.2)
    term = tsys.terms[-1]
    assert isinstance(term, tforces.PositionalRestraintTerm)
    assert term.k.dtype == torch.float32
    assert float(term.k) == float(jsys.terms[-1].k)
    x = x0 + RNG.normal(scale=0.02, size=x0.shape)
    box = np.asarray(jw.system.default_box, np.float64)
    u_j = float(jax_energy_fn(jsys)(jnp.asarray(x), jnp.asarray(box)))
    u_t = float(make_energy_fn(tsys)(torch.as_tensor(x),
                                     torch.as_tensor(box)))
    assert abs(u_t - u_j) <= REL * abs(u_j)
    # the converter carries the restraint across
    converted = port_system(jsys)
    assert isinstance(converted.terms[-1], tforces.PositionalRestraintTerm)
    u_c = float(make_energy_fn(converted)(torch.as_tensor(x),
                                          torch.as_tensor(box)))
    assert abs(u_c - u_j) <= REL * abs(u_j)
    # at the reference positions the restraint adds nothing
    r0 = float(term.energy(torch.as_tensor(x0), None))
    assert r0 == 0.0


class _StubTopology:
    """Any object with ``select``: oxygens are every third atom."""

    def __init__(self, n):
        self.n = n

    def select(self, dsl):
        if dsl == "name O":
            return np.arange(0, self.n, 3)
        return np.zeros((0,), dtype=np.int64)


def test_restrain_atoms_by_dsl_with_a_stub_topology():
    _, tw = _water_pair()
    system = tforces.restrain_atoms_by_dsl(tw.system, tw.positions,
                                           _StubTopology(375), "name O")
    assert len(system.terms) == len(tw.system.terms) + 1
    assert system.terms[-1].particles.shape[0] == 125
    with pytest.raises(ValueError, match="matched no atoms"):
        tforces.restrain_atoms_by_dsl(tw.system, tw.positions,
                                      _StubTopology(375), "resname BOGUS")


def test_restraint_controlled_through_the_state():
    pair = LennardJonesPair(device="cpu")
    f = tforces.HarmonicRestraintBondForce(spring_constant=torch.tensor(50.0))
    system = pair.system.replace(terms=pair.system.terms + (f,))
    ss = SamplerState(positions=torch.tensor([[0.0, 0.0, 0.0],
                                              [0.4, 0.0, 0.0]]))
    on = ThermodynamicState(system, 300.0,
                            global_params={"lambda_restraints": 1.0})
    off = ThermodynamicState(system, 300.0,
                             global_params={"lambda_restraints": 0.0})
    du = float(on.potential_energy(ss)) - float(off.potential_energy(ss))
    assert du == pytest.approx(0.5 * 50.0 * 0.16, rel=1e-5)


@pytest.mark.parametrize("switch_width", [None, 0.05])
def test_replace_reaction_field_matches_jax(switch_width):
    jw, tw = _water_pair(nonbonded_method="cutoff_periodic")
    jsys = jforces.replace_reaction_field(jw.system, switch_width)
    tsys = tforces.replace_reaction_field(tw.system, switch_width)
    jt = [t for t in jsys.terms if type(t).__name__ == "NonbondedTerm"][0]
    tt = [t for t in tsys.terms if isinstance(t, NonbondedTerm)][0]
    assert (tt.shift_rf, tt.switch_coulomb) == (False, True)
    assert tt.switch_width == jt.switch_width
    x = np.asarray(jw.positions, np.float64) + RNG.normal(
        scale=2e-3, size=np.shape(jw.positions))
    box = np.asarray(jw.system.default_box, np.float64)
    u_j = float(jax_energy_fn(jax_f64(jsys))(jnp.asarray(x),
                                             jnp.asarray(box)))
    t64 = tsys.to(dtype=torch.float64)
    u_t = float(make_energy_fn(t64)(torch.as_tensor(x),
                                    torch.as_tensor(box)))
    assert abs(u_t - u_j) <= REL * abs(u_j)
    # the sweep kernel carries the unshifted, switched reaction field
    bound = BAOABIntegrator(temperature=T, sweep="force").bind(t64)
    assert bound.sweep_mode
    u_s = float(bound.energies_at(torch.as_tensor(x), torch.as_tensor(box),
                                  [{}])[0])
    assert abs(u_s - u_j) <= REL * abs(u_j)


def test_analyzer_unbiases_with_the_ports_restraint(tmp_path):
    """The analyzer's restraint unbiasing (two restraint-free end states
    from the stored analysis positions) driven by the port's own centroid
    restraint, against the JAX analyzer with the JAX restraint on the same
    file: the unbiased rows and the free energies to float32 rounding (each
    package evaluates the restraint on the stored float32 positions)."""
    pytest.importorskip("h5py")
    pytest.importorskip("yaml")
    import openmmtools_tpu.mcmc as jmc
    import openmmtools_tpu.multistate as jms
    from openmmtools_tpu.models import IdealGas as JaxIdealGas
    from openmmtools_tpu.states import ThermodynamicState as JaxState
    import openmmtools_tpu_torch.multistate as tms

    gas = JaxIdealGas(nparticles=3)
    jr = jforces.HarmonicRestraintForce(
        spring_constant=jnp.asarray(400.0),
        group1=jnp.asarray([0], dtype=jnp.int32),
        group2=jnp.asarray([1, 2], dtype=jnp.int32))
    system = gas.system.replace(terms=gas.system.terms + (jr,))
    states = [JaxState(system, jnp.asarray(T),
                       global_params={"lambda_restraints": 1.0})] * 2
    path = str(tmp_path / "rest.h5")
    reporter = jms.MultiStateReporter(path, checkpoint_interval=100,
                                      analysis_particle_indices=[0, 1, 2])
    sampler = jms.ReplicaExchangeSampler(
        mcmc_moves=jmc.LangevinDynamicsMove(timestep=0.01,
                                            collision_rate=5.0, n_steps=10),
        number_of_iterations=40, online_analysis_interval=None, rng_seed=7)
    sampler.create(states, gas.sampler_state(), storage=reporter)
    sampler.run()
    reporter.close()
    tr = tforces.HarmonicRestraintForce(
        spring_constant=torch.tensor(400.0),
        group1=torch.tensor([0], dtype=torch.int32),
        group2=torch.tensor([1, 2], dtype=torch.int32))
    kw = dict(unbias_restraint=True, restraint_energy_cutoff="auto",
              restraint_distance_cutoff="auto")
    ja = jms.MultiStateSamplerAnalyzer(jms.MultiStateReporter(path),
                                       restraint_force=jr, **kw)
    ta = tms.MultiStateSamplerAnalyzer(tms.MultiStateReporter(path),
                                       restraint_force=tr, **kw)
    u_t, n_t = ta._decorrelated_u_ln_and_n_k()
    u_j, n_j = ja._decorrelated_u_ln_and_n_k()
    assert u_t.shape[0] == 4 and n_t[-1] == n_t[-2] == 0
    np.testing.assert_array_equal(n_t, n_j)
    fin = np.isfinite(u_j)
    np.testing.assert_array_equal(np.isfinite(u_t), fin)
    scale = np.abs(u_j[fin]).max()
    assert np.abs(u_t[fin] - u_j[fin]).max() <= 1e-6 * scale
    for got, want in zip(ta.get_free_energy(), ja.get_free_energy()):
        got, want = np.asarray(got), np.asarray(want)
        assert np.abs(got - want).max() <= 1e-6 * max(np.abs(want).max(), 1)
    ta.reporter.close()
    ja.reporter.close()
