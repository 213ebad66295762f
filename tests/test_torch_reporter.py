"""The port's MultiStateReporter and analyzer against the JAX package's, on
the CPU (skipped without h5py, as ``tests/test_amber.py`` skips without its
data).

* Layout across packages: a JAX sampler and a port sampler run the same
  configuration (replica exchange with checkpoints, analysis particles and
  online analysis; SAMS; locality) into storage; both files hold the same
  datasets and attributes, with the same names, shapes and dtypes, and the
  real-time YAML the same keys.
* The port's analyzer on files the JAX package wrote gives the JAX
  analyzer's numbers at rel 1e-10: free energies and their errors,
  enthalpy and entropy, the effective-energy timeseries and equilibration,
  on replica exchange, SAMS (the log-weight correction) and locality (the
  stitched BAR path) runs; with restraint unbiasing, at rel 1e-6 (each
  package evaluates the restraint energies in float32).
* The reporter's own behaviour: UUID pairing, the checkpoint and
  position/velocity intervals, the last-iteration rollback, the stored
  analysis particle indices winning, every variable family round-tripping,
  a path string as storage, analysis without the checkpoint file, the
  real-time YAML across a resume, systems deduplicated, and a resume with
  an unsampled state of its own system.
"""
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")
yaml = pytest.importorskip("yaml")

import openmmtools_tpu.mcmc as jmc  # noqa: E402
import openmmtools_tpu.multistate as jms  # noqa: E402
from openmmtools_tpu.forces import HarmonicRestraintBondForce  # noqa: E402
from openmmtools_tpu.models import HarmonicOscillator as JaxHO  # noqa: E402
from openmmtools_tpu.models import IdealGas as JaxIdealGas  # noqa: E402
from openmmtools_tpu.states import SamplerState as JaxSS  # noqa: E402
from openmmtools_tpu.states import ThermodynamicState as JaxState  # noqa: E402
from openmmtools_tpu.states import (  # noqa: E402
    create_thermodynamic_state_protocol as jproto,
)
import openmmtools_tpu_torch.multistate as tms  # noqa: E402
from openmmtools_tpu_torch.mcmc import (  # noqa: E402
    LangevinDynamicsMove,
    MCDisplacementMove,
    SequenceMove,
)
from openmmtools_tpu_torch.models import (  # noqa: E402
    HarmonicOscillator,
    LennardJonesFluid,
    PowerOscillator,
)
from openmmtools_tpu_torch.states import (  # noqa: E402
    ThermodynamicState,
    create_thermodynamic_state_protocol,
)

TEMP = 300.0
K_LADDER = [100.0, 200.0, 400.0, 800.0]
K_NAME = "testsystems_HarmonicOscillator_K"
REL = 1e-10


def _jax_states():
    ho = JaxHO(K=K_LADDER[0])
    return ho, jproto(ho.thermodynamic_state(TEMP), {K_NAME: K_LADDER})


def _port_states():
    ho = HarmonicOscillator(K=K_LADDER[0], device="cpu")
    return ho, create_thermodynamic_state_protocol(
        ho.thermodynamic_state(TEMP), {K_NAME: K_LADDER})


def _run(package, path, cls="ReplicaExchangeSampler", n_iterations=5,
         checkpoint_interval=2, reporter_kw=None, **kw):
    """The same run by either package into ``path``."""
    reporter_kw = dict(reporter_kw or {})
    if package == "jax":
        ho, states = _jax_states()
        ms, move = jms, jmc.LangevinDynamicsMove(timestep=0.01,
                                                 collision_rate=5.0,
                                                 n_steps=5)
        ss = JaxSS(positions=ho.positions)
    else:
        ho, states = _port_states()
        ms, move = tms, LangevinDynamicsMove(timestep=0.01,
                                             collision_rate=5.0, n_steps=5)
        ss = ho.sampler_state()
    kw.setdefault("online_analysis_interval", None)
    sampler = getattr(ms, cls)(mcmc_moves=move,
                               number_of_iterations=n_iterations,
                               rng_seed=3, **kw)
    reporter = ms.MultiStateReporter(
        str(path), checkpoint_interval=checkpoint_interval, **reporter_kw)
    sampler.create(states, ss, storage=reporter)
    sampler.run()
    reporter.close()
    return sampler


def _layout(path):
    """{name: (kind, shape, dtype)} of every group, dataset and attribute
    of an HDF5 file (attribute values aside)."""
    out = {}

    def attrs(name, obj):
        for a, v in obj.attrs.items():
            v = np.asarray(v)
            out[f"{name}@{a}"] = ("attr", v.shape, v.dtype.kind)

    with h5py.File(path, "r") as f:
        attrs("", f)

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = ("dataset", obj.shape, obj.dtype.str)
            else:
                out[name] = ("group",)
            attrs(name, obj)

        f.visititems(visit)
    return out


def _yaml_keys(path):
    with open(os.path.splitext(path)[0] + "_real_time.yaml") as fh:
        return [sorted(d) for d in yaml.safe_load(fh)]


LAYOUT_RUNS = {
    "replica-exchange": dict(
        reporter_kw=dict(analysis_particle_indices=[0],
                         analysis_velocities=True, position_interval=2),
        online_analysis_interval=2, online_analysis_minimum_iterations=0),
    "sams": dict(cls="SAMSSampler", state_update_scheme="global-jump",
                 flatness_criteria="minimum-visits", minimum_visits=1),
    "locality": dict(cls="SAMSSampler", state_update_scheme="local-jump",
                     locality=1),
    "swap-neighbors": dict(replica_mixing_scheme="swap-neighbors",
                           iterations_per_sync=2),
}


@pytest.mark.parametrize("run", sorted(LAYOUT_RUNS))
def test_layout_matches_jax(tmp_path, run):
    paths = {}
    for package in ("jax", "port"):
        paths[package] = str(tmp_path / f"{package}.h5")
        _run(package, paths[package], **LAYOUT_RUNS[run])
    for suffix in ("", "_checkpoint"):
        j = _layout(paths["jax"].replace(".h5", suffix + ".h5"))
        t = _layout(paths["port"].replace(".h5", suffix + ".h5"))
        assert sorted(j) == sorted(t)
        assert j == t
    assert _yaml_keys(paths["jax"]) == _yaml_keys(paths["port"])


# -- the port's analyzer on files of the JAX package --------------------------


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    scale = max(float(np.abs(want[fin]).max()), 1e-300) if fin.any() else 1
    assert float(np.abs(got[fin] - want[fin]).max()) <= rel * scale


ANALYSIS_RUNS = {
    "replica-exchange": dict(n_iterations=120),
    "sams": dict(cls="SAMSSampler", n_iterations=120,
                 state_update_scheme="global-jump",
                 flatness_criteria="minimum-visits", minimum_visits=5,
                 gamma0=0.5),
    "locality": dict(cls="SAMSSampler", n_iterations=150,
                     state_update_scheme="local-jump", locality=1,
                     flatness_criteria="minimum-visits", minimum_visits=5,
                     gamma0=0.5),
}


@pytest.mark.parametrize("run", sorted(ANALYSIS_RUNS))
def test_analyzer_on_jax_file(tmp_path, run):
    path = str(tmp_path / "jax.h5")
    kw = dict(ANALYSIS_RUNS[run])
    cls = kw.get("cls", "ReplicaExchangeSampler").replace(
        "Sampler", "Analyzer").replace("MultiStateAnalyzer",
                                       "MultiStateSamplerAnalyzer")
    _run("jax", path, checkpoint_interval=50, **kw)
    ja = getattr(jms, cls)(jms.MultiStateReporter(path))
    ta = getattr(tms, cls)(tms.MultiStateReporter(path))
    _close(ta.get_effective_energy_timeseries(),
           ja.get_effective_energy_timeseries())
    assert ta.n_equilibration_iterations == ja.n_equilibration_iterations
    assert ta.statistical_inefficiency == ja.statistical_inefficiency
    assert ta.is_locality_restricted == ja.is_locality_restricted
    df_t, ddf_t = ta.get_free_energy()
    df_j, ddf_j = ja.get_free_energy()
    _close(df_t, df_j)
    _close(ddf_t, ddf_j)
    if not ja.is_locality_restricted:
        for name in ("get_enthalpy", "get_entropy"):
            for got, want in zip(getattr(ta, name)(), getattr(ja, name)()):
                _close(got, want, rel=1e-9)
    mt = ta.generate_mixing_statistics()
    mj = ja.generate_mixing_statistics()
    np.testing.assert_allclose(mt.transition_matrix, mj.transition_matrix,
                               rtol=1e-12)
    assert mt.scheme == mj.scheme
    ta.reporter.close()
    ja.reporter.close()


class _BondRestraint:
    """A harmonic bond restraint 0.5 K r^2 between atoms 0 and 1: the JAX
    package's HarmonicRestraintBondForce at lambda 1, in the stored
    positions' float32."""

    def __init__(self, k):
        self.k = k

    def energy(self, x, box, params=None):
        d = x[0] - x[1]
        r = torch.sqrt(torch.clamp(torch.sum(d * d), min=1e-12))
        return 0.5 * self.k * r * r


@pytest.mark.parametrize("cutoff", [None, "auto"])
def test_restraint_unbiasing_on_jax_file(tmp_path, cutoff):
    gas = JaxIdealGas(nparticles=2)
    restraint = HarmonicRestraintBondForce(spring_constant=jnp.asarray(400.0),
                                           atom1=0, atom2=1)
    system = gas.system.replace(terms=gas.system.terms + (restraint,))
    states = [JaxState(system, jnp.asarray(TEMP),
                       global_params={"lambda_restraints": 1.0})] * 2
    path = str(tmp_path / "rest.h5")
    reporter = jms.MultiStateReporter(path, checkpoint_interval=100,
                                      analysis_particle_indices=[0, 1])
    sampler = jms.ReplicaExchangeSampler(
        mcmc_moves=jmc.LangevinDynamicsMove(timestep=0.01,
                                            collision_rate=5.0, n_steps=10),
        number_of_iterations=60, online_analysis_interval=None, rng_seed=7)
    sampler.create(states, gas.sampler_state(), storage=reporter)
    sampler.run()
    reporter.close()
    ja = jms.MultiStateSamplerAnalyzer(
        jms.MultiStateReporter(path), unbias_restraint=True,
        restraint_force=restraint, restraint_energy_cutoff=cutoff)
    ta = tms.MultiStateSamplerAnalyzer(
        tms.MultiStateReporter(path), unbias_restraint=True,
        restraint_force=_BondRestraint(400.0), restraint_energy_cutoff=cutoff)
    u_t, n_t = ta._decorrelated_u_ln_and_n_k()
    u_j, n_j = ja._decorrelated_u_ln_and_n_k()
    assert u_t.shape[0] == 4 and n_t[-1] == n_t[-2] == 0
    np.testing.assert_array_equal(n_t, n_j)
    # each package evaluates the restraint in float32 (one frame at a time
    # here, vmapped there): the unbiased rows agree to float32 rounding
    _close(u_t, u_j, rel=1e-6)
    for got, want in zip(ta.get_free_energy(), ja.get_free_energy()):
        _close(got, want, rel=1e-6)


# -- the reporter's own behaviour --------------------------------------------


def test_uuid_mismatch(tmp_path):
    for name in ("a", "b"):
        tms.MultiStateReporter(str(tmp_path / f"{name}.h5")).open("w").close()
    bad = tms.MultiStateReporter(
        str(tmp_path / "a.h5"),
        checkpoint_storage=str(tmp_path / "b_checkpoint.h5"))
    with pytest.raises(IOError):
        bad.open("r")


def test_position_velocity_intervals(tmp_path):
    path = str(tmp_path / "intervals.h5")
    _run("port", path, checkpoint_interval=10,
         reporter_kw=dict(analysis_particle_indices=[0],
                          analysis_velocities=True, position_interval=2,
                          velocity_interval=0))
    with h5py.File(path, "r") as f:
        pos = f["analysis_positions"]
        assert pos.shape[0] == 5             # written at 0, 2, 4
        assert np.any(pos[4] != 0) and not np.any(pos[3])
        assert "analysis_velocities" not in f


def test_last_iteration_rollback(tmp_path):
    path = str(tmp_path / "rollback.h5")
    _run("port", path, n_iterations=10, checkpoint_interval=2)
    reporter = tms.MultiStateReporter(path, checkpoint_interval=2).open("a")
    all_energies, _ = reporter.read_energies()
    assert all_energies.shape[0] == 11
    reporter.write_last_iteration(4)
    reporter.close()
    reporter = tms.MultiStateReporter(path).open("r")
    np.testing.assert_array_equal(reporter.read_energies(1)[0],
                                  all_energies[1])
    np.testing.assert_array_equal(reporter.read_energies(-1)[0],
                                  all_energies[4])
    np.testing.assert_array_equal(reporter.read_energies()[0],
                                  all_energies[:5])
    np.testing.assert_array_equal(
        reporter.read_energies(slice(-1, None, -1))[0], all_energies[4::-1])
    with pytest.raises(IndexError):
        reporter.read_energies(7)
    reporter.close()


def test_stored_analysis_particle_indices_win(tmp_path):
    blank = str(tmp_path / "blank.h5")
    tms.MultiStateReporter(blank, analysis_particle_indices=()).open(
        "w").close()
    r = tms.MultiStateReporter(blank, analysis_particle_indices=(0, 1)).open(
        "r")
    assert r.analysis_particle_indices.size == 0
    r.close()
    set1 = str(tmp_path / "set1.h5")
    tms.MultiStateReporter(set1, analysis_particle_indices=(0, 1)).open(
        "w").close()
    for passed in ((), (0, 2)):
        r = tms.MultiStateReporter(set1, analysis_particle_indices=passed
                                   ).open("r")
        np.testing.assert_array_equal(r.analysis_particle_indices, [0, 1])
        r.close()


def test_variable_families_round_trip(tmp_path):
    rep = tms.MultiStateReporter(str(tmp_path / "types.h5"),
                                 checkpoint_interval=2)
    rep.open("w")
    options = {"number_of_iterations": 7, "online_analysis_interval": None,
               "locality": 3, "target_error": 0.25, "flag": True,
               "name": "remd"}
    rep.write_options(options)
    assert rep.read_options() == options
    moves = SequenceMove([
        LangevinDynamicsMove(timestep=0.002, collision_rate=5.0, n_steps=10),
        MCDisplacementMove(displacement_sigma=0.1, atom_subset=[0, 2])])
    rep.write_mcmc_moves(moves)
    got = rep.read_mcmc_moves()
    assert type(got) is SequenceMove
    assert type(got.move_list[0]) is LangevinDynamicsMove
    assert got.move_list[0].n_steps == 10
    assert np.isclose(got.move_list[1].displacement_sigma, 0.1)
    assert got.move_list[1].atom_subset == [0, 2]
    for it in range(4):
        rep.write_iteration(iteration=it, energies=np.full((3, 4), float(it)),
                            replica_states=np.arange(3) + it,
                            n_accepted=np.eye(3, dtype=int) * it,
                            n_proposed=np.ones((3, 3), int))
    u_all, s_all = rep.read_energies()
    assert u_all.shape == (4, 3, 4) and s_all.shape == (4, 3)
    np.testing.assert_array_equal(rep.read_energies(slice(1, 3))[0],
                                  u_all[1:3])
    acc, prop = rep.read_mixing_statistics(2)
    assert acc[0, 0] == 2 and prop[1, 2] == 1
    x = np.random.default_rng(0).normal(size=(3, 5, 3)).astype(np.float32)
    box = np.diag([2.0, 2.0, 2.0]).astype(np.float32)
    rep.write_checkpoint(iteration=2, positions=x, velocities=x * 0.1,
                         box_vectors=np.stack([box] * 3), rng_iteration=5)
    rep.write_last_iteration(3)
    ck = rep.read_checkpoint(3)
    assert ck["iteration"] == 2 and ck["rng_iteration"] == 5
    np.testing.assert_array_equal(ck["positions"], x)
    rep.write_online_analysis(3, np.array([0.0, 1.5, 3.0, 4.2]), 0.07)
    online = rep.read_online_analysis()
    assert np.isclose(online["err_free_energy"], 0.07)
    rep.write_timing(3, {"iteration_seconds": 0.5, "ns_per_day": 12.0})
    assert glob.glob(os.path.join(str(tmp_path), "*.yaml"))
    rep.close()


def test_systems_deduplicated(tmp_path):
    fluid = LennardJonesFluid(nparticles=8, device="cpu")
    term = fluid.system.terms[0]
    other = fluid.system.replace(terms=(term.replace(switch_width=0.05),))
    states = [ThermodynamicState(system=fluid.system, temperature=120.0),
              ThermodynamicState(system=fluid.system, temperature=130.0,
                                 global_params={"x": torch.tensor(
                                     0.5, dtype=torch.float32)})]
    unsampled = [ThermodynamicState(system=other, temperature=120.0)]
    rep = tms.MultiStateReporter(str(tmp_path / "dedup.h5")).open("w")
    rep.write_thermodynamic_states(states, unsampled)
    got, got_uns = rep.read_thermodynamic_states()
    rep.close()
    assert got[0].system is got[1].system
    assert got_uns[0].system is not got[0].system
    assert got_uns[0].system.terms[0].switch_width == 0.05
    assert got[1].temperature == 130.0
    assert got[1].global_params["x"].dtype == torch.float32
    assert got[0].system.fingerprint == fluid.system.fingerprint


def test_storage_path_string_and_analysis_without_checkpoint(tmp_path):
    ho, states = _port_states()
    path = str(tmp_path / "by_path.h5")
    sampler = tms.ReplicaExchangeSampler(
        mcmc_moves=LangevinDynamicsMove(timestep=0.01, collision_rate=5.0,
                                        n_steps=5),
        number_of_iterations=20, online_analysis_interval=None, rng_seed=1)
    sampler.create(states, ho.sampler_state(), storage=path)
    sampler.run()
    sampler._reporter.close()
    with tms.MultiStateReporter(path).open("r") as rep:
        assert rep.read_energies()[0].shape == (21, 4, 4)
    ckpt = path.replace(".h5", "_checkpoint.h5")
    os.rename(ckpt, ckpt + ".moved")
    df, _ = tms.MultiStateSamplerAnalyzer(
        tms.MultiStateReporter(path)).get_free_energy()
    assert np.all(np.isfinite(df))
    status = tms.MultiStateSampler.read_status(tms.MultiStateReporter(path))
    assert status == {"iteration": 20, "number_of_iterations": 20}


def test_real_time_yaml_across_resume(tmp_path):
    path = str(tmp_path / "rt.h5")
    _run("port", path, n_iterations=4, online_analysis_interval=2,
         online_analysis_minimum_iterations=0)
    ypath = os.path.splitext(path)[0] + "_real_time.yaml"
    with open(ypath) as fh:
        n1 = len(yaml.safe_load(fh))
    resumed = tms.ReplicaExchangeSampler.from_storage(
        tms.MultiStateReporter(path, checkpoint_interval=2), device="cpu")
    resumed.extend(2)
    with open(ypath) as fh:
        docs = yaml.safe_load(fh)
    assert len(docs) > n1
    iters = [d["iteration"] for d in docs[n1:]]
    assert iters == sorted(iters)
    assert all("iteration_seconds" in d for d in docs)
    resumed._reporter.close()


def test_resume_with_a_system_of_its_own(tmp_path):
    """An unsampled state with a different system round-trips through
    storage and stays separately evaluated after a resume."""
    ho, states = _port_states()
    po = PowerOscillator(K=2.0, b=2, device="cpu")
    unsampled = [po.thermodynamic_state(TEMP)]
    path = str(tmp_path / "uns.h5")
    sampler = tms.ReplicaExchangeSampler(
        mcmc_moves=LangevinDynamicsMove(timestep=0.01, collision_rate=5.0,
                                        n_steps=5),
        number_of_iterations=6, online_analysis_interval=None, rng_seed=11)
    sampler.create(states, ho.sampler_state(),
                   storage=tms.MultiStateReporter(path, checkpoint_interval=3),
                   unsampled_thermodynamic_states=unsampled)
    assert sampler._unsampled_separate
    sampler.run()
    for n, ss in enumerate(sampler.sampler_states):
        assert abs(sampler.energies_last_iteration[n, 4]
                   - float(unsampled[0].reduced_potential(ss))) < 1e-4
    sampler._reporter.close()
    resumed = tms.ReplicaExchangeSampler.from_storage(
        tms.MultiStateReporter(path), device="cpu")
    assert resumed._unsampled_separate
    resumed.extend(2)
    assert resumed.energies_last_iteration.shape == (4, 5)
    resumed._reporter.close()
