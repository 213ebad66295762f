"""Moves through storage (fault F10): a sampler whose move is, or holds, an
``IntegratorMove`` resumes from its files bit for bit.

* ``move_to_dict`` / ``move_from_dict`` round-trip every move class of
  ``mcmc.py``, containers included, and every integrator an
  ``IntegratorMove`` can carry (equal by ``moves_equal``, the integrators
  by ``serialize``), in plain values and through YAML;
* a ``ReplicaExchangeSampler`` of two harmonic-oscillator states with an
  ``IntegratorMove``, alone or in a ``SequenceMove`` with a displacement,
  run 3 + 3 iterations across ``from_storage`` equals 6 straight ones:
  positions, velocities and the energy matrix;
* a stored move that names a module outside the port is refused, and a
  file of the JAX package, which stores no integrator, raises an error
  that names it.
"""
import inspect

import numpy as np
import pytest
import torch

import openmmtools_tpu_torch.integrators as tint
import openmmtools_tpu_torch.mcmc as tmc
import openmmtools_tpu_torch.multistate as tms
from openmmtools_tpu_torch.models import HarmonicOscillator
from openmmtools_tpu_torch.multistate.reporter import (
    move_from_dict,
    move_to_dict,
)
from openmmtools_tpu_torch.utils.serialization import serialize

TEMPS = (300.0, 330.0)
F32 = torch.float32


def _integrators():
    """One instance of each integrator class the port exports, with
    settings off their defaults; a float32 tensor timestep and temperature
    in one of them."""
    return {
        "LangevinIntegrator": tint.LangevinIntegrator(
            timestep=0.001, collision_rate=2.0, splitting="V R O R V",
            sweep=None, sweep_sort_interval=50),
        "BAOABIntegrator": tint.BAOABIntegrator(
            timestep=torch.tensor(0.002, dtype=F32),
            temperature=torch.tensor(310.0, dtype=F32)),
        "VVVRIntegrator": tint.VVVRIntegrator(timestep=0.003,
                                              neighbor_skin=0.05),
        "GeodesicBAOABIntegrator": tint.GeodesicBAOABIntegrator(K_r=3),
        "GHMCIntegrator": tint.GHMCIntegrator(collision_rate=5.0),
        "VelocityVerletIntegrator": tint.VelocityVerletIntegrator(
            timestep=0.0005),
        "MTS": tint.LangevinIntegrator(splitting="V0 V1 R O R V1 V0"),
        "AndersenVelocityVerletIntegrator":
            tint.AndersenVelocityVerletIntegrator(),
        "NoseHooverChainVelocityVerletIntegrator":
            tint.NoseHooverChainVelocityVerletIntegrator(),
        "MetropolisMonteCarloIntegrator":
            tint.MetropolisMonteCarloIntegrator(),
        "HMCIntegrator": tint.HMCIntegrator(),
        "MTSIntegrator": tint.MTSIntegrator(),
        "DummyIntegrator": tint.DummyIntegrator(),
    }


def _moves():
    """One instance of each move class of ``mcmc.py``, with parameters
    off their defaults."""
    langevin = tmc.LangevinDynamicsMove(timestep=0.004, collision_rate=3.0,
                                        n_steps=7, reassign_velocities=True)
    integ = tmc.IntegratorMove(tint.VVVRIntegrator(timestep=0.002),
                               n_steps=3, n_restart_attempts=2, seed=5)
    return {
        "MCMCMove": tmc.MCMCMove(seed=3),
        "SequenceMove": tmc.SequenceMove(
            [langevin, integ, tmc.MCDisplacementMove(atom_subset=[0])]),
        "WeightedMove": tmc.WeightedMove(
            [(tmc.GHMCMove(timestep=0.002, n_steps=5), 0.25),
             (tmc.SequenceMove([integ, tmc.MCRotationMove()]), 0.75)]),
        "BaseIntegratorMove": tmc.BaseIntegratorMove(
            n_steps=4, reassign_velocities=True),
        "IntegratorMove": integ,
        "LangevinDynamicsMove": langevin,
        "LangevinSplittingDynamicsMove": tmc.LangevinSplittingDynamicsMove(
            timestep=0.002, splitting="O V R V O", n_steps=3,
            constraint_tolerance=1e-6, measure_heat=True),
        "_MetropolizedIntegratorMove": tmc._MetropolizedIntegratorMove(
            n_steps=2, n_restart_attempts=1),
        "GHMCMove": tmc.GHMCMove(timestep=0.003, collision_rate=7.0,
                                 n_steps=9),
        "HMCMove": tmc.HMCMove(timestep=0.002, n_inner_steps=4, n_steps=2,
                               reassign_velocities=False),
        "MetropolizedMove": tmc.MetropolizedMove(
            atom_subset=np.array([0, 2])),
        "MCDisplacementMove": tmc.MCDisplacementMove(
            displacement_sigma=0.02, atom_subset=torch.tensor([1, 3])),
        "MCRotationMove": tmc.MCRotationMove(atom_subset=[0, 1, 2]),
        "MonteCarloBarostatMove": tmc.MonteCarloBarostatMove(
            volume_scale=0.003, n_attempts=5, seed=11),
    }


def test_every_move_class_has_a_round_trip_case():
    classes = {name for name, obj in vars(tmc).items()
               if inspect.isclass(obj) and issubclass(obj, tmc.MCMCMove)
               and obj.__module__ == tmc.__name__}
    assert classes == set(_moves())


def _same_integrators(a, b):
    """Every integrator of two move trees, compared by ``serialize``."""
    if isinstance(a, tmc.IntegratorMove):
        assert serialize(a.integrator) == serialize(b.integrator)
    for name in ("move_list", "move_set"):
        for x, y in zip(getattr(a, name, ()), getattr(b, name, ())):
            if name == "move_set":
                (x, wx), (y, wy) = x, y
                assert wx == wy
            _same_integrators(x, y)


@pytest.mark.parametrize("name", sorted(_moves()))
def test_move_round_trip(name):
    yaml = pytest.importorskip("yaml")
    move = _moves()[name]
    d = move_to_dict(move)
    for back in (move_from_dict(d),
                 move_from_dict(yaml.safe_load(yaml.safe_dump(d)))):
        assert type(back) is type(move)
        assert tmc.moves_equal(back, move)
        assert back.seed == move.seed
        _same_integrators(back, move)


@pytest.mark.parametrize("name", sorted(_integrators()))
def test_integrator_move_round_trip(name):
    yaml = pytest.importorskip("yaml")
    move = tmc.IntegratorMove(_integrators()[name], n_steps=6)
    text = yaml.safe_dump(move_to_dict(move))
    back = move_from_dict(yaml.safe_load(text))
    assert tmc.moves_equal(back, move)
    assert serialize(back.integrator) == serialize(move.integrator)
    for attr, value in vars(move.integrator).items():
        if isinstance(value, torch.Tensor):   # a tensor keeps its dtype
            got = getattr(back.integrator, attr)
            assert got.dtype == value.dtype and torch.equal(got, value)


def test_move_from_dict_refuses_a_module_outside_the_port():
    d = move_to_dict(tmc.IntegratorMove(tint.BAOABIntegrator(), n_steps=2))
    d["integrator"]["_serialized__module_name"] = "os"
    with pytest.raises(ValueError, match="'os'"):
        move_from_dict(d)
    nested = move_to_dict(tmc.MCDisplacementMove(atom_subset=[0]))
    nested["atom_subset"] = {"_serialized__module_name": "subprocess",
                             "_serialized__class_name": "Popen"}
    with pytest.raises(ValueError, match="subprocess"):
        move_from_dict(nested)
    with pytest.raises(ValueError, match="Popen"):
        move_from_dict({"type": "Popen"})


def test_reporter_refuses_a_module_outside_the_port(tmp_path):
    pytest.importorskip("h5py")
    yaml = pytest.importorskip("yaml")
    path = str(tmp_path / "moves.h5")
    reporter = tms.MultiStateReporter(path)
    reporter.open(mode="w")
    reporter.write_mcmc_moves(tmc.SequenceMove([tmc.IntegratorMove(
        tint.LangevinIntegrator(timestep=0.001), n_steps=5)]))
    reporter.close()
    reporter.open(mode="r")
    assert isinstance(reporter.read_mcmc_moves(), tmc.SequenceMove)
    reporter.close()
    reporter.open(mode="a")
    doc = yaml.safe_load(reporter._analysis.attrs["mcmc_moves_yaml"])
    doc["move_list"][0]["integrator"]["_serialized__module_name"] = \
        "builtins"
    reporter._analysis.attrs["mcmc_moves_yaml"] = yaml.safe_dump(doc)
    reporter.close()
    reporter.open(mode="r")
    with pytest.raises(ValueError, match="builtins"):
        reporter.read_mcmc_moves()
    reporter.close()


def test_a_jax_file_without_its_integrator_names_it(tmp_path):
    pytest.importorskip("h5py")
    import openmmtools_tpu.integrators as jint
    import openmmtools_tpu.mcmc as jmc
    import openmmtools_tpu.multistate as jms

    path = str(tmp_path / "jax.h5")
    reporter = jms.MultiStateReporter(path)
    reporter.open(mode="w")
    reporter.write_mcmc_moves([
        jmc.IntegratorMove(jint.LangevinIntegrator(timestep=0.001),
                           n_steps=5),
        jmc.LangevinDynamicsMove(n_steps=5)])
    reporter.close()
    port = tms.MultiStateReporter(path)
    port.open(mode="r")
    with pytest.raises(ValueError, match="integrator") as err:
        port.read_mcmc_moves()
    assert not isinstance(err.value, TypeError)
    port.close()


# -- F10: a sampler with an IntegratorMove resumes --------------------------


def _integrator_move():
    return tmc.IntegratorMove(tint.LangevinIntegrator(timestep=0.001),
                              n_steps=5)


MOVES = {
    "integrator-move": _integrator_move,
    "sequence": lambda: tmc.SequenceMove(
        [_integrator_move(), tmc.MCDisplacementMove(displacement_sigma=0.01)]),
}


def _sampler(make_move, n_iterations):
    ho = HarmonicOscillator(K=100.0, device="cpu")
    states = [ho.thermodynamic_state(t) for t in TEMPS]
    sampler = tms.ReplicaExchangeSampler(
        mcmc_moves=make_move(), number_of_iterations=n_iterations,
        online_analysis_interval=None, rng_seed=17)
    return sampler, states, ho.sampler_state()


@pytest.mark.parametrize("kind", sorted(MOVES))
def test_f10_resume_with_an_integrator_move_is_bitwise(tmp_path, kind):
    pytest.importorskip("h5py")
    straight, states, ss = _sampler(MOVES[kind], 6)
    straight.create(states, ss)
    straight.run()

    path = str(tmp_path / f"{kind}.h5")
    first, states, ss = _sampler(MOVES[kind], 6)
    first.create(states, ss,
                 storage=tms.MultiStateReporter(path, checkpoint_interval=1))
    first.run(3)
    first._reporter.close()
    resumed = tms.ReplicaExchangeSampler.from_storage(
        tms.MultiStateReporter(path, checkpoint_interval=1), device="cpu")
    assert tmc.moves_equal(resumed.mcmc_moves, first.mcmc_moves)
    assert resumed.iteration == 3
    resumed.run(3)
    assert resumed.iteration == 6
    for a, b in zip(resumed.sampler_states, straight.sampler_states):
        assert torch.equal(a.positions, b.positions)
        assert torch.equal(a.velocities, b.velocities)
    np.testing.assert_array_equal(resumed.energies_last_iteration,
                                  straight.energies_last_iteration)
    # the run moved: the last matrix is not the first
    assert not np.array_equal(straight.energies_last_iteration,
                              first._energy_history[0])
    resumed._reporter.close()
