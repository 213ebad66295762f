"""The single-chain path on the CPU: ``MCMCSampler`` with a
``LangevinDynamicsMove`` on a small ``WaterBox`` (216 rigid TIP3P waters,
648 atoms, PME and SETTLE), the benchmark's ``water-md`` at a small size.

* The program's potential energy and forces at the final positions of a
  few steps agree with the benchmark's float64 plain reference
  (``benchmark/reference/energy.py``), in neighbour mode (the CPU's
  default) and in sweep mode (forced: the card's program with the kernels'
  plain versions).
* With tracing on, one iteration records ``sampler.iteration`` around
  ``move.apply`` around the move's four inner spans, and the
  ``move.restarts`` counter reads 0; off, nothing is recorded and no
  profiler range is made; a forced NaN restart counts 1.
"""
import collections
import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark import check
from benchmark.reference import forcefield
from benchmark.reference.energy import K_BOLTZMANN, Reference
from openmmtools_tpu_torch.integrators.langevin import (
    BoundIntegrator,
    thermalize_velocities,
)
from openmmtools_tpu_torch.mcmc import LangevinDynamicsMove, MCMCSampler
from openmmtools_tpu_torch.models import WaterBox
from openmmtools_tpu_torch.states import ThermodynamicState
from openmmtools_tpu_torch.utils import tracing

CONFIG = pathlib.Path(__file__).resolve().parents[1] / "benchmark" / \
    "configs" / "waterbox-24000.json"
EDGE, CUTOFF, SWITCH, TOL = 1.9, 0.9, 0.15, 5e-4
N_STEPS = 3
TEMPERATURE = 300.0

# |U - U_ref| / |U_ref| by mode. In neighbour mode the program's total is
# float32: the Ewald self energy (about -5.5e4 kJ/mol here) and the
# exclusion correction cancel to a total of about -1.5e3, and one float32
# ulp of a part (4e-3 kJ/mol) is 2.7e-6 of the total; the order of the
# sums, which follows the CPU's thread count, moves it a few ulps (1.8e-6
# read with 8 threads, 1.3e-5 with one). Sweep mode sums those parts in
# float64 (3.6e-7 read).
ENERGY_REL = {"auto": 1e-4, "force": 1e-5}
# float32 pair sums of some 400 partners an atom, each force component
# rounded at 6e-8 of its size: 2.3e-6 of the largest component read.
FORCE_REL = 1e-4


@pytest.fixture(autouse=True)
def _fresh():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _sampler(sweep="force", n_steps=N_STEPS):
    """A sampler on the small box with seeded velocities, and the list
    that the move's final integrator states go to."""
    ts = WaterBox(box_edge=EDGE, cutoff=CUTOFF, switch_width=SWITCH,
                  ewald_error_tolerance=TOL, device="cpu")
    state = ThermodynamicState(system=ts.system, temperature=TEMPERATURE)
    move = LangevinDynamicsMove(timestep=0.002, collision_rate=1.0,
                                n_steps=n_steps, seed=2 ** 31 + 3)
    move._get_integrator(state).sweep = sweep
    kept = []
    move._on_integration_end = kept.append
    gen = torch.Generator().manual_seed(2 ** 31 + 11)
    kT = torch.tensor(K_BOLTZMANN * TEMPERATURE)
    ss = ts.sampler_state().replace(
        velocities=thermalize_velocities(ts.system.masses, kT, gen))
    return MCMCSampler(state, ss, move), kept


@pytest.mark.parametrize("sweep", ["auto", "force"])
def test_energy_and_forces_against_the_float64_reference(sweep):
    sampler, kept = _sampler(sweep)
    bound = sampler.move._bound(sampler.thermodynamic_state)
    assert bound.sweep_mode == (sweep == "force")
    x_start = sampler.sampler_state.positions.clone()
    sampler.run(1)
    (s,) = kept
    x = s.positions.double().numpy()
    assert not np.allclose(x, x_start.double().numpy())
    assert torch.equal(sampler.sampler_state.positions, s.positions)
    model = json.loads(CONFIG.read_text())["water_model"]
    spec = forcefield.water_spec(len(x) // 3, EDGE, model, CUTOFF, TOL,
                                 SWITCH)
    u_ref, f_ref = Reference(spec, "cpu").energy_forces(x, EDGE)
    u = float(sum(float(p) for p in s.potentials))
    f = sum(g.double().numpy() for g in s.forces)
    assert abs(u - u_ref) / abs(u_ref) < ENERGY_REL[sweep], (u, u_ref)
    assert check.force_error(f, f_ref) < FORCE_REL


def test_one_iteration_gives_the_single_chain_span_tree():
    sampler, _ = _sampler()
    tracing.enable()
    with tracing.span("caller"):
        sampler.run(1)
    tracing.disable()
    snap = tracing.snapshot()
    counts = collections.Counter(s[0] for s in snap.spans)
    causes = collections.defaultdict(set)
    for name, _, _, cause, _ in snap.spans:
        causes[name].add(cause)
    inner = ("integrator.initial_state", "integrator.run",
             "integrator.sampler_states", "move.nan_check")
    assert counts["sampler.iteration"] == counts["move.apply"] == 1
    assert all(counts[name] == 1 for name in inner), counts
    assert counts["integrator.step"] == N_STEPS
    assert causes["sampler.iteration"] == {"caller"}
    assert causes["move.apply"] == {"sampler.iteration"}
    assert all(causes[name] == {"move.apply"} for name in inner), causes
    assert causes["integrator.step"] == {"integrator.run"}
    # each span nests in time inside its cause, and the four inner spans
    # follow one another
    for name, lo, hi, cause, _ in snap.spans:
        if name != "caller":
            assert any(s[0] == cause and s[1] <= lo and hi <= s[2]
                       for s in snap.spans), name
    starts = [next(s[1] for s in snap.spans if s[0] == n) for n in inner]
    assert starts == sorted(starts)
    assert snap.counters["move.restarts"] == 0
    assert snap.counters["integrator.steps"] == N_STEPS


def _refuse(*args, **kwargs):
    raise AssertionError("a profiler range was constructed")


def test_with_tracing_off_the_path_records_nothing(monkeypatch):
    sampler, _ = _sampler()
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    sampler.run(1)
    snap = tracing.snapshot()
    assert snap.spans == [] and snap.counters == {} and snap.dropped == 0


def test_a_nan_restart_counts_one(monkeypatch):
    """The first run comes back with NaN positions; the move restarts once
    and the second attempt's state is kept."""
    calls = []
    run = BoundIntegrator.run

    def nan_once(self, state, n_steps):
        out = run(self, state, n_steps)
        calls.append(n_steps)
        if len(calls) == 1:
            out = out.replace(positions=torch.full_like(out.positions,
                                                        float("nan")))
        return out

    monkeypatch.setattr(BoundIntegrator, "run", nan_once)
    sampler, kept = _sampler()
    tracing.enable()
    sampler.run(1)
    tracing.disable()
    snap = tracing.snapshot()
    assert calls == [N_STEPS, N_STEPS]
    assert snap.counters["move.restarts"] == 1
    counts = collections.Counter(s[0] for s in snap.spans)
    assert counts["move.apply"] == 1 and counts["integrator.run"] == 2
    assert counts["move.nan_check"] == 2
    assert len(kept) == 1
    assert torch.isfinite(sampler.sampler_state.positions).all()
