"""Faults F3-F7 of the port, each held by a test that fails without its
repair (CPU, float64; sweep mode forced, so the sweep kernels' plain
versions stand in for the card's).

* F6: ``energies_at`` and ``energy_forces_at`` raise, as ``run`` does,
  when an exception pair lies farther apart in the sort than the
  exclusion bitfield covers; the energy matrix reads the flag once.
* F3: the fused LJ kernel takes no term with a global LJ scale
  (``fused_lj_eligible``).
* F4: parallel tempering's O(N) energies take the move's bound integrator
  in sweep mode.
* F5: the unsampled states with a system of their own, the Metropolized
  moves and the barostat evaluate through a bound integrator (the context
  cache's), and ``ThermodynamicState.potential_energy`` refuses the dense
  sum on the card.
* F7: ``minimize`` takes its energies, forces and constraint projection
  from the context cache's bound integrator.
* F8: sweep mode and neighbour mode rebuild a system's virtual sites from
  their parents before they sort the ring or build the list, and inside
  the energy: the step never moves the massless sites, so without it the
  kernel, the remainder and the list read them at their first places.

Energies by the sweep path are held against the dense sum at rel 1e-10.
"""
import numpy as np
import pytest
import torch

from openmmtools_tpu_torch import states as tstates
from openmmtools_tpu_torch.integrators import BAOABIntegrator, minimize
from openmmtools_tpu_torch.integrators.force_paths import SweepPath
from openmmtools_tpu_torch.integrators.langevin import IntegratorError
from openmmtools_tpu_torch.mcmc import (
    IntegratorMove,
    MCDisplacementMove,
    MCRotationMove,
    MonteCarloBarostatMove,
)
from openmmtools_tpu_torch.models import LennardJonesFluid, PMEWaterBox
from openmmtools_tpu_torch.multistate import (
    MultiStateSampler,
    ParallelTemperingSampler,
)
from openmmtools_tpu_torch.states import SamplerState, ThermodynamicState
from openmmtools_tpu_torch.system import NonbondedTerm, make_energy_fn

REL = 1e-10
TEMP = 300.0


@pytest.fixture(scope="module")
def water():
    """PMEWaterBox(2.5): 512 rigid waters, 1,536 atoms, float64."""
    w = PMEWaterBox(box_edge=2.5, device="cpu")
    return w.system.to(dtype=torch.float64), w.positions.to(torch.float64)


@pytest.fixture
def sweep_calls(monkeypatch):
    """Sweep-path evaluations by the fingerprint of the bound system: one a
    configuration of a single call, and B of a batched call (one a pair of
    ``rep``, else one a configuration of the batch)."""
    calls = {}
    original = SweepPath.evaluate_sweep

    def counting(self, x, *args, **kwargs):
        key = self.system.fingerprint
        rep = kwargs.get("rep")
        count = (1 if x.dim() == 2 else
                 x.shape[0] if rep is None else len(rep))
        calls[key] = calls.get(key, 0) + count
        return original(self, x, *args, **kwargs)

    monkeypatch.setattr(SweepPath, "evaluate_sweep", counting)
    return calls


def _rel(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


# -- F6 ----------------------------------------------------------------------


def _fluid_with_pair(far):
    """LJ fluid of 4,200 atoms (past the size where the bitfield covers
    half the ring) with one exception pair: about half a box apart in x
    (``far``), else two nearest neighbours in x."""
    f = LennardJonesFluid(nparticles=4200, reduced_density=0.5, device="cpu")
    system = f.system.to(dtype=torch.float64)
    x = f.positions.to(torch.float64)
    L = float(system.default_box[0, 0])
    xs = x[:, 0]
    i = int(torch.argmin(xs))
    target = xs[i] + (0.5 * L if far else 1e-3)
    j = int(torch.argmin((xs - target).abs() + (torch.arange(len(xs)) == i)))
    term = system.terms[0]
    one = torch.ones(1, dtype=torch.float64)
    term = term.replace(
        exception_index=torch.tensor([[i, j]],
                                     dtype=term.exception_index.dtype),
        exception_sigma=one, exception_epsilon=0 * one,
        exception_chargeprod=0 * one)
    return system.replace(terms=(term,)), x


@pytest.mark.parametrize("far", [True, False])
def test_f6_overflow_raises_on_every_entry_point(far):
    system, x = _fluid_with_pair(far)
    bound = BAOABIntegrator(temperature=120.0, sweep="force").bind(system)
    assert bound.sweep_mode and bound._sweep_kernel.mask_shells == 2048
    state = bound.initial_state(SamplerState(positions=x),
                                torch.Generator().manual_seed(0))
    calls = [lambda: bound.run(state, 1),
             lambda: bound.energies_at(x, None, [{}]),
             lambda: bound.energy_forces_at(x, None, {})]
    for call in calls:
        if far:
            with pytest.raises(IntegratorError, match="overflow"):
                call()
        else:
            call()
    u, flag = bound.energies_and_overflow_at(x, None, [{}])
    assert bool(flag) == far


def test_f6_energy_matrix_checks_the_flag_once():
    """The energy matrix ORs the replicas' flags and raises once."""
    system, x = _fluid_with_pair(True)
    move = IntegratorMove(BAOABIntegrator(temperature=120.0, sweep="force"),
                          n_steps=1)
    sampler = MultiStateSampler(mcmc_moves=move, number_of_iterations=1,
                                online_analysis_interval=None)
    with pytest.raises(IntegratorError, match="overflow"):
        sampler.create([ThermodynamicState(system=system, temperature=120.0)],
                       SamplerState(positions=x))


# -- F3 ----------------------------------------------------------------------


def test_f3_fused_path_refuses_an_lj_scale():
    from openmmtools_tpu_torch.integrators.force_paths import (
        fused_lj_eligible,
    )

    fluid = LennardJonesFluid(nparticles=256, device="cpu")
    assert fused_lj_eligible(fluid.system)
    term = fluid.system.terms[0]
    scaled = fluid.system.replace(
        terms=(term.replace(lj_scale_param="lambda_sterics"),))
    assert not fused_lj_eligible(scaled)
    # a charge scale reads zero charges: the kernel stays exact
    charged = fluid.system.replace(
        terms=(term.replace(charge_scale_param="lambda_electrostatics"),))
    assert fused_lj_eligible(charged)


# -- F4 ----------------------------------------------------------------------


def test_f4_parallel_tempering_takes_the_sweep_path(water, sweep_calls):
    system, x = water
    move = IntegratorMove(BAOABIntegrator(temperature=TEMP, sweep="force"),
                          n_steps=1)
    sampler = ParallelTemperingSampler(mcmc_moves=move,
                                       number_of_iterations=1,
                                       online_analysis_interval=None)
    rng = np.random.default_rng(3)
    xs = [x + torch.as_tensor(rng.normal(scale=1e-3, size=x.shape))
          for _ in range(2)]
    sampler.create(ThermodynamicState(system=system, temperature=TEMP),
                   [SamplerState(positions=p) for p in xs],
                   temperatures=[300.0, 330.0])
    sweep_calls.clear()
    u = sampler._energy_matrix(windowed=True).numpy()
    assert sweep_calls == {system.fingerprint: 2}   # once a replica
    beta = sampler._stacked_sampled.beta.numpy()
    for n, p in enumerate(xs):
        U = float(make_energy_fn(system)(p, system.default_box, {}))
        for k in range(2):
            assert _rel(u[n, k], beta[k] * U) <= REL


# -- F5 ----------------------------------------------------------------------


def test_f5_unsampled_state_of_its_own_system(water, sweep_calls):
    """YANK's expanded-cutoff end state: the same box with a longer
    cutoff, a system of its own."""
    system, x = water
    term = system.terms[0]
    assert isinstance(term, NonbondedTerm)
    expanded = system.replace(terms=(term.replace(cutoff=1.2),)
                              + system.terms[1:])
    move = IntegratorMove(BAOABIntegrator(temperature=TEMP, sweep="force"),
                          n_steps=1)
    sampler = MultiStateSampler(mcmc_moves=move, number_of_iterations=1,
                                online_analysis_interval=None)
    unsampled = ThermodynamicState(system=expanded, temperature=TEMP)
    shifted = x + 0.01
    sampler.create([ThermodynamicState(system=system, temperature=TEMP)],
                   SamplerState(positions=shifted),
                   unsampled_thermodynamic_states=[unsampled])
    assert sampler._unsampled_separate
    sweep_calls.clear()
    u = sampler._energy_matrix(windowed=True).numpy()
    assert sweep_calls == {system.fingerprint: 1,
                           expanded.fingerprint: 1}
    dense = unsampled.reduced_potential(SamplerState(positions=shifted))
    assert _rel(u[0, 1], dense) <= REL
    assert u[0, 1] != u[0, 0]


@pytest.mark.parametrize("move", [
    MCDisplacementMove(displacement_sigma=0.05, atom_subset=[0, 1, 2]),
    MCRotationMove(atom_subset=[3, 4, 5])])
def test_f5_metropolized_moves_evaluate_in_the_cache(water, sweep_calls,
                                                      move):
    from openmmtools_tpu_torch.cache import ContextCache
    from openmmtools_tpu_torch.mcmc import reduced_potentials

    system, x = water
    ts = ThermodynamicState(system=system, temperature=TEMP)
    cache = ContextCache(sweep="force")
    ss = SamplerState(positions=x)
    gen = torch.Generator().manual_seed(1)
    draw = move._draw(gen, x)
    sweep_calls.clear()
    new, accept = move.metropolis_step(ts, ss, draw, torch.tensor(-1e-3,
                                       dtype=torch.float64), cache)
    assert sweep_calls == {system.fingerprint: 2}
    bound, _ = cache.get_context(ts)
    assert bound.sweep_mode
    proposed = ss.replace(positions=x.index_put(
        (torch.as_tensor(move.atom_subset),),
        move._propose_positions(draw, x[move.atom_subset])))
    got = reduced_potentials(ts, (ss, proposed), cache)
    for g, s in zip(got, (ss, proposed)):
        assert _rel(g, ts.reduced_potential(s)) <= REL
    want = -(float(got[1]) - float(got[0])) > -1e-3
    assert bool(accept) == want
    # through apply, with the cache handed down
    sweep_calls.clear()
    move.apply(ts, ss, context_cache=cache)
    assert sweep_calls == {system.fingerprint: 2}


def test_f5_barostat_evaluates_in_the_cache(water, sweep_calls):
    from openmmtools_tpu_torch.cache import ContextCache

    system, x = water
    ts = ThermodynamicState(system=system, temperature=TEMP, pressure=1.0)
    cache = ContextCache(sweep="force")
    ss = SamplerState(positions=x, box_vectors=system.default_box.clone())
    baro = MonteCarloBarostatMove(volume_scale=0.01)
    mol_ids, n_mol = baro._molecules_for(system)
    for eps in (-0.03, 0.03):   # the box edge scaled by -1 % and +1 %
        sweep_calls.clear()
        new, accept = baro.attempt(
            ts, ss, torch.tensor(eps, dtype=torch.float64),
            torch.tensor(-1e9, dtype=torch.float64), mol_ids, n_mol, cache)
        assert sweep_calls == {system.fingerprint: 2}
        assert bool(accept)
        box = new.box_vectors
        assert float(box[0, 0]) == pytest.approx(2.5 * np.exp(eps / 3))
        bound, _ = cache.get_context(ts)
        u = bound.energies_at(new.positions, box, [{}])[0]
        dense = make_energy_fn(system)(new.positions, box, {})
        assert _rel(u, dense) <= REL


def test_f5_potential_energy_refuses_the_dense_sum(water, monkeypatch):
    """``ThermodynamicState.potential_energy`` (and so the reduced
    potential) asks ``refuse_dense``, which raises on the card from
    ``DENSE_LIMIT`` atoms up."""
    system, x = water
    seen = []
    monkeypatch.setattr(tstates, "refuse_dense",
                        lambda s, xx, what: seen.append((s, what)))
    ts = ThermodynamicState(system=system, temperature=TEMP)
    ts.reduced_potential(SamplerState(positions=x))
    assert seen and seen[0][0] is system
    seen.clear()
    ts.reduced_potential(SamplerState(positions=x),
                         potential_energy=torch.tensor(1.0))
    assert not seen


# -- F7 ----------------------------------------------------------------------


def test_f7_minimize_takes_the_cached_bound_integrator(water, sweep_calls):
    from openmmtools_tpu_torch.cache import ContextCache

    system, x = water
    ts = ThermodynamicState(system=system, temperature=TEMP)
    cache = ContextCache(sweep="force")
    rng = np.random.default_rng(7)
    start = x + torch.as_tensor(rng.normal(scale=2e-3, size=x.shape))
    bound, _ = cache.get_context(ts)
    start = bound._constrain_positions(start, x)   # rigid waters
    ss = SamplerState(positions=start)
    sweep_calls.clear()
    out = minimize(ts, ss, max_iterations=5, context_cache=cache)
    # 5 FIRE steps, FIRE's final energy, the acceptance check's two
    assert sweep_calls == {system.fingerprint: 5 + 1 + 2}
    assert out is not ss
    u0 = make_energy_fn(system)(start, system.default_box, {})
    u1 = make_energy_fn(system)(out.positions, system.default_box, {})
    assert float(u1) < float(u0)
    c = system.constraints
    d = out.positions[c.index[:, 0].long()] - out.positions[
        c.index[:, 1].long()]
    assert float((d.norm(dim=-1) - c.distance).abs().max()) < 1e-6


# -- F8 ----------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["neighbour", "sweep"])
def test_f8_virtual_sites_follow_their_parents(mode):
    """A four-site water box in neighbour mode and in forced sweep mode.
    The parents move 0.5 nm, past the list's skin and the sweep's, and the
    sites stay behind: the state's U and F are the dense energy's, whose
    sites follow their parents. So are they after a run across three
    rebuilds of the list (re-sorts of the ring)."""
    from openmmtools_tpu_torch.models import FourSiteWaterBox
    from openmmtools_tpu_torch.system import make_energy_force_fn

    box = FourSiteWaterBox(box_edge=2.1, device="cpu")
    system = box.system.to(dtype=torch.float64)
    vs = system.virtual_sites
    assert vs.n_sites > 0
    if mode == "sweep":
        integ = BAOABIntegrator(temperature=TEMP, timestep=0.002,
                                sweep="force", sweep_sort_interval=5)
    else:
        integ = BAOABIntegrator(temperature=TEMP, timestep=0.002, sweep=None,
                                neighbor_rebuild_interval=5)
    bound = integ.bind(system)
    assert bound.sweep_mode == (mode == "sweep")
    assert bound.neighbor_mode == (mode == "neighbour")
    x = box.positions.double().clone()
    parents = torch.ones(system.n_particles, dtype=torch.bool)
    parents[vs.site.long()] = False
    x[parents, 0] += 0.5
    ef = make_energy_force_fn(system)

    def held(state):
        u, f = ef(state.positions, state.box, {})
        assert abs(float(state.potentials[0] - u)) <= REL * abs(float(u))
        assert float((state.forces[0] - f).abs().max()) <= (
            REL * float(f.abs().max()))

    ss = tstates.SamplerState(positions=x, box_vectors=system.default_box)
    state = bound.initial_state(ss, torch.Generator().manual_seed(0))
    held(state)
    state = bound.run(state, 15)
    held(state)
