"""Replicas as one batched axis, on the CPU at float64.

* K2's plain versions over a batch (R sort sets, B evaluations, ``rep``)
  equal B single calls bit for bit: the standard and the alchemical
  variant, evaluations on mixed sets, one set rebuilding its bound while
  another keeps it;
* the batched step program equals the eager loop replica by replica (rel
  1e-10; with the same generators the trajectories agree to rounding):
  sweep mode forced on the small alchemical water box (SETTLE, PME, a
  re-sort inside the run) and the generic program on the alchemical LJ-216
  fluid, three replicas at different lambdas and temperatures, with noise;
* the batched energy matrix equals the eager rows, windowed and not, and
  the JAX sampler's vmapped matrix on the same positions;
* batched NCMC: the protocol work of four protocols at collision rate 0,
  their velocities given, equals the JAX package's vmap of ``run_program``
  and four eager runs;
* the sampler's batched route equals its eager route (a sampler held to
  the eager loop), and per-state moves that are equal batch as one group.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmmtools_tpu.mcmc as jmc
import openmmtools_tpu.multistate as jms
from openmmtools_tpu import alchemy as jalch
from openmmtools_tpu import integrators as jint
from openmmtools_tpu.models import LennardJonesFluid as JaxLJ
from openmmtools_tpu.models import water as jwater
from openmmtools_tpu.states import SamplerState as JaxSS
from openmmtools_tpu.states import ThermodynamicState as JaxState
from openmmtools_tpu.states import create_thermodynamic_state_protocol as jproto
import openmmtools_tpu_torch.multistate as tms
from openmmtools_tpu_torch import integrators as tint
from openmmtools_tpu_torch.integrators import BAOABIntegrator
from openmmtools_tpu_torch.mcmc import LangevinDynamicsMove
from openmmtools_tpu_torch.ops import sweep_nb as tsw
from openmmtools_tpu_torch.states import SamplerState, ThermodynamicState
from openmmtools_tpu_torch.states import create_thermodynamic_state_protocol

from test_torch_support import jax_f64, np64, port_system

REL = 1e-10
LAMS = [(1.0, 1.0), (0.5, 0.0), (0.2, 0.0)]
TEMPS = [300.0, 320.0, 350.0]


def _rel_close(got, want, rel=REL):
    got, want = np64(got), np64(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale, (got, want)


# -- K2's plain versions over a batch ----------------------------------------


def _water_inputs(alchemical, seed):
    """Sorted inputs of two configurations of the small (alchemical) water
    box: (k, xT (2, 3, n_pad), par (2, n_par, n_pad), excl, L (2, 3))."""
    jw = (jwater.AlchemicalWaterBox if alchemical else jwater.WaterBox)(
        box_edge=1.9, cutoff=0.9)
    system = port_system(jw.system)
    term = [t for t in system.terms
            if type(t).__name__ in ("NonbondedTerm",
                                    "AlchemicalNonbondedTerm")][0]
    k = tsw.PlainSweepNonbonded(
        system.n_particles, term.method, float(term.cutoff),
        ewald_alpha=term.ewald_alpha, switch_width=term.switch_width,
        mask_shells=256, n_regions=1 if alchemical else None)
    rng = np.random.default_rng(seed)
    box = torch.as_tensor(np.asarray(jw.system.default_box, np.float64))
    ins = []
    for _ in range(2):
        x = torch.as_tensor(np.asarray(jw.positions, np.float64)
                            + rng.normal(scale=3e-3, size=(system.n_particles,
                                                           3)))
        ins.append(tsw.sorted_inputs(term, x, box, k))
    xT, par, excl, L, _ = (torch.stack([i[c] for i in ins])
                           for c in range(5))
    return k, xT, par, excl, L


@pytest.mark.parametrize("alchemical", [False, True])
def test_batched_plain_sweep_equals_single_calls(alchemical):
    k, xT, par, excl, L = _water_inputs(alchemical, seed=1)
    # set 0 rebuilds its bound, set 1 keeps a stale one
    rebuild = torch.tensor([True, False])
    bound = torch.tensor([-1, 3], dtype=torch.int32)
    nblk = k.measure_bound(xT, L, rebuild, bound)
    assert nblk.shape == (2,) and int(nblk[1]) == 3
    for r in range(2):
        single = k.measure_bound(xT[r], L[r], rebuild[r], bound[r])
        assert torch.equal(nblk[r:r + 1], single)
    # four evaluations on mixed sets, each with its own parameters
    rep = torch.tensor([1, 0, 0, 1], dtype=torch.int32)
    par_b = par[rep.long()].clone()
    par_b[2, 2] *= 0.5                  # another charge scale
    lam = None
    if alchemical:
        # [lam_s | asc | lam_e] of the two region-pair classes
        lam = torch.tensor([[1.0, 1.0, 0.0, 0.0, 1.0, 1.0],
                            [0.5, 1.0, 0.25, 0.0, 0.0, 1.0],
                            [0.2, 1.0, 0.4, 0.0, 0.3, 1.0],
                            [0.9, 1.0, 0.05, 0.0, 0.7, 1.0]],
                           dtype=torch.float64)
    F, U = k.sweep(xT, par_b, excl, L, nblk, lam, rep)
    assert F.shape == (4, 3, k.n_pad) and U.shape == (4,)
    for b in range(4):
        r = int(rep[b])
        F1, U1 = k.sweep(xT[r], par_b[b], excl[r], L[r], nblk[r:r + 1],
                         None if lam is None else lam[b])
        assert torch.equal(F[b], F1) and torch.equal(U[b:b + 1], U1)
    assert not torch.equal(U[1], U[2])  # the parameters differ


def test_batched_sort_helpers_equal_single_sorts():
    k, xT, par, excl, L = _water_inputs(True, seed=2)
    jw = jwater.AlchemicalWaterBox(box_edge=1.9, cutoff=0.9)
    system = port_system(jw.system)
    term = system.terms[0]
    x = torch.stack([xT[r, :, :system.n_particles].t() for r in range(2)])
    box = torch.as_tensor(np.asarray(jw.system.default_box,
                                     np.float64)).expand(2, 3, 3)
    perm, inv = tsw.sort_for_sweep(x, box, k.n_pad)
    field, sep = tsw.build_exclusion_bitfield(term.exception_index, inv,
                                              k.n_pad, k.mask_rows)
    _, xs = tsw.sorted_positions(x, box, perm.long(), k.n_pad)
    for r in range(2):
        p1, i1 = tsw.sort_for_sweep(x[r], box[r], k.n_pad)
        f1, s1 = tsw.build_exclusion_bitfield(term.exception_index, i1,
                                              k.n_pad, k.mask_rows)
        _, x1 = tsw.sorted_positions(x[r], box[r], p1.long(), k.n_pad)
        assert torch.equal(perm[r], p1) and torch.equal(inv[r], i1)
        assert torch.equal(field[r], f1) and torch.equal(sep[r], s1)
        assert torch.equal(xs[r], x1)


# -- the batched step program against the eager loop -------------------------


def _replicas(bound, x, n_steps, params):
    """Three replicas through the batched program and one by one, each
    drawing from a generator seeded 11 + b."""
    ss = [SamplerState(positions=x) for _ in TEMPS]

    def gens():
        return [torch.Generator().manual_seed(11 + b)
                for b in range(len(TEMPS))]

    batch = bound.initial_state_batch(ss, gens(), temperatures=TEMPS,
                                      global_params=params)
    batch = bound.run(batch, n_steps)
    eager = []
    for b, gen in enumerate(gens()):
        st = bound.initial_state(ss[b], gen, temperature=TEMPS[b],
                                 global_params=params[b])
        eager.append(bound.run(st, n_steps))
    return batch, eager


def test_batched_sweep_mode_equals_eager_loop():
    jw = jwater.AlchemicalWaterBox(box_edge=1.9, cutoff=0.9)
    system = port_system(jw.system)
    bound = BAOABIntegrator(temperature=300.0, timestep=0.002,
                            collision_rate=5.0, sweep="force",
                            sweep_sort_interval=7).bind(system)
    assert bound.sweep_mode and bound.constraint_solver.settle is not None
    x = torch.as_tensor(np.asarray(jw.positions, np.float64))
    params = [{"lambda_sterics": torch.tensor(ls, dtype=torch.float64),
               "lambda_electrostatics": torch.tensor(le,
                                                     dtype=torch.float64)}
              for ls, le in LAMS]
    batch, eager = _replicas(bound, x, 20, params)
    assert batch.sweep_nblk.shape == (3,)
    for b, st in enumerate(eager):
        _rel_close(batch.positions[b], st.positions)
        _rel_close(batch.velocities[b], st.velocities)
        _rel_close(batch.potentials[0][b], st.potentials[0])
        assert not torch.equal(batch.positions[b], x)


def _alchemical_lj():
    jf = JaxLJ(nparticles=216, reduced_density=0.3)
    jsys = jalch.AbsoluteAlchemicalFactory().create_alchemical_system(
        jf.system, jalch.AlchemicalRegion(alchemical_atoms=[0]))
    return jf, jsys


def test_batched_generic_program_equals_eager_loop():
    jf, jsys = _alchemical_lj()
    system = port_system(jsys)
    bound = BAOABIntegrator(temperature=120.0, timestep=0.002,
                            collision_rate=1.0).bind(system)
    assert not (bound.sweep_mode or bound.neighbor_mode
                or bound.force_path.name == "K1")
    x = torch.as_tensor(np.asarray(jf.positions, np.float64))
    params = [{"lambda_sterics": torch.tensor(ls, dtype=torch.float64),
               "lambda_electrostatics": torch.tensor(1.0,
                                                     dtype=torch.float64)}
              for ls, _ in LAMS]
    batch, eager = _replicas(bound, x, 20, params)
    for b, st in enumerate(eager):
        _rel_close(batch.positions[b], st.positions)
        _rel_close(batch.velocities[b], st.velocities)
        _rel_close(batch.potentials[0][b], st.potentials[0])


# -- the energy matrix -------------------------------------------------------


def _water_ladder(locality=None):
    jw = jwater.AlchemicalWaterBox(box_edge=1.9, cutoff=0.9)
    jsys = jax_f64(jw.system)
    psys = port_system(jw.system)
    protocol = {"lambda_sterics": [1.0, 0.75, 0.5, 0.25],
                "lambda_electrostatics": [1.0, 0.5, 0.0, 0.0]}
    jst = jproto(JaxState(system=jsys, temperature=np.float64(300.0)),
                 protocol)
    pst = create_thermodynamic_state_protocol(
        ThermodynamicState(system=psys, temperature=300.0), protocol)
    rng = np.random.default_rng(5)
    x = np.asarray(jw.positions, np.float64)[None] + rng.normal(
        scale=3e-3, size=(5,) + np.asarray(jw.positions).shape)
    s = [0, 3, 1, 2, 3]
    common = dict(number_of_iterations=1, online_analysis_interval=None,
                  locality=locality)
    ps = tms.ReplicaExchangeSampler(
        mcmc_moves=LangevinDynamicsMove(n_steps=1), **common)
    ps.create(pst, [SamplerState(positions=torch.as_tensor(p)) for p in x],
              initial_thermodynamic_states=s)
    js = jms.ReplicaExchangeSampler(
        mcmc_moves=jmc.LangevinDynamicsMove(n_steps=1), **common)
    js.create(jst, [JaxSS(positions=jnp.asarray(p)) for p in x],
              initial_thermodynamic_states=s)
    return ps, js, x, s


@pytest.mark.parametrize("locality", [None, 1])
def test_batched_matrix_equals_eager_rows_and_jax(locality, monkeypatch):
    ps, js, x, s = _water_ladder(locality)
    # sweep mode forced for the port's bound integrator of the matrix
    integ = ps._moves_per_state()[0]._get_integrator(
        ps._thermodynamic_states[0])
    monkeypatch.setattr(integ, "sweep", "force")
    integ._bound = {}
    bound = ps._matrix_bound()
    assert bound.sweep_mode
    u = ps._energy_matrix(windowed=True).numpy()
    params = ps._params_on(torch.device("cpu"), torch.float64)
    beta = ps._stacked_states.beta.numpy()
    for n in range(len(s)):
        cols = ps._columns(s[n], windowed=True)
        U = bound.energies_at(torch.as_tensor(x[n]), None,
                              [params[c] for c in cols])
        _rel_close(u[n, cols], beta[cols] * U.numpy())
        if locality is not None:
            others = sorted(set(range(4)) - set(cols))
            assert np.all(np.isinf(u[n, others]))
    fn = js._build_energies_fn()
    c = js._carry
    box_axis = None if c.boxes is None else 0
    want = np.asarray(jax.vmap(fn, in_axes=(0, box_axis, 0))(
        c.positions, c.boxes, c.replica_states))
    np.testing.assert_array_equal(np.isinf(u), np.isinf(want))
    fin = np.isfinite(want)
    _rel_close(u[fin], want[fin], rel=1e-9)


# -- batched NCMC -------------------------------------------------------------


def test_batched_ncmc_work_equals_jax_vmap_and_eager():
    jf, jsys = _alchemical_lj()
    system = port_system(jsys)
    n_neq, n_prot = 16, 4
    funcs = {"lambda_sterics": "1.0 - lambda"}
    kw = dict(alchemical_functions=funcs, splitting="V R H R V O",
              temperature=120.0, collision_rate=0.0, timestep=0.001,
              n_steps_neq=n_neq)
    rng = np.random.default_rng(9)
    x = np.asarray(jf.positions, np.float64)
    v = rng.normal(scale=0.05, size=(n_prot,) + x.shape)
    params0 = {"lambda_sterics": 1.0, "lambda_electrostatics": 1.0}

    jb = jint.AlchemicalNonequilibriumLangevinIntegrator(**kw).bind(
        jax_f64(jsys))

    def one(vel, key):
        st = jb.initial_state(JaxSS(positions=jnp.asarray(x),
                                    velocities=vel), key, temperature=120.0,
                              global_params=params0)
        return jb.run_program(n_neq)(st).protocol_work

    keys = jax.random.split(jax.random.PRNGKey(0), n_prot)
    w_jax = np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(v), keys))

    tb = tint.AlchemicalNonequilibriumLangevinIntegrator(**kw).bind(system)
    ss = [SamplerState(positions=torch.as_tensor(x),
                       velocities=torch.as_tensor(v[k]))
          for k in range(n_prot)]
    gens = [torch.Generator().manual_seed(k) for k in range(n_prot)]
    batch = tb.initial_state_batch(ss, gens, temperatures=120.0,
                                   global_params=params0)
    batch = tb.run_program(n_neq)(batch)
    assert batch.protocol_work.shape == (n_prot,)
    _rel_close(batch.protocol_work, w_jax)
    for k in range(n_prot):
        st = tb.initial_state(ss[k], torch.Generator().manual_seed(k),
                              temperature=120.0, global_params=params0)
        st = tb.run_program(n_neq)(st)
        _rel_close(batch.protocol_work[k], st.protocol_work)
    assert np.ptp(w_jax) > 0.0            # the protocols differ


# -- the sampler's routes ----------------------------------------------------


class _EagerSampler(tms.ReplicaExchangeSampler):
    """The sampler held to its eager loop, one ``apply`` a replica."""

    @property
    def propagation_route(self):
        return "eager"


def test_sampler_batched_route_equals_eager_route():
    jw = jwater.AlchemicalWaterBox(box_edge=1.9, cutoff=0.9)
    psys = port_system(jw.system)
    protocol = {"lambda_sterics": [1.0, 0.5, 0.2],
                "lambda_electrostatics": [1.0, 0.0, 0.0]}
    states = create_thermodynamic_state_protocol(
        ThermodynamicState(system=psys, temperature=300.0), protocol)
    x = torch.as_tensor(np.asarray(jw.positions, np.float64))

    def sampler(moves, klass=tms.ReplicaExchangeSampler):
        s = klass(mcmc_moves=moves, number_of_iterations=2,
                  online_analysis_interval=None, rng_seed=3)
        s.create(states, [SamplerState(positions=x) for _ in range(3)])
        return s

    def move():
        m = LangevinDynamicsMove(timestep=0.002, n_steps=5)
        m._get_integrator(states[0]).sweep = "force"
        return m

    batched = sampler(move())
    # three equal moves, one a state, batch as one group
    per_state = sampler([move() for _ in range(3)])
    eager = sampler([move() for _ in range(3)], _EagerSampler)
    assert batched.propagation_route == "batched"
    assert per_state.propagation_route == "batched"
    assert eager.propagation_route == "eager"
    batched.run()
    per_state.run()
    eager.run()
    for a, b, c in zip(batched.sampler_states, eager.sampler_states,
                       per_state.sampler_states):
        _rel_close(a.positions, b.positions)
        _rel_close(a.velocities, b.velocities)
        assert torch.equal(a.positions, c.positions)
    _rel_close(batched.energies_last_iteration,
               eager.energies_last_iteration)


def test_apply_batch_redoes_a_nan_replica_alone(monkeypatch):
    """A replica that goes to NaN in a batch is redone alone, by the move's
    restarts from the second attempt; the others keep the batch's result,
    and only they count in the move's statistics."""
    from openmmtools_tpu_torch.mcmc import BaseIntegratorMove, GHMCMove
    from openmmtools_tpu_torch.models import HarmonicOscillator

    ho = HarmonicOscillator(device="cpu")
    ts = ho.thermodynamic_state(300.0)
    x = torch.as_tensor(np.asarray(ho.positions), dtype=torch.float64)
    sss = [SamplerState(positions=x + 0.01 * b) for b in range(3)]
    sss[1] = SamplerState(positions=torch.full_like(x, float("nan")))
    redone = []

    def attempts(self, state, ss, generator, first=0):
        redone.append((first, bool(ss.has_nan())))
        return ss.replace(positions=torch.zeros_like(ss.positions))

    monkeypatch.setattr(BaseIntegratorMove, "_attempts", attempts)
    move = GHMCMove(timestep=0.001, n_steps=4)
    gens = [torch.Generator().manual_seed(b) for b in range(3)]
    out = move.apply_batch([ts] * 3, sss, gens)
    assert redone == [(1, True)]
    assert torch.equal(out[1].positions, torch.zeros_like(x))
    assert all(bool(torch.isfinite(out[b].positions).all()) for b in (0, 2))
    assert move.n_proposed == 2 * 4     # the two finite replicas' steps
