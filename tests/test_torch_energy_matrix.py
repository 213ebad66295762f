"""The multistate energy matrix of the port against the JAX package's, on
the CPU at float64 (rel 1e-10 of the matrix's scale).

The same replica positions, state assignments and thermodynamic states go
to a JAX sampler and a port sampler: the full matrix that ``create`` takes
(the JAX package's ``_compute_energies``) and an iteration's matrix (its
``_build_energies_fn``, vmapped over the replicas, against the port's
``_energy_matrix``) for

* a HarmonicOscillator K ladder, with more replicas than states;
* a small alchemical LJ fluid over a lambda ladder, by the dense path and
  by sweep mode (forced on the CPU: the kernels' plain versions);
* NPT states at several temperatures and pressures, one box a replica;
* locality windows (+inf outside);
* unsampled states with the sampled system and with a system of their own;
* parallel tempering's O(N) path.

And the bound integrator's ``energies_at`` in sweep mode against the dense
energy of the alchemical water box at several lambdas; the compatibility
groups and the stacked per-state scalars against the JAX package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmmtools_tpu.mcmc as jmc
import openmmtools_tpu.multistate as jms
from openmmtools_tpu import alchemy as jalch
from openmmtools_tpu.models import HarmonicOscillator as JaxHO
from openmmtools_tpu.models import LennardJonesFluid as JaxLJ
from openmmtools_tpu.models import PowerOscillator as JaxPO
from openmmtools_tpu.models import water as jwater
from openmmtools_tpu.states import SamplerState as JaxSS
from openmmtools_tpu.states import ThermodynamicState as JaxState
from openmmtools_tpu.states import create_thermodynamic_state_protocol as jproto
import openmmtools_tpu_torch.multistate as tms
from openmmtools_tpu_torch import alchemy as talch
from openmmtools_tpu_torch.integrators import BAOABIntegrator
from openmmtools_tpu_torch.mcmc import IntegratorMove, LangevinDynamicsMove
from openmmtools_tpu_torch.states import SamplerState, ThermodynamicState
from openmmtools_tpu_torch.states import create_thermodynamic_state_protocol
from openmmtools_tpu_torch.system import make_energy_fn

from test_torch_support import jax_f64, port_system

REL = 1e-10
TEMP = 300.0
K_LADDER = [100.0, 200.0, 400.0, 800.0]
K_NAME = "testsystems_HarmonicOscillator_K"


def assert_matrix_close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    scale = max(float(np.abs(want[fin]).max()), 1e-30)
    assert float(np.abs(got[fin] - want[fin]).max()) <= rel * scale


def _pair(jsys, psys, protocol, base=None):
    """JAX and port state ladders over ``protocol`` from one reference."""
    base = dict(base or {})
    jref = JaxState(system=jsys, temperature=np.float64(TEMP),
                    pressure=base.get("pressure"))
    pref = ThermodynamicState(system=psys, temperature=TEMP,
                              pressure=base.get("pressure"))
    return jproto(jref, protocol), create_thermodynamic_state_protocol(
        pref, protocol)


def _samplers(jstates, pstates, x, s, boxes=None, pmove=None, jcls=None,
              pcls=None, unsampled=(None, None), **kw):
    """A JAX and a port sampler created on the same replicas."""
    jcls = jcls or jms.ReplicaExchangeSampler
    pcls = pcls or tms.ReplicaExchangeSampler
    common = dict(number_of_iterations=1, online_analysis_interval=None,
                  **kw)
    js = jcls(mcmc_moves=jmc.LangevinDynamicsMove(n_steps=1), **common)
    ps = pcls(mcmc_moves=pmove or LangevinDynamicsMove(n_steps=1), **common)
    jss = [JaxSS(positions=jnp.asarray(x[n]),
                 box_vectors=None if boxes is None else jnp.asarray(boxes[n]))
           for n in range(x.shape[0])]
    pss = [SamplerState(positions=torch.as_tensor(x[n]),
                        box_vectors=(None if boxes is None
                                     else torch.as_tensor(boxes[n])))
           for n in range(x.shape[0])]
    js.create(jstates, jss, initial_thermodynamic_states=s,
              unsampled_thermodynamic_states=unsampled[0])
    ps.create(pstates, pss, initial_thermodynamic_states=s,
              unsampled_thermodynamic_states=unsampled[1])
    return js, ps


def _jax_iteration_matrix(js):
    """The JAX iteration's matrix at the sampler's current replicas."""
    fn = js._build_energies_fn()
    c = js._carry
    box_axis = None if c.boxes is None else 0
    return np.asarray(jax.vmap(fn, in_axes=(0, box_axis, 0))(
        c.positions, c.boxes, c.replica_states))


def _ho():
    ho = JaxHO(K=K_LADDER[0])
    return jax_f64(ho.system), port_system(ho.system)


def _ho_positions(n, seed=0):
    return np.random.default_rng(seed).normal(scale=0.05, size=(n, 1, 3))


def test_harmonic_ladder_matrix():
    jsys, psys = _ho()
    jst, pst = _pair(jsys, psys, {K_NAME: K_LADDER})
    s = [0, 1, 2, 3, 0, 2]
    js, ps = _samplers(jst, pst, _ho_positions(6), s)
    assert ps.energies_last_iteration.dtype == np.float64
    assert_matrix_close(ps.energies_last_iteration,
                        js.energies_last_iteration)
    assert_matrix_close(ps._energy_matrix(windowed=True),
                        _jax_iteration_matrix(js))


def test_locality_windows():
    jsys, psys = _ho()
    ladder = [100.0 * 1.5 ** i for i in range(6)]
    jst, pst = _pair(jsys, psys, {K_NAME: ladder})
    s = [0, 5, 2, 3, 1, 4]
    js, ps = _samplers(jst, pst, _ho_positions(6, seed=1), s, locality=1)
    u = ps._energy_matrix(windowed=True).numpy()
    assert np.isinf(u).sum() == 6 * 6 - 6 * 3
    assert_matrix_close(u, _jax_iteration_matrix(js))
    # the reporter's 'neighborhoods': exactly the evaluated entries
    np.testing.assert_array_equal(ps._neighborhoods(u, np.asarray(s)),
                                  np.isfinite(u))


def test_unsampled_same_system():
    jsys, psys = _ho()
    jst, pst = _pair(jsys, psys, {K_NAME: K_LADDER})
    j_uns = [jst[0].replace(global_params={K_NAME: np.float64(k)})
             for k in (1600.0, 3200.0)]
    p_uns = [pst[0].replace(global_params={K_NAME: k})
             for k in (1600.0, 3200.0)]
    js, ps = _samplers(jst, pst, _ho_positions(4, seed=2), [0, 1, 2, 3],
                       unsampled=(j_uns, p_uns), locality=1)
    assert not ps._unsampled_separate
    assert ps.energies_last_iteration.shape == (4, 6)
    assert_matrix_close(ps.energies_last_iteration,
                        js.energies_last_iteration)
    assert_matrix_close(ps._energy_matrix(windowed=True),
                        _jax_iteration_matrix(js))


def test_unsampled_different_system():
    jsys, psys = _ho()
    jst, pst = _pair(jsys, psys, {K_NAME: K_LADDER})
    po = JaxPO(K=2.0, b=2)
    j_uns = [JaxState(system=jax_f64(po.system), temperature=np.float64(TEMP))]
    p_uns = [ThermodynamicState(system=port_system(po.system),
                                temperature=TEMP)]
    js, ps = _samplers(jst, pst, _ho_positions(4, seed=3), [3, 2, 1, 0],
                       unsampled=(j_uns, p_uns))
    assert ps._unsampled_separate and js._unsampled_separate
    assert ps.energies_last_iteration.shape == (4, 5)
    assert_matrix_close(ps.energies_last_iteration,
                        js.energies_last_iteration)
    assert_matrix_close(ps._energy_matrix(windowed=True),
                        _jax_iteration_matrix(js))


def test_npt_states():
    f = JaxLJ(nparticles=64)
    jsys, psys = jax_f64(f.system), port_system(f.system)
    protocol = {"temperature": [110.0, 120.0, 135.0],
                "pressure": [1.0, 20.0, 50.0]}
    jst, pst = _pair(jsys, psys, protocol, base={"pressure": 1.0})
    rng = np.random.default_rng(4)
    box0 = np.asarray(jsys.default_box)
    scales = [1.0, 1.02, 0.99, 1.01]
    boxes = np.stack([box0 * c for c in scales])
    x = np.stack([np.asarray(f.positions, np.float64) * c
                  + rng.normal(scale=1e-3, size=(64, 3)) for c in scales])
    js, ps = _samplers(jst, pst, x, [0, 1, 2, 0], boxes=boxes)
    assert_matrix_close(ps.energies_last_iteration,
                        js.energies_last_iteration)
    assert_matrix_close(ps._energy_matrix(windowed=True),
                        _jax_iteration_matrix(js))


def _alchemical_fluid(module, fluid):
    base = fluid.system if module is jalch else port_system(fluid.system)
    return module.AbsoluteAlchemicalFactory().create_alchemical_system(
        base, module.AlchemicalRegion(alchemical_atoms=list(range(8))))


LAMBDAS = {"lambda_electrostatics": [1.0, 0.5, 0.0, 0.0, 0.0],
           "lambda_sterics": [1.0, 1.0, 1.0, 0.5, 0.0]}


@pytest.mark.parametrize("sweep", [None, "force"])
def test_alchemical_lambda_ladder(sweep):
    """The dense path, and sweep mode: one sort a replica, then the plain
    sweep at each state's lambdas."""
    fluid = JaxLJ(nparticles=256, reduced_density=0.3, charge=0.2)
    jsys = jax_f64(_alchemical_fluid(jalch, fluid))
    psys = _alchemical_fluid(talch, fluid)
    jst, pst = _pair(jsys, psys, LAMBDAS)
    rng = np.random.default_rng(5)
    x = np.asarray(fluid.positions, np.float64)[None] + rng.normal(
        scale=2e-3, size=(3, 256, 3))
    box = np.asarray(jsys.default_box)
    move = IntegratorMove(BAOABIntegrator(temperature=TEMP, sweep=sweep),
                          n_steps=1)
    js, ps = _samplers(jst, pst, x, [0, 2, 4], boxes=np.stack([box] * 3),
                       pmove=move)
    bound = ps._matrix_bound()
    assert bound.sweep_mode == (sweep is not None)
    assert_matrix_close(ps.energies_last_iteration,
                        js.energies_last_iteration)
    assert_matrix_close(ps._energy_matrix(windowed=True),
                        _jax_iteration_matrix(js))


def test_parallel_tempering_o_n_path():
    jsys, psys = _ho()
    jref = JaxState(system=jsys, temperature=np.float64(TEMP))
    pref = ThermodynamicState(system=psys, temperature=TEMP)
    temps = dict(min_temperature=250.0, max_temperature=400.0,
                 n_temperatures=5)
    common = dict(number_of_iterations=1, online_analysis_interval=None)
    js = jms.ParallelTemperingSampler(
        mcmc_moves=jmc.LangevinDynamicsMove(n_steps=1), **common)
    ps = tms.ParallelTemperingSampler(
        mcmc_moves=LangevinDynamicsMove(n_steps=1), **common)
    x = _ho_positions(5, seed=6)
    js.create(jref, [JaxSS(positions=jnp.asarray(p)) for p in x], **temps)
    ps.create(pref, [SamplerState(positions=torch.as_tensor(p)) for p in x],
              **temps)
    np.testing.assert_allclose(
        [float(t) for t in ps._stacked_sampled.temperature],
        np.asarray(js._stacked_sampled.temperature), rtol=1e-12)
    assert_matrix_close(ps.energies_last_iteration,
                        js.energies_last_iteration)
    u = ps._energy_matrix(windowed=True)
    assert_matrix_close(u, _jax_iteration_matrix(js))
    # and u_k = beta_k U: one energy a replica
    beta = ps._stacked_sampled.beta.numpy()
    np.testing.assert_allclose(u.numpy() / beta[None, :],
                               np.repeat(u.numpy()[:, :1] / beta[0], 5, 1),
                               rtol=1e-12)


@pytest.mark.parametrize("lams", [(1.0, 1.0), (0.5, 0.0), (0.0, 0.25)])
def test_energies_at_sweep_matches_dense(lams):
    """``energies_at`` in sweep mode (forced: plain sweep plus the rest of
    the terms) against the dense energy of the alchemical water box."""
    jw = jwater.AlchemicalWaterBox(box_edge=1.9, cutoff=0.9)
    system = port_system(jw.system)
    bound = BAOABIntegrator(temperature=TEMP, sweep="force").bind(system)
    assert bound.sweep_mode and bound.force_path.alch is not None
    x = torch.as_tensor(np.asarray(jw.positions, np.float64)
                        + np.random.default_rng(7).normal(
                            scale=2e-3, size=(system.n_particles, 3)))
    box = system.default_box
    sets = [{"lambda_sterics": lams[0], "lambda_electrostatics": lams[1]},
            {"lambda_sterics": 1.0, "lambda_electrostatics": 1.0}]
    got = bound.energies_at(x, box, sets)
    assert got.dtype == torch.float64 and got.shape == (2,)
    u_fn = make_energy_fn(system)
    for u, params in zip(got, sets):
        want = float(u_fn(x, box, params))
        assert abs(float(u) - want) <= REL * abs(want), (float(u), want)
    # one sort, then each set: the same values one set at a time
    for u, params in zip(got, sets):
        assert float(bound.energies_at(x, box, [params])[0]) == float(u)


def test_compatibility_groups_and_stacks_match_jax():
    """``group_by_compatibility`` groups a mixed list as the JAX package
    does, and ``stack_thermodynamic_states`` gives the JAX stack's columns;
    incompatible states refuse to stack."""
    from openmmtools_tpu.states import group_by_compatibility as jgroup
    from openmmtools_tpu.states import stack_thermodynamic_states as jstack
    from openmmtools_tpu_torch.states import (
        ThermodynamicsError,
        group_by_compatibility,
        is_state_compatible,
        stack_thermodynamic_states,
    )

    jsys, psys = _ho()
    f = JaxLJ(nparticles=64)
    jlj, plj = jax_f64(f.system), port_system(f.system)
    jho, pho = _pair(jsys, psys, {K_NAME: K_LADDER[:3]})
    jnpt, pnpt = _pair(jlj, plj, {"temperature": [110.0, 130.0],
                                  "pressure": [1.0, 2.0]},
                       base={"pressure": 1.0})
    jnvt = [JaxState(system=jlj, temperature=np.float64(120.0))]
    pnvt = [ThermodynamicState(system=plj, temperature=120.0)]
    order = [0, 3, 1, 5, 2, 4]
    jall = [(jho + jnpt + jnvt)[i] for i in order]
    pall = [(pho + pnpt + pnvt)[i] for i in order]
    jg, ji = jgroup(jall)
    pg, pi = group_by_compatibility(pall)
    assert pi == ji == [[0, 2, 4], [1, 5], [3]]
    assert is_state_compatible(pall[0], pall[2])
    assert not is_state_compatible(pall[1], pall[3])   # NPT against NVT
    for jgrp, pgrp in zip(jg, pg):
        js, ps = jstack(jgrp), stack_thermodynamic_states(pgrp)
        np.testing.assert_array_equal(ps.temperature.numpy(),
                                      np.asarray(js.temperature))
        if js.pressure is None:
            assert ps.pressure is None
        else:
            np.testing.assert_array_equal(ps.pressure.numpy(),
                                          np.asarray(js.pressure))
        assert set(ps.global_params) == set(js.global_params)
        for name, col in ps.global_params.items():
            np.testing.assert_array_equal(col.numpy(),
                                          np.asarray(js.global_params[name]))
        assert ps.system is pgrp[0].system
    with pytest.raises(ThermodynamicsError):
        stack_thermodynamic_states(pall[:2])
