"""The alchemical variant of the bounded sweep (ops/sweep_nb.py) and sweep
mode on alchemical systems, against the JAX package.

* The plain version of the kernel at float32 against the JAX kernel
  ``SweepNonbonded(..., alchemical=True, interpret=True)`` on the same
  sorted inputs, with the class scalars the port computes from the global
  parameters: the new bound equal, forces within 2e-4 of the force scale,
  energy within 1e-5 of itself. Charged LJ fluid (512 particles), one and
  two regions, direct-space and 'coulomb' treatments.
* Sweep mode's energy and forces (through ``initial_state``) at float64
  against the JAX package's dense evaluation of the same alchemical system,
  rel 1e-9: treatments, lambdas, exceptions, two regions, an alchemical
  water box (its dispersion tail weighted by class).
* Sweep mode against the port's own dense path at float32, with the
  tolerances the JAX package holds its kernel to against its dense path
  (tests/test_sweep_nb.py:154-195, 214-325, 380-415): energy within 2e-3,
  forces within 2e-4 of the force scale.
* A gamma = 0 trajectory of the alchemical water box in sweep mode against
  the JAX package's dense path, dx < 1e-3 nm (tests/test_sweep_nb.py:58).
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmmtools_tpu import alchemy as jalch
from openmmtools_tpu.integrators import BAOABIntegrator as JaxBAOAB
from openmmtools_tpu.models import LennardJonesFluid as JaxLJ
from openmmtools_tpu.models import water as jwater
from openmmtools_tpu.ops import sweep_nb as jsw
from openmmtools_tpu.states import SamplerState as JaxSamplerState
from openmmtools_tpu.system import make_energy_force_fn as jax_ef
from openmmtools_tpu_torch import alchemy as talch
from openmmtools_tpu_torch.constants import kB
from openmmtools_tpu_torch.integrators import BAOABIntegrator
from openmmtools_tpu_torch.models import AlchemicalWaterBox
from openmmtools_tpu_torch.ops import sweep_nb as tsw
from openmmtools_tpu_torch.states import SamplerState

from test_torch_support import (
    fluid_with_exceptions,
    jax_f64,
    np64,
    port_system,
    two_regions,
)

REL32 = 2e-4


def _fluid():
    return JaxLJ(nparticles=512, charge=0.2)


def _alchemical_fluid(module, regions="one", treatment="direct-space",
                      exceptions=False, annihilate_sterics=True, fluid=None):
    """The charged fluid made alchemical by ``module``'s factory, from the
    JAX build (converted for the port)."""
    f = fluid or _fluid()
    jsys = f.system
    if exceptions:
        jsys = fluid_with_exceptions(jsys, f.positions)
    base = jsys if module is jalch else port_system(jsys)
    if regions == "one":
        reg, inter = module.AlchemicalRegion(
            alchemical_atoms=list(range(24)),
            annihilate_sterics=annihilate_sterics), frozenset()
    else:
        reg, inter = two_regions(module, regions == "two-interacting")
    return module.AbsoluteAlchemicalFactory(
        alchemical_pme_treatment=treatment).create_alchemical_system(
        base, reg, inter)


def _lambdas(regions, lam_a, lam_b=None):
    if regions == "one":
        return {"lambda_sterics": lam_a, "lambda_electrostatics": lam_a}
    return {"lambda_sterics_a": lam_a, "lambda_electrostatics_a": lam_a,
            "lambda_sterics_b": lam_b, "lambda_electrostatics_b": lam_b}


KERNEL_CASES = [("one", "direct-space", 0.55), ("one", "coulomb", 0.3),
                ("two-interacting", "direct-space", 0.55)]


@pytest.mark.parametrize("regions,treatment,lam", KERNEL_CASES)
def test_plain_kernel_matches_jax_interpret(regions, treatment, lam):
    fluid = _fluid()
    term = _alchemical_fluid(talch, regions, treatment).terms[0]
    n = term.charge.shape[0]
    x = np.asarray(fluid.positions, np.float32)
    box = np.asarray(fluid.system.default_box, np.float32)
    kw = dict(ewald_alpha=term.ewald_alpha, mask_shells=256,
              n_regions=term.n_regions,
              coulomb_pme_treatment=term.coulomb_pme_treatment)
    tk = tsw.SweepNonbonded(n, "pme", term.cutoff, **kw)
    jk = jsw.SweepNonbonded(n, "pme", term.cutoff, interpret=True, **kw)
    assert tk.n_lam == jk.n_lam and tk.alch_classes == jk._alch_classes
    assert tk.launches == {"sweep_bound": 0, "sweep_forces_alch": 0}
    term32 = term.to(dtype=torch.float32)
    xT, par, excl, L, _ = tsw.sorted_inputs(term32, torch.as_tensor(x),
                                            torch.as_tensor(box), tk)
    params = {k: torch.tensor(v, dtype=torch.float32)
              for k, v in _lambdas(regions, lam, 0.3).items()}
    lam_t, _, _ = term32.sweep_lambdas(params, xT)
    bound = 3
    f_j, u_j, nb_j = jk.forces(jnp.asarray(xT.numpy().T),
                               jnp.asarray(par.numpy().T), jnp.asarray(box),
                               jnp.asarray(excl.numpy()), jnp.asarray(True),
                               jnp.int32(bound), lam=jnp.asarray(lam_t.numpy()))
    f_t, u_t, nb_t = tk.forces(xT.t(), par.t(), torch.as_tensor(box), excl,
                               torch.tensor(True),
                               torch.tensor(bound, dtype=torch.int32),
                               lam=lam_t)
    assert int(nb_t) == int(nb_j) > bound
    f_j = np.asarray(f_j)
    assert np.abs(np64(f_t) - f_j).max() <= REL32 * np.abs(f_j).max()
    assert abs(float(u_t) - float(u_j)) <= 1e-5 * abs(float(u_j))
    assert tk.launches == {"sweep_bound": 0, "sweep_forces_alch": 0}


def test_class_index_is_the_class_order():
    """The integer class index the kernel computes enumerates the classes
    in the JAX kernel's order, env-env excluded."""
    for R in (1, 2, 4):
        table = tsw.class_index(R)
        classes = [(a, b) for a in range(R + 1) for b in range(a, R + 1)][1:]
        assert int(table[0, 0]) == -1
        for ci, (a, b) in enumerate(classes):
            assert int(table[a, b]) == int(table[b, a]) == ci


def _initial(bound, x, box, params):
    n = x.shape[0]
    return bound.initial_state(
        SamplerState(positions=torch.as_tensor(x),
                     velocities=torch.zeros((n, 3), dtype=torch.as_tensor(
                         x).dtype),
                     box_vectors=torch.as_tensor(box)),
        torch.Generator(), global_params=params)


EVAL_CASES = [
    ("one", "direct-space", (1.0,), False),
    ("one", "direct-space", (0.0,), False),
    ("one", "exact", (0.55,), False),
    ("one", "coulomb", (0.55,), True),
    ("two-interacting", "direct-space", (0.55, 0.3), False),
    ("two-apart", "direct-space", (0.0, 0.7), False),
]


@pytest.mark.parametrize("regions,treatment,lams,exceptions", EVAL_CASES)
def test_sweep_eval_matches_jax_dense(regions, treatment, lams, exceptions):
    fluid = _fluid()
    jsys = _alchemical_fluid(jalch, regions, treatment, exceptions,
                             fluid=fluid)
    system = _alchemical_fluid(talch, regions, treatment, exceptions,
                               fluid=fluid)
    x = np.asarray(fluid.positions, np.float64)
    box = np.asarray(jsys.default_box, np.float64)
    params = _lambdas(regions, *lams)
    u_j, f_j = jax.jit(jax_ef(jax_f64(jsys)))(x, box, params)
    bound = BAOABIntegrator(temperature=120.0, sweep="force").bind(system)
    assert bound.sweep_mode and bound.force_path.alch is system.terms[0]
    assert bound._sweep_kernel.coulomb_pme_treatment == (
        treatment == "coulomb")
    state = _initial(bound, x, box, params)
    u_t = float(state.potentials[0])
    assert abs(u_t - float(u_j)) <= 1e-9 * abs(float(u_j))
    f_j = np.asarray(f_j)
    assert np.abs(np64(state.forces[0]) - f_j).max() <= 1e-9 * np.abs(
        f_j).max()


@pytest.mark.parametrize("lams", [(0.5, 0.0), (1.0, 1.0), (0.2, 0.6)])
def test_sweep_eval_alchemical_water_matches_jax_dense(lams):
    """The alchemical water box (SETTLE waters, PME, the dispersion tail
    weighted by class) at float64 against the JAX dense evaluation."""
    jw = jwater.AlchemicalWaterBox(box_edge=1.9, cutoff=0.9)
    system = port_system(jw.system)
    x = np.asarray(jw.positions, np.float64) + np.random.default_rng(
        4).normal(scale=2e-3, size=(system.n_particles, 3))
    box = np.asarray(jw.system.default_box, np.float64)
    params = {"lambda_sterics": lams[0], "lambda_electrostatics": lams[1]}
    u_j, f_j = jax.jit(jax_ef(jax_f64(jw.system)))(x, box, params)
    bound = BAOABIntegrator(temperature=300.0, sweep="force").bind(system)
    assert bound.force_path.disp_class is not None
    assert bound.force_path.recip is None and bound.force_path.rows is None
    state = _initial(bound, x, box, params)
    assert abs(float(state.potentials[0]) - float(u_j)) <= 1e-9 * abs(
        float(u_j))
    f_j = np.asarray(f_j)
    assert np.abs(np64(state.forces[0]) - f_j).max() <= 1e-9 * np.abs(
        f_j).max()


@pytest.mark.parametrize("regions,treatment,lams,annihilate", [
    ("one", "direct-space", (0.55,), True),
    ("one", "coulomb", (0.55,), True),
    ("one", "direct-space", (0.0,), False),
    ("two-interacting", "direct-space", (0.55, 0.3), True),
    ("two-apart", "direct-space", (0.55, 0.3), True),
])
def test_sweep_mode_matches_dense_at_float32(regions, treatment, lams,
                                              annihilate):
    fluid = _fluid()
    system = _alchemical_fluid(talch, regions, treatment,
                               annihilate_sterics=annihilate,
                               fluid=fluid).to(dtype=torch.float32)
    params = _lambdas(regions, *lams)
    x = np.asarray(fluid.positions, np.float32)
    box = np.asarray(fluid.system.default_box, np.float32)
    dense = BAOABIntegrator(temperature=120.0, sweep=None).bind(system)
    sweep = BAOABIntegrator(temperature=120.0, sweep="force").bind(system)
    assert sweep.sweep_mode and not dense.sweep_mode
    sd, ss = _initial(dense, x, box, params), _initial(sweep, x, box, params)
    u_d, u_s = float(sd.potentials[0]), float(ss.potentials[0])
    assert abs(u_d - u_s) < 2e-3 * max(abs(u_d), 1.0), (u_d, u_s)
    fd = np64(sd.forces[0])
    assert np.abs(fd - np64(ss.forces[0])).max() < REL32 * max(
        np.abs(fd).max(), 1.0)


def test_sweep_mode_policy_for_alchemical_terms(caplog):
    """A softcore other than beta = 0, c = 6 keeps the dense path, and says
    so at N >= 4096; the factory's default engages the kernel's alchemical
    variant (with its own launch counter)."""
    small = AlchemicalWaterBox(box_edge=1.9, cutoff=0.9, device="cpu").system
    bound = BAOABIntegrator(temperature=300.0, sweep="force").bind(small)
    assert bound.sweep_mode and bound._sweep_kernel.alchemical
    assert bound._sweep_kernel.launches == {"sweep_bound": 0,
                                            "sweep_forces_alch": 0}
    assert not BAOABIntegrator(temperature=300.0).bind(small).sweep_mode
    term = small.terms[0]
    beta = small.replace_term(0, term.replace(softcore_beta=0.5))
    assert not BAOABIntegrator(temperature=300.0,
                               sweep="force").bind(beta).sweep_mode
    c4 = small.replace_term(0, term.replace(softcore_c=4.0))
    assert not BAOABIntegrator(temperature=300.0,
                               sweep="force").bind(c4).sweep_mode
    assert "dense" not in caplog.text
    big = AlchemicalWaterBox(box_edge=3.6, cutoff=0.9, device="cpu").system
    assert big.n_particles >= 4096
    big = big.replace_term(0, big.terms[0].replace(softcore_beta=0.5))
    with caplog.at_level(logging.WARNING):
        bound = BAOABIntegrator(temperature=300.0, sweep="force").bind(big)
    assert not bound.sweep_mode
    assert "dense O(N^2) force path" in caplog.text


def test_gamma0_trajectory_matches_jax_dense():
    """Rigid alchemical water, 10 steps at collision rate 0 from the same
    numpy velocities: the port's sweep mode (re-sorting every 5 steps)
    against the JAX package's dense path."""
    kw = dict(box_edge=1.9, cutoff=0.9)
    jw = jwater.AlchemicalWaterBox(**kw)
    n = jw.system.n_particles
    masses = np.asarray(jw.system.masses, np.float64)
    v0 = (np.random.default_rng(8).normal(size=(n, 3))
          * np.sqrt(kB * 300.0 / masses)[:, None]).astype(np.float32)
    params = {"lambda_sterics": 0.5, "lambda_electrostatics": 0.0}
    jb = JaxBAOAB(temperature=300.0, collision_rate=0.0, timestep=0.001,
                  sweep=None, neighborlist=None).bind(jw.system)
    js = jb.initial_state(JaxSamplerState(positions=jw.positions,
                                          velocities=v0,
                                          box_vectors=jw.system.default_box),
                          jax.random.PRNGKey(0), global_params=params)
    js = jb.run(js, 10)
    tw = AlchemicalWaterBox(device="cpu", **kw)
    tb = BAOABIntegrator(temperature=300.0, collision_rate=0.0,
                         timestep=0.001, sweep="force",
                         sweep_sort_interval=5).bind(tw.system)
    assert tb.sweep_mode and tb.force_path.alch is not None
    assert tb.constraint_solver.settle
    ts = tb.initial_state(SamplerState(positions=tw.positions,
                                       velocities=torch.as_tensor(v0),
                                       box_vectors=tw.system.default_box),
                          torch.Generator().manual_seed(0),
                          global_params=params)
    ts = tb.run(ts, 10)
    assert ts.positions.dtype == torch.float32 and ts.step_count == 10
    dx = np.abs(np64(ts.positions) - np64(js.positions)).max()
    assert dx < 1e-3, dx
    assert np.abs(np64(ts.positions) - np64(tw.positions)).max() > 1e-3
