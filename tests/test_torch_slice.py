"""The port's main paths end to end, against the JAX package's.

LennardJonesFluid -> BAOABIntegrator -> bind -> initial_state -> run, called
the way bench.py calls it, at N = 256 and collision_rate 0 (deterministic),
from the same numpy velocities. Both sides run float32 on their own default
CPU paths (the JAX package's neighbour list, the port's generic program),
so the tolerances are those of tests/test_pallas_baoab.py:195-202.

The explicit-solvent path, PMEWaterBox -> BAOABIntegrator -> bind ->
initial_state -> run, in the port's sweep mode (the kernels' plain versions
on the CPU, re-sorting every 5 steps) against the JAX package's dense path:
rigid water under SETTLE, 10 steps at collision_rate 0, dx < 1e-3 nm as in
tests/test_sweep_nb.py:58.

The alchemical path the same way: AlchemicalWaterBox -> a
CompoundThermodynamicState of AlchemicalState(lambda_electrostatics=0,
lambda_sterics=0.5) -> BAOABIntegrator -> bind (sweep mode with the
alchemical variant) -> initial_state(thermodynamic_state=...) -> run, then
NCMC switching of lambda_electrostatics on the state it reached, both
against the JAX package's dense path at collision rate 0.
"""
import ast
import pathlib

import jax
import numpy as np
import torch

from openmmtools_tpu import alchemy as jalch
from openmmtools_tpu import states as jstates
from openmmtools_tpu.integrators import (
    AlchemicalNonequilibriumLangevinIntegrator as JaxNCMC,
)
from openmmtools_tpu.integrators import BAOABIntegrator as JaxBAOAB
from openmmtools_tpu.models import AlchemicalWaterBox as JaxAlchemicalWaterBox
from openmmtools_tpu.models import LennardJonesFluid as JaxLJ
from openmmtools_tpu.models import PMEWaterBox as JaxPMEWaterBox
from openmmtools_tpu.states import SamplerState as JaxSamplerState
import openmmtools_tpu_torch
from openmmtools_tpu_torch import alchemy as talch
from openmmtools_tpu_torch import states as tstates
from openmmtools_tpu_torch.constants import kB
from openmmtools_tpu_torch.integrators import (
    AlchemicalNonequilibriumLangevinIntegrator,
    BAOABIntegrator,
)
from openmmtools_tpu_torch.models import (
    AlchemicalWaterBox,
    LennardJonesFluid,
    PMEWaterBox,
)
from openmmtools_tpu_torch.states import SamplerState

from test_torch_support import np64, wrapped_distance

N = 256


def test_main_path_matches_jax():
    rng = np.random.default_rng(21)
    v0 = (rng.normal(size=(N, 3)) * np.sqrt(kB * 120.0 / 39.9)).astype(np.float32)

    jf = JaxLJ(nparticles=N)
    jb = JaxBAOAB(temperature=120.0, collision_rate=0.0,
                  timestep=0.002).bind(jf.system)
    js = jb.initial_state(JaxSamplerState(positions=jf.positions, velocities=v0,
                                          box_vectors=jf.system.default_box),
                          jax.random.PRNGKey(0))
    js = jb.run(js, 40)

    tf = LennardJonesFluid(nparticles=N, device="cpu")
    tb = BAOABIntegrator(temperature=120.0, collision_rate=0.0,
                         timestep=0.002).bind(tf.system)
    ts = tb.initial_state(SamplerState(positions=tf.positions,
                                       velocities=torch.as_tensor(v0),
                                       box_vectors=tf.system.default_box),
                          torch.Generator().manual_seed(0))
    ts = tb.run(ts, 40)

    L = float(tf.box_edge)
    assert ts.positions.dtype == torch.float32
    assert torch.isfinite(ts.positions).all()
    assert wrapped_distance(ts.positions, js.positions, L) < 5e-4
    v_scale = float(np.abs(np64(js.velocities)).max())
    assert np.abs(np64(ts.velocities) - np64(js.velocities)).max() < 5e-3 * v_scale
    u_ref = float(js.potentials[0])
    assert abs(float(ts.potentials[0]) - u_ref) <= 2e-4 * abs(u_ref)
    assert wrapped_distance(ts.positions, tf.positions, L) > 1e-3


def test_explicit_solvent_path_matches_jax_dense():
    kw = dict(box_edge=1.9, cutoff=0.9)
    rng = np.random.default_rng(8)
    jw = JaxPMEWaterBox(**kw)
    n = jw.system.n_particles
    masses = np.asarray(jw.system.masses, np.float64)
    v0 = (rng.normal(size=(n, 3)) * np.sqrt(kB * 300.0 / masses)[:, None]
          ).astype(np.float32)

    jb = JaxBAOAB(temperature=300.0, collision_rate=0.0, timestep=0.001,
                  sweep=None, neighborlist=None).bind(jw.system)
    js = jb.initial_state(JaxSamplerState(positions=jw.positions,
                                          velocities=v0,
                                          box_vectors=jw.system.default_box),
                          jax.random.PRNGKey(0))
    js = jb.run(js, 10)

    tw = PMEWaterBox(device="cpu", **kw)
    tb = BAOABIntegrator(temperature=300.0, collision_rate=0.0,
                         timestep=0.001, sweep="force",
                         sweep_sort_interval=5).bind(tw.system)
    assert tb.sweep_mode and tb._vproj_skip
    assert tb.constraint_solver.settle is not None
    ts = tb.initial_state(SamplerState(positions=tw.positions,
                                       velocities=torch.as_tensor(v0),
                                       box_vectors=tw.system.default_box),
                          torch.Generator().manual_seed(0))
    ts = tb.run(ts, 10)

    assert ts.positions.dtype == torch.float32 and ts.step_count == 10
    assert torch.isfinite(ts.positions).all()
    dx = np.abs(np64(ts.positions) - np64(js.positions)).max()
    assert dx < 1e-3, dx
    assert np.abs(np64(ts.positions) - np64(tw.positions)).max() > 1e-3
    # the rigid geometry holds, and the kernels never launched on the CPU
    c = tw.system.constraints
    i, j = c.index[:, 0].long(), c.index[:, 1].long()
    r = torch.linalg.norm(ts.positions[i] - ts.positions[j], dim=1)
    assert float(((r - c.distance) / c.distance).abs().max()) < 1e-5
    assert tb._sweep_kernel.launches == {"sweep_bound": 0, "sweep_forces": 0}


def _compound(system, alchemy, states):
    return states.CompoundThermodynamicState(
        base_state=states.ThermodynamicState(system=system,
                                             temperature=300.0),
        composable_states=(alchemy.AlchemicalState(
            lambda_electrostatics=0.0, lambda_sterics=0.5),))


def test_alchemical_path_matches_jax_dense():
    kw = dict(box_edge=1.9, cutoff=0.9)
    jw = JaxAlchemicalWaterBox(**kw)
    tw = AlchemicalWaterBox(device="cpu", **kw)
    n = jw.system.n_particles
    masses = np.asarray(jw.system.masses, np.float64)
    v0 = (np.random.default_rng(9).normal(size=(n, 3))
          * np.sqrt(kB * 300.0 / masses)[:, None]).astype(np.float32)

    # Path A: an equilibrium lambda window
    jb = JaxBAOAB(temperature=300.0, collision_rate=0.0, timestep=0.001,
                  sweep=None, neighborlist=None).bind(jw.system)
    js = jb.initial_state(
        JaxSamplerState(positions=jw.positions, velocities=v0,
                        box_vectors=jw.system.default_box),
        jax.random.PRNGKey(0),
        thermodynamic_state=_compound(jw.system, jalch, jstates))
    js = jb.run(js, 10)
    tb = BAOABIntegrator(temperature=300.0, collision_rate=0.0,
                         timestep=0.001, sweep="force",
                         sweep_sort_interval=5).bind(tw.system)
    assert tb.sweep_mode and tb.force_path.alch is not None
    assert tb._sweep_kernel.alchemical and tb.force_path.name != "K1"
    ts = tb.initial_state(
        SamplerState(positions=tw.positions, velocities=torch.as_tensor(v0),
                     box_vectors=tw.system.default_box),
        torch.Generator().manual_seed(0),
        thermodynamic_state=_compound(tw.system, talch, tstates))
    assert {k: float(v) for k, v in ts.global_params.items()} == {
        "lambda_electrostatics": 0.0, "lambda_sterics": 0.5}
    ts = tb.run(ts, 10)
    assert torch.isfinite(ts.positions).all()
    assert np.abs(np64(ts.positions) - np64(js.positions)).max() < 1e-3

    # Path B: NCMC switching of the electrostatics from there, 4 steps
    params = {"lambda_electrostatics": 1.0, "lambda_sterics": 1.0}
    funcs = {"lambda_electrostatics": "1 - lambda"}
    jn = JaxNCMC(alchemical_functions=funcs, splitting="V R H R V",
                 temperature=300.0, collision_rate=0.0, timestep=0.001,
                 n_steps_neq=4, sweep=None, neighborlist=None).bind(jw.system)
    jns = jn.initial_state(
        JaxSamplerState(positions=js.positions, velocities=js.velocities,
                        box_vectors=jw.system.default_box),
        jax.random.PRNGKey(1), global_params=params)
    jns = jn.run(jns, 4)
    tn = AlchemicalNonequilibriumLangevinIntegrator(
        alchemical_functions=funcs, splitting="V R H R V", temperature=300.0,
        collision_rate=0.0, timestep=0.001, n_steps_neq=4, sweep="force",
        sweep_sort_interval=5).bind(tw.system)
    tns = tn.initial_state(tb.sampler_state_from(ts), torch.Generator(),
                           global_params=params)
    tns = tn.run(tns, 4)
    assert float(tns.lambda_) == 1.0 and tns.lambda_step == 4
    assert float(tns.global_params["lambda_electrostatics"]) == 0.0
    w_j = float(jns.protocol_work)
    assert abs(float(tns.protocol_work) - w_j) <= 1e-3 * abs(w_j)
    assert np.abs(np64(tns.positions) - np64(jns.positions)).max() < 1e-3
    assert tb._sweep_kernel.launches == tn._sweep_kernel.launches == {
        "sweep_bound": 0, "sweep_forces_alch": 0}


def test_bound_integrator_does_not_fuse_on_cpu():
    """The fused kernel is CUDA-only; on the CPU the generic program serves
    (as the JAX package's TPU-only fused path does off the TPU)."""
    f = LennardJonesFluid(nparticles=N, device="cpu")
    bound = BAOABIntegrator(temperature=120.0, collision_rate=1.0,
                            timestep=0.002).bind(f.system)
    assert bound.force_path.name != "K1"


def test_port_never_imports_jax():
    """No module of the port, and not chip_smoke.py, which drives it on the
    card, imports jax or the JAX package (read from the source: this test
    process has both imported already)."""
    root = pathlib.Path(openmmtools_tpu_torch.__file__).parent
    offenders = []
    files = sorted(root.rglob("*.py"))
    assert len(files) >= 15
    smoke = root.parent / "chip_smoke.py"
    assert smoke.exists()
    for name in ("models/amber.py", "scripts/benchmark_dhfr.py",
                 "scripts/benchmark_remd.py"):
        assert root / name in files, name
    for path in files + [smoke]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "openmmtools_tpu"):
                    offenders.append(f"{path.relative_to(root.parent)}: {name}")
    assert not offenders, offenders
