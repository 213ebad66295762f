"""The flagship free-energy workflow on the port, on the CPU
(``tests/test_alchemical_workflow.py``'s three tests, at their sizes and
bounds).

The seam: a softcore alchemical system (``AbsoluteAlchemicalFactory``) ->
a ladder of ``CompoundThermodynamicState`` -> ``ReplicaExchangeSampler`` ->
``MultiStateReporter`` -> ``MultiStateSamplerAnalyzer``'s MBAR free
energy. LJ-64 at reduced density 0.30 and 120 K, particle 0 decoupled
over 5 lambda_sterics states.

* The analyzer's Delta G agrees with the port's Widom insertion oracle
  (``demo_free_energy.route_c_widom``, which shares no ladder or MBAR
  machinery with the workflow) within max(4 sigma, 0.5) kT.
* The ladder survives storage, and 6 + 6 iterations across a resume equal
  12 straight ones bit for bit.
* A two-region ladder (two suffixed ``AlchemicalState``\\ s), run in
  float64: its energy matrix at the port's final positions equals the JAX
  package's ``reduced_potential`` of the same positions and parameters at
  rel 1e-10, and its suffixed ladders survive a resume.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmmtools_tpu_torch import alchemy as talch
from openmmtools_tpu_torch.alchemy import (
    AbsoluteAlchemicalFactory,
    AlchemicalRegion,
    AlchemicalState,
)
from openmmtools_tpu_torch.mcmc import LangevinSplittingDynamicsMove
from openmmtools_tpu_torch.models import LennardJonesFluid
from openmmtools_tpu_torch.multistate import (
    MultiStateReporter,
    MultiStateSamplerAnalyzer,
    ReplicaExchangeSampler,
)
from openmmtools_tpu_torch.scripts.demo_free_energy import route_c_widom
from openmmtools_tpu_torch.states import (
    CompoundThermodynamicState,
    SamplerState,
    ThermodynamicState,
    create_thermodynamic_state_protocol,
)

pytest.importorskip("h5py")

TEMP = 120.0
N_PARTICLES = 64
DENSITY = 0.30
N_STATES = 5


def _fluid():
    return LennardJonesFluid(nparticles=N_PARTICLES, reduced_density=DENSITY,
                             device="cpu")


def _build_ladder():
    """The LJ fluid with particle 0 decoupled through a softcore sterics
    ladder (the demo's route A, cut for the tests)."""
    fluid = _fluid()
    alch_system = AbsoluteAlchemicalFactory().create_alchemical_system(
        fluid.system, AlchemicalRegion(alchemical_atoms=[0]))
    compound = CompoundThermodynamicState(
        base_state=ThermodynamicState(alch_system, TEMP),
        composable_states=[AlchemicalState(lambda_sterics=1.0,
                                           lambda_electrostatics=1.0)])
    states = create_thermodynamic_state_protocol(
        compound, {"lambda_sterics": np.linspace(1.0, 0.0, N_STATES)},
        constants={"lambda_electrostatics": 1.0})
    return fluid, compound, states


def _move(n_steps):
    return LangevinSplittingDynamicsMove(timestep=0.002, collision_rate=1.0,
                                         n_steps=n_steps)


def test_alchemical_ladder_remd_mbar_vs_widom(tmp_path):
    """factory -> compound ladder -> REMD -> reporter -> analyzer: Delta G
    agrees with the Widom oracle. Fails if the sampler, compound-state
    and softcore seam breaks (the lambdas wired wrongly, the energy matrix
    blind to the alchemical parameters, the analyzer misreading the
    ladder)."""
    fluid, compound, states = _build_ladder()
    reporter = MultiStateReporter(str(tmp_path / "alch.h5"),
                                  checkpoint_interval=100)
    sampler = ReplicaExchangeSampler(
        mcmc_moves=_move(50), number_of_iterations=400,
        online_analysis_interval=None, iterations_per_sync=50, rng_seed=2)
    sampler.create(states, [SamplerState(positions=fluid.positions)]
                   * N_STATES, storage=reporter)
    assert sampler.propagation_route == "batched"
    sampler.run()
    assert int(sampler._n_accepted.sum()) > 0

    analyzer = MultiStateSamplerAnalyzer(reporter)
    df, ddf = analyzer.get_free_energy()
    dg_ladder = float(df[0, N_STATES - 1])
    ddg_ladder = float(ddf[0, N_STATES - 1])
    assert np.isfinite(dg_ladder) and ddg_ladder > 0

    # route_c_widom gives f(1) - f(0) = beta mu_ex; the ladder's Delta G
    # runs from coupled to decoupled: -beta mu_ex
    f_widom, ddg_widom, _ = route_c_widom(
        fluid, compound, seed=33, n_snapshots=300, steps_between=100,
        n_insertions=32, n_eq=2000)
    dg_widom = -f_widom
    sigma = max(np.hypot(ddg_ladder, ddg_widom), 0.05)
    assert abs(dg_ladder - dg_widom) < max(4 * sigma, 0.5), (
        f"ladder dG={dg_ladder:.3f}+-{ddg_ladder:.3f} vs "
        f"Widom {dg_widom:.3f}+-{ddg_widom:.3f} kT")
    reporter.close()


def _lambdas(sampler, name):
    return [float(ts.global_params[name])
            for ts in sampler._thermodynamic_states]


def test_alchemical_sampler_resume_roundtrip(tmp_path):
    """The alchemical ladder survives checkpoint and resume: the lambdas
    round-trip through storage and the resumed sampler continues bit for
    bit (multistatesampler.py:264)."""
    fluid, _, states = _build_ladder()

    def fresh(storage=None):
        s = ReplicaExchangeSampler(
            mcmc_moves=_move(10), number_of_iterations=12,
            online_analysis_interval=None, rng_seed=9)
        s.create(states, [SamplerState(positions=fluid.positions)]
                 * N_STATES, storage=storage)
        return s

    sampler_a = fresh()
    sampler_a.run()

    path = str(tmp_path / "alch-resume.h5")
    sampler_b = fresh(storage=MultiStateReporter(path, checkpoint_interval=1))
    sampler_b.run(6)
    sampler_b._reporter.close()

    resumed = ReplicaExchangeSampler.from_storage(
        MultiStateReporter(path, checkpoint_interval=1), device="cpu")
    np.testing.assert_allclose(_lambdas(resumed, "lambda_sterics"),
                               np.linspace(1.0, 0.0, N_STATES), atol=1e-6)
    resumed.run(6)
    assert resumed.iteration == 12
    for a, b in zip(sampler_a.sampler_states, resumed.sampler_states):
        assert torch.equal(a.positions, b.positions)
        assert torch.equal(a.velocities, b.velocities)
    np.testing.assert_array_equal(sampler_a.energies_last_iteration,
                                  resumed.energies_last_iteration)
    np.testing.assert_array_equal(sampler_a.replica_states,
                                  resumed.replica_states)
    resumed._reporter.close()


def test_two_region_ladder_energy_matrix_and_resume(tmp_path):
    """Two suffixed AlchemicalStates drive independent lambda ladders
    through CompoundThermodynamicState -> REMD (float64). The energy
    matrix equals the JAX package's reduced potential of the same
    positions at the same suffixed parameters, and the suffixed ladders
    survive a resume (alchemy.py:1693-1720, test_alchemy.py:2139)."""
    from openmmtools_tpu import alchemy as jalch
    from openmmtools_tpu import states as jstates
    from openmmtools_tpu.models import LennardJonesFluid as JaxLJ

    from test_torch_support import jax_f64

    def two_regions(module):
        return [module.AlchemicalRegion(alchemical_atoms=[0], name="a"),
                module.AlchemicalRegion(alchemical_atoms=[1], name="b")]

    fluid = _fluid()
    system = AbsoluteAlchemicalFactory().create_alchemical_system(
        fluid.system, two_regions(talch)).to(dtype=torch.float64)
    compound = CompoundThermodynamicState(
        base_state=ThermodynamicState(system, TEMP),
        composable_states=[AlchemicalState(parameters_name_suffix="a"),
                           AlchemicalState(parameters_name_suffix="b")])
    lams = np.linspace(1.0, 0.2, 4)
    ladder = {"lambda_sterics_a": lams, "lambda_sterics_b": lams[::-1]}
    states = create_thermodynamic_state_protocol(
        compound, ladder, constants={"lambda_electrostatics_a": 1.0,
                                     "lambda_electrostatics_b": 1.0})

    path = str(tmp_path / "tworeg.h5")
    sampler = ReplicaExchangeSampler(
        mcmc_moves=_move(10), number_of_iterations=6,
        online_analysis_interval=None, rng_seed=4)
    x0 = fluid.positions.to(torch.float64)
    sampler.create(states, [SamplerState(positions=x0)] * 4,
                   storage=MultiStateReporter(path, checkpoint_interval=1))
    sampler.run()
    u_port = sampler.energies_last_iteration
    assert u_port.dtype == np.float64 and u_port.shape == (4, 4)

    # the JAX package's reduced potential of the port's final positions at
    # each state's explicit suffixed parameters
    jfluid = JaxLJ(nparticles=N_PARTICLES, reduced_density=DENSITY)
    jsystem = jax_f64(jalch.AbsoluteAlchemicalFactory()
                      .create_alchemical_system(jfluid.system,
                                                two_regions(jalch)))
    jbase = jstates.ThermodynamicState(jsystem, jnp.asarray(TEMP))
    for r, ss in enumerate(sampler.sampler_states):
        jss = jstates.SamplerState(positions=jnp.asarray(
            ss.positions.numpy()))
        for j, (la, lb) in enumerate(zip(lams, lams[::-1])):
            u_jax = float(jbase.replace(global_params={
                **jbase.global_params,
                "lambda_sterics_a": la, "lambda_sterics_b": lb,
                "lambda_electrostatics_a": 1.0,
                "lambda_electrostatics_b": 1.0}).reduced_potential(jss))
            assert abs(u_port[r, j] - u_jax) <= 1e-10 * max(abs(u_jax),
                                                            1.0), \
                (r, j, u_port[r, j], u_jax)
    sampler._reporter.close()

    resumed = ReplicaExchangeSampler.from_storage(
        MultiStateReporter(path, checkpoint_interval=1), device="cpu")
    for name, expect in ladder.items():
        np.testing.assert_allclose(_lambdas(resumed, name), expect,
                                   atol=1e-6)
    resumed.extend(2)
    assert resumed.iteration == 8
    assert np.all(np.isfinite(resumed.energies_last_iteration))
    resumed._reporter.close()
