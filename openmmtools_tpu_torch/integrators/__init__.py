"""Integrators: the Langevin operator-splitting language, the integrators
outside it (Nosé–Hoover, Andersen, Metropolis MC, HMC, MTS, the no-op), the
nonequilibrium (NCMC) integrators and the minimizers."""

from openmmtools_tpu_torch.integrators.extras import (  # noqa: F401
    AndersenVelocityVerletIntegrator,
    DummyIntegrator,
    HMCIntegrator,
    MetropolisMonteCarloIntegrator,
    MTSIntegrator,
    NoseHooverChainVelocityVerletIntegrator,
)

from openmmtools_tpu_torch.integrators.langevin import (  # noqa: F401
    BAOABIntegrator,
    BoundIntegrator,
    GeodesicBAOABIntegrator,
    GHMCIntegrator,
    IntegratorError,
    IntegratorState,
    LangevinIntegrator,
    VelocityVerletIntegrator,
    VVVRIntegrator,
    parse_splitting,
    thermalize_velocities,
)
from openmmtools_tpu_torch.integrators.minimize import (  # noqa: F401
    FIREMinimizationIntegrator,
    GradientDescentMinimizationIntegrator,
    fire_minimize,
    gradient_descent_minimize,
    lbfgs_minimize,
    minimize,
)
from openmmtools_tpu_torch.integrators.nonequilibrium import (  # noqa: F401
    AlchemicalNonequilibriumLangevinIntegrator,
    BoundNonequilibriumIntegrator,
    ExternalPerturbationLangevinIntegrator,
    NonequilibriumLangevinIntegrator,
    PeriodicNonequilibriumIntegrator,
)
