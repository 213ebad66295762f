"""Integrators: the Langevin operator-splitting language, the
nonequilibrium (NCMC) integrators and FIRE."""

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
from openmmtools_tpu_torch.integrators.minimize import fire_minimize  # noqa: F401
from openmmtools_tpu_torch.integrators.nonequilibrium import (  # noqa: F401
    AlchemicalNonequilibriumLangevinIntegrator,
    BoundNonequilibriumIntegrator,
    ExternalPerturbationLangevinIntegrator,
    NonequilibriumLangevinIntegrator,
    PeriodicNonequilibriumIntegrator,
)
