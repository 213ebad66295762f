"""Model catalog: the analytic, LJ and water test systems ported so far."""

from openmmtools_tpu_torch.models.testsystems import (  # noqa: F401
    HarmonicOscillator,
    LennardJonesFluid,
    LennardJonesFluidSwitched,
    LennardJonesFluidTruncated,
    LennardJonesPair,
    TestSystem,
)
from openmmtools_tpu_torch.models.water import (  # noqa: F401
    AlchemicalWaterBox,
    DischargedWaterBox,
    DischargedWaterBoxHsites,
    FiveSiteWaterBox,
    FlexibleDischargedWaterBox,
    FlexiblePMEWaterBox,
    FlexibleReactionFieldWaterBox,
    FlexibleWaterBox,
    FourSiteWaterBox,
    GiantFlexibleDischargedWaterBox,
    GiantFlexibleWaterBox,
    PMEWaterBox,
    WaterBox,
    WaterCluster,
)
