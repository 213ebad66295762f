"""Multistate samplers: replica exchange, SAMS, parallel tempering, storage
and analysis (counterpart of ``multistate/``).

Replicas propagate through their states' moves in a host loop; the N x K
reduced-potential matrix takes the path of the moves' bound integrator
(sweep mode on a large system, K1's force kernel on the fused LJ path);
mixing, MBAR and the SAMS adaptation run on the host on CPU tensors.
"""

from openmmtools_tpu_torch.multistate.mbar import MBARResult, mbar_free_energies
from openmmtools_tpu_torch.multistate.utils import (
    SimulationNaNError,
    detect_equilibration,
    statistical_inefficiency,
    subsample_correlated_data,
)
from openmmtools_tpu_torch.multistate.sampler import MultiStateSampler
from openmmtools_tpu_torch.multistate.replicaexchange import (
    ReplicaExchangeSampler,
)
from openmmtools_tpu_torch.multistate.sams import SAMSSampler
from openmmtools_tpu_torch.multistate.paralleltempering import (
    ParallelTemperingSampler,
)
from openmmtools_tpu_torch.multistate.reporter import MultiStateReporter
from openmmtools_tpu_torch.multistate.analyzer import (
    MultiStateSamplerAnalyzer,
    ParallelTemperingAnalyzer,
    ReplicaExchangeAnalyzer,
    SAMSAnalyzer,
)

__all__ = [
    "mbar_free_energies", "MBARResult",
    "statistical_inefficiency", "detect_equilibration",
    "subsample_correlated_data", "SimulationNaNError",
    "MultiStateSampler", "ReplicaExchangeSampler", "SAMSSampler",
    "ParallelTemperingSampler", "MultiStateReporter",
    "MultiStateSamplerAnalyzer", "ReplicaExchangeAnalyzer", "SAMSAnalyzer",
    "ParallelTemperingAnalyzer",
]
