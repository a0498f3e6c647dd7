"""Engine specs beside FedCET (port of ``src/repro/core/baselines/``):
FedAvg, FedDyn, FedLin / FedTrack, FedProx, NIDS and SCAFFOLD."""

from repro_torch.core.baselines.fedavg import FedAvg, FedAvgState
from repro_torch.core.baselines.feddyn import FedDyn, FedDynState
from repro_torch.core.baselines.fedlin import FedLin, FedLinState, FedTrack
from repro_torch.core.baselines.fedprox import FedProx, FedProxState
from repro_torch.core.baselines.nids import NIDS, NIDSState
from repro_torch.core.baselines.scaffold import Scaffold, ScaffoldState

__all__ = ["FedAvg", "FedAvgState", "FedDyn", "FedDynState", "FedLin",
           "FedLinState", "FedProx", "FedProxState", "FedTrack", "NIDS",
           "NIDSState", "Scaffold", "ScaffoldState"]
