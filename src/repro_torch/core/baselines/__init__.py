"""Engine specs beside FedCET (port of ``src/repro/core/baselines/``):
NIDS in this slice. FedAvg, SCAFFOLD, FedTrack/FedLin, FedProx and FedDyn
are not ported yet (ROADMAP Queue 1 items 4 and 9)."""

from repro_torch.core.baselines.nids import NIDS, NIDSState

__all__ = ["NIDS", "NIDSState"]
