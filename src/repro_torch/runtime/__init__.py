from repro_torch.runtime.chaos import (FaultEvent, FaultKind, FaultSchedule,
                                       InjectedCrash, InjectedFault)
from repro_torch.runtime.fault import (PreemptionHandler, RestartableLoop,
                                       StragglerMonitor)

__all__ = ["PreemptionHandler", "StragglerMonitor", "RestartableLoop",
           "FaultSchedule", "FaultKind", "FaultEvent", "InjectedFault",
           "InjectedCrash"]
