"""Fault-tolerance runtime (counterpart of ``repro.runtime``)."""
from repro_torch.runtime.fault import (FailureInjector, StragglerMonitor,
                                       supervise)

__all__ = ["FailureInjector", "StragglerMonitor", "supervise"]
