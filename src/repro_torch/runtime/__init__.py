from repro_torch.runtime import trace
from repro_torch.runtime.health import Heartbeat, PreemptionGuard, StepMonitor

__all__ = ["Heartbeat", "PreemptionGuard", "StepMonitor", "trace"]
