from repro_torch.runtime.health import Heartbeat, StepMonitor

__all__ = ["Heartbeat", "StepMonitor"]
