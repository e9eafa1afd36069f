"""Online serving: cross-request coalesced SSD command blocks — see
``repro_torch.serving.engine`` and ``python -m repro_torch.launch.serve``."""

from repro_torch.serving.cache import HotVertexCache
from repro_torch.serving.engine import ServeResult, ServingEngine
from repro_torch.serving.queue import RequestQueue, ServeRequest

__all__ = ["HotVertexCache", "RequestQueue", "ServeRequest", "ServeResult",
           "ServingEngine"]
