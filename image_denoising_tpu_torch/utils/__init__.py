from .device import resolve_device
from .profiling import trace

__all__ = ["resolve_device", "trace"]
