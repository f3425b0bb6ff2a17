from .device import resolve_device
from .profiling import StepTimer, trace

__all__ = ["StepTimer", "resolve_device", "trace"]
