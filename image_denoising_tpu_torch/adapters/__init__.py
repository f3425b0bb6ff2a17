from .memory_adapters import (
    MEMORY_ADAPTERS,
    GlobalMonotoneToneCurveAdapter,
    HyperGatedResidualAdapter,
    HyperGatedResidualAdapterFFT,
    LowFrequencyBlendAdapter,
    MemoryResidualAdapter,
    build_memory_adapter,
)
from .output_adapter import OutputAdapter
from .wrappers import (
    DenoiserWithAdapter,
    DenoiserWithMemoryAdapter,
    batched_select_memory_patch,
    select_memory_patch,
)

__all__ = [
    "OutputAdapter",
    "MemoryResidualAdapter",
    "LowFrequencyBlendAdapter",
    "GlobalMonotoneToneCurveAdapter",
    "HyperGatedResidualAdapter",
    "HyperGatedResidualAdapterFFT",
    "MEMORY_ADAPTERS",
    "build_memory_adapter",
    "DenoiserWithAdapter",
    "DenoiserWithMemoryAdapter",
    "batched_select_memory_patch",
    "select_memory_patch",
]
