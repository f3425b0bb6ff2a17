from .bank import (MemoryBank, build_memory_bank, build_memory_bank_from_frames,
                   extract_patches)
from .retrieval import (pad_bank_for_retrieval, top1_l2_retrieval,
                        top1_l2_retrieval_reference)

__all__ = [
    "MemoryBank",
    "build_memory_bank",
    "build_memory_bank_from_frames",
    "extract_patches",
    "pad_bank_for_retrieval",
    "top1_l2_retrieval",
    "top1_l2_retrieval_reference",
]
