from .bank import (MemoryBank, build_memory_bank, build_memory_bank_from_frames,
                   extract_patches)
from .retrieval import (KEY_ROW_MASK, pad_bank_for_retrieval, top1_l2_retrieval,
                        top1_l2_keys, top1_l2_keys_reference,
                        top1_l2_retrieval_reference)
from .sharded import ShardedBank, make_ring_retrieval, shard_bank

__all__ = [
    "KEY_ROW_MASK",
    "MemoryBank",
    "build_memory_bank",
    "build_memory_bank_from_frames",
    "extract_patches",
    "ShardedBank",
    "make_ring_retrieval",
    "pad_bank_for_retrieval",
    "shard_bank",
    "top1_l2_keys",
    "top1_l2_keys_reference",
    "top1_l2_retrieval",
    "top1_l2_retrieval_reference",
]
