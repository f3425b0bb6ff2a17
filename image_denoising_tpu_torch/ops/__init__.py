from .fused_block import FusedChainWeights, fused_rdb_chain, fused_rdb_chain_reference
from .neighbor import (generate_mask_pair, generate_subimages, subsample_pair,
                       subsample_pair_fused)
from .noise import AugmentNoise
from .rng import OperationSeed, philox4x32_10, split_seed
from .space_to_depth import depth_to_space, space_to_depth

__all__ = [
    "AugmentNoise",
    "FusedChainWeights",
    "OperationSeed",
    "depth_to_space",
    "fused_rdb_chain",
    "fused_rdb_chain_reference",
    "generate_mask_pair",
    "generate_subimages",
    "philox4x32_10",
    "space_to_depth",
    "split_seed",
    "subsample_pair",
    "subsample_pair_fused",
]
