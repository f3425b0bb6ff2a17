from .fused_block import FusedChainWeights, fused_rdb_chain, fused_rdb_chain_reference

__all__ = ["FusedChainWeights", "fused_rdb_chain", "fused_rdb_chain_reference"]
