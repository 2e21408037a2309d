from .pipeline import Prefetcher, SyntheticTokens, host_shard_info

__all__ = ["Prefetcher", "SyntheticTokens", "host_shard_info"]
