"""Sharded diverse search over P shards on one device or one shard per
rank of a process group, with elastic resharding between shard counts,
in one process or across the ranks (port of ``repro.sharded_search``)."""
from repro_torch.sharded_search.engine import ShardedEngine
from repro_torch.sharded_search.search import (ShardedIndex, ShardedSearchState,
                                               beam_state_capacity,
                                               build_sharded_index,
                                               exact_rerank_frontier,
                                               index_from_host, index_to_host,
                                               init_sharded_state,
                                               local_shard,
                                               migrate_sharded_state,
                                               reshard_index,
                                               sharded_diverse_resume,
                                               sharded_diverse_search,
                                               sharded_progressive_diverse,
                                               sharded_topk,
                                               sharded_topk_resume,
                                               state_from_host)

__all__ = ["ShardedIndex", "ShardedSearchState", "ShardedEngine",
           "beam_state_capacity", "build_sharded_index",
           "exact_rerank_frontier", "index_from_host", "index_to_host",
           "init_sharded_state", "local_shard", "migrate_sharded_state",
           "reshard_index",
           "sharded_diverse_resume", "sharded_diverse_search",
           "sharded_progressive_diverse", "sharded_topk",
           "sharded_topk_resume", "state_from_host"]
