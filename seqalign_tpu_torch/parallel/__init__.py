"""Multi-device and multi-host search, and the sequence-parallel long
pair: the port of ``seqalign_tpu.parallel``."""

from .longpair import sw_longpair
from .multidevice import deal_chunks, multi_device_search
from .multihost import (
    host_stripe,
    init_distributed,
    merge_topk_candidates,
    multihost_search,
)
from .sharding import make_mesh, shard_db, sharded_engine, sharded_topk

__all__ = [
    "deal_chunks",
    "host_stripe",
    "init_distributed",
    "make_mesh",
    "merge_topk_candidates",
    "multi_device_search",
    "multihost_search",
    "shard_db",
    "sharded_engine",
    "sharded_topk",
    "sw_longpair",
]
