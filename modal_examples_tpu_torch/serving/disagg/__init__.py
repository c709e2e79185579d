"""Disaggregated prefill/decode serving, after
``modal_examples_tpu/serving/disagg/``: the KV-page transport
(:mod:`.transport`), role-aware replica coordination (:mod:`.roles`) and
the tiered prefix cache (:mod:`.tiered_cache`).

A prefill replica computes a prompt's KV and ships the finished pages to a
decode replica, which adopts them into its own paged cache and continues,
so neither phase steals the other's step time. The tiered prefix cache
spills evicted prefix pages HBM -> host RAM -> ``Volume`` over the same
page (de)serialization and promotes them back on demand.
"""

from .roles import DisaggCoordinator
from .tiered_cache import TieredPrefixCache
from .transport import (
    ChunkAssembler,
    PageBlock,
    TransferAborted,
    TransportError,
    adopt_pages,
    deserialize_block,
    extract_pages,
    iter_chunks,
    serialize_block,
    wire_leaves,
)

__all__ = [
    "ChunkAssembler",
    "DisaggCoordinator",
    "PageBlock",
    "TransferAborted",
    "TieredPrefixCache",
    "TransportError",
    "adopt_pages",
    "deserialize_block",
    "extract_pages",
    "iter_chunks",
    "serialize_block",
    "wire_leaves",
]
