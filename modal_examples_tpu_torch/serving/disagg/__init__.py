"""Disaggregated prefill/decode serving, after
``modal_examples_tpu/serving/disagg/``: the KV-page transport
(:mod:`.transport`) and role-aware replica coordination (:mod:`.roles`).

A prefill replica computes a prompt's KV and ships the finished pages to a
decode replica, which adopts them into its own paged cache and continues,
so neither phase steals the other's step time. The tiered prefix cache
(``TieredPrefixCache``: HBM, host RAM and ``Volume`` tiers) waits with
ROADMAP A9b.
"""

from .roles import DisaggCoordinator
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
    "TransportError",
    "adopt_pages",
    "deserialize_block",
    "extract_pages",
    "iter_chunks",
    "serialize_block",
    "wire_leaves",
]
