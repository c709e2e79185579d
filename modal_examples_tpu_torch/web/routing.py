"""Copy of ``modal_examples_tpu/web/routing.py``: request routing by rendezvous (highest-random-weight) hashing.

Reference parity: 07_web/server_sticky.py:16-27 routes each sticky key to a
stable replica via rendezvous hashing so stateful servers (KV caches,
conversations) see consistent traffic; replicas joining/leaving only move the
keys they own. ``@app.server(sticky_header=...)`` uses this to pick the
replica for a request.
"""

from __future__ import annotations

import hashlib


def _weight(key: str, node: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(f"{key}\x00{node}".encode(), digest_size=8).digest(), "big"
    )


def rendezvous_pick(key: str, nodes: list[str]) -> str:
    """The node owning ``key``: argmax over hash(key, node)."""
    if not nodes:
        raise ValueError("no nodes to route to")
    return max(nodes, key=lambda n: _weight(key, n))


def rendezvous_rank(key: str, nodes: list[str]) -> list[str]:
    """All nodes ordered by preference for ``key`` (failover order)."""
    return sorted(nodes, key=lambda n: _weight(key, n), reverse=True)
