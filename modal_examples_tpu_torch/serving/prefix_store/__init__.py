"""The fleet-wide shared prefix store, after
``modal_examples_tpu/serving/prefix_store/``.

One content-addressed, deduplicated KV block store per fleet instead of
one private Volume tier per replica: blocks keyed by chained page hashes,
written once fleet-wide under rendezvous ownership, promotable by any
replica through the MTKV1 wire codec, refcount-GC'd across replicas.
"""

from .ownership import LeaseBoard, rendezvous_owner
from .store import DEFAULT_ROOT, SharedPrefixStore, block_file

__all__ = [
    "DEFAULT_ROOT",
    "LeaseBoard",
    "SharedPrefixStore",
    "block_file",
    "rendezvous_owner",
]
