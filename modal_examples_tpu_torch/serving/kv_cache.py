"""Paged KV cache: device pages plus a host-side page allocator.

Counterpart of ``modal_examples_tpu/serving/kv_cache.py``: ``PageAllocator``
(a free list over page ids, page 0 reserved as the trash page that padded and
dead slots write) and ``PagedKVCache`` (``[L, P, page_size, Hkv, D]`` K and V
pages: two tensors, or for ``kv_dtype="int8"`` two :class:`QuantizedKV`,
four tensors in all). Each sequence claims its whole page budget at
admission, so decode never runs out mid-flight. ``occupancy()`` is the
snapshot admission control and ``/metrics`` read (pages used, free and
usable, the allocated fraction, and the bytes it pins); every ``alloc`` and
``free`` refreshes the page gauges (``mtpu_kv_pages_used``,
``mtpu_kv_pages_free``, ``mtpu_kv_page_occupancy``).
"""

from __future__ import annotations

import dataclasses
import threading

import torch

from ..observability import metrics as _obs
from ..ops.kv_quant import QuantizedKV, is_quantized, kv_dtype_name, kv_empty


class OutOfPages(RuntimeError):
    pass


class PageAllocator:
    """Thread-safe free list over physical page ids (page 0 is reserved).

    Every alloc and free refreshes the page gauges; allocators in one
    process share them last-writer-wins, and ``track=False`` opts one out."""

    def __init__(self, n_pages: int, *, track: bool = True):
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, 0, -1))  # pop() yields low ids first
        self._lock = threading.Lock()
        self._track = track

    def _emit_gauges_locked(self) -> None:
        if not self._track:
            return
        usable = self.n_pages - 1  # page 0 is the reserved trash page
        free = len(self._free)
        _obs.set_kv_occupancy(used=usable - free, free=free, total_usable=usable)

    def alloc(self, n: int) -> list[int]:
        with self._lock:
            if n > len(self._free):
                raise OutOfPages(f"need {n} pages, {len(self._free)} free")
            out = [self._free.pop() for _ in range(n)]
            self._emit_gauges_locked()
            return out

    def free(self, pages: list[int]) -> None:
        with self._lock:
            self._free.extend(p for p in pages if p != 0)
            self._emit_gauges_locked()

    @property
    def available(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used(self) -> int:
        with self._lock:
            return (self.n_pages - 1) - len(self._free)

    @property
    def occupancy(self) -> float:
        """Allocated fraction of the usable pool (0..1)."""
        usable = self.n_pages - 1
        return self.used / usable if usable > 0 else 0.0


@dataclasses.dataclass
class PagedKVCache:
    k_pages: torch.Tensor | QuantizedKV  # [L, P, page_size, Hkv, D]
    v_pages: torch.Tensor | QuantizedKV
    page_size: int
    allocator: PageAllocator

    @classmethod
    def create(
        cls, *, n_layers: int, n_kv_heads: int, head_dim: int, n_pages: int,
        page_size: int = 16, kv_dtype="bfloat16", device,
    ) -> "PagedKVCache":
        shape = (n_layers, n_pages, page_size, n_kv_heads, head_dim)
        return cls(
            k_pages=kv_empty(shape, kv_dtype, device),
            v_pages=kv_empty(shape, kv_dtype, device),
            page_size=page_size,
            allocator=PageAllocator(n_pages),
        )

    @property
    def n_pages(self) -> int:
        return self.k_pages.shape[1]

    @property
    def kv_dtype(self) -> str:
        """Reporting name of the page dtype: "int8" or the tensor dtype's name."""
        return kv_dtype_name(self.k_pages)

    @property
    def quantized(self) -> bool:
        return is_quantized(self.k_pages)

    def bytes(self) -> int:
        """Device bytes of the pages: int8 caches count their payload plus the
        f32 scales (about half the bf16 figure at D=128)."""
        return self.k_pages.nbytes + self.v_pages.nbytes

    def occupancy(self) -> dict:
        """Page-pool snapshot: used, free and usable pages (page 0 is the
        trash page), the allocated fraction, and the device bytes that
        fraction pins (dtype-aware through :meth:`bytes`)."""
        usable = self.n_pages - 1
        free = self.allocator.available
        used = usable - free
        bytes_per_page = self.bytes() // self.n_pages
        return {
            "pages_used": used,
            "pages_free": free,
            "pages_total": usable,
            "occupancy": used / usable if usable > 0 else 0.0,
            "bytes_used": used * bytes_per_page,
            "bytes_total": self.bytes(),
        }

    def pages_for(self, n_tokens: int) -> int:
        return (n_tokens + self.page_size - 1) // self.page_size
