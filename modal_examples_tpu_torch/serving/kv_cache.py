"""Paged KV cache: two device tensors plus a host-side page allocator.

Counterpart of ``modal_examples_tpu/serving/kv_cache.py``: ``PageAllocator``
(a free list over page ids, page 0 reserved as the trash page that padded and
dead slots write) and ``PagedKVCache`` (``[L, P, page_size, Hkv, D]`` K and V
tensors). Each sequence claims its whole page budget at admission, so decode
never runs out mid-flight. The int8 cache and the occupancy gauges are not
ported yet.
"""

from __future__ import annotations

import dataclasses
import threading

import torch

from ..ops.kv_quant import kv_empty


class OutOfPages(RuntimeError):
    pass


class PageAllocator:
    """Thread-safe free list over physical page ids (page 0 is reserved)."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, 0, -1))  # pop() yields low ids first
        self._lock = threading.Lock()

    def alloc(self, n: int) -> list[int]:
        with self._lock:
            if n > len(self._free):
                raise OutOfPages(f"need {n} pages, {len(self._free)} free")
            return [self._free.pop() for _ in range(n)]

    def free(self, pages: list[int]) -> None:
        with self._lock:
            self._free.extend(p for p in pages if p != 0)

    @property
    def available(self) -> int:
        with self._lock:
            return len(self._free)



@dataclasses.dataclass
class PagedKVCache:
    k_pages: torch.Tensor  # [L, P, page_size, Hkv, D]
    v_pages: torch.Tensor
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

    def pages_for(self, n_tokens: int) -> int:
        return (n_tokens + self.page_size - 1) // self.page_size
