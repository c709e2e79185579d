"""Paged-KV storage helpers, bf16/f32 subset.

Counterpart of ``modal_examples_tpu/ops/kv_quant.py`` for plain page arrays:
``kv_empty``, ``kv_gather`` and ``kv_scatter``. The JAX functions return new
arrays; ``kv_scatter`` here writes the pages in place and returns them. The
int8 cache (``QuantizedKV``) is not ported yet.
"""

from __future__ import annotations

import torch

_ALIASES = {"bf16": "bfloat16", "f32": "float32", "fp32": "float32", "f16": "float16"}


def resolve_kv_dtype(kv_dtype) -> torch.dtype:
    """A torch dtype from a dtype or its name ("bfloat16", "bf16", "float32", ...)."""
    if isinstance(kv_dtype, torch.dtype):
        return kv_dtype
    name = str(kv_dtype).lower()
    if name in ("int8", "i8"):
        raise NotImplementedError("the int8 KV cache is not ported yet")
    name = _ALIASES.get(name, name)
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"unknown kv dtype {kv_dtype!r}")
    return dtype


def kv_empty(shape: tuple, kv_dtype, device) -> torch.Tensor:
    """A zeroed cache-page array of ``shape`` = [..., D]."""
    return torch.zeros(shape, dtype=resolve_kv_dtype(kv_dtype), device=device)


def kv_gather(pages, tables, layer=None):
    """``pages[(layer,) tables]``."""
    return pages[tables] if layer is None else pages[layer][tables]


def kv_scatter(pages, update, page_idx, slot):
    """``pages[:, page_idx, slot] = update`` in place; returns ``pages``."""
    pages[:, page_idx, slot] = update.to(pages.dtype)
    return pages
