"""Paged-KV storage: plain page tensors, or int8 pages with per-token-head
f32 scales (:class:`QuantizedKV`).

Counterpart of ``modal_examples_tpu/ops/kv_quant.py``: ``QuantizedKV``,
``is_quantized``, ``resolve_kv_dtype``, ``kv_dtype_name``, ``quantize_kv``,
``dequantize_kv``, ``kv_empty``, ``kv_gather`` and ``kv_scatter``. The JAX
functions return new arrays; ``kv_scatter`` here writes the pages in place
and returns them (all layers, or one layer's pages with
``leading_layer=False``).

int8 scheme (the JAX package's): pages keep the ``[L, P, page_size, Hkv, D]``
layout in int8 with an f32 scale array ``[L, P, page_size, Hkv]`` beside
them; quantize at write (symmetric ``amax/127`` over D per token and head),
dequantize at read (one multiply at the reader's dtype). Every helper passes
plain page tensors through unchanged.
"""

from __future__ import annotations

import dataclasses

import torch

_QMAX = 127.0
_ALIASES = {"bf16": "bfloat16", "f32": "float32", "fp32": "float32", "f16": "float16"}


@dataclasses.dataclass
class QuantizedKV:
    """int8 KV pages plus per-token-head f32 scales: ``data`` ``[..., D]``
    int8, ``scale`` ``data.shape[:-1]`` f32, ``dequant = data * scale[...,
    None]``. Shape and dtype delegate to ``data`` so shape-probing callers
    work unchanged; callers that read values branch on :func:`is_quantized`."""

    data: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def device(self):
        return self.data.device

    def __getitem__(self, idx) -> "QuantizedKV":
        """Index data and scale together: valid on the leading (non-D) axes
        only, as a layer view ``pages[li]`` or a page gather ``pages[tables]``."""
        return QuantizedKV(data=self.data[idx], scale=self.scale[idx])

    @property
    def nbytes(self) -> int:
        """Device bytes of the int8 payload plus the f32 scales."""
        return self.data.nbytes + self.scale.nbytes


def is_quantized(pages) -> bool:
    return isinstance(pages, QuantizedKV)


def resolve_kv_dtype(kv_dtype):
    """``"int8"`` for the quantized cache ("int8", "i8", ``torch.int8``),
    else a floating torch dtype from a dtype or its name ("bfloat16", "bf16",
    "float32", ...)."""
    if kv_dtype == torch.int8:
        return "int8"
    if isinstance(kv_dtype, torch.dtype):
        return kv_dtype
    name = str(kv_dtype).lower()
    if name in ("int8", "i8"):
        return "int8"
    name = _ALIASES.get(name, name)
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"unknown kv dtype {kv_dtype!r}")
    return dtype


def kv_dtype_name(pages) -> str:
    """Reporting name of a cache tensor: "int8" or the dtype's name."""
    if is_quantized(pages):
        return "int8"
    return str(pages.dtype).removeprefix("torch.")


def quantize_kv(x) -> QuantizedKV:
    """Per-token-head symmetric int8 over the last (D) axis: ``scale =
    amax/127`` (1.0 for an all-zero row, whose dequant is then exactly zero),
    ``data = round(x / scale)`` half to even, clipped to +-127. Both
    divisions are IEEE quotients, as in the JAX function: the divisor is a
    tensor because CUDA's division by a Python scalar multiplies by its
    reciprocal instead."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, _QMAX), torch.ones_like(amax))
    q = torch.round(xf / scale[..., None]).clamp_(-_QMAX, _QMAX).to(torch.int8)
    return QuantizedKV(data=q, scale=scale)


def dequantize_kv(pages, dtype=torch.bfloat16):
    """One multiply at ``dtype``; plain tensors pass through."""
    if not is_quantized(pages):
        return pages
    return pages.data.to(dtype) * pages.scale[..., None].to(dtype)


def kv_empty(shape: tuple, kv_dtype, device):
    """A zeroed cache-page array of ``shape`` = [..., D] at ``kv_dtype``
    ("int8": zero data with unit scales, so its dequant is exactly zero)."""
    kv_dtype = resolve_kv_dtype(kv_dtype)
    if kv_dtype == "int8":
        return QuantizedKV(
            data=torch.zeros(shape, dtype=torch.int8, device=device),
            scale=torch.ones(shape[:-1], dtype=torch.float32, device=device),
        )
    return torch.zeros(shape, dtype=kv_dtype, device=device)


def kv_gather(pages, tables, layer=None, *, dtype=torch.bfloat16):
    """``pages[(layer,) tables]``; int8 pages are dequantized at ``dtype``
    (the scale rounded to ``dtype`` before the multiply). Plain pages gather
    untouched and ignore ``dtype``."""
    if is_quantized(pages):
        view = pages if layer is None else pages[layer]
        return dequantize_kv(view[tables], dtype)
    return pages[tables] if layer is None else pages[layer][tables]


def kv_scatter(pages, update, page_idx, slot, *, leading_layer: bool = True):
    """``pages[:, page_idx, slot] = update`` in place (``pages[page_idx, slot]``
    for one layer's ``[P, ps, Hkv, D]`` pages when ``leading_layer`` is
    False), quantizing the update first for int8 pages (int8 rows plus their
    scales); returns ``pages``."""
    idx = (slice(None), page_idx, slot) if leading_layer else (page_idx, slot)
    if is_quantized(pages):
        q = quantize_kv(update)
        pages.data[idx] = q.data
        pages.scale[idx] = q.scale
        return pages
    pages[idx] = update.to(pages.dtype)
    return pages
