"""Paged-cache kernels: ragged decode attention (``csrc/paged_decode.cu``) and
the KV page scatter (``csrc/kv_scatter.cu``), each beside its plain version.

Counterpart of ``modal_examples_tpu/ops/paged_attention.py``
(``paged_decode_attention_ragged``, ``scatter_kv_pages``,
``ragged_variant_for``). The cache is ``[L, P, page_size, Hkv, D]`` per array,
page 0 being the trash page that padded and dead slots write.

Dispatch is by the tensor's device and nothing else: CPU tensors take the
plain version, CUDA tensors launch the kernel or raise. ``decode_launches``
and ``scatter_launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .kv_quant import kv_gather, kv_scatter
from .reference import paged_decode_attention_inflight

#: kernel launches since the last reset (the main path's proof of use)
decode_launches = 0
scatter_launches = 0

_MAX_DECODE_HEAD_DIM = 256


def ragged_variant_for(n_kv_heads: int, kv_dtype: str = "bfloat16") -> str:
    """The TPU kernel formulation the JAX package would pick ("flat" at
    Hkv % 16 for bf16 / % 32 for int8, else "grouped"). On the card one kernel
    serves every Hkv; the name is kept as a reported label only."""
    mult = 32 if str(kv_dtype) == "int8" else 16
    return "flat" if n_kv_heads % mult == 0 else "grouped"


def _require_cuda(name: str, t, device, dtype=None) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}; got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# -- ragged paged decode attention -------------------------------------------


def paged_decode_plain(q, k_pages, v_pages, layer: int, page_tables, prefix_lens, k_new, v_new, *, sm_scale=None):
    """The kernel's function in plain PyTorch: gather the layer's pages, then
    the in-flight twin (``paged_decode_attention_inflight``)."""
    ks = kv_gather(k_pages, page_tables, layer)
    vs = kv_gather(v_pages, page_tables, layer)
    return paged_decode_attention_inflight(q, ks, vs, prefix_lens, k_new, v_new, sm_scale=sm_scale)


def _decode_lib():
    lib = _build.load("paged_decode")
    fn = lib.paged_decode
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def paged_decode_cuda(q, k_pages, v_pages, layer: int, page_tables, prefix_lens, k_new, v_new, *, sm_scale: float):
    """Launch ``csrc/paged_decode.cu`` on bf16 pages."""
    global decode_launches
    dev = q.device
    bf16 = torch.bfloat16
    _require_cuda("q", q, dev, bf16)
    _require_cuda("k_pages", k_pages, dev, bf16)
    _require_cuda("v_pages", v_pages, dev, bf16)
    _require_cuda("k_new", k_new, dev, bf16)
    _require_cuda("v_new", v_new, dev, bf16)
    _require_cuda("page_tables", page_tables, dev, torch.int32)
    _require_cuda("prefix_lens", prefix_lens, dev, torch.int32)
    B, Hq, D = q.shape
    L, P, ps, Hkv, _ = k_pages.shape
    if D > _MAX_DECODE_HEAD_DIM:
        raise ValueError(f"decode kernel head dim must be <= {_MAX_DECODE_HEAD_DIM}; got {D}")
    out = torch.empty_like(q)
    lib = _decode_lib()
    err = lib.paged_decode(
        _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages), _build.ptr(page_tables),
        _build.ptr(prefix_lens), _build.ptr(k_new), _build.ptr(v_new), _build.ptr(out),
        B, Hq, Hkv, D, layer, P, ps, page_tables.shape[1], sm_scale, _build.stream_ptr(dev),
    )
    decode_launches += 1
    _build.check(lib, "paged_decode", err)
    return out


def paged_decode_attention_ragged(
    q,  # [B, Hq, D]
    k_pages,  # [L, P, page_size, Hkv, D]: the full cache
    v_pages,
    layer: int,  # which layer to attend against
    page_tables,  # [B, pages_per_seq] int32
    prefix_lens,  # [B] int32: tokens already in the cache
    k_new,  # [B, Hkv, D]: current token's K (not yet written)
    v_new,
    *,
    sm_scale: float | None = None,
):  # [B, Hq, D]
    """Ragged decode attention over prefix pages plus the in-flight token;
    equal to ``paged_decode_attention_inflight`` given
    ``ks = k_pages[layer, page_tables]``."""
    B, Hq, D = q.shape
    L, _, _, Hkv, Dk = k_pages.shape
    if Dk != D or v_pages.shape != k_pages.shape:
        raise ValueError(f"pages {tuple(k_pages.shape)} do not match q {tuple(q.shape)}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside [0, {L})")
    scale = D**-0.5 if sm_scale is None else sm_scale
    k_new = k_new.to(k_pages.dtype)
    v_new = v_new.to(v_pages.dtype)
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pages, v_pages, layer, page_tables, prefix_lens, k_new, v_new, sm_scale=scale)
    return paged_decode_cuda(
        q.contiguous(), k_pages, v_pages, layer, page_tables, prefix_lens,
        k_new.contiguous(), v_new.contiguous(), sm_scale=scale,
    )


# -- KV page scatter ------------------------------------------------------------


def scatter_plain(k_pages, v_pages, k_all, v_all, page_idx, slot):
    """The kernel's function in plain PyTorch (``kv_scatter`` on both arrays)."""
    kv_scatter(k_pages, k_all, page_idx, slot)
    kv_scatter(v_pages, v_all, page_idx, slot)
    return k_pages, v_pages


def _scatter_lib():
    lib = _build.load("kv_scatter")
    fn = lib.kv_scatter
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def scatter_cuda(k_pages, v_pages, k_all, v_all, page_idx, slot):
    """Launch ``csrc/kv_scatter.cu``: rows of 16-byte multiples, written in place."""
    global scatter_launches
    dev = k_pages.device
    _require_cuda("k_pages", k_pages, dev)
    _require_cuda("v_pages", v_pages, dev, k_pages.dtype)
    _require_cuda("k_all", k_all, dev, k_pages.dtype)
    _require_cuda("v_all", v_all, dev, k_pages.dtype)
    _require_cuda("page_idx", page_idx, dev, torch.int32)
    _require_cuda("slot", slot, dev, torch.int32)
    L, P, ps, Hkv, D = k_pages.shape
    N = k_all.shape[1]
    row_bytes = Hkv * D * k_pages.element_size()
    if row_bytes % 16:
        raise ValueError(f"scatter kernel needs Hkv*D*itemsize % 16 == 0; got {row_bytes}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages), ("k_all", k_all), ("v_all", v_all)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    lib = _scatter_lib()
    err = lib.kv_scatter(
        _build.ptr(k_pages), _build.ptr(v_pages), _build.ptr(k_all), _build.ptr(v_all),
        _build.ptr(page_idx), _build.ptr(slot), L, N, P, ps, row_bytes, _build.stream_ptr(dev),
    )
    scatter_launches += 1
    _build.check(lib, "kv_scatter", err)
    return k_pages, v_pages


def scatter_kv_pages(
    k_pages,  # [L, P, ps, Hkv, D]
    v_pages,
    k_all,  # [L, N, Hkv, D]: new KV per layer per token
    v_all,
    page_idx,  # [N] int32: target page per token
    slot,  # [N] int32: position within the page
):
    """Write every layer's new KV into the paged cache in place and return the
    (same) page tensors. The JAX version aliased its inputs to the outputs of
    the pallas_call; here the update is in place. Same semantics as
    ``pages[:, page_idx, slot] = new`` for distinct targets; dead tokens all
    aimed at trash page 0 slot 0 may race, which is harmless."""
    L, N, Hkv, D = k_all.shape
    if k_pages.shape[0] != L or k_pages.shape[3:] != (Hkv, D) or v_pages.shape != k_pages.shape:
        raise ValueError(f"pages {tuple(k_pages.shape)} do not take rows {tuple(k_all.shape)}")
    if v_all.shape != k_all.shape or page_idx.shape != (N,) or slot.shape != (N,):
        raise ValueError("k_all/v_all/page_idx/slot shapes disagree")
    if k_pages.device.type == "cpu":
        return scatter_plain(k_pages, v_pages, k_all, v_all, page_idx, slot)
    return scatter_cuda(
        k_pages, v_pages, k_all.to(k_pages.dtype).contiguous(), v_all.to(v_pages.dtype).contiguous(),
        page_idx, slot,
    )
