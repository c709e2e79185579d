"""Paged-cache kernels: ragged decode attention (``csrc/paged_decode.cu``,
int8 pages ``csrc/paged_decode_int8.cu``), the write-then-attend decode over
one layer's pages (``csrc/paged_decode_writeback.cu``, int8 pages
``csrc/paged_decode_writeback_int8.cu``), all four on one body in
``csrc/paged_decode.cuh``, and the KV page scatter (``csrc/kv_scatter.cu``,
int8 pages ``csrc/kv_scatter_int8.cu``), each beside its plain version.

Counterpart of ``modal_examples_tpu/ops/paged_attention.py``
(``paged_decode_attention_ragged``, ``paged_decode_attention``,
``scatter_kv_pages``, ``ragged_variant_for``). The cache is ``[L, P,
page_size, Hkv, D]`` per array, page 0 being the trash page that padded and
dead slots write; an int8 cache is a :class:`~.kv_quant.QuantizedKV` per
array (int8 data plus f32 scales ``[L, P, page_size, Hkv]``).

Dispatch is by the tensor's device and the cache's kind and nothing else: CPU
tensors take the plain version, CUDA tensors launch the kernel or raise.
``decode_launches``, ``decode_writeback_launches``, ``scatter_launches``,
``decode_int8_launches``, ``decode_writeback_int8_launches`` and
``scatter_int8_launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import reference
from .kv_quant import is_quantized, kv_gather, kv_scatter

#: kernel launches since the last reset (the main path's proof of use)
decode_launches = 0
decode_writeback_launches = 0
scatter_launches = 0
decode_int8_launches = 0
decode_writeback_int8_launches = 0
scatter_int8_launches = 0

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
    """The kernel's function in plain PyTorch: gather the layer's pages (int8
    pages dequantized at the query's dtype), then the in-flight twin
    (``paged_decode_attention_inflight``)."""
    ks = kv_gather(k_pages, page_tables, layer, dtype=q.dtype)
    vs = kv_gather(v_pages, page_tables, layer, dtype=q.dtype)
    return reference.paged_decode_attention_inflight(q, ks, vs, prefix_lens, k_new, v_new, sm_scale=sm_scale)


def _decode_lib():
    lib = _build.load("paged_decode")
    fn = lib.paged_decode
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _split_scratch(lib, name: str, q, Hkv: int, ps: int, pps: int):
    """(splits, workspace, tickets) of a launch of a decode kernel on
    ``csrc/paged_decode.cuh`` (ragged or write-then-attend): the table's
    ``pps * ps`` rows in splits of the kernel's own size, one f32 workspace
    ``[B, Hq, splits, D + 2]`` for the splits' partials, and the per-stream
    ticket buffer of one int a (sequence, kv head)."""
    B, Hq, D = q.shape
    splits = -(-(pps * ps) // getattr(lib, f"{name}_split_rows")())
    work = torch.empty((B, Hq, splits, D + 2), dtype=torch.float32, device=q.device)
    return splits, work, _build.ticket_buffer(name, q.device, B * Hkv)


def _require_rows(name: str, pages, D: int, vec: int) -> None:
    """What the decode kernels' 16-byte copies need: a head's row is
    whole 16-byte pieces (``vec`` values each), and the pages start on a
    16-byte boundary."""
    if D > _MAX_DECODE_HEAD_DIM or D % vec:
        raise ValueError(f"{name} head dim must be a multiple of {vec} up to {_MAX_DECODE_HEAD_DIM}; got {D}")
    if pages.data_ptr() % 16:
        raise ValueError(f"{name} pages must be 16-byte aligned")


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
    for pages in (k_pages, v_pages):
        _require_rows("decode kernel", pages, D, 8)
    out = torch.empty_like(q)
    lib = _decode_lib()
    pps = page_tables.shape[1]
    splits, work, tickets = _split_scratch(lib, "paged_decode", q, Hkv, ps, pps)
    err = lib.paged_decode(
        _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages), _build.ptr(page_tables),
        _build.ptr(prefix_lens), _build.ptr(k_new), _build.ptr(v_new), _build.ptr(out), _build.ptr(work),
        _build.ptr(tickets), B, Hq, Hkv, D, layer, P, ps, pps, splits, sm_scale, _build.stream_ptr(dev),
    )
    decode_launches += 1
    _build.check(lib, "paged_decode", err)
    return out


def paged_decode_int8_plain(q, k_pages, v_pages, layer: int, page_tables, prefix_lens, k_new, v_new, *, sm_scale=None):
    """The int8 kernel's function in plain PyTorch: :func:`paged_decode_plain`
    over int8 pages, dequantized at the query's dtype (``bf16(int8) *
    bf16(scale)`` on the card), with ``k_new``/``v_new`` at that dtype."""
    return paged_decode_plain(q, k_pages, v_pages, layer, page_tables, prefix_lens, k_new, v_new, sm_scale=sm_scale)


def _decode_int8_lib():
    lib = _build.load("paged_decode_int8")
    fn = lib.paged_decode_int8
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def paged_decode_int8_cuda(q, k_pages, v_pages, layer: int, page_tables, prefix_lens, k_new, v_new, *, sm_scale: float):
    """Launch ``csrc/paged_decode_int8.cu`` on int8 pages (:class:`QuantizedKV`)
    with bf16 ``q``/``k_new``/``v_new``."""
    global decode_int8_launches
    dev = q.device
    bf16 = torch.bfloat16
    _require_cuda("q", q, dev, bf16)
    for name, pages in (("k_pages", k_pages), ("v_pages", v_pages)):
        _require_cuda(f"{name}.data", pages.data, dev, torch.int8)
        _require_cuda(f"{name}.scale", pages.scale, dev, torch.float32)
    _require_cuda("k_new", k_new, dev, bf16)
    _require_cuda("v_new", v_new, dev, bf16)
    _require_cuda("page_tables", page_tables, dev, torch.int32)
    _require_cuda("prefix_lens", prefix_lens, dev, torch.int32)
    B, Hq, D = q.shape
    L, P, ps, Hkv, _ = k_pages.shape
    for pages in (k_pages, v_pages):
        _require_rows("int8 decode kernel", pages.data, D, 16)
    out = torch.empty_like(q)
    lib = _decode_int8_lib()
    pps = page_tables.shape[1]
    splits, work, tickets = _split_scratch(lib, "paged_decode_int8", q, Hkv, ps, pps)
    err = lib.paged_decode_int8(
        _build.ptr(q), _build.ptr(k_pages.data), _build.ptr(v_pages.data), _build.ptr(k_pages.scale),
        _build.ptr(v_pages.scale), _build.ptr(page_tables), _build.ptr(prefix_lens), _build.ptr(k_new),
        _build.ptr(v_new), _build.ptr(out), _build.ptr(work), _build.ptr(tickets),
        B, Hq, Hkv, D, layer, P, ps, pps, splits, sm_scale, _build.stream_ptr(dev),
    )
    decode_int8_launches += 1
    _build.check(lib, "paged_decode_int8", err)
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
    ``ks = k_pages[layer, page_tables]``. int8 pages (:class:`QuantizedKV`)
    are dequantized at the query's dtype, and the in-flight token is taken at
    that dtype too (the JAX ``compute_dtype = q.dtype``)."""
    B, Hq, D = q.shape
    L, _, _, Hkv, Dk = k_pages.shape
    if Dk != D or v_pages.shape != k_pages.shape or is_quantized(v_pages) != is_quantized(k_pages):
        raise ValueError(f"pages {tuple(k_pages.shape)} do not match q {tuple(q.shape)}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside [0, {L})")
    scale = D**-0.5 if sm_scale is None else sm_scale
    if is_quantized(k_pages):
        args = (q, k_pages, v_pages, layer, page_tables, prefix_lens, k_new.to(q.dtype), v_new.to(q.dtype))
        if q.device.type == "cpu":
            return paged_decode_int8_plain(*args, sm_scale=scale)
        return paged_decode_int8_cuda(*(a.contiguous() if torch.is_tensor(a) else a for a in args), sm_scale=scale)
    k_new = k_new.to(k_pages.dtype)
    v_new = v_new.to(v_pages.dtype)
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pages, v_pages, layer, page_tables, prefix_lens, k_new, v_new, sm_scale=scale)
    return paged_decode_cuda(
        q.contiguous(), k_pages, v_pages, layer, page_tables, prefix_lens,
        k_new.contiguous(), v_new.contiguous(), sm_scale=scale,
    )


# -- write-then-attend decode attention ---------------------------------------------


def paged_decode_writeback_plain(q, k_pages, v_pages, page_tables, context_lens, *, sm_scale=None):
    """The kernel's function in plain PyTorch: over one layer's pages, the
    first ``context_lens[b]`` rows of each sequence (int8 pages dequantized
    at the query's dtype), ``q * scale`` in f32, an f32 softmax whose
    probabilities stay f32 in the P.V product, divided by the softmax sum; a
    sequence with no context gives zeros."""
    B, Hq, D = q.shape
    _, ps, Hkv, _ = k_pages.shape
    pps = page_tables.shape[1]
    S = pps * ps
    G = Hq // Hkv
    scale = D**-0.5 if sm_scale is None else sm_scale
    ks = kv_gather(k_pages, page_tables.long(), dtype=q.dtype).reshape(B, S, Hkv, D)
    vs = kv_gather(v_pages, page_tables.long(), dtype=q.dtype).reshape(B, S, Hkv, D)
    s = torch.einsum("bhgd,bshd->bhgs", q.reshape(B, Hkv, G, D).float() * scale, ks.float())
    valid = torch.arange(S, device=q.device)[None, :] < context_lens.to(q.device)[:, None]  # [B, S]
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))  # exp(-inf) = 0
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgs,bshd->bhgd", p, vs.float()) / torch.where(l > 0, l, torch.ones_like(l))
    return o.reshape(B, Hq, D).to(q.dtype)


def _decode_writeback_lib():
    lib = _build.load("paged_decode_writeback")
    fn = lib.paged_decode_writeback
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def paged_decode_writeback_cuda(q, k_pages, v_pages, page_tables, context_lens, *, sm_scale: float):
    """Launch ``csrc/paged_decode_writeback.cu`` on one layer's bf16 pages
    ``[P, ps, Hkv, D]`` (a contiguous view of the cache)."""
    global decode_writeback_launches
    dev = q.device
    bf16 = torch.bfloat16
    _require_cuda("q", q, dev, bf16)
    _require_cuda("k_pages", k_pages, dev, bf16)
    _require_cuda("v_pages", v_pages, dev, bf16)
    _require_cuda("page_tables", page_tables, dev, torch.int32)
    _require_cuda("context_lens", context_lens, dev, torch.int32)
    B, Hq, D = q.shape
    P, ps, Hkv, _ = k_pages.shape
    for pages in (k_pages, v_pages):
        _require_rows("writeback decode kernel", pages, D, 8)
    out = torch.empty_like(q)
    lib = _decode_writeback_lib()
    pps = page_tables.shape[1]
    splits, work, tickets = _split_scratch(lib, "paged_decode_writeback", q, Hkv, ps, pps)
    err = lib.paged_decode_writeback(
        _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages), _build.ptr(page_tables),
        _build.ptr(context_lens), _build.ptr(out), _build.ptr(work), _build.ptr(tickets),
        B, Hq, Hkv, D, P, ps, pps, splits, sm_scale, _build.stream_ptr(dev),
    )
    decode_writeback_launches += 1
    _build.check(lib, "paged_decode_writeback", err)
    return out


def paged_decode_writeback_int8_plain(q, k_pages, v_pages, page_tables, context_lens, *, sm_scale=None):
    """The int8 kernel's function in plain PyTorch: the JAX entry's route for
    int8 pages (``reference.paged_decode_attention``: dequantized at the
    query's dtype in the gather, an f32 softmax, probabilities rounded to
    that dtype before P.V); a sequence with no context gives zeros, as the
    kernel's contract says."""
    o = reference.paged_decode_attention(q, k_pages, v_pages, page_tables, context_lens, sm_scale=sm_scale)
    return o.masked_fill((context_lens.to(q.device) <= 0)[:, None, None], 0).to(q.dtype)


def _decode_writeback_int8_lib():
    lib = _build.load("paged_decode_writeback_int8")
    fn = lib.paged_decode_writeback_int8
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def paged_decode_writeback_int8_cuda(q, k_pages, v_pages, page_tables, context_lens, *, sm_scale: float):
    """Launch ``csrc/paged_decode_writeback_int8.cu`` on one layer's int8
    pages (:class:`QuantizedKV` of ``[P, ps, Hkv, D]`` data and ``[P, ps,
    Hkv]`` scales, contiguous views of the cache) with a bf16 ``q``."""
    global decode_writeback_int8_launches
    dev = q.device
    _require_cuda("q", q, dev, torch.bfloat16)
    for name, pages in (("k_pages", k_pages), ("v_pages", v_pages)):
        _require_cuda(f"{name}.data", pages.data, dev, torch.int8)
        _require_cuda(f"{name}.scale", pages.scale, dev, torch.float32)
    _require_cuda("page_tables", page_tables, dev, torch.int32)
    _require_cuda("context_lens", context_lens, dev, torch.int32)
    B, Hq, D = q.shape
    P, ps, Hkv, _ = k_pages.shape
    for pages in (k_pages, v_pages):
        _require_rows("int8 writeback decode kernel", pages.data, D, 16)
    out = torch.empty_like(q)
    lib = _decode_writeback_int8_lib()
    pps = page_tables.shape[1]
    splits, work, tickets = _split_scratch(lib, "paged_decode_writeback_int8", q, Hkv, ps, pps)
    err = lib.paged_decode_writeback_int8(
        _build.ptr(q), _build.ptr(k_pages.data), _build.ptr(v_pages.data), _build.ptr(k_pages.scale),
        _build.ptr(v_pages.scale), _build.ptr(page_tables), _build.ptr(context_lens), _build.ptr(out),
        _build.ptr(work), _build.ptr(tickets), B, Hq, Hkv, D, P, ps, pps, splits, sm_scale, _build.stream_ptr(dev),
    )
    decode_writeback_int8_launches += 1
    _build.check(lib, "paged_decode_writeback_int8", err)
    return out


def paged_decode_attention(
    q,  # [B, Hq, D]
    k_pages,  # [P, page_size, Hkv, D]: one layer's pages
    v_pages,
    page_tables,  # [B, pages_per_seq] int32
    context_lens,  # [B] int32: tokens in the cache, the current one included
    *,
    sm_scale: float | None = None,
    impl: str | None = None,  # "xla" or "pallas": accepted for parity, same function
):  # [B, Hq, D]
    """One decode step of attention over one layer's paged cache, the
    current token already written (the write-then-attend structure).
    ``impl`` names the JAX package's two formulations of this function; both
    launch the same kernel on the card. int8 pages (:class:`QuantizedKV`)
    compute the JAX entry's int8 route (dequantized in the gather,
    probabilities at the query's dtype in P.V): its plain version on the
    CPU, the int8 kernel on the card."""
    if impl not in (None, "xla", "pallas"):
        raise ValueError(f"unknown paged decode impl {impl!r}; known: xla, pallas")
    B, Hq, D = q.shape
    _, _, Hkv, Dk = k_pages.shape
    if Dk != D or v_pages.shape != k_pages.shape or is_quantized(v_pages) != is_quantized(k_pages):
        raise ValueError(f"pages {tuple(k_pages.shape)} do not match q {tuple(q.shape)}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    scale = D**-0.5 if sm_scale is None else sm_scale
    if is_quantized(k_pages):
        if q.device.type == "cpu":
            return paged_decode_writeback_int8_plain(q, k_pages, v_pages, page_tables, context_lens, sm_scale=scale)
        return paged_decode_writeback_int8_cuda(
            q.contiguous(), k_pages, v_pages, page_tables, context_lens, sm_scale=scale
        )
    if q.device.type == "cpu":
        return paged_decode_writeback_plain(q, k_pages, v_pages, page_tables, context_lens, sm_scale=scale)
    return paged_decode_writeback_cuda(q.contiguous(), k_pages, v_pages, page_tables, context_lens, sm_scale=scale)


# -- KV page scatter ------------------------------------------------------------


def scatter_plain(k_pages, v_pages, k_all, v_all, page_idx, slot):
    """The kernel's function in plain PyTorch (``kv_scatter`` on both arrays,
    which quantizes the rows for int8 pages)."""
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


def scatter_int8_plain(k_pages, v_pages, k_all, v_all, page_idx, slot):
    """The int8 kernel's function in plain PyTorch: :func:`scatter_plain` into
    int8 pages, each (layer, token, kv head) row quantized
    (``kv_quant.quantize_kv``) and written as int8 data plus its scale."""
    return scatter_plain(k_pages, v_pages, k_all, v_all, page_idx, slot)


def _scatter_int8_lib():
    lib = _build.load("kv_scatter_int8")
    fn = lib.kv_scatter_int8
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def scatter_int8_cuda(k_pages, v_pages, k_all, v_all, page_idx, slot):
    """Launch ``csrc/kv_scatter_int8.cu``: quantize bf16 rows ``[L, N, Hkv, D]``
    and write them into int8 pages (:class:`QuantizedKV`), in place."""
    global scatter_int8_launches
    dev = k_all.device
    for name, pages in (("k_pages", k_pages), ("v_pages", v_pages)):
        _require_cuda(f"{name}.data", pages.data, dev, torch.int8)
        _require_cuda(f"{name}.scale", pages.scale, dev, torch.float32)
    _require_cuda("k_all", k_all, dev, torch.bfloat16)
    _require_cuda("v_all", v_all, dev, torch.bfloat16)
    _require_cuda("page_idx", page_idx, dev, torch.int32)
    _require_cuda("slot", slot, dev, torch.int32)
    L, P, ps, Hkv, D = k_pages.shape
    N = k_all.shape[1]
    if D % 4 or D > _MAX_DECODE_HEAD_DIM:
        raise ValueError(f"int8 scatter kernel head dim must be a multiple of 4 up to {_MAX_DECODE_HEAD_DIM}; got {D}")
    lib = _scatter_int8_lib()
    err = lib.kv_scatter_int8(
        _build.ptr(k_pages.data), _build.ptr(v_pages.data), _build.ptr(k_pages.scale), _build.ptr(v_pages.scale),
        _build.ptr(k_all), _build.ptr(v_all), _build.ptr(page_idx), _build.ptr(slot),
        L, N, P, ps, Hkv, D, _build.stream_ptr(dev),
    )
    scatter_int8_launches += 1
    _build.check(lib, "kv_scatter_int8", err)
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
    aimed at trash page 0 slot 0 may race, which is harmless. int8 pages
    (:class:`QuantizedKV`) quantize each row at the write (per token-head
    ``amax/127``, as the JAX function does before its pallas_call) and take
    its int8 data and f32 scale: four tensors written."""
    L, N, Hkv, D = k_all.shape
    if k_pages.shape[0] != L or k_pages.shape[3:] != (Hkv, D) or v_pages.shape != k_pages.shape:
        raise ValueError(f"pages {tuple(k_pages.shape)} do not take rows {tuple(k_all.shape)}")
    if v_all.shape != k_all.shape or page_idx.shape != (N,) or slot.shape != (N,):
        raise ValueError("k_all/v_all/page_idx/slot shapes disagree")
    if is_quantized(k_pages) != is_quantized(v_pages):
        raise ValueError("k_pages and v_pages must both be int8 or both plain")
    if is_quantized(k_pages):
        if k_pages.device.type == "cpu":
            return scatter_int8_plain(k_pages, v_pages, k_all, v_all, page_idx, slot)
        return scatter_int8_cuda(k_pages, v_pages, k_all.contiguous(), v_all.contiguous(), page_idx, slot)
    if k_pages.device.type == "cpu":
        return scatter_plain(k_pages, v_pages, k_all, v_all, page_idx, slot)
    return scatter_cuda(
        k_pages, v_pages, k_all.to(k_pages.dtype).contiguous(), v_all.to(v_pages.dtype).contiguous(),
        page_idx, slot,
    )


def scatter_kv_layer(k_pages, v_pages, k_new, v_new, page_idx, slot):
    """Write N tokens' K/V ``[N, Hkv, D]`` into one layer's pages ``[P, ps,
    Hkv, D]`` (a view of the cache) in place: ``kv_scatter(...,
    leading_layer=False)`` on the CPU, the scatter kernel (its int8 kernel
    for int8 pages) over the one-layer view on the card."""
    if k_pages.device.type == "cpu":
        kv_scatter(k_pages, k_new, page_idx, slot, leading_layer=False)
        kv_scatter(v_pages, v_new, page_idx, slot, leading_layer=False)
        return k_pages, v_pages
    scatter_kv_pages(k_pages[None], v_pages[None], k_new[None], v_new[None], page_idx, slot)
    return k_pages, v_pages
