"""Plain PyTorch twins of the JAX package's reference attention functions.

Counterpart of ``modal_examples_tpu/ops/reference.py`` (``attention``,
``attention_with_lse``, ``attention_chunked``, ``paged_decode_attention``)
plus ``paged_decode_attention_inflight`` from
``modal_examples_tpu/ops/paged_attention.py``, the exact-match target of the
ragged decode kernel. Numerics follow the JAX versions: products of the
inputs accumulate in f32, the softmax is f32, and probabilities are rounded
to the value dtype before the P.V product.
"""

from __future__ import annotations

import torch

from .kv_quant import kv_gather


def _scale(D: int, sm_scale: float | None) -> float:
    return D**-0.5 if sm_scale is None else sm_scale


def _grouped_scores(q, k, sm_scale):
    """[B, Hq, Sq, D] x [B, Hkv, Skv, D] -> f32 scores [B, Hkv, G, Sq, Skv]."""
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    qg = q.reshape(B, Hkv, Hq // Hkv, Sq, D).float()
    return torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * _scale(D, sm_scale)


def _pv(p, v, out_shape):
    o = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    return o.to(v.dtype).reshape(out_shape)


def _causal_mask(s, q_offset: int):
    Sq, Skv = s.shape[-2], s.shape[-1]
    rows = q_offset + torch.arange(Sq, device=s.device)[:, None]
    cols = torch.arange(Skv, device=s.device)[None, :]
    return s.masked_fill(rows < cols, float("-inf"))


def attention(q, k, v, *, causal: bool = True, sm_scale: float | None = None):
    """Dense softmax attention with GQA (Hq a multiple of Hkv)."""
    s = _grouped_scores(q, k, sm_scale)
    if causal:
        s = _causal_mask(s, 0)
    return _pv(torch.softmax(s, dim=-1), v, q.shape)


def attention_with_lse(q, k, v, *, causal: bool = True, sm_scale: float | None = None):
    """Dense attention also returning the per-row logsumexp [B, Hq, S]."""
    B, Hq, S, _ = q.shape
    s = _grouped_scores(q, k, sm_scale)
    if causal:
        s = _causal_mask(s, 0)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return _pv(p, v, q.shape), lse.reshape(B, Hq, S)


def attention_chunked(q, k, v, *, q_offset: int, sm_scale: float | None = None):
    """Rectangular causal attention: queries at q_offset.. against K/V from 0."""
    s = _causal_mask(_grouped_scores(q, k, sm_scale), q_offset)
    return _pv(torch.softmax(s, dim=-1), v, q.shape)


def paged_decode_attention(
    q,  # [B, Hq, D]: one new token per sequence
    k_pages,  # [P, page_size, Hkv, D]: one layer's pages
    v_pages,
    page_tables,  # [B, pages_per_seq] int32
    context_lens,  # [B] int32: tokens in the cache, the current one included
    *,
    sm_scale: float | None = None,
):  # [B, Hq, D]
    """Decode attention over one layer's paged cache, the current token
    already written. int8 pages (:class:`~.kv_quant.QuantizedKV`) are
    dequantized in the gather at the query's dtype."""
    B, Hq, D = q.shape
    _, ps, Hkv, _ = k_pages.shape
    pps = page_tables.shape[1]
    S = pps * ps
    ks = kv_gather(k_pages, page_tables.long(), dtype=q.dtype)  # [B, pps, ps, Hkv, D]
    vs = kv_gather(v_pages, page_tables.long(), dtype=q.dtype)
    ks = ks.permute(0, 3, 1, 2, 4).reshape(B, Hkv, S, D)
    vs = vs.permute(0, 3, 1, 2, 4).reshape(B, Hkv, S, D)
    s = _grouped_scores(q[:, :, None], ks, sm_scale)  # [B, Hkv, G, 1, S]
    valid = torch.arange(S, device=q.device)[None, :] < context_lens.to(q.device)[:, None]
    s = s.masked_fill(~valid[:, None, None, None], float("-inf"))
    return _pv(torch.softmax(s, dim=-1), vs, q.shape)


def paged_decode_attention_inflight(
    q,  # [B, Hq, D]
    ks,  # [B, pages_per_seq, page_size, Hkv, D] gathered pages
    vs,
    prefix_lens,  # [B] int32: tokens already in the cache
    k_new,  # [B, Hkv, D]: the current token's K, not yet written
    v_new,
    *,
    sm_scale: float | None = None,
):  # [B, Hq, D]
    """Decode attention over the cached prefix plus the in-flight token, as
    one softmax (the in-flight token is the last column)."""
    B, Hq, D = q.shape
    _, pps, ps, Hkv, _ = ks.shape
    G = Hq // Hkv
    scale = _scale(D, sm_scale)
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bpthd->bhgpt", qg, ks.float()) * scale
    pos = torch.arange(pps * ps, device=q.device).reshape(pps, ps)
    valid = pos[None] < prefix_lens.to(q.device)[:, None, None]  # [B, pp, ps]
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    flat = s.reshape(B, Hkv, G, pps * ps)
    s_new = torch.einsum("bhgd,bhd->bhg", qg, k_new.to(ks.dtype).float())[..., None] * scale
    p = torch.softmax(torch.cat([flat, s_new], dim=-1), dim=-1)
    p_prefix = p[..., :-1].reshape(s.shape).to(vs.dtype)
    p_new = p[..., -1]
    o = torch.einsum("bhgpt,bpthd->bhgd", p_prefix.float(), vs.float())
    o = o + p_new[..., None] * v_new.to(vs.dtype).float()[:, :, None, :]
    return o.reshape(B, Hq, D).to(q.dtype)
