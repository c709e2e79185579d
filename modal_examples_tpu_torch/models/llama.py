"""Llama-family decoder: the training forward, prefill, chunked prefill and
paged decode.

Counterpart of ``modal_examples_tpu/models/llama.py`` (``LlamaConfig``,
``init_params``, ``forward`` for dense models, ``prefill``, ``prefill_chunk``,
``decode_step`` with its ``impl``/``scatter_impl``, ``_decode_step_writeback``,
``tp_shard_ok``, ``paged_impl_plan``). Architecture: RMSNorm, RoPE, GQA,
SwiGLU.

Parameters are a plain dict: ``embed`` [V, D], ``layers`` (a list of per-layer
dicts, weights [in, out] as in the JAX tree), ``final_norm``, and ``lm_head``
[D, V] unless embeddings are tied. :func:`params_from_jax` converts the JAX
tree (layers stacked on axis 0) and is the only place where layout changes.

Structure of the serving functions (the JAX package's read-only-pages
design): attention reads the cache, never writes it; every layer's new K/V
goes into the pages in ONE scatter launch after the last layer. Prefill
attention is the flash kernel; decode attention is the ragged paged kernel
with the in-flight token as an extra softmax column. The writeback impls
of ``decode_step`` keep the JAX package's older write-then-attend structure
instead (one scatter and one attention per layer). Padded positions and
dead slots write trash page 0, slot 0. Cache updates are in place.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from ..ops import flash_attention as _flash
from ..ops import paged_attention as _paged
from ..ops.kv_quant import kv_gather
from ..utils.device import resolve_device
from . import layers
from .quantize import QuantizedWeight


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    ffn_dim: int = 11008
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 4096
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    # llama-3.1 rope scaling: tuple(sorted(dict.items())) or None
    rope_scaling: tuple | None = None

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def param_count(self) -> int:
        emb = self.vocab_size * self.dim * (1 if self.tie_embeddings else 2)
        per_layer = (
            self.dim * self.head_dim * (self.n_heads + 2 * self.n_kv_heads)
            + self.n_heads * self.head_dim * self.dim
            + 3 * self.dim * self.ffn_dim
            + 2 * self.dim
        )
        return emb + self.n_layers * per_layer + self.dim

    @staticmethod
    def llama2_7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=128256, n_kv_heads=8, ffn_dim=14336, rope_theta=500000.0,
            max_seq_len=8192,
        )

    @staticmethod
    def llama31_8b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=128256, n_kv_heads=8, ffn_dim=14336, rope_theta=500000.0,
            max_seq_len=131072,
            rope_scaling=(
                ("factor", 8.0), ("high_freq_factor", 4.0), ("low_freq_factor", 1.0),
                ("original_max_position_embeddings", 8192),
            ),
        )

    @staticmethod
    def llama32_1b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=128256, dim=2048, n_layers=16, n_kv_heads=8, ffn_dim=8192,
            rope_theta=500000.0, max_seq_len=131072, tie_embeddings=True,
            rope_scaling=(
                ("factor", 32.0), ("high_freq_factor", 4.0), ("low_freq_factor", 1.0),
                ("original_max_position_embeddings", 8192),
            ),
        )

    @staticmethod
    def mistral_7b() -> "LlamaConfig":
        return LlamaConfig(n_kv_heads=8, ffn_dim=14336, max_seq_len=4096)

    @staticmethod
    def tiny(vocab_size: int = 512) -> "LlamaConfig":
        """Test-tier config."""
        return LlamaConfig(
            vocab_size=vocab_size, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
            ffn_dim=256, max_seq_len=256,
        )

    @staticmethod
    def from_hf_config(path: str | Path) -> "LlamaConfig":
        cfg = json.loads(Path(path).read_text())
        if cfg.get("num_local_experts", 0) > 0:  # the reference reads n_experts / top_k_experts
            raise NotImplementedError(
                f"{path}: a mixture-of-experts config (num_local_experts="
                f"{cfg['num_local_experts']}) is not ported yet (ROADMAP A3)"
            )
        scaling = cfg.get("rope_scaling")
        llama3 = isinstance(scaling, dict) and scaling.get("rope_type", scaling.get("type")) == "llama3"
        return LlamaConfig(
            vocab_size=cfg["vocab_size"],
            dim=cfg["hidden_size"],
            n_layers=cfg["num_hidden_layers"],
            n_heads=cfg["num_attention_heads"],
            n_kv_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
            ffn_dim=cfg["intermediate_size"],
            rope_theta=cfg.get("rope_theta", 10000.0),
            norm_eps=cfg.get("rms_norm_eps", 1e-5),
            max_seq_len=cfg.get("max_position_embeddings", 4096),
            tie_embeddings=cfg.get("tie_word_embeddings", False),
            rope_scaling=tuple(sorted(scaling.items())) if llama3 else None,
        )


_LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "gate", "up", "down")


# -- parameters -----------------------------------------------------------------


def init_params(cfg: LlamaConfig, *, seed: int = 0, device=None, map_layer=None) -> dict:
    """Random weights from a seeded ``torch.Generator`` on the target device,
    drawn directly in the model dtype (a 7B init never holds an f32 copy).
    Scales follow the JAX init: fan_in**-0.5, embeddings 0.02. ``map_layer``
    transforms each layer's dict as soon as it is drawn (the quantized init
    keeps one model-dtype layer at a time)."""
    device = resolve_device(device)
    dt = cfg.torch_dtype
    gen = torch.Generator(device=device).manual_seed(seed)

    def dense(n_in: int, n_out: int, scale: float | None = None):
        w = torch.randn((n_in, n_out), generator=gen, device=device, dtype=dt)
        return w.mul_(n_in**-0.5 if scale is None else scale)

    D, hd, F = cfg.dim, cfg.head_dim, cfg.ffn_dim
    params = {"embed": dense(cfg.vocab_size, D, 0.02), "layers": []}
    for _ in range(cfg.n_layers):
        layer = {
            "attn_norm": torch.ones(D, dtype=dt, device=device),
            "wq": dense(D, cfg.n_heads * hd),
            "wk": dense(D, cfg.n_kv_heads * hd),
            "wv": dense(D, cfg.n_kv_heads * hd),
            "wo": dense(cfg.n_heads * hd, D),
            "mlp_norm": torch.ones(D, dtype=dt, device=device),
            "gate": dense(D, F),
            "up": dense(D, F),
            "down": dense(F, D),
        }
        params["layers"].append(layer if map_layer is None else map_layer(layer))
    params["final_norm"] = torch.ones(D, dtype=dt, device=device)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(D, cfg.vocab_size)
    return params


def params_from_jax(np_params: dict, cfg: LlamaConfig, device=None) -> dict:
    """The JAX parameter tree (numpy leaves; per-layer weights stacked on axis
    0, weights [in, out]) as this module's parameter dict: layers unstacked
    into a list, every other layout kept. A quantized leaf (the JAX
    ``QuantizedWeight``, numpy ``q`` and ``scale``) becomes a
    :class:`QuantizedWeight` with its int8 and f32 values as they are."""
    device = resolve_device(device)
    dt = cfg.torch_dtype

    def conv(a, li=None):
        if hasattr(a, "q"):
            q, scale = (np.asarray(t) if li is None else np.asarray(t)[li] for t in (a.q, a.scale))
            return QuantizedWeight(
                q=torch.from_numpy(q.astype(np.int8)).to(device),
                scale=torch.from_numpy(scale.astype(np.float32)).to(device),
            )
        a = np.asarray(a if li is None else a[li], np.float32)  # bf16 leaves arrive as ml_dtypes arrays
        return torch.tensor(a).to(device=device, dtype=dt)

    stacked = np_params["layers"]
    missing = set(_LAYER_KEYS) - set(stacked)
    if missing or set(stacked) - set(_LAYER_KEYS):
        raise ValueError(f"layer leaves {sorted(stacked)} are not the dense llama set {_LAYER_KEYS}")
    params = {
        "embed": conv(np_params["embed"]),
        "layers": [{k: conv(stacked[k], li) for k in _LAYER_KEYS} for li in range(cfg.n_layers)],
        "final_norm": conv(np_params["final_norm"]),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = conv(np_params["lm_head"])
    return params


def _head(params: dict, cfg: LlamaConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _rope(cfg: LlamaConfig, positions):
    return layers.rotary_embedding(
        positions, cfg.head_dim, cfg.rope_theta,
        rope_scaling=dict(cfg.rope_scaling) if cfg.rope_scaling else None,
    )


# -- forward (training) ---------------------------------------------------------


def forward(
    params: dict,
    tokens,  # [B, S] integer
    cfg: LlamaConfig,
    *,
    positions=None,  # [B, S] (defaults to arange)
    attn_impl: str = "flash",
    lora: dict | None = None,  # adapters (models.lora), applied on the fly
    lora_scale: float = 1.0,
    return_aux: bool = False,
    moe_impl: str = "nodrop",
    input_embeds=None,
):  # [B, S, vocab] f32
    """Full-sequence forward with causal attention (flash kernels or the
    plain ``xla`` attention), differentiable in the adapters and the base.
    Dense models only: MoE (``return_aux``, ``moe_impl``) and
    ``input_embeds`` wait for ROADMAP A3."""
    if return_aux or moe_impl != "nodrop" or input_embeds is not None:
        raise NotImplementedError("MoE and multimodal forward are not ported yet (ROADMAP A3)")
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = params["embed"][tokens]
    cos, sin = _rope(cfg, positions)
    n = len(params["layers"])
    if lora is None:
        per_layer = [None] * n
    else:
        unstacked = {k: t.unbind(0) for k, t in lora["layers"].items()}
        per_layer = [{k: ts[li] for k, ts in unstacked.items()} for li in range(n)]
    for layer, llayer in zip(params["layers"], per_layer):
        h = layers.rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        x = x + layers.causal_self_attention(
            layer, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, cos=cos, sin=sin,
            causal=True, attn_impl=attn_impl, lora=llayer, lora_scale=lora_scale,
        )
        h = layers.rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
        x = x + layers.swiglu_mlp(layer, h, lora=llayer, lora_scale=lora_scale)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return layers.mm(x, _head(params, cfg))


# -- serving ----------------------------------------------------------------------


def _qkv(layer: dict, x, cfg: LlamaConfig, cos, sin):
    """Norm, projections and RoPE for [B, S, dim] -> q [B,Hq,S,D], k/v [B,Hkv,S,D]."""
    B, S, _ = x.shape
    D = cfg.head_dim
    h = layers.rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    q = layers.mm(h, layer["wq"]).to(x.dtype).view(B, S, cfg.n_heads, D).transpose(1, 2)
    k = layers.mm(h, layer["wk"]).to(x.dtype).view(B, S, cfg.n_kv_heads, D).transpose(1, 2)
    v = layers.mm(h, layer["wv"]).to(x.dtype).view(B, S, cfg.n_kv_heads, D).transpose(1, 2)
    return layers.apply_rope(q, cos, sin), layers.apply_rope(k, cos, sin), v


def _finish_layer(layer: dict, x, o, cfg: LlamaConfig):
    """Output projection, residual, MLP, residual. o: [B, S, Hq*D]."""
    x = x + layers.mm(o, layer["wo"]).to(x.dtype)
    h = layers.rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    return x + layers.swiglu_mlp(layer, h)


def _page_targets(page_tables, positions, valid, page_size: int):
    """(page_idx, slot) per position; invalid positions -> trash page 0 slot 0."""
    col = (positions // page_size).clamp(0, page_tables.shape[1] - 1).long()
    page_idx = torch.gather(page_tables, 1, col)
    zero = torch.zeros_like(page_idx)
    return (
        torch.where(valid, page_idx, zero).int(),
        torch.where(valid, positions % page_size, zero.to(positions.dtype)).int(),
    )


def _last_logits(params, x, lens, cfg: LlamaConfig):
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    last = (lens.long() - 1).clamp(min=0)
    x_last = x[torch.arange(x.shape[0], device=x.device), last]
    return layers.mm(x_last, _head(params, cfg))


def prefill(params, tokens, k_pages, v_pages, page_tables, seq_lens, cfg: LlamaConfig):
    """Process padded prompts [B, S], writing their K/V into the pages.
    Returns (last-token logits [B, vocab] f32, k_pages, v_pages) with the
    pages updated in place."""
    B, S = tokens.shape
    ps = k_pages.shape[2]
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    valid = positions < seq_lens[:, None]
    cos, sin = _rope(cfg, positions)
    page_idx, slot = _page_targets(page_tables, positions, valid, ps)
    x = params["embed"][tokens]
    L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    k_all = torch.empty((L, B, S, Hkv, D), dtype=x.dtype, device=x.device)
    v_all = torch.empty_like(k_all)
    for li, layer in enumerate(params["layers"]):
        q, k, v = _qkv(layer, x, cfg, cos, sin)
        o = _flash.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
        x = _finish_layer(layer, x, o.transpose(1, 2).reshape(B, S, -1), cfg)
        k_all[li] = k.transpose(1, 2)
        v_all[li] = v.transpose(1, 2)
    _paged.scatter_kv_pages(
        k_pages, v_pages, k_all.view(L, B * S, Hkv, D), v_all.view(L, B * S, Hkv, D),
        page_idx.reshape(-1), slot.reshape(-1),
    )
    return _last_logits(params, x, seq_lens, cfg), k_pages, v_pages


def prefill_chunk(params, tokens, k_pages, v_pages, page_tables, chunk_lens, cfg: LlamaConfig, *, q_offset: int):
    """One chunk [B, C] of a long prompt at positions q_offset..: attends to the
    cached prefix (page gather) plus itself through the flash kernel with
    ``q_offset``, then writes its K/V. ``q_offset`` is page-aligned (chunks are
    bucket-sized). Returns (last logits [B, vocab], k_pages, v_pages)."""
    B, C = tokens.shape
    ps = k_pages.shape[2]
    if q_offset % ps:
        raise ValueError(f"q_offset {q_offset} must be a multiple of page_size {ps}")
    dev = tokens.device
    positions = q_offset + torch.arange(C, device=dev).expand(B, C)
    valid = torch.arange(C, device=dev)[None, :] < chunk_lens[:, None]
    cos, sin = _rope(cfg, positions)
    page_idx, slot = _page_targets(page_tables, positions, valid, ps)
    n_pp = q_offset // ps
    prefix_tables = page_tables[:, :n_pp].long()
    x = params["embed"][tokens]
    L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    k_all = torch.empty((L, B, C, Hkv, D), dtype=x.dtype, device=dev)
    v_all = torch.empty_like(k_all)
    for li, layer in enumerate(params["layers"]):
        q, k, v = _qkv(layer, x, cfg, cos, sin)
        if n_pp:
            # [B, n_pp, ps, Hkv, D] -> [B, Hkv, prefix, D]
            pk = kv_gather(k_pages, prefix_tables, li, dtype=k.dtype).permute(0, 3, 1, 2, 4).reshape(B, Hkv, n_pp * ps, D)
            pv = kv_gather(v_pages, prefix_tables, li, dtype=v.dtype).permute(0, 3, 1, 2, 4).reshape(B, Hkv, n_pp * ps, D)
            k_full = torch.cat([pk, k.to(pk.dtype)], dim=2)
            v_full = torch.cat([pv, v.to(pv.dtype)], dim=2)
        else:
            k_full, v_full = k.contiguous(), v.contiguous()
        o = _flash.flash_attention_chunked(q.contiguous(), k_full, v_full, q_offset=q_offset)
        x = _finish_layer(layer, x, o.transpose(1, 2).reshape(B, C, -1), cfg)
        k_all[li] = k.transpose(1, 2)
        v_all[li] = v.transpose(1, 2)
    _paged.scatter_kv_pages(
        k_pages, v_pages, k_all.view(L, B * C, Hkv, D), v_all.view(L, B * C, Hkv, D),
        page_idx.reshape(-1), slot.reshape(-1),
    )
    return _last_logits(params, x, chunk_lens, cfg), k_pages, v_pages


#: the decode structures the JAX engine names (``paged_impl``), and its scatter impls
PAGED_IMPLS = ("xla", "pallas", "xla-writeback", "pallas-writeback")
SCATTER_IMPLS = ("xla", "pallas")


def _check_impls(impl: str, scatter_impl: str) -> None:
    if impl not in PAGED_IMPLS:
        raise ValueError(f"unknown paged_impl {impl!r}; known: {PAGED_IMPLS}")
    if scatter_impl not in SCATTER_IMPLS:
        raise ValueError(f"unknown scatter_impl {scatter_impl!r}; known: {SCATTER_IMPLS}")


def tp_shard_ok(cfg: LlamaConfig, tp: int) -> bool:
    """Whether this model's heads divide the tensor-parallel degree (the one
    predicate behind every head-sharding legality decision)."""
    return cfg.n_kv_heads % tp == 0 and cfg.n_heads % tp == 0


def paged_impl_plan(
    cfg: LlamaConfig, device, kv_dtype: str = "bfloat16", weights: str | None = None, *,
    impl: str = "xla", scatter_impl: str = "xla",
) -> dict:
    """What the serving functions run for this config on ``device``: always
    the flash prefill and the page scatter (their int8 kernels for an int8
    cache), as CUDA kernels on the card and as their plain versions on the
    CPU. ``impl`` picks the decode structure, never a kernel's stand-in:
    "xla" and "pallas" attend with the ragged decode over read-only pages
    (``attention`` "ragged"), the two writeback impls write each layer's
    token first and attend with the write-then-attend decode ("writeback").
    ``ragged_variant`` is the TPU formulation's label for the ragged shapes;
    ``weights`` is "int8" for quantized weights (the int8 matmul kernel) or
    the model dtype. Nothing is downgraded: every structure serves every kv
    dtype, int8 pages through the int8 kernels of the same structure."""
    _check_impls(impl, scatter_impl)
    on_card = torch.device(device).type == "cuda"
    writeback = impl.endswith("-writeback")
    return {
        "attention": "writeback" if writeback else "ragged",
        "ragged_variant": None if writeback else _paged.ragged_variant_for(cfg.n_kv_heads, kv_dtype),
        "scatter": "kernel",
        "prefill": "flash",
        "impl": "cuda" if on_card else "plain",
        "kv_dtype": str(kv_dtype),
        "weights": weights or cfg.dtype,
        "requested": impl,
        "downgraded": [],
    }


def decode_step(
    params, tokens, positions, k_pages, v_pages, page_tables, active, cfg: LlamaConfig,
    impl: str = "xla", scatter_impl: str = "xla",
):
    """One decode token per slot against the paged cache. tokens/positions
    [B]; active [B] bool (dead slots attend an empty prefix and write trash
    page 0). Returns (logits [B, vocab] f32, k_pages, v_pages), pages updated
    in place.

    ``impl`` selects the structure (:func:`paged_impl_plan`): "xla" and
    "pallas" keep the pages read-only inside the layer loop (the ragged
    decode kernel with the in-flight token as an extra softmax column) and
    write every layer's K/V in one scatter after the last layer;
    "xla-writeback" and "pallas-writeback" run :func:`_decode_step_writeback`.
    ``scatter_impl`` names the JAX package's scatter choice; both values run
    the scatter kernel."""
    _check_impls(impl, scatter_impl)
    if impl.endswith("-writeback"):
        return _decode_step_writeback(params, tokens, positions, k_pages, v_pages, page_tables, active, cfg)
    B = tokens.shape[0]
    ps = k_pages.shape[2]
    cos, sin = _rope(cfg, positions[:, None])  # [B, 1, hd/2]
    page_idx, slot = _page_targets(page_tables, positions[:, None], active[:, None], ps)
    prefix_lens = torch.where(active, positions, torch.zeros_like(positions)).int()
    x = params["embed"][tokens][:, None]  # [B, 1, dim]
    L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    k_all = torch.empty((L, B, Hkv, D), dtype=x.dtype, device=x.device)
    v_all = torch.empty_like(k_all)
    for li, layer in enumerate(params["layers"]):
        q, k, v = _qkv(layer, x, cfg, cos, sin)
        k_tok, v_tok = k[:, :, 0], v[:, :, 0]  # [B, Hkv, D]
        o = _paged.paged_decode_attention_ragged(
            q[:, :, 0], k_pages, v_pages, li, page_tables, prefix_lens, k_tok, v_tok
        )  # [B, Hq, D]
        x = _finish_layer(layer, x, o.reshape(B, 1, -1), cfg)
        k_all[li] = k_tok
        v_all[li] = v_tok
    _paged.scatter_kv_pages(k_pages, v_pages, k_all, v_all, page_idx[:, 0], slot[:, 0])
    return _last_logits(params, x, torch.ones(B, device=x.device, dtype=torch.long), cfg), k_pages, v_pages


def _decode_step_writeback(params, tokens, positions, k_pages, v_pages, page_tables, active, cfg: LlamaConfig):
    """Write-then-attend decode: each layer writes this token's K/V into its
    pages (the scatter kernel over the one-layer view on the card), then the
    write-then-attend decode attends over ``positions + 1`` rows, reading the
    current token back from the cache. Dead slots write trash page 0 and
    attend one row. Both writeback impls launch the same kernel (its int8
    twin, after the int8 scatter, over an int8 cache)."""
    B = tokens.shape[0]
    ps = k_pages.shape[2]
    cos, sin = _rope(cfg, positions[:, None])  # [B, 1, hd/2]
    page_idx, slot = _page_targets(page_tables, positions[:, None], active[:, None], ps)
    page_idx, slot = page_idx[:, 0], slot[:, 0]
    ctx_lens = torch.where(active, positions + 1, torch.ones_like(positions)).int()
    x = params["embed"][tokens][:, None]  # [B, 1, dim]
    for li, layer in enumerate(params["layers"]):
        q, k, v = _qkv(layer, x, cfg, cos, sin)
        k_pg, v_pg = k_pages[li], v_pages[li]  # [P, ps, Hkv, D] views
        _paged.scatter_kv_layer(k_pg, v_pg, k[:, :, 0], v[:, :, 0], page_idx, slot)
        o = _paged.paged_decode_attention(q[:, :, 0], k_pg, v_pg, page_tables, ctx_lens)
        x = _finish_layer(layer, x, o.reshape(B, 1, -1), cfg)
    return _last_logits(params, x, torch.ones(B, device=x.device, dtype=torch.long), cfg), k_pages, v_pages
