"""Llama-family decoder: the training forward, prefill, chunked prefill and
paged decode.

Counterpart of ``modal_examples_tpu/models/llama.py`` (``LlamaConfig``,
``init_params``, ``_mlp_block``, ``forward``, ``prefill``, ``prefill_chunk``,
``decode_step`` with its ``impl``/``scatter_impl``, ``_decode_step_writeback``,
``verify_step``, ``tp_shard_ok``, ``paged_impl_plan``, ``load_hf_weights``). Architecture:
RMSNorm, RoPE, GQA, SwiGLU, or top-k routed SwiGLU experts (Mixtral) where
``n_experts > 0``.

Parameters are a plain dict: ``embed`` [V, D], ``layers`` (a list of per-layer
dicts, weights [in, out] as in the JAX tree; a mixture of experts has
``router`` [D, E], ``moe_gate``/``moe_up`` [E, D, F] and ``moe_down``
[E, F, D] in place of ``gate``/``up``/``down``), ``final_norm``, and
``lm_head`` [D, V] unless embeddings are tied. :func:`params_from_jax`
converts the JAX tree (layers stacked on axis 0) and is the only place where
layout changes.

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
import re
from pathlib import Path

import numpy as np
import torch

from ..ops import flash_attention as _flash
from ..ops import paged_attention as _paged
from ..ops.kv_quant import kv_gather
from ..ops.quantized_matmul import pack_int4
from ..utils.device import resolve_device
from ..utils.safetensors import SafeFile
from . import layers
from . import moe as _moe
from .quantize import LLAMA_TARGETS, QuantizedWeight, bits_of, quantize_weight_host


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
    # mixture of experts (Mixtral): n_experts > 0 replaces the dense SwiGLU
    # with top-k routed SwiGLU experts (models.moe)
    n_experts: int = 0
    top_k_experts: int = 2
    expert_capacity_factor: float = 1.5
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
        if self.n_experts > 0:
            mlp = self.n_experts * 3 * self.dim * self.ffn_dim + self.dim * self.n_experts
        else:
            mlp = 3 * self.dim * self.ffn_dim
        per_layer = (
            self.dim * self.head_dim * (self.n_heads + 2 * self.n_kv_heads)
            + self.n_heads * self.head_dim * self.dim
            + mlp
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
    def mixtral_8x7b() -> "LlamaConfig":
        return LlamaConfig(
            n_kv_heads=8, ffn_dim=14336, rope_theta=1e6, max_seq_len=32768, n_experts=8, top_k_experts=2,
        )

    @staticmethod
    def tiny_moe(vocab_size: int = 512) -> "LlamaConfig":
        """Test-tier Mixtral-shape config."""
        return LlamaConfig(
            vocab_size=vocab_size, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
            ffn_dim=256, max_seq_len=256, n_experts=4, top_k_experts=2,
        )

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
            n_experts=cfg.get("num_local_experts", 0),
            top_k_experts=cfg.get("num_experts_per_tok", 2),
            rope_scaling=tuple(sorted(scaling.items())) if llama3 else None,
        )


_LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "gate", "up", "down")
_MOE_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "router", "moe_gate", "moe_up", "moe_down")


def _layer_keys(cfg: LlamaConfig) -> tuple:
    """The leaves of one layer: the dense SwiGLU's, or the router and the
    stacked experts' of a mixture of experts."""
    return _MOE_KEYS if cfg.n_experts > 0 else _LAYER_KEYS


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

    def dense(*shape: int, scale: float | None = None):
        w = torch.randn(shape, generator=gen, device=device, dtype=dt)
        return w.mul_(shape[-2] ** -0.5 if scale is None else scale)

    D, hd, F, E = cfg.dim, cfg.head_dim, cfg.ffn_dim, cfg.n_experts
    params = {"embed": dense(cfg.vocab_size, D, scale=0.02), "layers": []}
    for _ in range(cfg.n_layers):
        layer = {
            "attn_norm": torch.ones(D, dtype=dt, device=device),
            "wq": dense(D, cfg.n_heads * hd),
            "wk": dense(D, cfg.n_kv_heads * hd),
            "wv": dense(D, cfg.n_kv_heads * hd),
            "wo": dense(cfg.n_heads * hd, D),
            "mlp_norm": torch.ones(D, dtype=dt, device=device),
        }
        if E > 0:  # router [D, E]; experts stacked on axis 0
            layer.update(router=dense(D, E), moe_gate=dense(E, D, F), moe_up=dense(E, D, F), moe_down=dense(E, F, D))
        else:
            layer.update(gate=dense(D, F), up=dense(D, F), down=dense(F, D))
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
    :class:`QuantizedWeight` with its integer and f32 values as they are: an
    ``int4`` ``q`` (``ml_dtypes.int4``) packed two rows a byte, bit for bit."""
    device = resolve_device(device)
    dt = cfg.torch_dtype

    def conv(a, li=None):
        if hasattr(a, "q"):
            q, scale = (np.asarray(t) if li is None else np.asarray(t)[li] for t in (a.q, a.scale))
            q8 = torch.from_numpy(q.astype(np.int8))
            scale = torch.from_numpy(scale.astype(np.float32)).to(device)
            if str(q.dtype) == "int4":
                return QuantizedWeight(q=pack_int4(q8).to(device), scale=scale, bits=4, rows=q.shape[-2])
            return QuantizedWeight(q=q8.to(device), scale=scale)
        a = np.asarray(a if li is None else a[li], np.float32)  # bf16 leaves arrive as ml_dtypes arrays
        return torch.tensor(a).to(device=device, dtype=dt)

    stacked = np_params["layers"]
    keys = _layer_keys(cfg)
    if set(stacked) != set(keys):
        raise ValueError(f"layer leaves {sorted(stacked)} are not the llama set {keys}")
    params = {
        "embed": conv(np_params["embed"]),
        "layers": [{k: conv(stacked[k], li) for k in keys} for li in range(cfg.n_layers)],
        "final_norm": conv(np_params["final_norm"]),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = conv(np_params["lm_head"])
    return params


#: HF llama tensor names (stored [out, in]) -> this module's names
_HF_TOP = {"model.embed_tokens.weight": "embed", "model.norm.weight": "final_norm", "lm_head.weight": "lm_head"}
_HF_LAYER = {
    "input_layernorm.weight": "attn_norm",
    "self_attn.q_proj.weight": "wq",
    "self_attn.k_proj.weight": "wk",
    "self_attn.v_proj.weight": "wv",
    "self_attn.o_proj.weight": "wo",
    "post_attention_layernorm.weight": "mlp_norm",
    "mlp.gate_proj.weight": "gate",
    "mlp.up_proj.weight": "up",
    "mlp.down_proj.weight": "down",
    "block_sparse_moe.gate.weight": "router",
}
#: Mixtral's expert matrices (``block_sparse_moe.experts.{e}.<name>.weight``)
_HF_EXPERT = {"w1": "moe_gate", "w3": "moe_up", "w2": "moe_down"}
_UNTRANSPOSED = ("embed", "final_norm", "attn_norm", "mlp_norm")


def load_hf_weights(model_dir, cfg: LlamaConfig, dtype=None, quantization: str | None = None, device=None) -> dict:
    """HF llama safetensors (every ``*.safetensors`` of ``model_dir``) as
    this module's parameter dict, read file by file and tensor by tensor:
    each tensor goes to ``device`` (transposed from HF's [out, in] to
    [in, out] there) before the next is read, so the host never holds the
    checkpoint. ``dtype`` (default ``cfg.dtype``) is the dtype of every
    unquantized leaf. ``quantization="int8"`` or ``"int4"`` quantizes
    ``LLAMA_TARGETS`` and ``lm_head`` on the host
    (:func:`~.quantize.quantize_weight_host`, from the stored values) and
    moves only the int8 (packed int4) weights and their scales.
    ``lm_head`` is not read when embeddings are tied. A mixture of
    experts reads Mixtral's layout: ``block_sparse_moe.gate`` becomes
    ``router`` [D, E] (never quantized) and each layer's
    ``experts.{e}.w1``/``w3``/``w2`` are transposed and stacked into
    ``moe_gate``/``moe_up`` [E, D, F] and ``moe_down`` [E, F, D] once all E
    are read (quantized as stacks, scales [E, 1, out])."""
    device = resolve_device(device)
    dt = dtype or cfg.torch_dtype
    bits = None
    if quantization is not None:
        bits = bits_of(quantization)
    files = sorted(Path(model_dir).glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors under {model_dir}")

    def place(w, name: str):
        if name not in _UNTRANSPOSED:
            w = w.T
        if bits is not None and (name in LLAMA_TARGETS or name == "lm_head"):
            return quantize_weight_host(w.contiguous(), bits, device)
        return w.to(device=device, dtype=dt).contiguous()

    def place_stack(mats: list):  # E [in, out] host matrices -> one [E, in, out] leaf on the device
        w = torch.stack(mats)
        return w.to(device=device, dtype=dt) if bits is None else quantize_weight_host(w, bits, device)

    keys = _layer_keys(cfg)
    top: dict = {}
    per_layer: list[dict] = [{} for _ in range(cfg.n_layers)]
    experts: dict = {}  # (layer, leaf) -> {expert: [in, out] host tensor} until all E are read
    for path in files:
        with SafeFile(path) as f:
            for key in f.keys():
                name = _HF_TOP.get(key)
                if name is not None:
                    if not (name == "lm_head" and cfg.tie_embeddings):
                        top[name] = place(f.get_tensor(key), name)
                    continue
                m = re.fullmatch(r"model\.layers\.(\d+)\.(.+)", key)
                if not m or int(m.group(1)) >= cfg.n_layers:
                    continue
                li = int(m.group(1))
                if m.group(2) in _HF_LAYER and _HF_LAYER[m.group(2)] in keys:
                    name = _HF_LAYER[m.group(2)]
                    per_layer[li][name] = place(f.get_tensor(key), name)
                    continue
                e = re.fullmatch(r"block_sparse_moe\.experts\.(\d+)\.(w[123])\.weight", m.group(2))
                if e and cfg.n_experts > 0 and int(e.group(1)) < cfg.n_experts:
                    name = _HF_EXPERT[e.group(2)]
                    got = experts.setdefault((li, name), {})
                    got[int(e.group(1))] = f.get_tensor(key).T
                    if len(got) == cfg.n_experts:
                        per_layer[li][name] = place_stack([got[i] for i in range(cfg.n_experts)])
                        del experts[(li, name)]
    want_top = ["embed", "final_norm"] + ([] if cfg.tie_embeddings else ["lm_head"])
    wanted = [(k, v) for k, v in _HF_LAYER.items() if v in keys] + [
        (f"block_sparse_moe.experts.*.{k}.weight", v) for k, v in _HF_EXPERT.items() if v in keys
    ]
    missing = [k for k, v in _HF_TOP.items() if v in want_top and v not in top] + [
        f"model.layers.{li}.{k}" for li, got in enumerate(per_layer) for k, v in wanted if v not in got
    ]
    if missing:
        raise KeyError(f"{model_dir}: checkpoint lacks {missing[:8]}{' ...' if len(missing) > 8 else ''}")
    params = {
        "embed": top["embed"],
        "layers": [{k: got[k] for k in keys} for got in per_layer],
        "final_norm": top["final_norm"],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = top["lm_head"]
    return params


def _head(params: dict, cfg: LlamaConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _rope(cfg: LlamaConfig, positions):
    return layers.rotary_embedding(
        positions, cfg.head_dim, cfg.rope_theta,
        rope_scaling=dict(cfg.rope_scaling) if cfg.rope_scaling else None,
    )


def _mlp_block(layer: dict, h, cfg: LlamaConfig, *, lora=None, lora_scale: float = 1.0, moe_impl: str = "nodrop"):
    """Post-norm MLP of one layer: the dense SwiGLU, or with
    ``cfg.n_experts > 0`` the top-k routed SwiGLU experts. ``moe_impl``
    "capacity" is the GShard dispatch at about top_k / E of the work; any
    other value (the serving default "nodrop") runs every expert on every
    token, so incremental decode reproduces the full forward. Returns (out
    in h's dtype, aux load-balance loss, or None for a dense layer)."""
    if cfg.n_experts > 0:
        if lora is not None and any(f"{n}_a" in lora for n in ("gate", "up", "down")):
            raise ValueError(
                "LoRA MLP adapters (gate/up/down) are not supported for MoE "
                "expert MLPs; restrict LoRAConfig.targets to attention "
                "projections (wq/wk/wv/wo) for n_experts > 0"
            )
        experts = (layer["router"], layer["moe_gate"], layer["moe_up"], layer["moe_down"], h.reshape(-1, cfg.dim))
        if moe_impl == "capacity":
            flat, aux = _moe.moe_swiglu_capacity(*experts, cfg.top_k_experts, cfg.expert_capacity_factor)
        else:
            flat, aux = _moe.moe_swiglu_nodrop(*experts, cfg.top_k_experts)
        return flat.reshape(h.shape).to(h.dtype), aux
    return layers.swiglu_mlp(layer, h, lora=lora, lora_scale=lora_scale), None


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
):  # [B, S, vocab] f32 (, aux)
    """Full-sequence forward with causal attention (flash kernels or the
    plain ``xla`` attention), differentiable in the adapters and the base.
    ``return_aux`` also returns the mean over layers of the MoE load-balance
    loss (0 for a dense model); ``moe_impl`` picks the expert formulation
    (:func:`_mlp_block`). ``input_embeds`` (the multimodal prefix) waits for
    ROADMAP A11's ``vlm``."""
    if input_embeds is not None:
        raise NotImplementedError("input_embeds (a multimodal prefix) waits for the vlm model (ROADMAP A11)")
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
    auxes = []
    for layer, llayer in zip(params["layers"], per_layer):
        h = layers.rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        x = x + layers.causal_self_attention(
            layer, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, cos=cos, sin=sin,
            causal=True, attn_impl=attn_impl, lora=llayer, lora_scale=lora_scale,
        )
        h = layers.rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
        h, aux = _mlp_block(layer, h, cfg, lora=llayer, lora_scale=lora_scale, moe_impl=moe_impl)
        x = x + h
        if aux is not None:
            auxes.append(aux)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = layers.mm(x, _head(params, cfg))
    if return_aux:  # a dense model's loss is 0, as the reference's mean of zeros
        return logits, torch.stack(auxes).mean() if auxes else torch.zeros((), device=logits.device)
    return logits


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
    return x + _mlp_block(layer, h, cfg)[0]


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
    ``weights`` is "int8" or "int4" for quantized weights (the int8 or int4
    matmul kernel) or the model dtype. Nothing is downgraded: every structure serves every kv
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


def verify_step(params, tokens, positions0, k_pages, v_pages, page_tables, active, cfg: LlamaConfig):
    """T tokens of teacher-forced decode against the paged cache, the
    target's scoring half of speculative decoding. tokens [B, T] (the
    committed token, then the proposals), positions0 [B] (the position of
    ``tokens[:, 0]``), active [B] bool.

    Each layer writes the K/V of all T chain tokens at positions0 ..
    positions0 + T - 1 (the scatter kernel over the one-layer view on the
    card), then attends with ``paged_verify_attention``: query t sees the
    cache up to its own position, so rejected tokens' rows are overwritten
    later and never read past the accept point. Positions past the table's
    capacity write trash page 0 (a slot near its length can overshoot by up
    to T - 1 rejected tokens); their RoPE angle is the last position's.
    Returns (logits [B, T, vocab], k_pages, v_pages), pages updated in
    place: ``logits[:, t]`` is the distribution of position positions0 + t + 1."""
    B, T = tokens.shape
    ps = k_pages.shape[2]
    cap = page_tables.shape[1] * ps
    positions = positions0[:, None] + torch.arange(T, device=tokens.device)[None, :]  # [B, T]
    valid = active[:, None] & (positions < cap)
    pos_c = positions.clamp(max=cap - 1)
    cos, sin = _rope(cfg, pos_c)  # [B, T, hd/2]
    page_idx, slot = _page_targets(page_tables, pos_c, valid, ps)
    page_idx, slot = page_idx.reshape(B * T), slot.reshape(B * T)
    x = params["embed"][tokens]  # [B, T, dim]
    Hkv, D = cfg.n_kv_heads, cfg.head_dim
    for li, layer in enumerate(params["layers"]):
        q, k, v = _qkv(layer, x, cfg, cos, sin)  # q [B, Hq, T, D], k/v [B, Hkv, T, D]
        k_pg, v_pg = k_pages[li], v_pages[li]  # [P, ps, Hkv, D] views
        _paged.scatter_kv_layer(
            k_pg, v_pg, k.transpose(1, 2).reshape(B * T, Hkv, D), v.transpose(1, 2).reshape(B * T, Hkv, D),
            page_idx, slot,
        )
        o = _paged.paged_verify_attention(q.transpose(1, 2), k_pg, v_pg, page_tables, positions)  # [B, T, Hq, D]
        x = _finish_layer(layer, x, o.reshape(B, T, -1), cfg)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return layers.mm(x, _head(params, cfg)), k_pages, v_pages
