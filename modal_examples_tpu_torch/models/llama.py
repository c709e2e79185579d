"""Llama-family decoder: the training forward, prefill, chunked prefill and
paged decode.

Counterpart of ``modal_examples_tpu/models/llama.py`` (``LlamaConfig``,
``init_params``, ``_mlp_block``, ``forward``, ``prefill``, ``prefill_chunk``,
``decode_step`` with its ``impl``/``scatter_impl``, ``_decode_step_writeback``,
``verify_step``, ``tp_shard_ok``, ``paged_impl_plan``, ``load_hf_weights``,
``partition_specs``; ``shard_params`` is the engine's ``_shard_params``). Architecture:
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

Tensor parallelism (``mesh=`` with a ``tensor`` axis): each rank holds its
local shards (:func:`shard_params`, the Megatron layout of
:func:`partition_specs`) and runs the serving functions on them: the
column-parallel ``wq``/``wk``/``wv``/``gate``/``up`` give it its local heads
and ffn columns, the kernels run on those heads through ``ops.sharded``,
the row-parallel ``wo``/``down`` partial products are summed over the axis
in f32 (``psum``) and rounded once after the sum, as the JAX ``psum`` of f32
partial sums is; the vocab-sharded embedding is a masked local lookup (exact
zeros outside the rank's rows) summed over the axis, and the
column-parallel ``lm_head`` (or the tied ``embed.T``) gives each rank a
block of the vocabulary, all-gathered into the full logits on every rank.
A mixture of experts shards each expert's ffn dim and keeps the router
whole. On a one-wide ``tensor`` axis the same collectives run over a group
of one, and every value is the one-card path's.

The training forward under a mesh (``Trainer(param_specs=
partition_specs(cfg))``, or ``forward(mesh=)``) is differentiable in the
rank's shards: the collectives are the tensor-parallel regions' forms with a
gradient (``parallel.collectives.copy_to`` at the input of every
column-parallel product, ``reduce_from`` at every row-parallel sum and the
embedding's, ``gather_from`` on the logits), so each rank's gradients are
the one-card gradients' blocks of its shards and a replicated leaf (the
norms, the router) gets the whole gradient on every rank. Every rank
computes the whole loss.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import torch

from ..ops import paged_attention as _paged
from ..ops import sharded as _sharded
from ..ops.kv_quant import kv_gather
from ..parallel import collectives as _coll
from ..parallel.mesh import TENSOR, P, axis_sizes, entered_mesh, shard_tensor
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



def partition_specs(cfg: LlamaConfig) -> dict:
    """Tensor-parallel placements over the ``tensor`` axis, the JAX
    package's (layers with their stacked leading axis): column-parallel
    in-projections, row-parallel out-projections, the embedding split over
    the vocabulary. A mixture of experts splits each expert's ffn dim and
    keeps the router whole."""
    if cfg.n_experts > 0:
        mlp = {
            "router": P(None, None, None),
            "moe_gate": P(None, None, None, TENSOR),
            "moe_up": P(None, None, None, TENSOR),
            "moe_down": P(None, None, TENSOR, None),
        }
    else:
        mlp = {"gate": P(None, None, TENSOR), "up": P(None, None, TENSOR), "down": P(None, TENSOR, None)}
    specs = {
        "embed": P(TENSOR, None),
        "layers": {
            "attn_norm": P(None, None),
            "wq": P(None, None, TENSOR),
            "wk": P(None, None, TENSOR),
            "wv": P(None, None, TENSOR),
            "wo": P(None, TENSOR, None),
            "mlp_norm": P(None, None),
            **mlp,
        },
        "final_norm": P(None),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(None, TENSOR)
    return specs


def _shard_leaf(w, spec: P, mesh):
    """This rank's block of one leaf. A quantized weight splits ``q`` by the
    placement and its per-output-channel scale by the output dim's only (the
    contraction axis of a scale has size 1); an int4 ``q`` split on its
    contraction rows must split on a byte boundary (two rows a byte)."""
    if not isinstance(w, QuantizedWeight):
        return shard_tensor(w, spec, mesh)
    scale_spec = P(*spec[:-2], None, spec[-1])
    if w.bits != 4 or spec[-2] is None:
        return dataclasses.replace(w, q=shard_tensor(w.q, spec, mesh), scale=shard_tensor(w.scale, scale_spec, mesh))
    tp = _coll.axis_size(spec[-2], mesh)
    if w.din % tp or (w.din // tp) % 2:
        raise ValueError(
            f"an int4 weight's {w.din} contraction rows split over {tp} ranks as {w.din / tp:g} a rank: the packed "
            "rows split only on a byte boundary (an even count a rank)"
        )
    return dataclasses.replace(
        w, q=shard_tensor(w.q, spec, mesh), scale=shard_tensor(w.scale, scale_spec, mesh), rows=w.din // tp,
    )


def shard_layer(layer: dict, cfg: LlamaConfig, mesh) -> dict:
    """One layer's leaves cut to this rank's blocks (the per-layer
    placements: :func:`partition_specs` without the stacked axis)."""
    specs = partition_specs(cfg)["layers"]
    return {k: _shard_leaf(w, P(*specs[k][1:]), mesh) for k, w in layer.items()}


def shard_params(params: dict, cfg: LlamaConfig, mesh, *, layers: bool = True) -> dict:
    """This rank's blocks of a full parameter dict (the JAX engine's
    ``_shard_params``, quantized trees included), each a contiguous copy so
    the full leaf can be freed. ``init_params(map_layer=)`` with
    :func:`shard_layer` draws a sharded tree a layer at a time instead, and
    ``layers=False`` then cuts the rest. Head counts, the vocabulary and the
    ffn dim must divide the tensor degree; otherwise it raises."""
    tp = _sharded.mesh_tp_degree(mesh)
    if not tp_shard_ok(cfg, tp):
        raise ValueError(
            f"n_kv_heads={cfg.n_kv_heads} / n_heads={cfg.n_heads} must be divisible by the tensor axis size {tp} "
            "for kv-head-sharded TP serving"
        )
    specs = partition_specs(cfg)
    out = {
        "embed": _shard_leaf(params["embed"], specs["embed"], mesh),
        "layers": [shard_layer(layer, cfg, mesh) for layer in params["layers"]] if layers else params["layers"],
        "final_norm": params["final_norm"],
    }
    if "lm_head" in params:
        out["lm_head"] = _shard_leaf(params["lm_head"], specs["lm_head"], mesh)
    return out

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


def _row_sum(partial, mesh):
    """A row-parallel product's f32 partial summed over the tensor axis (no
    mesh: the product itself), its gradient passed through to every rank's
    partial. The caller rounds once, after the sum."""
    return partial if mesh is None else _coll.reduce_from(partial, TENSOR, mesh)


def _column_input(h, mesh):
    """A replicated input of column-parallel products: under a mesh, its
    gradient (each rank's columns' share) summed over the tensor axis."""
    return h if mesh is None else _coll.copy_to(h, TENSOR, mesh)


def _embed(params: dict, tokens, mesh):
    """The token embeddings: under a mesh, a lookup in this rank's block of
    the vocabulary, exact zeros for the tokens outside it, summed over the
    tensor axis (one rank holds each row, so the sum is exact)."""
    table = params["embed"]
    if mesh is None:
        return table[tokens]
    rows = table.shape[0]
    local = tokens.long() - _coll.axis_index(TENSOR, mesh) * rows
    inside = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)] * inside[..., None].to(table.dtype)
    return _coll.reduce_from(x, TENSOR, mesh)


def _with_prefix(x, input_embeds):
    """Token embeddings [B, S, dim] with the first P positions replaced by
    ``input_embeds`` [B, P, dim] (the multimodal prefix) in x's dtype."""
    if input_embeds is None:
        return x
    P = input_embeds.shape[1]
    return torch.cat([input_embeds.to(x.dtype), x[:, P:]], dim=1)


def _logits(x, params: dict, cfg: LlamaConfig, mesh):
    """``x @ head`` in f32; under a mesh this rank's vocabulary block,
    all-gathered so every rank holds the full logits (the gradient of the
    rank's block flows back to it alone)."""
    out = layers.mm(_column_input(x, mesh), _head(params, cfg))
    return out if mesh is None else _coll.gather_from(out, TENSOR, gather_dim=-1, mesh=mesh)


def _mlp_block(layer: dict, h, cfg: LlamaConfig, *, lora=None, lora_scale: float = 1.0, moe_impl: str = "nodrop",
               mesh=None):
    """Post-norm MLP of one layer: the dense SwiGLU, or with
    ``cfg.n_experts > 0`` the top-k routed SwiGLU experts. ``moe_impl``
    "capacity" is the GShard dispatch at about top_k / E of the work; any
    other value (the serving default "nodrop") runs every expert on every
    token, so incremental decode reproduces the full forward. Under a
    ``mesh`` the ffn dim is this rank's block and the f32 partial output is
    summed over the tensor axis before its one rounding. Returns (out in h's
    dtype, aux load-balance loss, or None for a dense layer)."""
    if cfg.n_experts > 0:
        if lora is not None and any(f"{n}_a" in lora for n in ("gate", "up", "down")):
            raise ValueError(
                "LoRA MLP adapters (gate/up/down) are not supported for MoE "
                "expert MLPs; restrict LoRAConfig.targets to attention "
                "projections (wq/wk/wv/wo) for n_experts > 0"
            )
        experts = (layer["router"], layer["moe_gate"], layer["moe_up"], layer["moe_down"], h.reshape(-1, cfg.dim))
        if moe_impl == "capacity":
            flat, aux = _moe.moe_swiglu_capacity(*experts, cfg.top_k_experts, cfg.expert_capacity_factor,
                                                 mesh=mesh)
        else:
            flat, aux = _moe.moe_swiglu_nodrop(*experts, cfg.top_k_experts, mesh=mesh)
            flat = _row_sum(flat, mesh)
        return flat.reshape(h.shape).to(h.dtype), aux
    if mesh is None:
        return layers.swiglu_mlp(layer, h, lora=lora, lora_scale=lora_scale), None
    h = _column_input(h, mesh)
    a = torch.nn.functional.silu(layers.mm(h, layer["gate"])) * layers.mm(h, layer["up"])
    return _row_sum(layers.mm(a.to(h.dtype), layer["down"]), mesh).to(h.dtype), None


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
    mesh=None,  # a mesh with a "tensor" axis: the rank's shards, attention on its heads
):  # [B, S, vocab] f32 (, aux)
    """Full-sequence forward with causal attention (flash kernels or the
    plain ``xla`` attention), differentiable in the adapters and the base.
    ``return_aux`` also returns the mean over layers of the MoE load-balance
    loss (0 for a dense model); ``moe_impl`` picks the expert formulation
    (:func:`_mlp_block`). ``input_embeds`` [B, P, dim] (the multimodal
    prefix, ``models.vlm``) replaces the embedding lookup of the first P
    positions, cast to the model dtype.

    Tensor parallel under ``mesh=``, or, given none, under the mesh the
    caller entered (``parallel.enter_mesh``, as ``Trainer`` enters its own
    around a step, JAX's ``with mesh:``) when that mesh has a ``tensor``
    axis: the rank's shards run the column/row-parallel products (module
    docstring) and attention on the rank's heads (the flash kernels through
    ``ops.sharded``, K5/K6 in the backward), differentiable in the shards. A
    mesh without a ``tensor`` axis (data parallelism, FSDP's gathered
    leaves) runs the one-card forward."""
    if mesh is None:
        mesh = entered_mesh()
    if input_embeds is not None and mesh is not None:
        raise NotImplementedError("input_embeds (a multimodal prefix) under tensor parallelism is ROADMAP A10b")
    if mesh is not None and TENSOR not in axis_sizes(mesh):
        mesh = None
    if mesh is not None and lora is not None:
        raise NotImplementedError("LoRA adapters over a tensor-parallel base are ROADMAP A10c")
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    cos, sin = _rope(cfg, positions)
    if mesh is not None:
        x = _embed(params, tokens, mesh)
        auxes = []
        for layer in params["layers"]:
            q, k, v = _qkv(layer, x, cfg, cos, sin, mesh)
            if attn_impl == "flash":
                o = _sharded.sharded_flash_attention(mesh, q.contiguous(), k.contiguous(), v.contiguous(), True,
                                                     heads=_heads(cfg))
            else:
                o = layers.attention_op(q, k, v, True, attn_impl)
            x, aux = _finish_layer(layer, x, o.transpose(1, 2).reshape(B, S, -1), cfg, mesh, moe_impl=moe_impl)
            if aux is not None:
                auxes.append(aux)
        logits = _logits(layers.rms_norm(x, params["final_norm"], cfg.norm_eps), params, cfg, mesh)
        if return_aux:
            return logits, torch.stack(auxes).mean() if auxes else torch.zeros((), device=logits.device)
        return logits
    x = _with_prefix(params["embed"][tokens], input_embeds)
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


def _heads(cfg: LlamaConfig) -> tuple[int, int]:
    """The model's global (query, kv) head counts, which ``ops.sharded``
    checks each rank's shards against."""
    return cfg.n_heads, cfg.n_kv_heads


def _qkv(layer: dict, x, cfg: LlamaConfig, cos, sin, mesh=None):
    """Norm, projections and RoPE for [B, S, dim] -> q [B,Hq,S,D], k/v
    [B,Hkv,S,D]: the heads of the rank's ``wq``/``wk``/``wv`` columns (all
    of them without a mesh)."""
    B, S, _ = x.shape
    D = cfg.head_dim
    h = _column_input(layers.rms_norm(x, layer["attn_norm"], cfg.norm_eps), mesh)
    q = layers.mm(h, layer["wq"]).to(x.dtype).view(B, S, -1, D).transpose(1, 2)
    k = layers.mm(h, layer["wk"]).to(x.dtype).view(B, S, -1, D).transpose(1, 2)
    v = layers.mm(h, layer["wv"]).to(x.dtype).view(B, S, -1, D).transpose(1, 2)
    return layers.apply_rope(q, cos, sin), layers.apply_rope(k, cos, sin), v


def _finish_layer(layer: dict, x, o, cfg: LlamaConfig, mesh=None, *, moe_impl: str = "nodrop"):
    """Output projection (row-parallel under a mesh: the f32 partials
    summed, then rounded), residual, MLP, residual. o: [B, S, Hq*D] (the
    rank's heads). Returns (x, the MoE aux loss or None)."""
    x = x + _row_sum(layers.mm(o, layer["wo"]), mesh).to(x.dtype)
    h = layers.rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    out, aux = _mlp_block(layer, h, cfg, moe_impl=moe_impl, mesh=mesh)
    return x + out, aux


def _page_targets(page_tables, positions, valid, page_size: int):
    """(page_idx, slot) per position; invalid positions -> trash page 0 slot 0."""
    col = (positions // page_size).clamp(0, page_tables.shape[1] - 1).long()
    page_idx = torch.gather(page_tables, 1, col)
    zero = torch.zeros_like(page_idx)
    return (
        torch.where(valid, page_idx, zero).int(),
        torch.where(valid, positions % page_size, zero.to(positions.dtype)).int(),
    )


def _last_logits(params, x, lens, cfg: LlamaConfig, mesh=None):
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    last = (lens.long() - 1).clamp(min=0)
    x_last = x[torch.arange(x.shape[0], device=x.device), last]
    return _logits(x_last, params, cfg, mesh)


def prefill(params, tokens, k_pages, v_pages, page_tables, seq_lens, cfg: LlamaConfig, *, input_embeds=None,
            mesh=None):
    """Process padded prompts [B, S], writing their K/V into the pages.
    Returns (last-token logits [B, vocab] f32, k_pages, v_pages) with the
    pages updated in place. ``input_embeds`` [B, P, dim] replaces the
    embedding lookup of the first P positions (the multimodal path: image
    tokens at positions 0..P-1, ``tokens[:, :P]`` placeholders; RoPE,
    attention and the scatter see the whole sequence, so image tokens are
    ordinary cache entries). Under ``mesh=`` the rank's shards and its pages'
    kv heads (the flash kernel and the scatter per head shard)."""
    if input_embeds is not None and mesh is not None:
        raise NotImplementedError("input_embeds (a multimodal prefix) under tensor parallelism is ROADMAP A10b")
    B, S = tokens.shape
    ps = k_pages.shape[2]
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    valid = positions < seq_lens[:, None]
    cos, sin = _rope(cfg, positions)
    page_idx, slot = _page_targets(page_tables, positions, valid, ps)
    x = _with_prefix(_embed(params, tokens, mesh), input_embeds)
    L, Hkv, D = cfg.n_layers, k_pages.shape[3], cfg.head_dim
    k_all = torch.empty((L, B, S, Hkv, D), dtype=x.dtype, device=x.device)
    v_all = torch.empty_like(k_all)
    for li, layer in enumerate(params["layers"]):
        q, k, v = _qkv(layer, x, cfg, cos, sin)
        o = _sharded.sharded_flash_attention(mesh, q.contiguous(), k.contiguous(), v.contiguous(), True,
                                             heads=_heads(cfg))
        x, _ = _finish_layer(layer, x, o.transpose(1, 2).reshape(B, S, -1), cfg, mesh)
        k_all[li] = k.transpose(1, 2)
        v_all[li] = v.transpose(1, 2)
    _sharded.sharded_scatter_kv_pages(
        mesh, k_pages, v_pages, k_all.view(L, B * S, Hkv, D), v_all.view(L, B * S, Hkv, D),
        page_idx.reshape(-1), slot.reshape(-1), heads=_heads(cfg),
    )
    return _last_logits(params, x, seq_lens, cfg, mesh), k_pages, v_pages


def prefill_chunk(params, tokens, k_pages, v_pages, page_tables, chunk_lens, cfg: LlamaConfig, *, q_offset: int,
                  mesh=None):
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
    x = _embed(params, tokens, mesh)
    L, Hkv, D = cfg.n_layers, k_pages.shape[3], cfg.head_dim
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
        o = _sharded.sharded_flash_attention_chunked(mesh, q.contiguous(), k_full, v_full, q_offset=q_offset,
                                                     heads=_heads(cfg))
        x, _ = _finish_layer(layer, x, o.transpose(1, 2).reshape(B, C, -1), cfg, mesh)
        k_all[li] = k.transpose(1, 2)
        v_all[li] = v.transpose(1, 2)
    _sharded.sharded_scatter_kv_pages(
        mesh, k_pages, v_pages, k_all.view(L, B * C, Hkv, D), v_all.view(L, B * C, Hkv, D),
        page_idx.reshape(-1), slot.reshape(-1), heads=_heads(cfg),
    )
    return _last_logits(params, x, chunk_lens, cfg, mesh), k_pages, v_pages


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
    impl: str = "xla", scatter_impl: str = "xla", mesh=None,
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
    dtype, int8 pages through the int8 kernels of the same structure.

    ``mesh`` makes the plan per shard, as the JAX one is: ``tp`` is the
    tensor degree and the variant is the one of the local ``Hkv // tp``
    heads. A head count the degree does not divide raises (the JAX plan
    downgrades to its XLA gather; the port has no path around the kernels)."""
    _check_impls(impl, scatter_impl)
    tp = _sharded.mesh_tp_degree(mesh)
    if not tp_shard_ok(cfg, tp):
        raise ValueError(
            f"n_kv_heads={cfg.n_kv_heads} / n_heads={cfg.n_heads} not divisible by tp={tp}: head-sharded kernels "
            "need whole heads per shard"
        )
    on_card = torch.device(device).type == "cuda"
    writeback = impl.endswith("-writeback")
    return {
        "attention": "writeback" if writeback else "ragged",
        "ragged_variant": None if writeback else _paged.ragged_variant_for(cfg.n_kv_heads // tp, kv_dtype),
        "scatter": "kernel",
        "prefill": "flash",
        "impl": "cuda" if on_card else "plain",
        "kv_dtype": str(kv_dtype),
        "weights": weights or cfg.dtype,
        "tp": tp,
        "requested": impl,
        "downgraded": [],
    }


def decode_step(
    params, tokens, positions, k_pages, v_pages, page_tables, active, cfg: LlamaConfig,
    impl: str = "xla", scatter_impl: str = "xla", *, mesh=None,
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
    the scatter kernel. Under ``mesh=`` the rank's shards and kv heads."""
    _check_impls(impl, scatter_impl)
    if impl.endswith("-writeback"):
        return _decode_step_writeback(params, tokens, positions, k_pages, v_pages, page_tables, active, cfg, mesh)
    B = tokens.shape[0]
    ps = k_pages.shape[2]
    cos, sin = _rope(cfg, positions[:, None])  # [B, 1, hd/2]
    page_idx, slot = _page_targets(page_tables, positions[:, None], active[:, None], ps)
    prefix_lens = torch.where(active, positions, torch.zeros_like(positions)).int()
    x = _embed(params, tokens, mesh)[:, None]  # [B, 1, dim]
    L, Hkv, D = cfg.n_layers, k_pages.shape[3], cfg.head_dim
    k_all = torch.empty((L, B, Hkv, D), dtype=x.dtype, device=x.device)
    v_all = torch.empty_like(k_all)
    for li, layer in enumerate(params["layers"]):
        q, k, v = _qkv(layer, x, cfg, cos, sin)
        k_tok, v_tok = k[:, :, 0], v[:, :, 0]  # [B, Hkv, D]
        o = _sharded.sharded_ragged_decode(
            mesh, q[:, :, 0], k_pages, v_pages, li, page_tables, prefix_lens, k_tok, v_tok, heads=_heads(cfg),
        )  # [B, Hq, D]
        x, _ = _finish_layer(layer, x, o.reshape(B, 1, -1), cfg, mesh)
        k_all[li] = k_tok
        v_all[li] = v_tok
    _sharded.sharded_scatter_kv_pages(mesh, k_pages, v_pages, k_all, v_all, page_idx[:, 0], slot[:, 0],
                                      heads=_heads(cfg))
    return _last_logits(params, x, torch.ones(B, device=x.device, dtype=torch.long), cfg, mesh), k_pages, v_pages


def _decode_step_writeback(params, tokens, positions, k_pages, v_pages, page_tables, active, cfg: LlamaConfig,
                           mesh=None):
    """Write-then-attend decode: each layer writes this token's K/V into its
    pages, then the write-then-attend decode attends over ``positions + 1``
    rows, the current token among them (``sharded_write_then_attend``: over
    bf16 pages on the card one launch of the write-then-attend kernel does
    both; over an int8 cache the int8 scatter, then its int8 twin). Dead
    slots write trash page 0 and attend one row. Both writeback impls launch
    the same kernels."""
    B = tokens.shape[0]
    ps = k_pages.shape[2]
    cos, sin = _rope(cfg, positions[:, None])  # [B, 1, hd/2]
    page_idx, slot = _page_targets(page_tables, positions[:, None], active[:, None], ps)
    page_idx, slot = page_idx[:, 0], slot[:, 0]
    ctx_lens = torch.where(active, positions + 1, torch.ones_like(positions)).int()
    x = _embed(params, tokens, mesh)[:, None]  # [B, 1, dim]
    for li, layer in enumerate(params["layers"]):
        q, k, v = _qkv(layer, x, cfg, cos, sin)
        k_pg, v_pg = k_pages[li], v_pages[li]  # [P, ps, Hkv, D] views
        o = _sharded.sharded_write_then_attend(mesh, q[:, :, 0], k_pg, v_pg, page_tables, ctx_lens, k[:, :, 0],
                                               v[:, :, 0], page_idx, slot, heads=_heads(cfg))
        x, _ = _finish_layer(layer, x, o.reshape(B, 1, -1), cfg, mesh)
    return _last_logits(params, x, torch.ones(B, device=x.device, dtype=torch.long), cfg, mesh), k_pages, v_pages


def verify_step(params, tokens, positions0, k_pages, v_pages, page_tables, active, cfg: LlamaConfig, *, mesh=None):
    """T tokens of teacher-forced decode against the paged cache, the
    target's scoring half of speculative decoding. tokens [B, T] (the
    committed token, then the proposals), positions0 [B] (the position of
    ``tokens[:, 0]``), active [B] bool.

    Each layer writes the K/V of all T chain tokens at positions0 ..
    positions0 + T - 1 and attends with ``paged_verify_attention`` (on the
    card over bf16 pages one launch of the write-then-attend kernel does
    both; the scatter kernel first over int8 pages): query t sees the
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
    x = _embed(params, tokens, mesh)  # [B, T, dim]
    Hkv, D = k_pages.shape[3], cfg.head_dim
    for li, layer in enumerate(params["layers"]):
        q, k, v = _qkv(layer, x, cfg, cos, sin)  # q [B, Hq, T, D], k/v [B, Hkv, T, D]
        k_pg, v_pg = k_pages[li], v_pages[li]  # [P, ps, Hkv, D] views
        o = _sharded.sharded_paged_verify_attention(
            mesh, q.transpose(1, 2), k_pg, v_pg, page_tables, positions,
            k_new=k.transpose(1, 2).reshape(B * T, Hkv, D), v_new=v.transpose(1, 2).reshape(B * T, Hkv, D),
            page_idx=page_idx, slot=slot, heads=_heads(cfg),
        )  # [B, T, Hq, D]
        x, _ = _finish_layer(layer, x, o.reshape(B, T, -1), cfg, mesh)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(x, params, cfg, mesh), k_pages, v_pages
