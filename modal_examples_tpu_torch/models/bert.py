"""BERT-family encoder: text embeddings (BGE).

Counterpart of ``modal_examples_tpu/models/bert.py`` (``BertConfig``,
``init_params``, ``forward``, ``embed``, ``load_hf_weights``): learned
word, position and type embeddings, a post-LN encoder with bidirectional
attention under an additive key-padding bias (-1e9 on padded keys, f32
scores and softmax, probabilities rounded to the value dtype), erf-GELU,
then CLS or mean pooling and L2 normalisation. The attention stays the
plain products, as in the reference (XLA einsums there): the padding bias
is not a mode of the flash kernel.

Parameters keep the JAX tree: per-layer leaves stacked on axis 0, weights
[in, out]. :func:`params_from_jax` converts a JAX tree of numpy leaves.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from ..utils.device import resolve_device
from ..utils.safetensors import SafeFile
from . import layers


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    dim: int = 384
    n_layers: int = 12
    n_heads: int = 12
    ffn_dim: int = 1536
    max_position: int = 512
    type_vocab_size: int = 2
    norm_eps: float = 1e-12
    dtype: str = "float32"
    pooling: str = "cls"  # bge uses CLS pooling

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @staticmethod
    def bge_small_en() -> "BertConfig":
        return BertConfig()  # bge-small-en-v1.5 == BERT-small geometry

    @staticmethod
    def bge_base_en() -> "BertConfig":
        return BertConfig(dim=768, n_layers=12, n_heads=12, ffn_dim=3072)

    @staticmethod
    def tiny() -> "BertConfig":
        return BertConfig(vocab_size=512, dim=64, n_layers=2, n_heads=2, ffn_dim=128)


def init_params(cfg: BertConfig, *, seed: int = 0, device=None) -> dict:
    """Random weights drawn on the device in the model dtype from ``seed``:
    every matrix N(0, 0.02), biases zero, norms one (the JAX init's scales)."""
    r = layers.SeededInit(seed, resolve_device(device), cfg.torch_dtype)
    D, F, L = cfg.dim, cfg.ffn_dim, cfg.n_layers
    return {
        "word_emb": r.dense(cfg.vocab_size, D, scale=0.02),
        "pos_emb": r.dense(cfg.max_position, D, scale=0.02),
        "type_emb": r.dense(cfg.type_vocab_size, D, scale=0.02),
        "emb_norm_w": r.full(1.0, D),
        "emb_norm_b": r.full(0.0, D),
        "layers": {
            "wq": r.dense(L, D, D, scale=0.02), "bq": r.full(0.0, L, D),
            "wk": r.dense(L, D, D, scale=0.02), "bk": r.full(0.0, L, D),
            "wv": r.dense(L, D, D, scale=0.02), "bv": r.full(0.0, L, D),
            "wo": r.dense(L, D, D, scale=0.02), "bo": r.full(0.0, L, D),
            "attn_norm_w": r.full(1.0, L, D), "attn_norm_b": r.full(0.0, L, D),
            "fc_w": r.dense(L, D, F, scale=0.02), "fc_b": r.full(0.0, L, F),
            "proj_w": r.dense(L, F, D, scale=0.02), "proj_b": r.full(0.0, L, D),
            "mlp_norm_w": r.full(1.0, L, D), "mlp_norm_b": r.full(0.0, L, D),
        },
    }


def params_from_jax(np_params: dict, cfg: BertConfig, device=None) -> dict:
    """The JAX tree (numpy leaves) as this module's tree, layouts unchanged."""
    return layers.from_numpy_tree(np_params, cfg.torch_dtype, resolve_device(device))


def forward(params: dict, tokens, attention_mask=None, cfg: BertConfig = BertConfig()):
    """tokens [B, S] (int), attention_mask [B, S] (1 real, 0 pad) -> final
    hidden states [B, S, D]."""
    B, S = tokens.shape
    if attention_mask is None:
        attention_mask = torch.ones((B, S), dtype=torch.int32, device=tokens.device)
    x = params["word_emb"][tokens] + params["pos_emb"][:S][None] + params["type_emb"][torch.zeros_like(tokens)]
    x = layers.layer_norm(x, params["emb_norm_w"], params["emb_norm_b"], cfg.norm_eps)
    bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9).float()  # [B, 1, 1, S]
    scale = cfg.head_dim**-0.5
    H, hd = cfg.n_heads, cfg.head_dim
    stacked = params["layers"]
    for i in range(cfg.n_layers):
        l = {k: v[i] for k, v in stacked.items()}
        q = (x @ l["wq"] + l["bq"]).reshape(B, S, H, hd).transpose(1, 2)
        k = (x @ l["wk"] + l["bk"]).reshape(B, S, H, hd).transpose(1, 2)
        v = (x @ l["wv"] + l["bv"]).reshape(B, S, H, hd).transpose(1, 2)
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale + bias
        p = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.einsum("bhqk,bhkd->bhqd", p, v).transpose(1, 2).reshape(B, S, cfg.dim)
        o = o @ l["wo"] + l["bo"]
        x = layers.layer_norm(x + o, l["attn_norm_w"], l["attn_norm_b"], cfg.norm_eps)  # post-LN
        h = layers.gelu_mlp(l, x, exact=True)  # BERT uses erf-GELU
        x = layers.layer_norm(x + h, l["mlp_norm_w"], l["mlp_norm_b"], cfg.norm_eps)
    return x


def embed(params: dict, tokens, attention_mask=None, cfg: BertConfig = BertConfig()):
    """[B, D] L2-normalised f32 sentence embeddings: the CLS state, or the
    mean over real tokens (``cfg.pooling == "mean"``)."""
    B, S = tokens.shape
    if attention_mask is None:
        attention_mask = torch.ones((B, S), dtype=torch.int32, device=tokens.device)
    h = forward(params, tokens, attention_mask, cfg)
    if cfg.pooling == "cls":
        pooled = h[:, 0]
    else:  # mean over real tokens
        m = attention_mask[..., None].to(h.dtype)
        pooled = (h * m).sum(1) / m.sum(1).clamp_min(1.0)
    norm = torch.linalg.vector_norm(pooled.float(), dim=-1, keepdim=True)
    return (pooled / norm.clamp_min(1e-9)).float()


def load_hf_weights(model_dir: str | Path, cfg: BertConfig, dtype=None, device=None) -> dict:
    """An HF BERT checkpoint (bge-*; every ``*.safetensors`` of
    ``model_dir``, names with or without the ``bert.`` prefix) as this
    module's tree, read through the port's safetensors reader: linears
    transposed from [out, in] to [in, out], layers stacked, every leaf in
    ``dtype`` (default ``cfg.dtype``) on ``device``."""
    device = resolve_device(device)
    dt = dtype or cfg.torch_dtype
    files = sorted(Path(model_dir).glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors under {model_dir}")
    raw: dict[str, torch.Tensor] = {}
    for f in files:
        with SafeFile(f) as sf:
            for name in sf.keys():
                raw[name.removeprefix("bert.")] = sf.get_tensor(name)

    def g(name):
        return raw.pop(name).to(device=device, dtype=dt)

    def stack(fmt, transpose=False):
        mats = [raw.pop(fmt.format(i)) for i in range(cfg.n_layers)]
        return torch.stack([m.T if transpose else m for m in mats]).to(device=device, dtype=dt).contiguous()

    pre = "encoder.layer.{}."
    return {
        "word_emb": g("embeddings.word_embeddings.weight"),
        "pos_emb": g("embeddings.position_embeddings.weight"),
        "type_emb": g("embeddings.token_type_embeddings.weight"),
        "emb_norm_w": g("embeddings.LayerNorm.weight"),
        "emb_norm_b": g("embeddings.LayerNorm.bias"),
        "layers": {
            "wq": stack(pre + "attention.self.query.weight", True),
            "bq": stack(pre + "attention.self.query.bias"),
            "wk": stack(pre + "attention.self.key.weight", True),
            "bk": stack(pre + "attention.self.key.bias"),
            "wv": stack(pre + "attention.self.value.weight", True),
            "bv": stack(pre + "attention.self.value.bias"),
            "wo": stack(pre + "attention.output.dense.weight", True),
            "bo": stack(pre + "attention.output.dense.bias"),
            "attn_norm_w": stack(pre + "attention.output.LayerNorm.weight"),
            "attn_norm_b": stack(pre + "attention.output.LayerNorm.bias"),
            "fc_w": stack(pre + "intermediate.dense.weight", True),
            "fc_b": stack(pre + "intermediate.dense.bias"),
            "proj_w": stack(pre + "output.dense.weight", True),
            "proj_b": stack(pre + "output.dense.bias"),
            "mlp_norm_w": stack(pre + "output.LayerNorm.weight"),
            "mlp_norm_b": stack(pre + "output.LayerNorm.bias"),
        },
    }
