"""CLIP text encoder: the prompt side of the SD family.

Counterpart of ``modal_examples_tpu/models/clip_text.py``
(``CLIPTextConfig``, ``init_params``, ``forward``, ``load_hf_weights``):
token and learned position embeddings, a pre-LN transformer with causal
attention and a quick-GELU MLP, a final layer norm; the pooled output is
the hidden state at each sequence's first EOS token (the last position
when there is none). Layer norms run in the model dtype, as the
reference's do. The attention is the plain products (f32 scores and
softmax), as in the reference.

Parameters keep the JAX tree (per-layer leaves stacked on axis 0, weights
[in, out]).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from ..ops import reference
from ..utils.device import resolve_device
from ..utils.safetensors import SafeFile
from . import layers


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    max_len: int = 77
    eos_token_id: int = 49407
    norm_eps: float = 1e-5
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @staticmethod
    def clip_l() -> "CLIPTextConfig":
        """CLIP-L/14 text tower (SD1/2/XL/3 primary text encoder)."""
        return CLIPTextConfig()

    @staticmethod
    def tiny(vocab_size: int = 512) -> "CLIPTextConfig":
        return CLIPTextConfig(
            vocab_size=vocab_size, dim=64, n_layers=2, n_heads=2, max_len=32,
            eos_token_id=vocab_size - 1,
        )


def init_params(cfg: CLIPTextConfig, *, seed: int = 0, device=None) -> dict:
    """Random weights drawn on the device in the model dtype from ``seed``,
    at the JAX init's scales: linears fan_in**-0.5, embeddings 0.02; biases
    zero, norms one."""
    r = layers.SeededInit(seed, resolve_device(device), cfg.torch_dtype)
    D, L = cfg.dim, cfg.n_layers
    return {
        "token_emb": r.dense(cfg.vocab_size, D, scale=0.02),
        "pos_emb": r.dense(cfg.max_len, D, scale=0.02),
        "layers": {
            "ln1_scale": r.full(1.0, L, D), "ln1_bias": r.full(0.0, L, D),
            "wq": r.dense(L, D, D), "bq": r.full(0.0, L, D),
            "wk": r.dense(L, D, D), "bk": r.full(0.0, L, D),
            "wv": r.dense(L, D, D), "bv": r.full(0.0, L, D),
            "wo": r.dense(L, D, D), "bo": r.full(0.0, L, D),
            "ln2_scale": r.full(1.0, L, D), "ln2_bias": r.full(0.0, L, D),
            "fc1": r.dense(L, D, 4 * D), "fc1_b": r.full(0.0, L, 4 * D),
            "fc2": r.dense(L, 4 * D, D), "fc2_b": r.full(0.0, L, D),
        },
        "final_ln_scale": r.full(1.0, D),
        "final_ln_bias": r.full(0.0, D),
    }


def params_from_jax(np_params: dict, cfg: CLIPTextConfig, device=None) -> dict:
    """The JAX tree (numpy leaves) as this module's tree, layouts unchanged."""
    return layers.from_numpy_tree(np_params, cfg.torch_dtype, resolve_device(device))


def _ln(x, scale, bias, eps):
    """Layer norm in the input's dtype (the reference's CLIP norm)."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def forward(params: dict, tokens, cfg: CLIPTextConfig):
    """tokens [B, S] (padded to ``max_len`` or shorter) -> (hidden
    [B, S, D], the per-token states diffusion models attend to; pooled
    [B, D], the state at the first EOS)."""
    B, S = tokens.shape
    H = cfg.n_heads
    hd = cfg.dim // H
    x = params["token_emb"][tokens] + params["pos_emb"][None, :S]
    stacked = params["layers"]
    for i in range(cfg.n_layers):
        l = {k: v[i] for k, v in stacked.items()}
        h = _ln(x, l["ln1_scale"], l["ln1_bias"], cfg.norm_eps)
        q, k, v = ((h @ l[w] + l[b]).reshape(B, S, H, hd).transpose(1, 2)
                   for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
        o = reference.attention(q, k, v, causal=True).transpose(1, 2).reshape(B, S, cfg.dim)
        x = x + (o @ l["wo"] + l["bo"])
        h = _ln(x, l["ln2_scale"], l["ln2_bias"], cfg.norm_eps)
        x = x + (layers.quick_gelu(h @ l["fc1"] + l["fc1_b"]) @ l["fc2"] + l["fc2_b"])
    hidden = _ln(x, params["final_ln_scale"], params["final_ln_bias"], cfg.norm_eps)
    is_eos = tokens == cfg.eos_token_id
    idx = torch.where(is_eos.any(dim=1), is_eos.int().argmax(dim=1), S - 1)  # first EOS, else the last position
    pooled = hidden[torch.arange(B, device=tokens.device), idx]
    return hidden, pooled


def load_hf_weights(model_dir: str | Path, cfg: CLIPTextConfig, dtype=None, device=None) -> dict:
    """A transformers CLIPTextModel safetensors checkpoint
    (``text_encoder/model.safetensors`` naming; every ``*.safetensors`` of
    ``model_dir``) as this module's tree, read through the port's
    safetensors reader: linears transposed to [in, out], layers stacked,
    every leaf in ``dtype`` (default ``cfg.dtype``) on ``device``."""
    device = resolve_device(device)
    dt = dtype or cfg.torch_dtype
    raw: dict[str, torch.Tensor] = {}
    for f in sorted(Path(model_dir).glob("*.safetensors")):
        with SafeFile(f) as sf:
            for name in sf.keys():
                raw[name] = sf.get_tensor(name)

    P = "text_model."

    def stack(fmt, transpose):
        mats = [raw.pop(fmt.format(i)) for i in range(cfg.n_layers)]
        return torch.stack([m.T if transpose else m for m in mats]).to(device=device, dtype=dt).contiguous()

    def vec(name):
        return raw.pop(name).to(device=device, dtype=dt)

    E = P + "encoder.layers.{}."
    lin = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
           "wo": "self_attn.out_proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    bias = {"bq": "self_attn.q_proj", "bk": "self_attn.k_proj", "bv": "self_attn.v_proj",
            "bo": "self_attn.out_proj", "fc1_b": "mlp.fc1", "fc2_b": "mlp.fc2"}
    norms = {"ln1_scale": "layer_norm1.weight", "ln1_bias": "layer_norm1.bias",
             "ln2_scale": "layer_norm2.weight", "ln2_bias": "layer_norm2.bias"}
    stacked = {
        **{k: stack(E + n + ".weight", True) for k, n in lin.items()},
        **{k: stack(E + n + ".bias", False) for k, n in bias.items()},
        **{k: stack(E + n, False) for k, n in norms.items()},
    }
    order = ("ln1_scale", "ln1_bias", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo",
             "ln2_scale", "ln2_bias", "fc1", "fc1_b", "fc2", "fc2_b")
    return {
        "token_emb": vec(P + "embeddings.token_embedding.weight"),
        "pos_emb": vec(P + "embeddings.position_embedding.weight"),
        "layers": {k: stacked[k] for k in order},
        "final_ln_scale": vec(P + "final_layer_norm.weight"),
        "final_ln_bias": vec(P + "final_layer_norm.bias"),
    }
