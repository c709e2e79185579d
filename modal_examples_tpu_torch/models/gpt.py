"""nanoGPT-style small LM: the SLM pretraining workload.

Counterpart of ``modal_examples_tpu/models/gpt.py`` (``GPTConfig``,
``init_params``, ``forward``, ``generate``, ``CharTokenizer``): learned
positional embeddings, pre-LN blocks with causal self-attention and a tanh
GELU MLP, the output head tied to the token embedding. The attention goes
through ``layers.causal_self_attention`` and ``attention_op``: ``flash`` (the
default, as in the reference) runs the flash kernels, forward and backward,
at the model's dtype (the f32 instances for the default f32 config, the bf16
ones for bf16), ``xla`` the plain products. Parameters keep the JAX tree
(per-layer leaves stacked on axis 0, weights [in, out]).

``generate`` samples as the reference does: the whole window re-run every
step with the plain attention, and step i's token drawn with key i of
``split(key, n_tokens)`` by JAX's threefry categorical (``serving/sampling.py``),
so the port and the JAX package draw the same tokens from the same key.
"""

from __future__ import annotations

import dataclasses

import torch

from ..serving import sampling
from ..utils.device import resolve_device
from . import layers


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 96  # char-level
    block_size: int = 256
    n_layers: int = 6
    n_heads: int = 6
    dim: int = 384
    dropout: float = 0.0  # handled by the caller if nonzero
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @staticmethod
    def tiny() -> "GPTConfig":
        return GPTConfig(vocab_size=96, block_size=64, n_layers=2, n_heads=2, dim=64)


def init_params(cfg: GPTConfig, *, seed: int = 0, device=None) -> dict:
    """Random weights drawn on the device in the model dtype from ``seed``,
    at the JAX init's scales: 0.02, the residual projections 0.02 / sqrt(2L);
    biases zero, norms one."""
    r = layers.SeededInit(seed, resolve_device(device), cfg.torch_dtype)
    D, F, L = cfg.dim, 4 * cfg.dim, cfg.n_layers
    resid = 0.02 / (2 * L) ** 0.5
    return {
        "tok_emb": r.dense(cfg.vocab_size, D, scale=0.02),
        "pos_emb": r.dense(cfg.block_size, D, scale=0.02),
        "layers": {
            "ln1_w": r.full(1.0, L, D), "ln1_b": r.full(0.0, L, D),
            "wq": r.dense(L, D, D, scale=0.02), "wk": r.dense(L, D, D, scale=0.02),
            "wv": r.dense(L, D, D, scale=0.02), "wo": r.dense(L, D, D, scale=resid),
            "ln2_w": r.full(1.0, L, D), "ln2_b": r.full(0.0, L, D),
            "fc_w": r.dense(L, D, F, scale=0.02), "fc_b": r.full(0.0, L, F),
            "proj_w": r.dense(L, F, D, scale=resid), "proj_b": r.full(0.0, L, D),
        },
        "final_ln_w": r.full(1.0, D),
        "final_ln_b": r.full(0.0, D),
    }


def params_from_jax(np_params: dict, cfg: GPTConfig, device=None) -> dict:
    """The JAX tree (numpy leaves) as this module's tree, layouts unchanged."""
    return layers.from_numpy_tree(np_params, cfg.torch_dtype, resolve_device(device))


def forward(params: dict, tokens, cfg: GPTConfig, *, attn_impl: str = "flash"):
    """tokens [B, S] -> logits [B, S, vocab] in f32."""
    B, S = tokens.shape
    x = params["tok_emb"][tokens] + params["pos_emb"][:S][None]
    stacked = params["layers"]
    for i in range(cfg.n_layers):
        l = {k: v[i] for k, v in stacked.items()}
        h = layers.layer_norm(x, l["ln1_w"], l["ln1_b"])
        x = x + layers.causal_self_attention(
            l, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_heads, causal=True, attn_impl=attn_impl,
        )
        h = layers.layer_norm(x, l["ln2_w"], l["ln2_b"])
        x = x + layers.gelu_mlp(l, h)
    x = layers.layer_norm(x, params["final_ln_w"], params["final_ln_b"])
    return layers.mm(x, params["tok_emb"].T)


@torch.no_grad()
def generate(params: dict, cfg: GPTConfig, prompt, n_tokens: int, key, temperature: float = 1.0):
    """Autoregressive sampling over a fixed window (no KV cache: at SLM scale
    re-running the window is cheaper than cache bookkeeping). ``prompt``
    [S0] integer, ``key`` a threefry key [2] (``sampling.prng_key``).
    Returns the ``n_tokens`` drawn tokens [n_tokens] int32."""
    S = cfg.block_size
    dev = params["tok_emb"].device
    prompt = torch.as_tensor(prompt, device=dev).to(torch.int64)
    buf = torch.zeros((S,), dtype=torch.int64, device=dev)
    buf[: prompt.shape[0]] = prompt
    pos = int(prompt.shape[0])
    keys = sampling.split(key.to(dev), n_tokens)
    out = []
    for i in range(n_tokens):
        logits = forward(params, buf[None], cfg, attn_impl="xla")[0]
        last = logits[min(max(pos - 1, 0), S - 1)]
        nxt = sampling.categorical(keys[i : i + 1], (last / max(temperature, 1e-6))[None])[0]
        buf[min(pos, S - 1)] = nxt
        pos = min(pos + 1, S)
        out.append(nxt)
    return torch.stack(out).to(torch.int32)


class CharTokenizer:
    """Char-level tokenizer for the Shakespeare-style corpus."""

    def __init__(self, text: str):
        chars = sorted(set(text))
        self.stoi = {c: i for i, c in enumerate(chars)}
        self.itos = {i: c for i, c in enumerate(chars)}
        self.vocab_size = len(chars)

    def encode(self, s: str) -> list[int]:
        return [self.stoi[c] for c in s if c in self.stoi]

    def decode(self, ids) -> str:
        return "".join(self.itos.get(int(i), "") for i in ids)
