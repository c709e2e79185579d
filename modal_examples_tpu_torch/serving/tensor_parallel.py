"""Tensor-parallel serving on a dense KV cache: the simple path beside the
paged engine.

Counterpart of ``modal_examples_tpu/serving/tensor_parallel.py``
(``DenseKVCache``, ``shard_params_tp``, ``decode_step_dense``,
``generate_tp``). The reference enables tensor parallelism with an engine
flag (``--tensor-parallel-size``, vllm_inference.py:179-180). Here each rank
holds its Megatron shards (``llama.shard_params``) and its kv heads of a
dense ``[L, B, Hkv, S, D]`` cache, and runs the same decode step: the
collectives are ``models.llama``'s (the vocab-sharded embedding's sum, the
row-parallel f32 sums, the logits' gather). No kernel runs here: attention
is plain PyTorch over the dense cache, as the JAX path is XLA's.

``kv_dtype="int8"`` stores the cache quantized, as the paged cache does:
int8 ``[L, B, Hkv, S, D]`` data plus per-token-head f32 ``[L, B, Hkv, S]``
scales, the scales on the same kv-head shard as their data.

Sampling at a temperature draws from a ``torch.Generator`` (the JAX path
draws ``jax.random.categorical``); greedy decoding is the same function.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models import layers, llama
from ..ops.kv_quant import QuantizedKV, dequantize_kv, kv_empty, quantize_kv, shard_kv
from ..parallel.mesh import TENSOR, P
from ..utils.device import resolve_device


@dataclasses.dataclass
class DenseKVCache:
    k: object  # [L, B, Hkv/tp, S, D] tensor, or QuantizedKV (int8 + scales)
    v: object

    @classmethod
    def create(cls, cfg: llama.LlamaConfig, batch: int, max_len: int, mesh=None, dtype=torch.bfloat16,
               kv_dtype=None, device=None):
        """An empty cache, cut to this rank's kv heads under ``mesh``."""
        device = resolve_device(device)
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
        data, scale = P(None, None, TENSOR, None, None), P(None, None, TENSOR, None)
        sides = []
        for _ in range(2):
            side = kv_empty(shape, kv_dtype if kv_dtype is not None else dtype, device)
            sides.append(side if mesh is None else shard_kv(side, data, scale, mesh))
        return cls(*sides)


def shard_params_tp(params: dict, cfg: llama.LlamaConfig, mesh) -> dict:
    """This rank's Megatron shards over the ``tensor`` axis."""
    return llama.shard_params(params, cfg, mesh)


def decode_step_dense(params: dict, tokens, cache: DenseKVCache, positions, cfg: llama.LlamaConfig, *, mesh=None):
    """One decode token per row against the dense cache, written in place.
    tokens, positions [B]. Returns (logits [B, vocab] f32, cache). With
    ``mesh=`` the rank's shards and kv heads; without, one device."""
    B = tokens.shape[0]
    S = cache.k.shape[3]
    D = cfg.head_dim
    x = llama._embed(params, tokens, mesh)  # [B, dim]
    cos, sin = llama._rope(cfg, positions[:, None])
    pos_mask = torch.arange(S, device=x.device)[None, :] <= positions[:, None]  # [B, S]
    rows = torch.arange(B, device=x.device)
    pos = positions.long()
    for li, layer in enumerate(params["layers"]):
        h = layers.rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q = layers.mm(h, layer["wq"]).to(x.dtype).view(B, 1, -1, D).transpose(1, 2)
        k = layers.mm(h, layer["wk"]).to(x.dtype).view(B, 1, -1, D).transpose(1, 2)
        v = layers.mm(h, layer["wv"]).to(x.dtype).view(B, 1, -1, D).transpose(1, 2)
        q, k = layers.apply_rope(q, cos, sin), layers.apply_rope(k, cos, sin)
        k_c, v_c = cache.k[li], cache.v[li]  # [B, Hkv, S, D] views
        if isinstance(k_c, QuantizedKV):
            for side, new in ((k_c, k[:, :, 0]), (v_c, v[:, :, 0])):
                qn = quantize_kv(new)
                side.data[rows, :, pos] = qn.data
                side.scale[rows, :, pos] = qn.scale
            k_att, v_att = dequantize_kv(k_c, x.dtype), dequantize_kv(v_c, x.dtype)
        else:
            k_c[rows, :, pos] = k[:, :, 0]
            v_c[rows, :, pos] = v[:, :, 0]
            k_att, v_att = k_c, v_c
        Hkv = k_att.shape[1]
        G = q.shape[1] // Hkv
        qg = q.reshape(B, Hkv, G, D)
        s = torch.einsum("bhgd,bhsd->bhgs", qg.float(), k_att.float()) * (D**-0.5)
        s = s.masked_fill(~pos_mask[:, None, None, :], float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgs,bhsd->bhgd", p.to(v_att.dtype), v_att).reshape(B, -1)
        x = x + llama._row_sum(layers.mm(o, layer["wo"]), mesh).to(x.dtype)
        h = layers.rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
        x = x + llama._mlp_block(layer, h, cfg, mesh=mesh)[0]
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return llama._logits(x, params, cfg, mesh), cache


def generate_tp(
    params: dict,
    cfg: llama.LlamaConfig,
    prompts,  # [B, S0] integer (right-padded)
    prompt_lens,  # [B]
    max_new: int,
    *,
    mesh=None,
    max_len: int = 256,
    generator: torch.Generator | None = None,
    temperature: float = 0.0,
    kv_dtype=None,  # "int8": the quantized dense cache
):
    """Greedy (or temperature) generation with the dense cache: the prompt
    fed token by token, then ``max_new`` tokens. ``params`` are the full
    weights; under ``mesh`` each rank cuts its shards. Returns [B, S0 +
    max_new] tokens (every rank the same)."""
    B, S0 = prompts.shape
    if mesh is not None:
        params = shard_params_tp(params, cfg, mesh)
    device = params["embed"].device
    cache = DenseKVCache.create(cfg, B, max_len, mesh, dtype=params["embed"].dtype, kv_dtype=kv_dtype,
                                device=device)
    total = S0 + max_new
    out = torch.zeros((B, total), dtype=torch.int32, device=device)
    out[:, :S0] = prompts
    lens = prompt_lens.to(device)
    tokens = out[:, 0]
    for pos in range(total - 1):
        positions = torch.full((B,), pos, dtype=torch.int32, device=device)
        logits, cache = decode_step_dense(params, tokens, cache, positions, cfg, mesh=mesh)
        if temperature <= 0:
            nxt = logits.argmax(dim=-1).to(torch.int32)
        else:
            probs = torch.softmax(logits / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
        teacher = out[:, min(pos + 1, total - 1)]
        tokens = torch.where(pos + 1 < lens, teacher, nxt)
        out[:, pos + 1] = tokens
    return out
