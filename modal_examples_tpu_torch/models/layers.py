"""Transformer building blocks used by the Llama model (plain PyTorch).

Counterpart of the subset of ``modal_examples_tpu/models/layers.py`` that
Llama uses: ``rms_norm``, ``rotary_embedding`` (with llama-3.1
``rope_scaling``), ``apply_rope``, the dense ``mm``, the LoRA-aware
projections ``_proj_f32``/``_proj``, ``swiglu_mlp``, ``attention_op`` and
``causal_self_attention``. Norms and softmax-adjacent math run in f32;
products accumulate in f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops import flash_attention as _flash
from ..ops import reference


def rms_norm(x, weight, eps: float = 1e-5):
    """RMSNorm in f32, cast back to the input dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def rotary_embedding(positions, head_dim: int, theta: float = 10000.0, rope_scaling: dict | None = None):
    """f32 cos/sin tables at ``positions`` ([..., S]): [..., S, head_dim/2].

    ``rope_scaling`` takes the llama-3.1 keys (factor, low_freq_factor,
    high_freq_factor, original_max_position_embeddings): low frequencies are
    stretched by ``factor``, high ones kept, the band between interpolated."""
    half = head_dim // 2
    idx = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=positions.device), -idx / half)
    if rope_scaling:
        factor = float(rope_scaling.get("factor", 8.0))
        low = float(rope_scaling.get("low_freq_factor", 1.0))
        high = float(rope_scaling.get("high_freq_factor", 4.0))
        orig = float(rope_scaling.get("original_max_position_embeddings", 8192))
        wavelen = 2.0 * math.pi / freqs
        smooth = torch.clamp((orig / wavelen - low) / max(high - low, 1e-6), 0.0, 1.0)
        freqs = torch.where(
            wavelen > orig / low,
            freqs / factor,
            torch.where(wavelen < orig / high, freqs, (1 - smooth) * freqs / factor + smooth * freqs),
        )
    angles = positions[..., None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """Rotate split halves (llama convention). x: [B, H, S, D]; cos/sin:
    [B, S, D/2] or [S, D/2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        cos_b, sin_b = cos[None, None], sin[None, None]
    else:
        cos_b, sin_b = cos[:, None], sin[:, None]
    o1 = x1 * cos_b - x2 * sin_b
    o2 = x2 * cos_b + x1 * sin_b
    return torch.cat([o1, o2], dim=-1).to(x.dtype)


class _MmF32(torch.autograd.Function):
    """``torch.mm(x, w, out_dtype=float32)`` on the card, which autograd has
    no formula for. The backward is the VJP of JAX's ``jnp.dot(x, w,
    preferred_element_type=f32)``: the f32 cotangent rounded to the inputs'
    dtype, then ``dX = dY @ w^T`` and ``dW = x^T @ dY``."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype)
        dx = dy @ w.T if ctx.needs_input_grad[0] else None
        dw = x.T @ dy if ctx.needs_input_grad[1] else None
        return dx, dw


def mm(x, w):
    """``x @ w`` ([..., K] x [K, N]) with f32 accumulation, returned in f32."""
    if x.dtype == torch.float32:
        return x @ w.float()
    flat = x.reshape(-1, x.shape[-1])
    if x.is_cuda:
        out = _MmF32.apply(flat, w)
    else:
        out = flat.float() @ w.float()
    return out.reshape(*x.shape[:-1], w.shape[-1])


def _proj_f32(x, w, name: str, lora: dict | None, lora_scale: float):
    """``x @ w`` in f32 accumulation, plus the LoRA low-rank delta when an
    adapter targets ``name``. Returns f32 (the caller decides when to round)."""
    out = mm(x, w)
    if lora is not None and f"{name}_a" in lora:
        from .lora import delta

        out = out + delta(x, lora[f"{name}_a"], lora[f"{name}_b"], lora_scale)
    return out


def _proj(x, w, name: str, lora: dict | None, lora_scale: float):
    return _proj_f32(x, w, name, lora, lora_scale).to(x.dtype)


def swiglu_mlp(params: dict, x, lora: dict | None = None, lora_scale: float = 1.0):
    """silu(x W_gate) * (x W_up) W_down, with gate/up kept in f32 through the
    silu product (one rounding before the down projection)."""
    gate = _proj_f32(x, params["gate"], "gate", lora, lora_scale)
    up = _proj_f32(x, params["up"], "up", lora, lora_scale)
    h = (F.silu(gate) * up).to(x.dtype)
    return _proj(h, params["down"], "down", lora, lora_scale)


def attention_op(q, k, v, causal: bool, impl: str = "flash"):
    """``flash``: the flash kernels (forward and backward); ``xla``: the plain
    dense attention, differentiated by autograd (the JAX name is kept)."""
    if impl == "flash":
        return _flash.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal)
    if impl == "xla":
        return reference.attention(q, k, v, causal=causal)
    raise ValueError(f"attn_impl must be 'flash' or 'xla'; got {impl!r}")


def causal_self_attention(
    params: dict,
    x,  # [B, S, E]
    *,
    n_heads: int,
    n_kv_heads: int,
    cos=None,
    sin=None,
    causal: bool = True,
    attn_impl: str = "flash",
    lora: dict | None = None,
    lora_scale: float = 1.0,
):
    """Projection + (optional RoPE) + attention + output projection."""
    B, S, E = x.shape
    D = E // n_heads
    q = _proj(x, params["wq"], "wq", lora, lora_scale)
    k = _proj(x, params["wk"], "wk", lora, lora_scale)
    v = _proj(x, params["wv"], "wv", lora, lora_scale)
    q = q.reshape(B, S, n_heads, D).transpose(1, 2)
    k = k.reshape(B, S, n_kv_heads, D).transpose(1, 2)
    v = v.reshape(B, S, n_kv_heads, D).transpose(1, 2)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    o = attention_op(q, k, v, causal, attn_impl)
    o = o.transpose(1, 2).reshape(B, S, E)
    return _proj(o, params["wo"], "wo", lora, lora_scale)
