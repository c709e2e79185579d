"""Transformer building blocks used by the Llama model (plain PyTorch).

Counterpart of the subset of ``modal_examples_tpu/models/layers.py`` that
Llama uses: ``rms_norm``, ``rotary_embedding`` (with llama-3.1
``rope_scaling``), ``apply_rope``, the dense ``mm`` and ``swiglu_mlp``.
Norms and softmax-adjacent math run in f32; products accumulate in f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


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


def mm(x, w):
    """``x @ w`` ([..., K] x [K, N]) with f32 accumulation, returned in f32."""
    if x.dtype == torch.float32:
        return x @ w.float()
    flat = x.reshape(-1, x.shape[-1])
    if x.is_cuda:
        out = torch.mm(flat, w, out_dtype=torch.float32)
    else:
        out = flat.float() @ w.float()
    return out.reshape(*x.shape[:-1], w.shape[-1])


def swiglu_mlp(params: dict, x):
    """silu(x W_gate) * (x W_up) W_down, with gate/up kept in f32 through the
    silu product (one rounding before the down projection)."""
    gate = mm(x, params["gate"])
    up = mm(x, params["up"])
    h = (F.silu(gate) * up).to(x.dtype)
    return mm(h, params["down"]).to(x.dtype)
