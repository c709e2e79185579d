"""Transformer building blocks used by the Llama model (plain PyTorch).

Counterpart of ``modal_examples_tpu/models/layers.py``: ``rms_norm``,
``layer_norm``, ``rotary_embedding`` (with llama-3.1 ``rope_scaling``),
``apply_rope``, ``mm`` (dense, or over an int8 or int4 ``QuantizedWeight``
through the int8 or int4 matmul kernel), the LoRA-aware projections
``_proj_f32``/``_proj``, ``swiglu_mlp``, ``quick_gelu``, ``gelu_mlp``,
``attention_op`` and ``causal_self_attention``. Norms and softmax-adjacent math run in f32;
products accumulate in f32. Three helpers serve the other models:
``SeededInit`` (random parameters drawn on the device), ``from_numpy_tree``
(a JAX parameter tree's numpy leaves as tensors), ``exact_f32_convs``
(cuDNN's f32 convolutions without TF32), ``check_exact_f32_matmuls``
(an f32 model's products refuse to run where PyTorch lets them take TF32)
and ``conv_same_nhwc`` (XLA's "SAME" convolution over NHWC inputs and HWIO
kernels, the JAX vision models' layout).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import flash_attention as _flash
from ..ops import quantized_matmul as _qmm
from ..ops import reference
from ..utils import tree
from .quantize import QuantizedWeight


def rms_norm(x, weight, eps: float = 1e-5):
    """RMSNorm in f32, cast back to the input dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm in f32 (mean, then the mean squared deviation), cast back to
    the input dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * weight.float() + bias.float()).to(x.dtype)


def rotary_embedding(positions, head_dim: int, theta: float = 10000.0, rope_scaling: dict | None = None):
    """f32 cos/sin tables at ``positions`` ([..., S]): [..., S, head_dim/2].

    ``rope_scaling`` takes the llama-3.1 keys (factor, low_freq_factor,
    high_freq_factor, original_max_position_embeddings): low frequencies are
    stretched by ``factor``, high ones kept, the band between interpolated."""
    half = head_dim // 2
    idx = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    # the base filled on the device: a tensor copied from the host would wait
    # for the stream, and so for every launch queued before it
    base = torch.full((half,), theta, dtype=torch.float32, device=positions.device)
    freqs = torch.pow(base, -idx / half)
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


class _MmPromoted(torch.autograd.Function):
    """``x @ w`` with f32 on one side (f32 adapters over an int8 base meet
    bf16 activations): the product in f32, as ``jnp.dot`` promotes it. The
    inputs are saved in their own dtypes and upcast again in the backward,
    so a bf16 ``x`` is not kept as an f32 copy for each adapter. The
    backward is the VJP of the promoted product: ``dX = dY @ w^T`` and
    ``dW = x^T @ dY`` in f32, each rounded to its input's dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return x.float() @ w.float()

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = (dy @ w.float().T).to(x.dtype) if ctx.needs_input_grad[0] else None
        dw = (x.float().T @ dy).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw


class _QMm(torch.autograd.Function):
    """``(x @ q) * scale`` over a frozen int8 or int4 weight: the forward on
    the int8 matmul kernel or the int4 one (their plain versions for CPU
    tensors), the backward the VJP of JAX's ``jnp.dot(x, q.astype(x.dtype),
    preferred_element_type=f32) * scale``: ``dX = (dY * scale) @ q^T`` in
    x's dtype. ``q`` (int4: unpacked) is converted for this one product and
    freed after it, so a backward over the whole base holds one layer's
    model-dtype copy at a time. ``q`` and ``scale`` get no gradient."""

    @staticmethod
    def forward(ctx, x, q, scale, bits):
        ctx.save_for_backward(q, scale)
        ctx.x_dtype, ctx.bits, ctx.rows = x.dtype, bits, x.shape[-1]
        if bits == 4:
            qmm = _qmm.qmm_int4_cuda if x.is_cuda else _qmm.qmm_int4_plain
        else:
            qmm = _qmm.qmm_cuda if x.is_cuda else _qmm.qmm_plain
        return qmm(x, q, scale)

    @staticmethod
    def backward(ctx, dy):
        q, scale = ctx.saved_tensors
        dy = (dy * scale).to(ctx.x_dtype)
        if ctx.bits == 4:
            q = _qmm.unpack_int4(q, ctx.rows)
        return dy @ q.to(ctx.x_dtype).T, None, None, None


def mm(x, w):
    """``x @ w`` ([..., K] x [K, N]) with f32 accumulation, returned in f32.
    ``w`` may be a :class:`QuantizedWeight`: ``(x @ q) * scale``, through
    the int8 matmul kernel or the int4 one on the card (their plain versions
    on the CPU), and differentiable in ``x`` (the quantized LoRA base)."""
    # no gradient to record (serving): each product's forward, called
    # directly, without an autograd node's host cost a launch
    graph = torch.is_grad_enabled() and (x.requires_grad or getattr(w, "requires_grad", False))
    if isinstance(w, QuantizedWeight):
        flat = x.reshape(-1, x.shape[-1]).contiguous()
        if graph:
            out = _QMm.apply(flat, w.q, w.scale, w.bits)
        elif w.bits == 4:
            out = (_qmm.qmm_int4_cuda if x.is_cuda else _qmm.qmm_int4_plain)(flat, w.q, w.scale)
        else:
            out = (_qmm.qmm_cuda if x.is_cuda else _qmm.qmm_plain)(flat, w.q, w.scale)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    flat = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32 or w.dtype == torch.float32:
        out = _MmPromoted.apply(flat, w) if graph else flat.float() @ w.float()
        return out.reshape(*x.shape[:-1], w.shape[-1])
    if x.is_cuda:
        out = _MmF32.apply(flat, w) if graph else torch.mm(flat, w, out_dtype=torch.float32)
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


def quick_gelu(x):
    """CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def gelu_mlp(params: dict, x, *, exact: bool = False):
    """GELU feed-forward with biases (``fc_w``, ``fc_b``, ``proj_w``,
    ``proj_b``): f32 sums, the activation in f32 and rounded to the input
    dtype before the second product. ``exact`` selects erf-GELU (BERT,
    Whisper) over the tanh approximation."""
    h = mm(x, params["fc_w"]) + params["fc_b"].float()
    h = F.gelu(h, approximate="none" if exact else "tanh").to(x.dtype)
    return (mm(h, params["proj_w"]) + params["proj_b"].float()).to(x.dtype)


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


class SeededInit:
    """Random parameters drawn on one device in one dtype from a seeded
    ``torch.Generator`` (a full-size init never holds an f32 copy): ``dense``
    is N(0, 1) times ``scale``, by default fan_in**-0.5 with fan_in the
    contraction dim ``shape[-2]`` (the JAX ``init_dense``); ``full`` a
    constant (zero biases and zero-init leaves, unit norms)."""

    def __init__(self, seed: int, device: torch.device, dtype: torch.dtype):
        self.device, self.dtype = device, dtype
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def dense(self, *shape: int, scale: float | None = None):
        fan_in = shape[-2] if len(shape) >= 2 else shape[0]
        w = torch.randn(shape, generator=self.gen, device=self.device, dtype=self.dtype)
        return w.mul_(fan_in**-0.5 if scale is None else scale)

    def full(self, value: float, *shape: int):
        return torch.full(shape, value, device=self.device, dtype=self.dtype)


def from_numpy_tree(np_tree, dtype: torch.dtype, device: torch.device, transform=None):
    """A JAX parameter tree with numpy leaves (bf16 ones as ml_dtypes arrays)
    as the same structure of ``dtype`` tensors on ``device``. ``transform``
    (numpy in, numpy out) changes a leaf's layout first; values are kept
    exactly (every bf16 and f32 value is an f32 value)."""

    def conv(a):
        a = np.asarray(a, np.float32)
        if transform is not None:
            a = transform(a)
        return torch.tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    return tree.map(conv, np_tree)


@contextlib.contextmanager
def exact_f32_convs():
    """cuDNN's f32 convolutions in f32, not TF32, for the block's duration:
    PyTorch lets cuDNN use TF32 by default, which the f32 models' reference
    does not. The other cuDNN flags keep their values; the previous ones
    come back on exit."""
    c = torch.backends.cudnn
    with c.flags(enabled=c.enabled, benchmark=c.benchmark, deterministic=c.deterministic, allow_tf32=False):
        yield


def check_exact_f32_matmuls(device) -> None:
    """Raise where PyTorch would run f32 matmuls on ``device`` in TF32 (which
    rounds the inputs to a 10-bit mantissa; the f32 models' reference does
    not): ``torch.backends.cuda.matmul.allow_tf32`` set, or a float32 matmul
    precision below "highest". The defaults pass; the CPU never takes TF32."""
    if torch.device(device).type != "cuda":
        return
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "an f32 model's products would take TF32 on the card: set torch.backends.cuda.matmul.allow_tf32 = "
            "False and torch.set_float32_matmul_precision('highest') (the defaults)"
        )


def conv_same_nhwc(x, w, stride=1):
    """XLA's "SAME" convolution of NHWC ``x`` [B, H, W, Cin] with an HWIO
    kernel [k, k, Cin, Cout] (``lax.conv_general_dilated`` with
    ``("NHWC", "HWIO", "NHWC")``): each spatial side padded by
    ``max((ceil(n/s) - 1) * s + k - n, 0)``, the smaller half first.
    ``stride`` an int or (sh, sw). Returns NHWC."""
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    pads = []
    for n, k, st in ((x.shape[1], w.shape[0], sh), (x.shape[2], w.shape[1], sw)):
        total = max((-(-n // st) - 1) * st + k - n, 0)
        pads.append((total // 2, total - total // 2))
    (top, bottom), (left, right) = pads
    xc = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
    return F.conv2d(xc, w.permute(3, 2, 0, 1), stride=(sh, sw)).permute(0, 2, 3, 1)
