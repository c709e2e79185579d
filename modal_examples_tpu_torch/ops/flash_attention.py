"""Flash attention forward: the CUDA kernel ``csrc/flash_fwd.cu`` and its plain
version.

Counterpart of ``modal_examples_tpu/ops/flash_attention.py`` (forward only:
``flash_attention``, ``flash_attention_with_lse``, ``flash_attention_chunked``).
Layouts match the JAX functions: q ``[B, Hq, S, D]``, k/v ``[B, Hkv, Skv, D]``,
Hq a multiple of Hkv (GQA).

Dispatch is by the tensor's device and nothing else: a CPU tensor takes the
plain version (:func:`flash_forward_plain`), a CUDA tensor launches the
kernel or raises. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: kernel launches since the last reset (the main path's proof of use)
launches = 0

_KERNEL_HEAD_DIMS = (32, 64, 128, 256)


def _resolve_scale(D: int, sm_scale: float | None) -> float:
    return D**-0.5 if sm_scale is None else sm_scale


def _check_shapes(q, k, v, causal: bool, q_offset: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,Hq,S,D], k/v [B,Hkv,Skv,D]; got {q.shape}, {k.shape}, {v.shape}")
    B, Hq, S, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on batch or head dim")
    Hkv, Skv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"query heads {Hq} not a multiple of kv heads {Hkv}")
    if causal and q_offset + S > Skv:
        raise ValueError(f"q_offset {q_offset} + q len {S} exceeds kv len {Skv}")


def flash_forward_plain(q, k, v, *, causal: bool, sm_scale: float, q_offset: int = 0):
    """The kernel's function in plain PyTorch, with its numerics: q scaled in
    f32 before Q.K^T, f32 softmax and P.V, one rounding of ``o`` at the end.
    Returns (o [B, Hq, S, D], lse [B, Hq, S] f32)."""
    B, Hq, S, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Hkv, Hq // Hkv, S, D) * sm_scale
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float())
    if causal:
        rows = q_offset + torch.arange(S, device=q.device)[:, None]
        cols = torch.arange(Skv, device=q.device)[None, :]
        s = s.masked_fill(rows < cols, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float()) / l_safe
    lse = torch.where(l > 0, m + torch.log(l_safe), torch.full_like(l, float("-inf")))
    return o.reshape(B, Hq, S, D).to(q.dtype), lse.reshape(B, Hq, S)


def _lib():
    lib = _build.load("flash_fwd")
    fn = lib.flash_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def flash_forward_cuda(q, k, v, *, causal: bool, sm_scale: float, q_offset: int = 0):
    """Launch ``csrc/flash_fwd.cu``: bf16, contiguous, head dim in 32/64/128/256."""
    global launches
    B, Hq, S, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash kernel takes bfloat16; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel head dim must be one of {_KERNEL_HEAD_DIMS}; got {D}")
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    lib = _lib()
    err = lib.flash_fwd(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o), _build.ptr(lse),
        B, Hq, Hkv, S, Skv, D, q_offset, int(causal), sm_scale, _build.stream_ptr(q.device),
    )
    launches += 1
    _build.check(lib, "flash_fwd", err)
    return o, lse


def _flash_forward(q, k, v, *, causal: bool, sm_scale: float | None, q_offset: int = 0):
    _check_shapes(q, k, v, causal, q_offset)
    scale = _resolve_scale(q.shape[-1], sm_scale)
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, causal=causal, sm_scale=scale, q_offset=q_offset)
    return flash_forward_cuda(q, k, v, causal=causal, sm_scale=scale, q_offset=q_offset)


def flash_attention(q, k, v, causal: bool = True, sm_scale: float | None = None):
    """Fused attention: q [B,Hq,S,D], k/v [B,Hkv,S,D] (GQA when Hkv < Hq)."""
    return _flash_forward(q, k, v, causal=causal, sm_scale=sm_scale)[0]


def flash_attention_with_lse(q, k, v, *, causal: bool = True, sm_scale: float | None = None):
    """Also returns the per-row logsumexp [B, Hq, S] (f32)."""
    return _flash_forward(q, k, v, causal=causal, sm_scale=sm_scale)


def flash_attention_chunked(q, k, v, *, q_offset: int, causal: bool = True, sm_scale: float | None = None):
    """One query chunk at positions [q_offset, q_offset + S) against the full
    (or so-far) K/V: the chunked-prefill attention."""
    return _flash_forward(q, k, v, causal=causal, sm_scale=sm_scale, q_offset=q_offset)[0]
