"""Flash attention: the forward kernel ``csrc/flash_fwd.cu``, the backward
kernels ``csrc/flash_bwd_dq.cu`` and ``csrc/flash_bwd_dkv.cu``, and their
plain versions.

Counterpart of ``modal_examples_tpu/ops/flash_attention.py`` (``flash_attention``
and ``flash_attention_with_lse`` with their custom VJPs, forward-only
``flash_attention_chunked``). Layouts match the JAX functions: q
``[B, Hq, S, D]``, k/v ``[B, Hkv, Skv, D]``, Hq a multiple of Hkv (GQA).

``flash_attention`` and ``flash_attention_with_lse`` are differentiable
through :class:`_FlashAttention`: the forward saves ``q, k, v, o, lse``, the
backward computes ``delta = rowsum(dO*O)`` in f32 and runs the dQ and dK/dV
kernels (their plain versions for CPU tensors).

Dispatch is by the tensor's device and nothing else: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises. On the card the
dtype picks the instance: bf16 runs the wgmma kernels above, f32 their f32
instances (``csrc/flash_fwd_f32.cu``, ``csrc/flash_bwd_dq_f32.cu``,
``csrc/flash_bwd_dkv_f32.cu``), as the reference's kernels compute at any
input dtype; any other dtype raises. The f32 instances run every product on
the tensor cores, f32-accurate by a 3xTF32 split (three TF32 products a
product, ``csrc/flash_tf32.cuh``), over tiles that TMA loads. Their plain
twins are the plain versions above, run at f32.

The kernels are built at head dims 32, 64, 128 and 256 (bf16) and 32, 64
and 128 (f32); the reference computes at any D. Every ``*_cuda`` wrapper
hands any other D to :func:`at_instance`, which zero-pads it up to the next
instance, calls the wrapper again and slices the outputs back, so any
1 <= D <= 256 (bf16) or D <= 128 (f32) runs on the kernels; the backward
pads once for its two kernels. What no instance takes (f32 above 128,
anything above 256) raises, naming the departure (:func:`kernel_head_dim`).

``launches``, ``dq_launches`` and ``dkv_launches`` count the bf16 kernels'
launches, ``f32_launches``, ``dq_f32_launches`` and ``dkv_f32_launches`` the
f32 instances'.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

#: kernel launches since the last reset (the main path's proof of use)
launches = 0
dq_launches = 0
dkv_launches = 0
f32_launches = 0
dq_f32_launches = 0
dkv_f32_launches = 0

_KERNEL_HEAD_DIMS = (32, 64, 128, 256)
_F32_HEAD_DIMS = (32, 64, 128)


def kernel_head_dim(D: int, dtype) -> int:
    """The instance a head dim of ``D`` runs at on the card in ``dtype``: the
    smallest built one at least ``D`` (f32: 32/64/128; else the bf16
    kernels' 32/64/128/256), the inputs zero-padded up to it
    (:func:`at_instance`). Raises ``ValueError`` naming the departure where
    none is wide enough."""
    dims = _F32_HEAD_DIMS if dtype == torch.float32 else _KERNEL_HEAD_DIMS
    if D < 1:
        raise ValueError(f"head dim must be positive; got {D}")
    for width in dims:
        if D <= width:
            return width
    if D <= _KERNEL_HEAD_DIMS[-1]:
        raise ValueError(
            f"the f32 flash kernels take head dim up to {dims[-1]}; got {D}. A departure: an f32 instance "
            f"wider than 128 does not fit shared memory (at D=256 K1-f32's split Q alone is 64 x 256 x 4 x 2 = "
            f"128 KB beside its K/V ring), and no shipped f32 config reaches it")
    raise ValueError(
        f"the flash kernels take head dim up to {_KERNEL_HEAD_DIMS[-1]}; got {D}. A departure: no instance is "
        f"wider, as the decode kernels stop at 256 (ops/paged_attention.py)")


def at_instance(launch, *args, **kw):
    """``launch(*args, **kw)`` at the instance for the first argument's head
    dim D (:func:`kernel_head_dim` in its dtype). Where D is not an
    instance, the 4-D arguments (q, k, v, do) are zero-padded along D to the
    instance's width (fresh contiguous tensors, so TMA's 16-byte alignment
    holds) and the 4-D outputs (o, dq, dk, dv) come back as views of their
    first D columns; the per-row ones (lse, delta, dlse) pass as they are.
    Exact: zero columns add nothing to Q.K^T, dO.V^T, dS.K, dS^T.Q or
    P^T.dO, and the padded output columns are dropped. ``sm_scale`` arrives
    in ``kw`` already resolved from the true D and is passed on untouched:
    it must not follow the padded width. An instance's own D takes the
    launch as it is, with no copy. ``launch`` may be a plain version (the
    CPU tests drive it so)."""
    D = args[0].shape[-1]
    width = kernel_head_dim(D, args[0].dtype)
    if width == D:
        return launch(*args, **kw)
    out = launch(*(F.pad(a, (0, width - D)) if a.dim() == 4 else a for a in args), **kw)

    def trim(t):
        return t[..., :D] if t.dim() == 4 else t

    return tuple(map(trim, out)) if isinstance(out, tuple) else trim(out)


def _padded(q) -> bool:
    """Whether q's head dim is no instance, so its launch goes through
    :func:`at_instance` (which raises where none is wide enough)."""
    return kernel_head_dim(q.shape[-1], q.dtype) != q.shape[-1]


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


def _check_kernel_inputs(what: str, tensors: tuple) -> None:
    """A launch's inputs, each ``(name, tensor, dtype)``: on the first one's
    card, of its dtype, contiguous; the tiled [B, H, S, D] ones on 16-byte
    boundaries (TMA loads their tiles). The head dim is the wrapper's
    guard's (:func:`_padded`)."""
    device = tensors[0][1].device
    for name, t, dt in tensors:
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{name} must be a CUDA tensor on {device}")
        if t.dtype != dt:
            raise ValueError(f"{what} takes {dt} {name}; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dim() == 4 and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (its tiles are loaded by TMA)")


def _lib(name: str = "flash_fwd"):
    lib = _build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def flash_forward_cuda(q, k, v, *, causal: bool, sm_scale: float, q_offset: int = 0):
    """Launch ``csrc/flash_fwd.cu``: bf16, contiguous, 16-byte aligned, head
    dim up to 256 (:func:`at_instance` pads it to 32/64/128/256). The kernel
    runs Q.K^T and P.V on wgmma over tiles that TMA brings into a
    shared-memory ring; it rounds P to bf16 for P.V. An f32 ``q`` goes to
    the f32 instance (:func:`flash_forward_f32_cuda`)."""
    global launches
    if q.dtype == torch.float32:
        return flash_forward_f32_cuda(q, k, v, causal=causal, sm_scale=sm_scale, q_offset=q_offset)
    if _padded(q):
        return at_instance(flash_forward_cuda, q, k, v, causal=causal, sm_scale=sm_scale, q_offset=q_offset)
    B, Hq, S, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    _check_kernel_inputs("the flash kernel", tuple((n, t, torch.bfloat16) for n, t in (("q", q), ("k", k), ("v", v))))
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


def flash_forward_f32_plain(q, k, v, *, causal: bool, sm_scale: float, q_offset: int = 0):
    """The f32 instance's plain twin: :func:`flash_forward_plain` at f32."""
    return flash_forward_plain(q, k, v, causal=causal, sm_scale=sm_scale, q_offset=q_offset)


def flash_forward_f32_cuda(q, k, v, *, causal: bool, sm_scale: float, q_offset: int = 0):
    """Launch ``csrc/flash_fwd_f32.cu``: f32 q/k/v, contiguous, 16-byte
    aligned (TMA loads the K/V tiles), head dim up to 128 (padded to
    32/64/128). Both products run on the tensor cores as three TF32 products
    each (the 3xTF32 split: f32-accurate, never one TF32 pass), the online
    softmax in f32; o is f32."""
    global f32_launches
    if _padded(q):
        return at_instance(flash_forward_f32_cuda, q, k, v, causal=causal, sm_scale=sm_scale, q_offset=q_offset)
    B, Hq, S, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    _check_kernel_inputs("the f32 flash kernel", tuple((n, t, torch.float32) for n, t in (("q", q), ("k", k), ("v", v))))
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    lib = _lib("flash_fwd_f32")
    err = lib.flash_fwd_f32(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o), _build.ptr(lse),
        B, Hq, Hkv, S, Skv, D, q_offset, int(causal), sm_scale, _build.stream_ptr(q.device),
    )
    f32_launches += 1
    _build.check(lib, "flash_fwd_f32", err)
    return o, lse


def _flash_forward(q, k, v, *, causal: bool, sm_scale: float | None, q_offset: int = 0):
    _check_shapes(q, k, v, causal, q_offset)
    scale = _resolve_scale(q.shape[-1], sm_scale)
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, causal=causal, sm_scale=scale, q_offset=q_offset)
    return flash_forward_cuda(q, k, v, causal=causal, sm_scale=scale, q_offset=q_offset)


# -- backward --------------------------------------------------------------------
# With P = exp(scale * Q.K^T - lse) (0 where lse = -inf, a fully masked row):
#   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta + dlse),  delta = rowsum(dO * O)
#   dQ = scale * dS K,  dK = scale * dS^T Q
# dlse is the lse output's cotangent (zero for flash_attention).


def _bwd_p_ds(q, k, v, do, lse, delta, dlse, *, causal: bool, sm_scale: float):
    """f32 P and dS, grouped: [B, Hkv, G, S, S] (G query heads per kv head)."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    s = torch.einsum("bhgqd,bhkd->bhgqk", q.float().reshape(B, Hkv, G, S, D), k.float()) * sm_scale
    if causal:
        rows = torch.arange(S, device=q.device)[:, None]
        cols = torch.arange(S, device=q.device)[None, :]
        s = s.masked_fill(rows < cols, float("-inf"))

    def rows_of(t):
        return t.float().reshape(B, Hkv, G, S, 1)

    lse_r = rows_of(lse)
    finite = torch.isfinite(lse_r)
    p = torch.where(finite, torch.exp(s - torch.where(finite, lse_r, torch.zeros_like(lse_r))), torch.zeros_like(s))
    dp = torch.einsum("bhgqd,bhkd->bhgqk", do.float().reshape(B, Hkv, G, S, D), v.float())
    return p, p * (dp - rows_of(delta) + rows_of(dlse))


def flash_bwd_dq_plain(q, k, v, do, lse, delta, dlse, *, causal: bool, sm_scale: float):
    """dQ = scale * dS K in f32, one rounding to q's dtype."""
    _, ds = _bwd_p_ds(q, k, v, do, lse, delta, dlse, causal=causal, sm_scale=sm_scale)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float()) * sm_scale
    return dq.reshape(q.shape).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, dlse, *, causal: bool, sm_scale: float):
    """dK = scale * dS^T Q and dV = P^T dO, summed over each kv head's query
    heads in f32, one rounding to k's and v's dtypes."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    p, ds = _bwd_p_ds(q, k, v, do, lse, delta, dlse, causal=causal, sm_scale=sm_scale)
    qg = q.float().reshape(B, Hkv, Hq // Hkv, S, D)
    dog = do.float().reshape(B, Hkv, Hq // Hkv, S, D)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg) * sm_scale
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dog)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_plain(q, k, v, o, lse, do, dlse, *, causal: bool, sm_scale: float):
    """The backward kernels' function written out: (dq, dk, dv) from the
    forward's ``o`` and ``lse``, the output cotangent ``do`` and the lse
    cotangent ``dlse`` ([B, Hq, S], zeros when lse is not an output)."""
    delta = (do.float() * o.float()).sum(dim=-1)
    args = (q, k, v, do, lse, delta, dlse)
    dq = flash_bwd_dq_plain(*args, causal=causal, sm_scale=sm_scale)
    dk, dv = flash_bwd_dkv_plain(*args, causal=causal, sm_scale=sm_scale)
    return dq, dk, dv


def _check_bwd_inputs(q, k, v, do, lse, delta, dlse, dtype=torch.bfloat16) -> None:
    """The backward kernels' inputs: q/k/v/do of ``dtype`` (bf16: the wgmma
    kernels; f32: the f32 instances) and 16-byte aligned (TMA loads their
    tiles), f32 lse/delta/dlse [B, Hq, S]."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    if k.shape != (B, Hkv, S, D) or v.shape != k.shape or do.shape != q.shape:
        raise ValueError(f"want q/do [B,Hq,S,D], k/v [B,Hkv,S,D]; got {q.shape}, {k.shape}, {v.shape}, {do.shape}")
    if Hq % Hkv:
        raise ValueError(f"query heads {Hq} not a multiple of kv heads {Hkv}")
    bf16 = dtype == torch.bfloat16
    _check_kernel_inputs(
        "flash backward kernels" if bf16 else "the f32 flash backward kernels",
        (("q", q, dtype), ("k", k, dtype), ("v", v, dtype), ("do", do, dtype), ("lse", lse, torch.float32),
         ("delta", delta, torch.float32), ("dlse", dlse, torch.float32)),
    )
    for name, t in (("lse", lse), ("delta", delta), ("dlse", dlse)):
        if t.shape != (B, Hq, S):
            raise ValueError(f"{name} must be [B, Hq, S] = {(B, Hq, S)}; got {tuple(t.shape)}")


def _bwd_lib(name: str):
    lib = _build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        n_ptrs = 8 if name.startswith("flash_bwd_dq") else 9
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, dlse, *, causal: bool, sm_scale: float):
    """Launch ``csrc/flash_bwd_dq.cu``: bf16 q/k/v/do, f32 lse/delta/dlse
    [B, Hq, S], all contiguous, the bf16 ones 16-byte aligned (TMA loads
    their tiles; S, dP and dQ run on wgmma). Returns dq in bf16. An f32
    ``q`` goes to the f32 instance (:func:`flash_bwd_dq_f32_cuda`)."""
    global dq_launches
    if q.dtype == torch.float32:
        return flash_bwd_dq_f32_cuda(q, k, v, do, lse, delta, dlse, causal=causal, sm_scale=sm_scale)
    if _padded(q):
        return at_instance(flash_bwd_dq_cuda, q, k, v, do, lse, delta, dlse, causal=causal, sm_scale=sm_scale)
    _check_bwd_inputs(q, k, v, do, lse, delta, dlse)
    B, Hq, S, D = q.shape
    dq = torch.empty_like(q)
    lib = _bwd_lib("flash_bwd_dq")
    err = lib.flash_bwd_dq(
        *(_build.ptr(t) for t in (q, k, v, do, lse, delta, dlse, dq)),
        B, Hq, k.shape[1], S, D, int(causal), sm_scale, _build.stream_ptr(q.device),
    )
    dq_launches += 1
    _build.check(lib, "flash_bwd_dq", err)
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, dlse, *, causal: bool, sm_scale: float):
    """Launch ``csrc/flash_bwd_dkv.cu``: inputs as :func:`flash_bwd_dq_cuda`
    (all four products run on wgmma). Returns (dk, dv) in bf16, already
    summed over each kv head's query heads. An f32 ``q`` goes to the f32
    instance (:func:`flash_bwd_dkv_f32_cuda`)."""
    global dkv_launches
    if q.dtype == torch.float32:
        return flash_bwd_dkv_f32_cuda(q, k, v, do, lse, delta, dlse, causal=causal, sm_scale=sm_scale)
    if _padded(q):
        return at_instance(flash_bwd_dkv_cuda, q, k, v, do, lse, delta, dlse, causal=causal, sm_scale=sm_scale)
    _check_bwd_inputs(q, k, v, do, lse, delta, dlse)
    B, Hq, S, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _bwd_lib("flash_bwd_dkv")
    err = lib.flash_bwd_dkv(
        *(_build.ptr(t) for t in (q, k, v, do, lse, delta, dlse, dk, dv)),
        B, Hq, k.shape[1], S, D, int(causal), sm_scale, _build.stream_ptr(q.device),
    )
    dkv_launches += 1
    _build.check(lib, "flash_bwd_dkv", err)
    return dk, dv


def flash_bwd_dq_f32_plain(q, k, v, do, lse, delta, dlse, *, causal: bool, sm_scale: float):
    """The f32 dQ instance's plain twin: :func:`flash_bwd_dq_plain` at f32."""
    return flash_bwd_dq_plain(q, k, v, do, lse, delta, dlse, causal=causal, sm_scale=sm_scale)


def flash_bwd_dq_f32_cuda(q, k, v, do, lse, delta, dlse, *, causal: bool, sm_scale: float):
    """Launch ``csrc/flash_bwd_dq_f32.cu``: every input f32 and contiguous,
    q/k/v/do also 16-byte aligned (TMA loads their tiles), head dim up to
    128 (padded to 32/64/128). S, dP and dQ = dS.K run on the tensor cores
    by the 3xTF32 split, P and dS in f32 registers. Returns dq in f32."""
    global dq_f32_launches
    if _padded(q):
        return at_instance(flash_bwd_dq_f32_cuda, q, k, v, do, lse, delta, dlse, causal=causal, sm_scale=sm_scale)
    _check_bwd_inputs(q, k, v, do, lse, delta, dlse, torch.float32)
    B, Hq, S, D = q.shape
    dq = torch.empty_like(q)
    lib = _bwd_lib("flash_bwd_dq_f32")
    err = lib.flash_bwd_dq_f32(
        *(_build.ptr(t) for t in (q, k, v, do, lse, delta, dlse, dq)),
        B, Hq, k.shape[1], S, D, int(causal), sm_scale, _build.stream_ptr(q.device),
    )
    dq_f32_launches += 1
    _build.check(lib, "flash_bwd_dq_f32", err)
    return dq


def flash_bwd_dkv_f32_plain(q, k, v, do, lse, delta, dlse, *, causal: bool, sm_scale: float):
    """The f32 dK/dV instance's plain twin: :func:`flash_bwd_dkv_plain` at f32."""
    return flash_bwd_dkv_plain(q, k, v, do, lse, delta, dlse, causal=causal, sm_scale=sm_scale)


def flash_bwd_dkv_f32_cuda(q, k, v, do, lse, delta, dlse, *, causal: bool, sm_scale: float):
    """Launch ``csrc/flash_bwd_dkv_f32.cu``: inputs as
    :func:`flash_bwd_dq_f32_cuda`. Its four products run on the tensor cores
    by the 3xTF32 split. Returns (dk, dv) in f32, summed over each kv head's query heads."""
    global dkv_f32_launches
    if _padded(q):
        return at_instance(flash_bwd_dkv_f32_cuda, q, k, v, do, lse, delta, dlse, causal=causal, sm_scale=sm_scale)
    _check_bwd_inputs(q, k, v, do, lse, delta, dlse, torch.float32)
    B, Hq, S, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _bwd_lib("flash_bwd_dkv_f32")
    err = lib.flash_bwd_dkv_f32(
        *(_build.ptr(t) for t in (q, k, v, do, lse, delta, dlse, dk, dv)),
        B, Hq, k.shape[1], S, D, int(causal), sm_scale, _build.stream_ptr(q.device),
    )
    dkv_f32_launches += 1
    _build.check(lib, "flash_bwd_dkv_f32", err)
    return dk, dv


def _flash_backward(q, k, v, o, lse, do, dlse, *, causal: bool, sm_scale: float):
    if k.shape[2] != q.shape[2]:  # as in JAX: the backward is for self-attention
        raise ValueError(f"flash backward wants kv len {k.shape[2]} == q len {q.shape[2]}")
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, o, lse, do, dlse, causal=causal, sm_scale=sm_scale)
    do = do.contiguous()
    delta = (do.float() * o.float()).sum(dim=-1)
    args = (q, k, v, do, lse, delta, dlse.contiguous())
    # a head dim between instances pads q, k, v and do once for both kernels
    return at_instance(_backward_kernels, *args, causal=causal, sm_scale=sm_scale)


def _backward_kernels(q, k, v, do, lse, delta, dlse, *, causal: bool, sm_scale: float):
    """(dq, dk, dv) from the dQ and dK/dV kernels on the same inputs."""
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, dlse, causal=causal, sm_scale=sm_scale)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, dlse, causal=causal, sm_scale=sm_scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """(o, lse) = flash attention of (q, k, v), differentiable in q, k, v
    through both outputs (the counterpart of the JAX custom VJPs)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        o, lse = _flash_forward(q, k, v, causal=causal, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):  # unused outputs arrive as zeros
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, o, lse, do, dlse, causal=ctx.causal, sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None


def _flash_differentiable(q, k, v, causal: bool, sm_scale: float | None):
    _check_shapes(q, k, v, causal, 0)
    return _FlashAttention.apply(q, k, v, causal, _resolve_scale(q.shape[-1], sm_scale))


def flash_attention(q, k, v, causal: bool = True, sm_scale: float | None = None):
    """Fused attention: q [B,Hq,S,D], k/v [B,Hkv,S,D] (GQA when Hkv < Hq)."""
    return _flash_differentiable(q, k, v, causal, sm_scale)[0]


def flash_attention_with_lse(q, k, v, *, causal: bool = True, sm_scale: float | None = None):
    """Also returns the per-row logsumexp [B, Hq, S] (f32); differentiable
    through both outputs."""
    return _flash_differentiable(q, k, v, causal, sm_scale)


def flash_attention_chunked(q, k, v, *, q_offset: int, causal: bool = True, sm_scale: float | None = None):
    """One query chunk at positions [q_offset, q_offset + S) against the full
    (or so-far) K/V: the chunked-prefill attention. Forward only, as in JAX."""
    return _flash_forward(q, k, v, causal=causal, sm_scale=sm_scale, q_offset=q_offset)[0]
