"""Int8-weight matmul: the kernel ``csrc/quantized_matmul.cu`` and its plain
version.

Counterpart of ``modal_examples_tpu/ops/quantized_matmul.py``
(``quantize_int8``, ``dequantize_int8``, ``quantized_matmul``): int8 weights
``[K, N]`` with per-output-channel f32 scales ``[1, N]`` times an activation
``[M, K]``, f32 accumulation, the scale applied once after the sum. The JAX
entry falls back to XLA for shapes that do not tile; the kernel here takes
every shape, on one of three paths it picks by shape (:func:`kernel_path`).

Dispatch is by the tensor's device and nothing else: a CPU tensor takes
:func:`qmm_plain`, a CUDA tensor launches the kernel or raises.
``qmm_launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

#: kernel launches since the last reset (the main path's proof of use)
qmm_launches = 0


def quantize_int8(w, axis: int = 0):
    """Symmetric per-channel int8 along ``axis`` (the JAX function: amax and
    the scale division at ``w``'s dtype, no clip). Returns (q int8, scale f32)."""
    amax = w.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax)).float()
    return torch.round(w.float() / scale).to(torch.int8), scale


def dequantize_int8(q, scale):
    return q.float() * scale


def qmm_plain(x, w_q, w_scale):
    """The kernel's function in plain PyTorch: ``(x @ q) * scale`` in f32
    (products of ``x``'s values and the int8 values, f32 sum), f32 out."""
    return (x.float() @ w_q.float()) * w_scale.float().reshape(1, -1)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


#: the kernel's three paths, by the number ``quantized_matmul_plan`` returns
PATHS = ("mma.sync", "ring", "wgmma")


def _lib():
    lib = _build.load("quantized_matmul")
    fn = lib.quantized_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.quantized_matmul_plan.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        lib.quantized_matmul_plan.restype = ctypes.c_int
    return lib


def _plan(lib, x, w_q, sms: int) -> tuple[int, int, int]:
    """(path, K splits, ticket ints) of a launch on ``x``, ``w_q``: the
    kernel's own plan, from the shapes, the SM count and whether each base
    is 16-byte aligned."""
    splits, tickets = ctypes.c_int(), ctypes.c_int()
    path = lib.quantized_matmul_plan(_build.ptr(x), _build.ptr(w_q), x.shape[0], w_q.shape[1], x.shape[1], sms,
                                     ctypes.byref(splits), ctypes.byref(tickets))
    return path, splits.value, tickets.value


def kernel_path(x, w_q) -> str:
    """The path a launch on ``x`` [M, K] and ``w_q`` [K, N] takes: "wgmma"
    (M > 64), "ring" (M <= 64), or "mma.sync" for what TMA cannot describe
    (N % 16 != 0, K % 8 != 0, a base not 16-byte aligned)."""
    dev = x.device
    return PATHS[_plan(_lib(), x, w_q, _sm_count(dev.index if dev.index is not None else torch.cuda.current_device()))[0]]


def qmm_cuda(x, w_q, w_scale):
    """Launch ``csrc/quantized_matmul.cu``: bf16 ``x`` [M, K], int8 ``w_q``
    [K, N], f32 ``w_scale`` with N values; returns f32 [M, N]. The kernel
    picks its path by shape (:func:`kernel_path`); one launch in every case."""
    global qmm_launches
    dev = x.device
    if not (x.is_cuda and w_q.is_cuda and w_scale.is_cuda) or w_q.device != dev or w_scale.device != dev:
        raise ValueError(f"x, w_q and w_scale must be CUDA tensors on one device; got {x.device}, {w_q.device}, {w_scale.device}")
    if x.dtype != torch.bfloat16 or w_q.dtype != torch.int8 or w_scale.dtype != torch.float32:
        raise ValueError(f"want bf16 x, int8 w_q, f32 w_scale; got {x.dtype}, {w_q.dtype}, {w_scale.dtype}")
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0] or w_scale.numel() != w_q.shape[1]:
        raise ValueError(f"shapes x {tuple(x.shape)}, w_q {tuple(w_q.shape)}, w_scale {tuple(w_scale.shape)} disagree")
    for name, t in (("x", x), ("w_q", w_q), ("w_scale", w_scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    M, K = x.shape
    N = w_q.shape[1]
    sms = _sm_count(dev.index if dev.index is not None else torch.cuda.current_device())
    lib = _lib()
    _, splits, n_tickets = _plan(lib, x, w_q, sms)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    part = torch.empty((splits, M, N), dtype=torch.float32, device=dev) if splits > 1 else out
    tickets = _build.ticket_buffer("quantized_matmul", dev, n_tickets) if n_tickets else out
    err = lib.quantized_matmul(
        _build.ptr(x), _build.ptr(w_q), _build.ptr(w_scale), _build.ptr(out), _build.ptr(part), _build.ptr(tickets),
        M, N, K, sms, _build.stream_ptr(dev),
    )
    qmm_launches += 1
    _build.check(lib, "quantized_matmul", err)
    return out


def quantized_matmul(x, w_q, w_scale):
    """``[M, K] x int8 [K, N] -> [M, N]`` in ``x``'s dtype. ``x`` enters the
    product at bf16, as the JAX kernel casts it; the sum is f32 and the scale
    applies once after it."""
    if x.dim() != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} does not multiply w_q {tuple(w_q.shape)}")
    xb = x.to(torch.bfloat16)
    if x.device.type == "cpu":
        return qmm_plain(xb, w_q, w_scale).to(x.dtype)
    return qmm_cuda(xb.contiguous(), w_q, w_scale.contiguous()).to(x.dtype)
