"""Int8- and int4-weight matmuls: the kernels ``csrc/quantized_matmul.cu``
(K7) and ``csrc/quantized_matmul_int4.cu`` (K7-int4) and their plain versions.

Counterpart of ``modal_examples_tpu/ops/quantized_matmul.py``
(``quantize_int8``, ``dequantize_int8``, ``quantized_matmul``): int8 weights
``[K, N]`` with per-output-channel f32 scales ``[1, N]`` times an activation
``[M, K]``, f32 accumulation, the scale applied once after the sum. The JAX
entry falls back to XLA for shapes that do not tile; the kernel here takes
every shape, on one of three paths it picks by shape (:func:`kernel_path`).

int4 weights are packed two contraction rows a byte (:func:`pack_int4`:
``[..., ceil(K/2), N]`` uint8, the even row in the low nibble), the layout
K7-int4 reads; the JAX package holds them as ``jnp.int4`` and multiplies
them through XLA's dot, so K7-int4 replaces no Pallas kernel. K7-int4 too
picks one of three paths by shape (:func:`int4_kernel_path`, the rule
mirrored in :func:`int4_path_rule`).

Dispatch is by the tensor's device and nothing else: a CPU tensor takes
:func:`qmm_plain` or :func:`qmm_int4_plain`, a CUDA tensor launches the
kernel or raises. ``qmm_launches`` and ``qmm_int4_launches`` count kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

#: kernel launches since the last reset (the main path's proof of use)
qmm_launches = 0
qmm_int4_launches = 0


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


# -- int4 ------------------------------------------------------------------------


def pack_int4(q):
    """int8 values in [-8, 7] ``[..., K, N]`` -> uint8 ``[..., ceil(K/2), N]``:
    byte ``(kp, n)`` holds row ``2 kp`` in its low nibble and row ``2 kp + 1``
    in its high nibble; an odd K is padded with a zero nibble."""
    if q.shape[-2] % 2:
        q = torch.cat([q, q.new_zeros((*q.shape[:-2], 1, q.shape[-1]))], dim=-2)
    b = q.contiguous().view(torch.uint8) & 0xF
    return b[..., 0::2, :] | (b[..., 1::2, :] << 4)


def unpack_int4(packed, rows: int):
    """The int8 values of :func:`pack_int4`'s bytes, ``[..., rows, N]``."""
    nib = torch.stack([packed & 0xF, packed >> 4], dim=-2).to(torch.int16)  # [..., Kp, 2, N]
    vals = ((nib ^ 8) - 8).to(torch.int8)  # sign-extend the nibble
    return vals.reshape(*packed.shape[:-2], 2 * packed.shape[-2], packed.shape[-1])[..., :rows, :]


def qmm_int4_plain(x, w_packed, w_scale):
    """K7-int4's function in plain PyTorch: ``(x @ q) * scale`` in f32 over
    the unpacked int4 values (K from ``x``), f32 out."""
    q = unpack_int4(w_packed, x.shape[-1])
    return (x.float() @ q.float()) * w_scale.float().reshape(1, -1)


#: K7-int4's three paths, by the number ``quantized_matmul_int4_path`` returns
INT4_PATHS = ("masked", "ring", "wgmma")


def _lib_int4():
    lib = _build.load("quantized_matmul_int4")
    fn = lib.quantized_matmul_int4
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.quantized_matmul_int4_plan.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
        lib.quantized_matmul_int4_plan.restype = ctypes.c_int
        lib.quantized_matmul_int4_path.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.quantized_matmul_int4_path.restype = ctypes.c_int
    return lib


def int4_path_rule(x, w_packed) -> str:
    """The path K7-int4's plan picks for ``x`` [M, K] and ``w_packed``
    [ceil(K/2), N], in Python: "wgmma" at M > 64 and "ring" at M <= 64 where
    TMA can describe both operands (16-byte aligned bases, N % 16 == 0,
    K % 8 == 0), "masked" for any other shape. ``int4_kernel_path`` asks the
    kernel itself; the two must agree."""
    (M, K), N = x.shape, w_packed.shape[1]
    tma = x.data_ptr() % 16 == 0 and w_packed.data_ptr() % 16 == 0 and N % 16 == 0 and K % 8 == 0 and K > 0
    return INT4_PATHS[0] if not tma else INT4_PATHS[2] if M > 64 else INT4_PATHS[1]


def int4_plan(x, w_packed) -> dict:
    """K7-int4's plan for a launch on ``x`` [M, K] and ``w_packed``: its path,
    rows of x a block, K splits (f32 partials summed in the launch above 1),
    K tiles a split and the depth of one (``k_tile``), ints of ticket
    scratch."""
    dev = x.device
    lib = _lib_int4()
    splits, chunk, tickets, k_tile = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    M, K, N = x.shape[0], x.shape[1], w_packed.shape[1]
    rows = lib.quantized_matmul_int4_plan(
        _build.ptr(x), _build.ptr(w_packed), M, N, K,
        _sm_count(dev.index if dev.index is not None else torch.cuda.current_device()),
        ctypes.byref(splits), ctypes.byref(chunk), ctypes.byref(tickets))
    path = lib.quantized_matmul_int4_path(_build.ptr(x), _build.ptr(w_packed), M, N, K, ctypes.byref(k_tile))
    return {"path": INT4_PATHS[path], "rows": rows, "splits": splits.value, "chunk": chunk.value,
            "k_tile": k_tile.value, "tickets": tickets.value}


def int4_kernel_path(x, w_packed) -> str:
    """The path a K7-int4 launch on ``x`` and ``w_packed`` takes, from the
    kernel's own plan (see :func:`int4_path_rule`)."""
    return int4_plan(x, w_packed)["path"]


def qmm_int4_cuda(x, w_packed, w_scale):
    """Launch ``csrc/quantized_matmul_int4.cu``: bf16 ``x`` [M, K], packed
    int4 ``w_packed`` uint8 [ceil(K/2), N], f32 ``w_scale`` with N values;
    returns f32 [M, N]. The kernel picks its path by shape
    (:func:`int4_kernel_path`); one launch in every case."""
    global qmm_int4_launches
    dev = x.device
    if not (x.is_cuda and w_packed.is_cuda and w_scale.is_cuda) or w_packed.device != dev or w_scale.device != dev:
        raise ValueError(
            f"x, w_packed and w_scale must be CUDA tensors on one device; got {x.device}, {w_packed.device}, "
            f"{w_scale.device}")
    if x.dtype != torch.bfloat16 or w_packed.dtype != torch.uint8 or w_scale.dtype != torch.float32:
        raise ValueError(f"want bf16 x, uint8 w_packed, f32 w_scale; got {x.dtype}, {w_packed.dtype}, {w_scale.dtype}")
    if x.dim() != 2 or w_packed.dim() != 2 or w_packed.shape[0] != (x.shape[1] + 1) // 2 \
            or w_scale.numel() != w_packed.shape[1]:
        raise ValueError(
            f"shapes x {tuple(x.shape)}, w_packed {tuple(w_packed.shape)}, w_scale {tuple(w_scale.shape)} disagree")
    for name, t in (("x", x), ("w_packed", w_packed), ("w_scale", w_scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    M, K = x.shape
    N = w_packed.shape[1]
    sms = _sm_count(dev.index if dev.index is not None else torch.cuda.current_device())
    lib = _lib_int4()
    splits, chunk, n_tickets = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib.quantized_matmul_int4_plan(_build.ptr(x), _build.ptr(w_packed), M, N, K, sms, ctypes.byref(splits),
                                   ctypes.byref(chunk), ctypes.byref(n_tickets))
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    part = torch.empty((splits.value, M, N), dtype=torch.float32, device=dev) if splits.value > 1 else out
    tickets = _build.ticket_buffer("quantized_matmul_int4", dev, n_tickets.value) if n_tickets.value else out
    err = lib.quantized_matmul_int4(
        _build.ptr(x), _build.ptr(w_packed), _build.ptr(w_scale), _build.ptr(out), _build.ptr(part),
        _build.ptr(tickets), M, N, K, sms, _build.stream_ptr(dev),
    )
    qmm_int4_launches += 1
    _build.check(lib, "quantized_matmul_int4", err)
    return out
