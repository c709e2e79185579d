"""One kernel of the port built from two source trees, timed in turns in one
process on one card.

``OTHER`` is another ``csrc`` directory: for example the parent commit's,
unpacked with ``git archive`` into a git-ignored directory. Both libraries
build from their sources (``ops/_build.py``; the other one into
``build/kernels_ab/``), both are held against the plain version on the timed
inputs, then each is timed in the order this, other, other, this (``--rounds``
times) four ways: CUDA events around 50 back-to-back launches
(``chip_smoke.back_to_back_ms``), the median of 20 single launches each
between its own events (``chip_smoke.time_ms``, phase 5's ``ms``), the
device time of 40 launches queued behind a spin kernel between CUDA events
(``chip_smoke.device_ms``), and the kernels' own time of 40 launches under
``torch.profiler`` (every kernel a launch runs, summed: ``profiler_ms``,
sound in a fresh process such as this one). Back-to-back is the kernel's
time only while the host enqueues faster than the card runs; for a kernel
shorter than the wrapper's host time (~0.03-0.05 ms) only the last two
are. The int8 matmul cycles
over four weight copies (more than the 50 MB L2), as a decode step streams
its weights, at M = 8 over every weight shape of Llama-2-7B and at M = 2048;
the int4 matmul (K7-int4) the same way, and at M = 1024 (a QLoRA step's
B=2 x S=512 forward), through either library's C API (the other tree's may
predate the path query).
The decode kernels (ragged and write-then-attend, bf16 and int8 pages)
cycle over four layers of one cache (``chip_smoke.CYCLED_LAYERS``), at phase
5's shape (8 slots, prefixes 0..1000, Hq = Hkv = 32), the burst's (8 slots at
prefixes 20..760) and a GQA one (Hkv = 8); the write-then-attend kernels
read each layer's pages as the contiguous view ``pages[li]``, with contexts
of the prefix plus the current token. The other tree's kernel may be the one
before the split design (its C entry takes no workspace; for the
write-then-attend decode, bf16 pages only). Their error is
max|o - plain| / max|plain| per (sequence, head) row. The scatter kernels
(bf16 and int8 pages) run at ``chip_smoke.SCATTER_SHAPES`` through the
wrappers a caller uses (``chip_smoke.scatter_timed``): a decode step's 8
tokens x 32 layers, cycled over 32 sets of rows and targets (134 MB, more
than the L2); the prefill batch's 2048 tokens x 32 layers; and one layer's view of 8
tokens through ``scatter_kv_layer``, cycled over the 32 layers of one
cache. Each must be bitwise equal to its plain version (error 0.0); the
other tree's int8 scatter may be the one before the row partition (its C
entry takes none). ``paged_decode_writeback_fold`` is the write-then-attend
step of one layer at the decode shapes: this tree's K4 writing each
layer's 8 new rows itself (the folded write) against the other tree's K3
over the one-layer view followed by its K4 (a library without the folded
write: its C entry takes no new rows), cycled over the four layers, each
with its own new rows; its error is the largest difference from this
tree's K3 -> K4 output (0.0: bitwise). The f32 flash instances
(``flash_fwd_f32``, ``flash_bwd_dq_f32``, ``flash_bwd_dkv_f32``) run at
``chip_smoke.F32_TIMED``'s causal shapes (GPT's default config, the f32
Llama of phase 20c, that shape at S=1024 and 2048) through their wrappers
(both trees' C entries take the same arguments), held as max|out - plain| /
max|plain| over their outputs; each round also takes PyTorch's f32
attention on the same inputs (``chip_smoke.f32_library``: the forward for
``flash_fwd_f32``, the backward, dQ, dK and dV together, for the other two)
in the same three ways, as ``library_*``.
Prints one JSON line per shape. Run from the repository root on one GPU:

    python3 benchmarks_torch/kernel_ab.py OTHER [--kernel flash_fwd|flash_bwd_dq|flash_bwd_dkv|quantized_matmul|
        flash_fwd_f32|flash_bwd_dq_f32|flash_bwd_dkv_f32|quantized_matmul_int4|
        paged_decode|paged_decode_int8|paged_decode_writeback|paged_decode_writeback_int8|
        paged_decode_writeback_fold|kv_scatter|kv_scatter_int8] [--rounds R]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from modal_examples_tpu_torch.ops import _build  # noqa: E402
from modal_examples_tpu_torch.ops import flash_attention as fa  # noqa: E402
from modal_examples_tpu_torch.ops import paged_attention as pa  # noqa: E402
from modal_examples_tpu_torch.ops import quantized_matmul as qmm  # noqa: E402

# flash kernels: (B, H, S), phase 5's prefill batch for the forward, the
# training step's for the backward; the int8 matmul: M over K x N
SHAPES = {
    "flash_fwd": [(4, 32, 512), (2, 32, 512)],
    "flash_bwd_dq": [(2, 32, 512)],
    "flash_bwd_dkv": [(2, 32, 512)],
    "quantized_matmul": [(8, 4096, 4096), (8, 4096, 11008), (8, 11008, 4096), (8, 4096, 32000),
                         (2048, 4096, 11008)],
    "quantized_matmul_int4": [(8, 4096, 4096), (8, 4096, 11008), (8, 11008, 4096), (8, 4096, 32000),
                              (1024, 4096, 11008), (2048, 4096, 11008)],
}
# the ragged decode kernels: (label, Hkv, prefixes) at B = 8, Hq = 32
DECODE_SHAPES = [("phase 5", 32, cs.DECODE_LENS), ("burst", 32, (20, 64, 130, 200, 300, 450, 511, 760)),
                 ("GQA", 8, cs.DECODE_LENS)]
DECODE_KERNELS = ("paged_decode", "paged_decode_int8", "paged_decode_writeback", "paged_decode_writeback_int8")
SHAPES.update({kernel: DECODE_SHAPES for kernel in DECODE_KERNELS})
SCATTER_KERNELS = ("kv_scatter", "kv_scatter_int8")
SHAPES.update({kernel: list(cs.SCATTER_SHAPES) for kernel in SCATTER_KERNELS})
SHAPES["paged_decode_writeback_fold"] = DECODE_SHAPES
# the f32 instances: (B, Hq, Hkv, S, D), causal, at chip_smoke.F32_TIMED's
# shapes (GPT's default config, 20c's f32 Llama, it at S=1024 and 2048)
F32_KERNELS = ("flash_fwd_f32", "flash_bwd_dq_f32", "flash_bwd_dkv_f32")
SHAPES.update({kernel: [shape[1:] for shape in cs.F32_TIMED] for kernel in F32_KERNELS})
D = 128


def build_other(name: str, csrc: Path):
    """The library of ``csrc/<name>.cu`` under ``csrc``, loaded beside this tree's."""
    here, build_dir = _build.CSRC, _build.BUILD_DIR
    _build.CSRC, _build.BUILD_DIR = csrc, ROOT / "build" / "kernels_ab"
    try:
        _build.build([name])
        lib = ctypes.CDLL(str(_build.library_path(name)))
        err_fn = getattr(lib, f"{name}_error_string")
        err_fn.argtypes, err_fn.restype = [ctypes.c_int], ctypes.c_char_p
        return lib
    finally:
        _build.CSRC, _build.BUILD_DIR = here, build_dir


def write_then_attend_call(args, new):
    """One layer's write-then-attend step through whichever libraries are
    loaded: this tree's folded K4 (one launch), or the other tree's K3 over
    the one-layer view and then its K4 (``split_writeback_call``)."""
    lib = _build._libs["paged_decode_writeback"]
    k_new, v_new, page_idx, slot = new
    if hasattr(lib, "paged_decode_writeback_folds"):
        return pa.paged_decode_writeback_cuda(*args, sm_scale=D**-0.5, k_new=k_new, v_new=v_new, page_idx=page_idx,
                                              slot=slot)
    pa.scatter_kv_layer(args[1], args[2], k_new, v_new, page_idx, slot)
    return split_writeback_call(lib, args)


def split_writeback_call(lib, args):
    """K4 through the C entry of the split design before the folded write
    (no new rows)."""
    q, k_pages, v_pages, tables, ctx = args
    fn = lib.paged_decode_writeback
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    (B, Hq, _), (P, ps, Hkv, _) = q.shape, k_pages.shape
    splits, work, tickets = pa._split_scratch(lib, "paged_decode_writeback", q, Hkv, ps, tables.shape[1])
    out = torch.empty_like(q)
    err = fn(*(_build.ptr(t) for t in (q, k_pages, v_pages, tables, ctx, out, work, tickets)), B, Hq, Hkv, D, P, ps,
             tables.shape[1], splits, D**-0.5, _build.stream_ptr(q.device))
    _build.check(lib, "paged_decode_writeback", err)
    return out


def decode_call(kernel: str, args):
    """A decode kernel through whichever library is loaded: this tree's
    wrapper, the write-then-attend kernel's split-design entry from before
    the folded write, or the C entry of the kernel before the split design
    (one block per (sequence, kv head), no workspace)."""
    lib = _build._libs[kernel]
    if kernel == "paged_decode_writeback" and hasattr(lib, "paged_decode_writeback_split_rows") and not hasattr(
            lib, "paged_decode_writeback_folds"):
        return split_writeback_call(lib, args)
    if hasattr(lib, f"{kernel}_split_rows"):
        return getattr(pa, f"{kernel}_cuda")(*args, sm_scale=D**-0.5)
    if kernel == "paged_decode_writeback":  # one layer's bf16 pages, contexts counting the current token
        q, k_pages, v_pages, tables, ctx = args
        fn = lib.paged_decode_writeback
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        (B, Hq, _), (_, ps, Hkv, _) = q.shape, k_pages.shape
        out = torch.empty_like(q)
        err = fn(*(_build.ptr(t) for t in (q, k_pages, v_pages, tables, ctx, out)), B, Hq, Hkv, D, ps,
                 tables.shape[1], D**-0.5, _build.stream_ptr(q.device))
        _build.check(lib, kernel, err)
        return out
    q, k_pages, v_pages, layer, tables, lens, k_new, v_new = args
    int8 = kernel == "paged_decode_int8"
    pages = [k_pages.data, v_pages.data, k_pages.scale, v_pages.scale] if int8 else [k_pages, v_pages]
    fn = getattr(lib, kernel)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * (6 + len(pages)) + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    (B, Hq, _), (_, P, ps, Hkv, _) = q.shape, k_pages.shape
    out = torch.empty_like(q)
    err = fn(*(_build.ptr(t) for t in (q, *pages, tables, lens, k_new, v_new, out)), B, Hq, Hkv, D, layer, P, ps,
             tables.shape[1], D**-0.5, _build.stream_ptr(q.device))
    _build.check(lib, kernel, err)
    return out


_scatter_int8_cuda = pa.scatter_int8_cuda


def scatter_int8_call(k_pages, v_pages, k_all, v_all, page_idx, slot):
    """The int8 scatter through whichever library is loaded: this tree's
    wrapper, or the C entry of the kernel before the row partition (grid
    (N, 2, L), no partition arguments). Stands in for ``pa.scatter_int8_cuda``,
    which ``scatter_kv_pages`` calls."""
    lib = _build._libs["kv_scatter_int8"]
    if hasattr(lib, "kv_scatter_int8_threads"):
        return _scatter_int8_cuda(k_pages, v_pages, k_all, v_all, page_idx, slot)
    fn = lib.kv_scatter_int8
    if fn.argtypes is None:
        fn.argtypes, fn.restype = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p], ctypes.c_int
    L, P, ps, Hkv, _ = k_pages.shape
    tensors = (k_pages.data, v_pages.data, k_pages.scale, v_pages.scale, k_all, v_all, page_idx, slot)
    err = fn(*(_build.ptr(t) for t in tensors), L, k_all.shape[1], P, ps, Hkv, D, _build.stream_ptr(k_all.device))
    _build.check(lib, "kv_scatter_int8", err)
    return k_pages, v_pages


def qmm_call(x, w):
    """The int8 matmul through whichever library is loaded: this tree's API,
    or the one before the three paths (a K split sized by
    ``quantized_matmul_splits``, partials summed by a second launch)."""
    lib = _build._libs["quantized_matmul"]
    if hasattr(lib, "quantized_matmul_plan"):
        return qmm.qmm_cuda(x, w.q, w.scale)
    fn = lib.quantized_matmul
    if fn.argtypes is None:
        fn.argtypes, fn.restype = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p], ctypes.c_int
        lib.quantized_matmul_splits.argtypes = [ctypes.c_int] * 4
        lib.quantized_matmul_splits.restype = ctypes.c_int
    (M, K), N = x.shape, w.q.shape[1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = lib.quantized_matmul_splits(M, N, K, sms)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    part = torch.empty((splits, M, N), dtype=torch.float32, device=x.device) if splits > 1 else out
    err = fn(*(_build.ptr(t) for t in (x, w.q, w.scale, out, part)), M, N, K, sms, _build.stream_ptr(x.device))
    _build.check(lib, "quantized_matmul", err)
    return out


def qmm4_call(x, w):
    """The int4 matmul through whichever library is loaded: this tree's
    wrapper, or the C entry of a library without the path query (the same
    plan and launch signatures)."""
    lib = _build._libs["quantized_matmul_int4"]
    if hasattr(lib, "quantized_matmul_int4_path"):
        return qmm.qmm_int4_cuda(x, w.q, w.scale)
    fn = lib.quantized_matmul_int4
    if fn.argtypes is None:
        fn.argtypes, fn.restype = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p], ctypes.c_int
        lib.quantized_matmul_int4_plan.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
        lib.quantized_matmul_int4_plan.restype = ctypes.c_int
    (M, K), N = x.shape, w.q.shape[1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits, chunk, tickets = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib.quantized_matmul_int4_plan(_build.ptr(x), _build.ptr(w.q), M, N, K, sms, ctypes.byref(splits),
                                   ctypes.byref(chunk), ctypes.byref(tickets))
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    part = torch.empty((splits.value, M, N), dtype=torch.float32, device=x.device) if splits.value > 1 else out
    ticket = _build.ticket_buffer("quantized_matmul_int4-other", x.device, tickets.value) if tickets.value else out
    err = fn(*(_build.ptr(t) for t in (x, w.q, w.scale, out, part, ticket)), M, N, K, sms,
             _build.stream_ptr(x.device))
    _build.check(lib, "quantized_matmul_int4", err)
    return out


def case(kernel: str, gen, shape):
    """(launch, check) over one set of inputs: ``check()`` launches once and
    returns the error against the plain version; an f32 instance's adds
    PyTorch's f32 call on the same inputs (``f32_case``)."""
    if kernel in DECODE_KERNELS:
        _, Hkv, lens = shape
        c = cs.decode_case(gen, 8, 32, Hkv, L=32, int8=kernel.endswith("int8"), lens=lens)
        ctx = c["prefix_lens"] + 1
        if "writeback" in kernel:
            per_layer = [[c["q"], c["k_pages"][li], c["v_pages"][li], c["page_tables"], ctx] for li in cs.CYCLED_LAYERS]
        else:
            per_layer = [cs.decode_args(c, li) for li in cs.CYCLED_LAYERS]
        want = getattr(pa, f"{kernel}_plain")(*per_layer[0], sm_scale=D**-0.5)
        return (cs.cycling([lambda a=a: decode_call(kernel, a) for a in per_layer]),
                lambda: cs.writeback_readings(decode_call(kernel, per_layer[0]), want, ctx)["row_rel"])
    if kernel in SCATTER_KERNELS:
        t = cs.scatter_timed(pa, gen, shape, int8=kernel.endswith("int8"))
        return t["launch"], t["check"]
    if kernel == "paged_decode_writeback_fold":
        _, Hkv, lens = shape
        c = cs.decode_case(gen, 8, 32, Hkv, L=32, lens=lens)
        ctx = c["prefix_lens"] + 1
        pos = (ctx - 1).long()
        page_idx = c["page_tables"].gather(1, (pos // 16)[:, None])[:, 0].int().contiguous()
        slot = (pos % 16).int()
        per_layer = [([c["q"], c["k_pages"][li], c["v_pages"][li], c["page_tables"], ctx],
                      (cs.rand_bf16(gen, 8, Hkv, D), cs.rand_bf16(gen, 8, Hkv, D), page_idx, slot))
                     for li in cs.CYCLED_LAYERS]
        args, new = per_layer[0]
        pa.scatter_kv_layer(args[1], args[2], *new)
        want = pa.paged_decode_writeback_cuda(*args, sm_scale=D**-0.5)  # this tree's K3 -> K4
        return (cs.cycling([lambda a=a, n=n: write_then_attend_call(a, n) for a, n in per_layer]),
                lambda: cs.max_err(write_then_attend_call(args, new), want))
    if kernel == "quantized_matmul":
        from modal_examples_tpu_torch.models.quantize import quantize_weight

        M, K, N = shape
        weights = [quantize_weight(torch.randn(K, N, generator=gen, device="cuda")) for _ in range(4)]
        x = cs.rand_bf16(gen, M, K)
        want = qmm.qmm_plain(x, weights[0].q, weights[0].scale)
        return cs.cycling([lambda w=w: qmm_call(x, w) for w in weights]), lambda: cs.rel_err(qmm_call(x, weights[0]), want)
    if kernel == "quantized_matmul_int4":
        from modal_examples_tpu_torch.models.quantize import quantize_weight

        M, K, N = shape
        weights = [quantize_weight(torch.randn(K, N, generator=gen, device="cuda"), bits=4) for _ in range(4)]
        x = cs.rand_bf16(gen, M, K)
        want = qmm.qmm_int4_plain(x, weights[0].q, weights[0].scale)
        return (cs.cycling([lambda w=w: qmm4_call(x, w) for w in weights]),
                lambda: cs.rel_err(qmm4_call(x, weights[0]), want))
    if kernel in F32_KERNELS:
        return f32_case(kernel, gen, *shape)
    B, H, S = shape
    if kernel == "flash_fwd":
        q, k, v = cs.flash_case(gen, B, H, H, S, S, D)

        def launch():
            return fa.flash_forward_cuda(q, k, v, causal=True, sm_scale=D**-0.5)

        want = fa.flash_forward_plain(q, k, v, causal=True, sm_scale=D**-0.5)
        return launch, lambda: max(cs.max_err(got, w) for got, w in zip(launch(), want))
    args, _ = cs.bwd_case(fa, gen, B, H, H, S, True, False, D)
    kernel_fn, plain = ((fa.flash_bwd_dq_cuda, fa.flash_bwd_dq_plain) if kernel == "flash_bwd_dq"
                        else (fa.flash_bwd_dkv_cuda, fa.flash_bwd_dkv_plain))

    def launch():
        return kernel_fn(*args, causal=True, sm_scale=D**-0.5)

    want = plain(*args, causal=True, sm_scale=D**-0.5)
    if kernel == "flash_bwd_dq":
        return launch, lambda: cs.rel_err(launch(), want)
    return launch, lambda: max(cs.rel_err(g, w) for g, w in zip(launch(), want))


def f32_case(kernel: str, gen, B, Hq, Hkv, S, Dh):
    """(launch, check, library) of an f32 instance at a causal shape
    through its wrapper (the two trees' C entries take the same arguments):
    the error is the largest of its outputs' max|out - plain| / max|plain|;
    ``library`` is PyTorch's f32 call on the same inputs
    (``chip_smoke.f32_library``)."""
    q, do = cs.rand_f32(gen, B, Hq, S, Dh), cs.rand_f32(gen, B, Hq, S, Dh)
    k, v = cs.rand_f32(gen, B, Hkv, S, Dh), cs.rand_f32(gen, B, Hkv, S, Dh)
    scale = Dh**-0.5
    o, lse = fa.flash_forward_f32_plain(q, k, v, causal=True, sm_scale=scale)
    args = (q, k, v, do, lse, (do * o).sum(dim=-1), torch.zeros_like(lse))
    library_fwd, library_bwd = cs.f32_library(q, k, v, do, scale)
    if kernel == "flash_fwd_f32":
        kernel_fn, plain, args = fa.flash_forward_f32_cuda, fa.flash_forward_f32_plain, (q, k, v)
    elif kernel == "flash_bwd_dq_f32":
        kernel_fn, plain = fa.flash_bwd_dq_f32_cuda, fa.flash_bwd_dq_f32_plain
    else:
        kernel_fn, plain = fa.flash_bwd_dkv_f32_cuda, fa.flash_bwd_dkv_f32_plain

    def launch():
        return kernel_fn(*args, causal=True, sm_scale=scale)

    def as_tuple(out):
        return out if isinstance(out, tuple) else (out,)

    want = as_tuple(plain(*args, causal=True, sm_scale=scale))
    return (launch, lambda: max(cs.rel_err(g, w) for g, w in zip(as_tuple(launch()), want)),
            library_fwd if kernel == "flash_fwd_f32" else library_bwd)


def profiler_ms(fn, n: int = 40, windows: int = 3) -> float | None:
    """The kernels' own time of a call of ``fn`` by ``torch.profiler``
    after 3 warm-up calls: the kernel events of ``n`` calls summed over
    ``n``. A window in which some kernel's events are not a whole number of
    calls (the profiler lost some) is taken again; None where none of
    ``windows`` is whole."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0]
        if events and all(e.count % n == 0 for e in events):
            return sum(e.self_device_time_total for e in events) / 1e3 / n
    print(f"profiler_ms: no whole window in {windows}", file=sys.stderr, flush=True)
    return None


def describe(kernel: str, shape) -> str:
    if kernel in DECODE_KERNELS or kernel == "paged_decode_writeback_fold":
        label, Hkv, lens = shape
        return f"{label}: B=8 Hq=32 Hkv={Hkv} D={D} prefixes {list(lens)}, layers {cs.CYCLED_LAYERS} in turn"
    if kernel in ("quantized_matmul", "quantized_matmul_int4"):
        return "M={} K={} N={} (four weight copies in turn)".format(*shape)
    if kernel in F32_KERNELS:
        return "B={} Hq={} Hkv={} S={} D={} causal, f32".format(*shape)
    if kernel in SCATTER_KERNELS:
        L, N = cs.SCATTER_SHAPES[shape]
        return f"{shape}: L={L} N={N} Hkv=32 D={D}, {cs.scatter_bytes(L, N, kernel.endswith('int8'))} bytes"
    return "B={} H={} S={} D={} causal".format(*shape, D)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="the other csrc directory")
    ap.add_argument("--kernel", default="flash_fwd", choices=sorted(SHAPES))
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    pa.scatter_int8_cuda = scatter_int8_call
    names = ["paged_decode_writeback", "kv_scatter"] if args.kernel == "paged_decode_writeback_fold" else [args.kernel]
    libs = {"this": {n: _build.load(n) for n in names},
            "other": {n: build_other(n, args.other.resolve()) for n in names}}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in SHAPES[args.kernel]:
        launch, check, *library = case(args.kernel, gen, shape)
        out = {"card": card, "kernel": args.kernel, "shape": describe(args.kernel, shape), "other": str(args.other)}
        if args.kernel in SCATTER_KERNELS:
            out["bound_ms"] = 1e3 * cs.scatter_bytes(*cs.SCATTER_SHAPES[shape], args.kernel.endswith("int8")) / cs.PEAK_BYTES
        for side, lib in libs.items():
            _build._libs.update(lib)
            out[f"{side}_err"] = check()
        sides = ("this", "other", "library") if library else ("this", "other")
        hows = ("ms", "single_ms", "device_ms", "profiler_ms")
        times = {f"{side}_{how}": [] for side in sides for how in hows}
        for _ in range(args.rounds):
            for side in ("this", "other", "other", "this") + sides[2:]:
                fn = library[0] if side == "library" else launch
                if side != "library":
                    _build._libs.update(libs[side])
                times[f"{side}_ms"].append(cs.back_to_back_ms(fn))
                times[f"{side}_single_ms"].append(cs.time_ms(fn))
                times[f"{side}_device_ms"].append(cs.device_ms(fn))
                times[f"{side}_profiler_ms"].append(profiler_ms(fn))
        _build._libs.update(libs["this"])
        out.update(times)
        # a reading that could not be taken is None and no median's part
        out.update({f"{k}_median": statistics.median(r) if (r := [x for x in v if x is not None]) else None
                    for k, v in times.items()})
        print(json.dumps(out), flush=True)
        del launch, check, library
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
