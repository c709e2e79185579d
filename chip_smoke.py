"""Chip smoke test of the PyTorch/CUDA port: builds its kernels, holds each
against its plain version on the card, serves Llama-2-7B-shaped requests
(random bf16 weights from a seed, full width) through the port's engine and
OpenAI server, again 8 decode steps per dispatch, again through the
write-then-attend decode, again with int8 weights and an int8 KV cache, and
through the write-then-attend decode over int8 pages, LoRA-fine-tunes the
same model through ``Trainer``, and prints per-kernel times beside their
bounds.

Run from the repository root on a machine with one NVIDIA GPU and nvcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
1. build the CUDA kernels from ``modal_examples_tpu_torch/csrc`` (the
   ptxas register and spill report of the flash forward, dQ and dK/dV
   kernels, the int8 matmul and the four decodes logged), and read their
   SASS with ``cuobjdump``: the first four must hold wgmma (``HGMMA``) and
   TMA load (``UTMALDG``) instructions, the four decode kernels (ragged and
   write-then-attend, bf16 and int8 pages) cp.async (``LDGSTS``);
2. each kernel against its plain version at the main paths' shapes
   (Hq=Hkv=32, D=128, page_size 16) and a GQA shape (Hkv=8); the flash
   forward also at a ragged S=300 (causal and not), a chunk at
   q_offset=496 over a ragged Skv=700, and D=64 and 256; the flash
   backward kernels also non-causal, at a ragged S=300, at D=32, 64 and 256
   and with a nonzero lse cotangent; the int8 matmul at M = 1, 8, 64, 65,
   300 and 2048 over every weight shape of the model (each must take a TMA
   path; the path is logged) and a ragged 4000 x 11000, each launched twice
   and required bitwise equal; the ragged decodes (bf16 and int8 pages) at
   Hkv=32 and 8, prefixes 0..1000 and at the kernels' split edges, held
   per (sequence, head) row, launched twice and required bitwise equal, with
   the same check shown to refuse two planted faults (the last page of the
   longest prefix dropped, the last split of its rows dropped from the
   merge); the int8 scatter bitwise at a decode step, a prefill batch (its
   blocks striding), one layer's view through ``scatter_kv_layer``, one
   token, 37 tokens at Hkv=5 and D=256, Hkv=8, D=64 and D=256, each with an
   all-zero row (scale 1.0, data 0) and a row of ties (rounded half to
   even), with the same check shown to refuse two planted faults (a row
   left unwritten, a scale from the neighbouring head); the write-then-attend
   decodes (bf16 and int8 pages) over one layer's pages at Hkv=32 and 8,
   contexts 0..1001 with a dead slot on trash page 0 and contexts at the
   split edges, held per (sequence, head) row, an empty context exactly
   zero, launched twice and required bitwise equal, with the same check
   shown to refuse planted faults (bf16: the last 64-row chunk skipped, the
   last split dropped, K2's bf16 probabilities; int8: the last page and the
   last split dropped);
3. the engine serving 8 requests (prompts of 20..700 tokens, one chunked),
   with the launch counters zeroed just before and read just after: every
   serving kernel must have launched, the decode kernel n_layers x decode
   steps times; then prefill + one decode step against a dense plain forward
   on the card; then the same burst with ``decode_steps = 8`` (the macro-step
   program), counters zeroed: the decode kernel n_layers x the steps that
   ran (``stats.steps``), greedy and seeded rows token-identical to N=1;
4. the OpenAI server: one completion, one streamed chat completion;
   then (phase 3b) write-then-attend serving: ``paged_impl=
   "pallas-writeback"`` at ``decode_steps=8``, then 1, counters zeroed each
   time: the writeback decode kernel n_layers x decode steps times, no
   ragged decode launch, the scatter at least once a layer a step, every
   page returned, N=8 token-identical to N=1; prefill + one writeback decode
   step against a dense plain forward;
   then int8 serving: the same weights quantized (``quantize_llama``) in an
   engine with an int8 KV cache serving the same 8 requests, counters
   zeroed: the int8 decode kernel n_layers x decode steps times, no bf16
   decode or scatter launch, the int8 scatter at least once, the int8
   matmul a multiple of 7 x n_layers + 1 and at least that many per decode
   step; weights and cache at most 0.52 of their bf16 bytes; prefill + one
   decode step against a dense plain forward over the same int8 weights
   and the same int8 cache rows; then (phase 3b over int8 pages) the same
   int8 weights and cache at ``paged_impl="pallas-writeback"``,
   ``decode_steps=8``, counters zeroed: the int8 write-then-attend decode
   n_layers x decode steps times and no other decode kernel, the int8
   scatter at least once a layer a step, every page returned, and the dense
   check through the writeback decode step;
   then training: Llama-2-7B (full depth, frozen random bf16 base) with
   rank-16 LoRA on all seven projections, B=2 x S=512, through
   ``Trainer.train_step``: the first step's adapter gradients against the
   same step with ``attn_impl="xla"``; then, counters zeroed, 1 warm-up and
   4 timed steps in which the flash forward, dQ and dK/dV kernels must each
   launch exactly n_layers x 5 times;
5. per-kernel numbers on earlier lines, each kernel and library call
   timed two ways (CUDA events): the median of single launches (``ms``,
   ``library_ms``) and 50 back-to-back launches (``ms_b2b``,
   ``library_ms_b2b``); the four decode kernels cycled over four layers of
   one cache (so their rows come from HBM) and also timed by the profiler's
   device time (``device_ms``); the two scatters' device time and byte
   bound also at a prefill batch and one layer's view (``shapes``); then
   the card's name and power limit, then the result line.
"""

from __future__ import annotations

import gc
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import traceback
import urllib.request
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
# bf16 tolerances against the plain versions (f32 math inside both):
# flash differs by the final bf16 rounding and summation order; decode also
# rounds unnormalised probabilities to bf16 where the plain version rounds
# normalised ones; the scatter is a copy. The flash backward kernels are held
# as max|grad - plain| / max|plain grad| (f32 math in both, one bf16 rounding
# of each gradient, sums in another order).
TOL = {"flash_fwd": 2e-2, "paged_decode": 6e-2, "kv_scatter": 0.0, "flash_bwd_dq": 1e-2, "flash_bwd_dkv": 1e-2,
       "quantized_matmul": 1e-3, "paged_decode_int8": 6e-2, "kv_scatter_int8": 0.0, "paged_decode_writeback": 1e-2,
       "paged_decode_writeback_differ": 1e-2, "paged_decode_row": 1e-2, "paged_decode_int8_row": 1e-2,
       "paged_decode_writeback_int8": 6e-2, "paged_decode_writeback_int8_row": 1e-2}
# the int8 matmul is held as max|out - plain| / max|plain|: its products are
# exact (int8 and bf16 values, f32 sums), only the summation order differs.
# The int8 decode has K2's numerics over the same dequantized values; the int8
# scatter must be bitwise (same IEEE divisions, round half to even). The
# write-then-attend decode keeps f32 probabilities as its plain version does,
# so the two differ only by f32 summation order before one bf16 rounding: it
# is held per (sequence, head) row as max|o - plain| / max|plain| (one bf16
# ulp is at most 2^-7 of the row's largest value) and by the share of output
# elements whose bf16 value differs from the plain version's ("_differ").
# Phase 2 shows that both limits see three planted faults: the last 64-row
# chunk of the longest context skipped, its last split dropped from the
# merge, and probabilities rounded to bf16 (K2's design, run on the same
# rows). K2, K2-int8 and K4-int8 (whose probabilities are rounded to bf16,
# as its JAX function's) are held the same way per (sequence, query head)
# row ("_row", beside the absolute limit), at contexts on both sides of the
# kernels' split edges, and phase 2 shows that check refusing two planted
# faults: the last page of the longest context dropped, and the last split
# of its rows dropped from the merge. The four decode kernels must also be
# bitwise equal from launch to launch (their merge runs in split order).
# (K, N) of every int8 weight of Llama-2-7B (wq/wk/wv/wo, gate/up, down,
# lm_head) and one ragged shape
QMM_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000), (4000, 11000)]
# training: adapter-gradient cosine between the flash and xla attention paths
GRAD_COSINE_MIN = 0.999
# K1 against its plain version: (B, Hq, Hkv, S, Skv, q_offset, causal, D)
K1_CASES = [
    (4, 32, 32, 512, 512, 0, True, 128),      # the engine's prefill batch
    (1, 32, 32, 512, 1024, 512, True, 128),   # a prompt chunk at a tile boundary
    (4, 32, 8, 512, 512, 0, True, 128),       # GQA
    (2, 8, 2, 300, 300, 0, True, 128),        # ragged S
    (2, 8, 2, 300, 300, 0, False, 128),       # ragged, full attention
    (1, 32, 32, 204, 700, 496, True, 128),    # q_offset a multiple of 16, not of the tile; ragged Skv
    (2, 8, 2, 300, 300, 0, True, 64),         # other head dims
    (2, 4, 2, 200, 200, 0, True, 256),
]
# instructions each library's SASS must hold: the products on wgmma (HGMMA)
# fed by TMA (UTMALDG); the four decode kernels' rows streamed by cp.async
# (LDGSTS)
SASS_CHECKED = {
    **{name: ("HGMMA", "UTMALDG") for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "quantized_matmul")},
    **{name: ("LDGSTS",) for name in ("paged_decode", "paged_decode_int8", "paged_decode_writeback",
                                      "paged_decode_writeback_int8")},
}
# phase 5 cycles the decode kernels over these layers of one cache: their
# rows (141 MB bf16, 71 MB int8) exceed the 50 MB L2, so each launch reads
# from HBM as a decode step's 32 layers do
CYCLED_LAYERS = (5, 6, 7, 8)
# K7's paths (``quantized_matmul.kernel_path``): every weight shape of the
# model must take the TMA ones, "ring" at M <= 64 and "wgmma" above
QMM_MS = (1, 8, 64, 65, 300, 2048)


def log(*a) -> None:
    print(*a, flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, n: int = 40) -> float:
    """Device time of a call of ``fn`` (every kernel it launches), from
    ``torch.profiler`` over ``n`` calls after 3 warm-up calls: the kernel's
    own time where a single or back-to-back launch reads the host. A window
    in which the profiler recorded no device time is taken again, at most
    twice, then refused."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages())
        if total > 0:
            return total / 1e3 / n
    raise RuntimeError("torch.profiler recorded no device time in three windows")


def back_to_back_ms(fn, n: int = 50) -> float:
    """Per-launch ms of ``n`` launches between two events, after 3 warm-up
    launches: the kernel's own time once the host enqueues faster than the
    card runs (a single launch between its own events also times the
    wrapper's host work whenever that is longer)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def sdpa(q, k, v, causal: bool):
    """PyTorch's attention on the same inputs: a yardstick, never the port's path."""
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)


def check_sass(_build) -> None:
    """Logs the counts of each library's ``SASS_CHECKED`` instructions, read
    with ``cuobjdump -sass``; raises if a library has none of one."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise RuntimeError("cuobjdump not found (PATH or /usr/local/cuda/bin)")
    counts = {}
    for name, ops in SASS_CHECKED.items():
        sass = subprocess.run([tool, "-sass", str(_build.library_path(name))], capture_output=True, text=True,
                              check=True).stdout
        counts[name] = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ops}
    log(f"SASS instruction counts: {counts}")
    if not all(n > 0 for c in counts.values() for n in c.values()):
        raise AssertionError(f"a kernel lacks a checked instruction in its SASS: {counts}")


# -- phase 2 inputs ---------------------------------------------------------------


def rand_bf16(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32).to(torch.bfloat16)


def flash_case(gen, B, Hq, Hkv, S, Skv, D=128):
    return rand_bf16(gen, B, Hq, S, D), rand_bf16(gen, B, Hkv, Skv, D), rand_bf16(gen, B, Hkv, Skv, D)


def int8_pages(gen, *shape):
    """A random int8 cache: int8 rows and positive f32 scales."""
    from modal_examples_tpu_torch.ops.kv_quant import QuantizedKV

    return QuantizedKV(
        data=torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8),
        scale=torch.rand(shape[:-1], generator=gen, device="cuda") * 0.02 + 1e-3,
    )


DECODE_LENS = (0, 1, 15, 16, 17, 333, 777, 1000)


def decode_split_rows() -> int:
    """SPLIT of ``csrc/paged_decode.cuh``: the cached rows one block of the
    ragged decode kernels takes."""
    src = (ROOT / "modal_examples_tpu_torch" / "csrc" / "paged_decode.cuh").read_text()
    return int(re.search(r"constexpr int SPLIT = (\d+);", src).group(1))


def split_edge_lens(split: int) -> tuple:
    """Prefixes on both sides of the decode kernels' split edges, one below
    the 64 x 16-row table and the full table."""
    return (split - 1, split, split + 1, 2 * split, 2 * split + 1, 3 * split - 1, 1023, 1024)


def decode_case(gen, B, Hq, Hkv, L, D=128, ps=16, pps=64, int8=False, lens=DECODE_LENS):
    """Ragged prefix lengths (default 0..1000) over shuffled pages of the
    full cache (bf16 pages, or int8 pages with their scales)."""
    P = 1 + B * pps
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(1))[: B * pps] + 1
    lens = torch.tensor(lens[:B], dtype=torch.int32)
    pages = int8_pages if int8 else rand_bf16
    return dict(
        q=rand_bf16(gen, B, Hq, D),
        k_pages=pages(gen, L, P, ps, Hkv, D),
        v_pages=pages(gen, L, P, ps, Hkv, D),
        page_tables=perm.reshape(B, pps).to(torch.int32).cuda(),
        prefix_lens=lens.cuda(),
        k_new=rand_bf16(gen, B, Hkv, D),
        v_new=rand_bf16(gen, B, Hkv, D),
    )


def writeback_case(gen, B, Hq, Hkv, L, ctx, D=128, ps=16, pps=64, int8=False, dead=True):
    """One layer's pages (the contiguous view ``pages[2]`` of a bf16 cache,
    or of an int8 one) for contexts ``ctx`` that count the current token,
    over shuffled pages; with ``dead`` the last slot is dead: its table is
    all trash page 0."""
    P = 1 + B * pps
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(1))[: B * pps] + 1
    tables = perm.reshape(B, pps).to(torch.int32)
    if dead:
        tables[-1] = 0
    pages = int8_pages if int8 else rand_bf16
    k_cache, v_cache = pages(gen, L, P, ps, Hkv, D), pages(gen, L, P, ps, Hkv, D)
    return dict(
        q=rand_bf16(gen, B, Hq, D), k_pages=k_cache[2], v_pages=v_cache[2],
        page_tables=tables.cuda(), context_lens=torch.tensor(ctx, dtype=torch.int32).cuda(),
        k_cache=k_cache, v_cache=v_cache,
    )


def decode_args(c, layer: int) -> list:
    return [c["q"], c["k_pages"], c["v_pages"], layer, c["page_tables"], c["prefix_lens"], c["k_new"], c["v_new"]]


def check_decode(name: str, kernel, plain, c, label: str) -> float:
    """K2 or K2-int8 (``kernel``) on one ``decode_case`` at layer 2 against
    its plain version, per (sequence, query head) row and by max abs; two
    launches must be bitwise equal; two planted faults, run through the plain
    version on the same rows, must read above the row limit. Returns the max
    abs error."""
    args = decode_args(c, 2)
    o = kernel(*args, sm_scale=128**-0.5)
    again = kernel(*args, sm_scale=128**-0.5)
    torch.cuda.synchronize()
    want = plain(*args, sm_scale=128**-0.5)
    lens = c["prefix_lens"]
    ctx = lens + 1  # every row attends at least to the in-flight token
    got = writeback_readings(o, want, ctx)
    log(f"{label} prefixes {lens.tolist()}: max|o-plain|={got['max_abs']:.3g}, row max|o-plain|/max|plain|="
        f"{got['row_rel']:.3g}, elements differing {got['differ']:.3g}, bitwise equal on a second launch "
        f"{torch.equal(o, again)}")
    longest = int(lens.argmax())
    n, ps, split = int(lens[longest]), c["k_pages"].shape[2], decode_split_rows()
    for fault, cut in ((f"last page of prefix {n} dropped", (n - 1) // ps * ps),
                       (f"last split of prefix {n} dropped from the combine", (n - 1) // split * split)):
        short = lens.clone()
        short[longest] = cut
        bad = writeback_readings(plain(*args[:5], short, *args[6:], sm_scale=128**-0.5), want, ctx)
        log(f"  planted fault, {fault}: max|o-plain|={bad['max_abs']:.3g}, row {bad['row_rel']:.3g}")
        if bad["row_rel"] <= TOL[f"{name}_row"]:
            raise AssertionError(f"the {name} check does not see a planted fault ({fault}): {bad}")
    if not (got["max_abs"] <= TOL[name] and got["row_rel"] <= TOL[f"{name}_row"]):
        raise AssertionError(f"{name} kernel disagrees with its plain version: {got}")
    if not torch.equal(o, again):
        raise AssertionError(f"{name} differs from run to run")
    return got["max_abs"]


def decode_cases(gen, int8: bool):
    """(label, case) of phase 2's decode checks: 8 slots at G = 1 and 4, at
    the default prefixes and at the split edges."""
    for lens in (DECODE_LENS, split_edge_lens(decode_split_rows())):
        for Hkv in (32, 8):
            yield (f"K2{'-int8' if int8 else ''} decode B=8 Hq=32 Hkv={Hkv} layer=2",
                   decode_case(gen, 8, 32, Hkv, L=4, int8=int8, lens=lens))


WRITEBACK_ARGS = ("q", "k_pages", "v_pages", "page_tables", "context_lens")


def writeback_readings(o, want, ctx) -> dict:
    """The K4 check's readings over the (sequence, head) rows that have a
    context: the largest max|o - want| / max|want| of a row, and the share of
    their elements whose bf16 value differs from ``want``'s (and max abs)."""
    live = torch.as_tensor(ctx, device=o.device) > 0
    o, want = o[live].float(), want[live].float()
    row = (o - want).abs().amax(dim=-1) / want.abs().amax(dim=-1)
    return {"row_rel": row.max().item(), "differ": (o != want).float().mean().item(), "max_abs": max_err(o, want)}


def longest_context(c) -> tuple:
    """(slot, rows) of the longest context of a ``writeback_case``, its rows
    cut to the table (the kernels read no further)."""
    lens = c["context_lens"]
    longest = int(lens.argmax())
    return longest, min(int(lens[longest]), c["page_tables"].shape[1] * c["k_pages"].shape[1])


def writeback_faults(pa, c, int8: bool) -> dict:
    """Planted faults on the same inputs, each a wrong K4 or K4-int8 that the
    check must refuse: the plain version with the longest context's last
    split dropped from the merge, and with its last 64-row chunk skipped
    (K4) or its last page dropped (K4-int8); for K4 also K2, which rounds its
    probabilities to bf16, over the same rows (the prefix is the context less
    its last row, which goes in as the in-flight token)."""
    plain = pa.paged_decode_writeback_int8_plain if int8 else pa.paged_decode_writeback_plain
    args = [c[n] for n in WRITEBACK_ARGS]
    longest, n = longest_context(c)
    ps, split = c["k_pages"].shape[1], decode_split_rows()
    cuts = {f"last split of context {n} dropped from the merge": (n - 1) // split * split}
    if int8:
        cuts[f"last page of context {n} dropped"] = (n - 1) // ps * ps
    else:
        cuts[f"last 64-row chunk of context {n} skipped"] = (n - 1) // 64 * 64
    faults = {}
    for fault, cut in cuts.items():
        short = c["context_lens"].clone()
        short[longest] = cut
        faults[fault] = plain(*args[:4], short, sm_scale=128**-0.5)
    if not int8:
        B = len(c["context_lens"])
        last = (c["context_lens"].long() - 1).clamp(min=0)
        page = c["page_tables"].long()[torch.arange(B, device="cuda"), last // ps]
        k_new, v_new = c["k_pages"][page, last % ps], c["v_pages"][page, last % ps]
        faults["probabilities rounded to bf16 (K2)"] = pa.paged_decode_cuda(
            c["q"], c["k_cache"], c["v_cache"], 2, c["page_tables"], last.int(), k_new, v_new, sm_scale=128**-0.5)
    return faults


def writeback_passes(name: str, r: dict) -> bool:
    """The K4 check (row and share of differing elements) or the K4-int8
    check (row and max abs) on ``writeback_readings``."""
    if name == "paged_decode_writeback":
        return r["row_rel"] <= TOL[name] and r["differ"] <= TOL[f"{name}_differ"]
    return r["row_rel"] <= TOL[f"{name}_row"] and r["max_abs"] <= TOL[name]


def check_writeback(pa, name: str, c, label: str) -> float:
    """K4 or K4-int8 (``name``: the wrapper ``pa.<name>_cuda``) on one
    ``writeback_case`` against its plain version (``writeback_passes``),
    empty contexts exactly zero, two launches bitwise equal, and every
    planted fault of ``writeback_faults`` refused by the same check. Returns
    the max abs error."""
    kernel, plain = getattr(pa, f"{name}_cuda"), getattr(pa, f"{name}_plain")
    args = [c[n] for n in WRITEBACK_ARGS]
    o = kernel(*args, sm_scale=128**-0.5)
    again = kernel(*args, sm_scale=128**-0.5)
    torch.cuda.synchronize()
    want = plain(*args, sm_scale=128**-0.5)
    ctx = c["context_lens"]
    got = writeback_readings(o, want, ctx)
    empty = o[ctx == 0]
    log(f"{label}, contexts {ctx.tolist()}: max|o-plain|={got['max_abs']:.3g}, row max|o-plain|/max|plain|="
        f"{got['row_rel']:.3g}, elements differing {got['differ']:.3g}, max|o| of the {len(empty)} empty contexts "
        f"{empty.abs().max().item() if len(empty) else None}, bitwise equal on a second launch {torch.equal(o, again)}")
    for fault, wrong in writeback_faults(pa, c, name.endswith("int8")).items():
        bad = writeback_readings(wrong, want, ctx)
        log(f"  planted fault, {fault}: max|o-plain|={bad['max_abs']:.3g}, row {bad['row_rel']:.3g}, "
            f"elements differing {bad['differ']:.3g}")
        if writeback_passes(name, bad):
            raise AssertionError(f"the {name} check does not see a planted fault ({fault}): {bad}")
    if not writeback_passes(name, got):
        raise AssertionError(f"{name} kernel disagrees with its plain version: {got}")
    if len(empty) and empty.abs().max().item() != 0.0:
        raise AssertionError(f"{name} gives nonzero output for an empty context")
    if not torch.equal(o, again):
        raise AssertionError(f"{name} differs from run to run")
    return got["max_abs"]


# contexts 1, a page, a page plus one, 1001; none (zeros); a mix; a dead slot
WRITEBACK_CTX = (1, 16, 17, 1001, 0, 334, 512, 1)


def writeback_cases(gen, int8: bool):
    """(label, case) of phase 2's write-then-attend checks: 8 slots at G = 1
    and 4 over layer 2's pages, at ``WRITEBACK_CTX`` (the last slot dead, on
    trash page 0) and at contexts on both sides of the split edges (each a
    prefix of ``split_edge_lens`` plus the current token, cut to the
    64 x 16-row table)."""
    edges = tuple(min(n + 1, 64 * 16) for n in split_edge_lens(decode_split_rows()))
    for ctx, dead in ((WRITEBACK_CTX, True), (edges, False)):
        for Hkv in (32, 8):
            yield (f"K4{'-int8' if int8 else ''} writeback decode B=8 Hq=32 Hkv={Hkv} one layer's pages",
                   writeback_case(gen, 8, 32, Hkv, L=4, ctx=ctx, int8=int8, dead=dead))


def scatter_case(gen, L, N, P, Hkv=32, D=128, ps=16, seed=2, dead=True):
    """N tokens on distinct targets (drawn from ``seed``); with ``dead``, two
    of them are dead on trash page 0 slot 0 (given equal rows, so the race
    has one possible result)."""
    k_all, v_all = rand_bf16(gen, L, N, Hkv, D), rand_bf16(gen, L, N, Hkv, D)
    flat = torch.randperm((P - 1) * ps, generator=torch.Generator().manual_seed(seed))[:N] + ps
    page_idx, slot = (flat // ps).to(torch.int32), (flat % ps).to(torch.int32)
    if dead:
        page_idx[[1, 3]] = 0
        slot[[1, 3]] = 0
        k_all[:, 3], v_all[:, 3] = k_all[:, 1], v_all[:, 1]
    return k_all, v_all, page_idx.cuda(), slot.cuda()


# K3 and K3-int8 in phase 5 and in benchmarks_torch/kernel_ab.py, (L, N) at
# Hkv=32, D=128 into a cache of 513 pages of 16: a decode step's 8 tokens x
# 32 layers, the prefill batch's 4 x 512 tokens x 32 layers, and the
# write-then-attend path's one layer's view (8 tokens, ``scatter_kv_layer``)
SCATTER_SHAPES = {"decode": (32, 8), "prefill": (32, 2048), "one layer": (1, 8)}
SCATTER_SETS = 32  # decode shape: sets of rows and targets cycled, 134 MB of bf16 rows


def scatter_bytes(L: int, N: int, int8: bool, Hkv: int = 32, D: int = 128) -> int:
    """Bytes a scatter of N tokens x L layers must move: the bf16 K and V
    rows read once, written once as bf16 (K3) or as int8 rows with one f32
    scale each (K3-int8)."""
    rows = 2 * L * N * Hkv
    return rows * 2 * D + rows * (D + 4 if int8 else 2 * D)


def copy_pages(dst, src) -> None:
    for a, b in ((dst.data, src.data), (dst.scale, src.scale)) if hasattr(src, "scale") else ((dst, src),):
        a.copy_(b)


def clone_pages(pages):
    from modal_examples_tpu_torch.ops.kv_quant import QuantizedKV

    return QuantizedKV(pages.data.clone(), pages.scale.clone()) if hasattr(pages, "scale") else pages.clone()


def pages_err(got, want) -> float:
    """0.0 where two caches (bf16, or int8 data and f32 scales) are bitwise
    equal, else their largest difference (inf if that reads 0)."""
    pairs = [(got.data, want.data), (got.scale, want.scale)] if hasattr(want, "scale") else [(got, want)]
    if all(torch.equal(a, b) for a, b in pairs):
        return 0.0
    return max(max_err(a, b) for a, b in pairs) or math.inf


def scatter_timed(pa, gen, shape: str, int8: bool) -> dict:
    """K3 or K3-int8 at one of ``SCATTER_SHAPES``, through the wrappers a
    caller uses: ``launch`` cycles the kernel over ``SCATTER_SETS`` sets of
    rows and targets at the decode shape (their rows exceed the 50 MB L2, so
    they are read from HBM as the bound counts them), over the 32 layers of
    one cache (each with its own rows, as a step's 32 launches) at the one
    layer shape; ``check()`` restores the cache, launches the first of
    them and returns ``pages_err`` against the plain version; ``plain`` is
    the plain version of that launch; ``nbytes`` is one launch's bytes;
    ``pages`` the cache and ``sets`` the rows and targets of each launch
    (none at the one-layer shape)."""
    L, N = SCATTER_SHAPES[shape]
    cache_layers, P = 32, 513
    pages = int8_pages if int8 else rand_bf16
    kp, vp = pages(gen, cache_layers, P, 16, 32, 128), pages(gen, cache_layers, P, 16, 32, 128)
    plain = pa.scatter_int8_plain if int8 else pa.scatter_plain
    if shape == "one layer":
        k_all, v_all, page_idx, slot = scatter_case(gen, cache_layers, N, P)
        calls = [(lambda li=li: pa.scatter_kv_layer(kp[li], vp[li], k_all[li], v_all[li], page_idx, slot))
                 for li in range(cache_layers)]

        def plain_first(k, v):
            return plain(k[0:1], v[0:1], k_all[0:1], v_all[0:1], page_idx.long(), slot.long())
    else:
        sets = [scatter_case(gen, L, N, P, seed=2 + i) for i in range(SCATTER_SETS if shape == "decode" else 1)]
        # the wrapper is looked up at each call, so a benchmark may swap it
        name = "scatter_int8_cuda" if int8 else "scatter_cuda"
        calls = [(lambda s=s: getattr(pa, name)(kp, vp, *s)) for s in sets]

        def plain_first(k, v):
            k_all, v_all, page_idx, slot = sets[0]
            return plain(k, v, k_all, v_all, page_idx.long(), slot.long())
    orig = (clone_pages(kp), clone_pages(vp))
    want = (clone_pages(kp), clone_pages(vp))
    plain_first(*want)

    def check() -> float:
        copy_pages(kp, orig[0])
        copy_pages(vp, orig[1])
        calls[0]()
        torch.cuda.synchronize()
        return max(pages_err(kp, want[0]), pages_err(vp, want[1]))

    return dict(launch=cycling(calls), check=check, plain=lambda: plain_first(kp, vp),
                nbytes=scatter_bytes(L, N, int8), pages=(kp, vp), sets=None if shape == "one layer" else sets)


def phase_kernels_vs_plain(fa, pa) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    for B, Hq, Hkv, S, Skv, off, causal, D in K1_CASES:
        q, k, v = flash_case(gen, B, Hq, Hkv, S, Skv, D)
        o, lse = fa.flash_forward_cuda(q, k, v, causal=causal, sm_scale=D**-0.5, q_offset=off)
        torch.cuda.synchronize()
        o2, lse2 = fa.flash_forward_plain(q, k, v, causal=causal, sm_scale=D**-0.5, q_offset=off)
        e, e_lse = max_err(o, o2), max_err(lse, lse2)
        # PyTorch's flash kernel on the same inputs also rounds P to bf16: its
        # reading is logged beside the kernel's, not held to a limit
        lib = "" if off else (f", SDPA max|o-plain|={max_err(sdpa(q, k, v, causal), o2):.3g}")
        log(f"K1 flash B={B} Hq={Hq} Hkv={Hkv} S={S} Skv={Skv} q_offset={off} causal={causal} D={D}: "
            f"max|o-plain|={e:.3g} max|lse-plain|={e_lse:.3g}{lib}")
        if not (e <= TOL["flash_fwd"] and e_lse <= 1e-3):
            raise AssertionError(f"flash kernel disagrees with its plain version: {e}, {e_lse}")
        errs["flash_fwd"] = max(errs.get("flash_fwd", 0.0), e)
    for label, c in decode_cases(gen, int8=False):
        e = check_decode("paged_decode", pa.paged_decode_cuda, pa.paged_decode_plain, c, label)
        errs["paged_decode"] = max(errs.get("paged_decode", 0.0), e)
        del c
    for label, c in writeback_cases(gen, int8=False):
        e = check_writeback(pa, "paged_decode_writeback", c, label)
        errs["paged_decode_writeback"] = max(errs.get("paged_decode_writeback", 0.0), e)
        del c
    for L, N, P in [(32, 8, 513), (32, 2048, 513)]:  # decode step; prefill batch 4 x 512
        k_all, v_all, page_idx, slot = scatter_case(gen, L, N, P)
        kp, vp = rand_bf16(gen, L, P, 16, 32, 128), rand_bf16(gen, L, P, 16, 32, 128)
        kq, vq = kp.clone(), vp.clone()
        pa.scatter_cuda(kp, vp, k_all, v_all, page_idx, slot)
        torch.cuda.synchronize()
        pa.scatter_plain(kq, vq, k_all, v_all, page_idx.long(), slot.long())
        e = max(max_err(kp, kq), max_err(vp, vq))
        log(f"K3 scatter L={L} N={N} P={P}: max|pages-plain|={e}")
        if e != 0.0:
            raise AssertionError(f"scatter kernel is not bitwise equal to its plain version: {e}")
        errs["kv_scatter"] = e
        del kp, vp, kq, vq
    return errs


def bwd_case(fa, gen, B, Hq, Hkv, S, causal, nonzero_dlse, D=128):
    """Inputs of the two backward kernels: q/k/v/dO bf16, and lse from the
    forward kernel, delta = rowsum(dO*O), dlse f32."""
    q, k, v = flash_case(gen, B, Hq, Hkv, S, S, D)
    do = rand_bf16(gen, B, Hq, S, D)
    o, lse = fa.flash_forward_cuda(q, k, v, causal=causal, sm_scale=D**-0.5)
    dlse = (torch.randn(B, Hq, S, generator=gen, device="cuda") if nonzero_dlse
            else torch.zeros(B, Hq, S, device="cuda"))
    delta = (do.float() * o.float()).sum(dim=-1)
    return (q, k, v, do, lse, delta, dlse), o


def rel_err(a, b) -> float:
    return max_err(a, b) / b.float().abs().max().item()


def phase_backward_vs_plain(fa, errs: dict) -> None:
    """dQ and dK/dV kernels against flash_backward_plain on the same inputs."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = [  # (B, Hq, Hkv, S, causal, nonzero dlse, D)
        (2, 32, 32, 512, True, False, 128),   # the training path's shape (MHA)
        (2, 32, 8, 512, True, False, 128),    # GQA
        (2, 32, 32, 512, False, False, 128),  # non-causal
        (2, 8, 2, 300, True, False, 128),     # ragged S
        (2, 32, 32, 512, True, True, 128),    # lse cotangent
        (2, 8, 2, 300, True, False, 64),      # other head dims
        (2, 8, 2, 300, True, False, 32),
        (2, 4, 2, 200, True, False, 256),
        (2, 4, 2, 200, False, True, 256),
    ]
    for B, Hq, Hkv, S, causal, nz, D in cases:
        args, o = bwd_case(fa, gen, B, Hq, Hkv, S, causal, nz, D)
        dq = fa.flash_bwd_dq_cuda(*args, causal=causal, sm_scale=D**-0.5)
        dk, dv = fa.flash_bwd_dkv_cuda(*args, causal=causal, sm_scale=D**-0.5)
        torch.cuda.synchronize()
        q, k, v, do, lse, _, dlse = args
        want = fa.flash_backward_plain(q, k, v, o, lse, do, dlse, causal=causal, sm_scale=D**-0.5)
        rel = [rel_err(g, w) for g, w in zip((dq, dk, dv), want)]
        log(f"K5/K6 flash bwd B={B} Hq={Hq} Hkv={Hkv} S={S} causal={causal} dlse={'randn' if nz else 0} D={D}: "
            f"max|d-plain|/max|plain| dq={rel[0]:.3g} dk={rel[1]:.3g} dv={rel[2]:.3g}")
        if not (rel[0] <= TOL["flash_bwd_dq"] and max(rel[1:]) <= TOL["flash_bwd_dkv"]):
            raise AssertionError(f"flash backward kernels disagree with flash_backward_plain: {rel}")
        errs["flash_bwd_dq"] = max(errs.get("flash_bwd_dq", 0.0), max_err(dq, want[0]))
        errs["flash_bwd_dkv"] = max(errs.get("flash_bwd_dkv", 0.0), max_err(dk, want[1]), max_err(dv, want[2]))


def phase_int8_kernels_vs_plain(pa, errs: dict) -> None:
    """The int8 matmul, int8 decode and int8 scatter kernels against their
    plain versions on the same inputs."""
    from modal_examples_tpu_torch.models.quantize import quantize_weight
    from modal_examples_tpu_torch.ops import quantized_matmul as qmm

    gen = torch.Generator(device="cuda").manual_seed(4)
    for K, N in QMM_SHAPES:
        w = quantize_weight(torch.randn(K, N, generator=gen, device="cuda"))
        for M in QMM_MS:  # one slot, decode, both sides of the ring's limit, ragged, the prefill batch 4 x 512
            x = rand_bf16(gen, M, K)
            path = qmm.kernel_path(x, w.q)
            out = qmm.qmm_cuda(x, w.q, w.scale)
            torch.cuda.synchronize()
            want = qmm.qmm_plain(x, w.q, w.scale)
            rel = rel_err(out, want)
            again = qmm.qmm_cuda(x, w.q, w.scale)  # the split-K sum runs in a fixed order
            log(f"K7 int8 matmul M={M} K={K} N={N} path {path}: max|out-plain|/max|plain|={rel:.3g}")
            if not rel <= TOL["quantized_matmul"]:
                raise AssertionError(f"int8 matmul kernel disagrees with its plain version: {rel}")
            if not torch.equal(out, again):
                raise AssertionError(f"int8 matmul M={M} K={K} N={N} differs from run to run")
            if (K, N) != (4000, 11000) and path != ("ring" if M <= 64 else "wgmma"):
                raise AssertionError(f"Llama-2-7B shape M={M} K={K} N={N} took the {path} path")
            errs["quantized_matmul"] = max(errs.get("quantized_matmul", 0.0), max_err(out, want))
        del w
    for label, c in decode_cases(gen, int8=True):
        e = check_decode("paged_decode_int8", pa.paged_decode_int8_cuda, pa.paged_decode_int8_plain, c, label)
        errs["paged_decode_int8"] = max(errs.get("paged_decode_int8", 0.0), e)
        del c
    for label, c in writeback_cases(gen, int8=True):
        e = check_writeback(pa, "paged_decode_writeback_int8", c, label)
        errs["paged_decode_writeback_int8"] = max(errs.get("paged_decode_writeback_int8", 0.0), e)
        del c
    for label, L, N, Hkv, D in SCATTER_INT8_CASES:
        e = check_scatter_int8(pa, gen, label, L, N, Hkv, D)
        errs["kv_scatter_int8"] = max(errs.get("kv_scatter_int8", 0.0), e)


# K3-int8 against its plain version, bitwise: (label, L, N, Hkv, D) into 513
# pages of 16, each with an all-zero K row, a V row on .5 steps and the two
# equal dead rows of scatter_case (N > 3)
SCATTER_INT8_CASES = [
    ("decode step", 32, 8, 32, 128),
    ("prefill batch (blocks stride, a partial last pass)", 32, 2048, 32, 128),
    ("one layer's view through scatter_kv_layer", 1, 8, 32, 128),
    ("one token", 32, 1, 32, 128),
    ("odd N, a partial last block", 3, 37, 5, 256),
    ("GQA", 32, 8, 8, 128),
    ("D=64", 32, 37, 8, 64),
    ("D=256", 32, 8, 32, 256),
]


def check_scatter_int8(pa, gen, label: str, L: int, N: int, Hkv: int, D: int) -> float:
    """K3-int8 on one ``SCATTER_INT8_CASES`` case against its plain version,
    bitwise (``pages_err``); the all-zero row must read scale 1.0 and data 0;
    two planted faults on the kernel's own output, each one row wrong, must
    be refused by the same check: the walk's last row left unwritten (a lost
    group) and the first row's scale taken from its neighbouring head.
    Returns the error (0.0)."""
    P = 513
    k_all, v_all, page_idx, slot = scatter_case(gen, L, N, P, Hkv, D, dead=N > 3)
    k_all[0, 0, 0] = 0.0  # scale 1.0, data 0
    half = torch.randint(-127, 127, (D,), generator=gen, device="cuda").float() + 0.5
    half[0] = 127.0  # scale exactly 1: every other value is a tie, rounded half to even
    v_all[0, 0, 0] = half.to(torch.bfloat16)
    one_layer = label.startswith("one layer")
    cache = (int8_pages(gen, 4 if one_layer else L, P, 16, Hkv, D), int8_pages(gen, 4 if one_layer else L, P, 16, Hkv, D))
    orig_v = clone_pages(cache[1])
    want = tuple(clone_pages(c) for c in cache)
    if one_layer:  # layer 2 of a 4-layer cache, as the write-then-attend path views it
        pa.scatter_kv_layer(cache[0][2], cache[1][2], k_all[0], v_all[0], page_idx, slot)
        pa.scatter_int8_plain(want[0][2:3], want[1][2:3], k_all, v_all, page_idx.long(), slot.long())
        layer0 = 2
    else:
        pa.scatter_int8_cuda(*cache, k_all, v_all, page_idx, slot)
        pa.scatter_int8_plain(*want, k_all, v_all, page_idx.long(), slot.long())
        layer0 = 0
    torch.cuda.synchronize()
    e = max(pages_err(g, w) for g, w in zip(cache, want))
    first = (layer0, int(page_idx[0]), int(slot[0]))
    zero_scale, zero_data = cache[0].scale[first][0].item(), cache[0].data[first][0].abs().max().item()
    log(f"K3-int8 scatter {label}: L={L} N={N} Hkv={Hkv} D={D} partition (lanes, rows a group, groups a block, "
        f"blocks) {pa.scatter_int8_partition(L, N, Hkv, D, torch.cuda.get_device_properties(0).multi_processor_count)}"
        f": pages vs plain (int8 data and f32 scales) {e}; all-zero row scale {zero_scale} max|data| {zero_data}")
    # planted faults, each on a copy of the kernel's output
    last = (layer0 + L - 1, int(page_idx[-1]), int(slot[-1]), Hkv - 1)
    lost = clone_pages(cache[1])
    lost.data[last], lost.scale[last] = orig_v.data[last], orig_v.scale[last]
    swapped = clone_pages(cache[0])
    swapped.scale[first + (0,)] = swapped.scale[first + (1,)]
    faults = {"the last row left unwritten (a lost group)": pages_err(lost, want[1]),
              "the first row's scale from its neighbouring head": pages_err(swapped, want[0])}
    log(f"  planted faults: {faults}")
    if not all(err > 0.0 for err in faults.values()):
        raise AssertionError(f"the int8 scatter check does not see a planted fault: {faults}")
    if e != 0.0:
        raise AssertionError(f"int8 scatter kernel is not bitwise equal to its plain version ({label}): {e}")
    if zero_scale != 1.0 or zero_data != 0:
        raise AssertionError(f"an all-zero row reads scale {zero_scale}, max|data| {zero_data}")
    return e


# -- phase 3 ----------------------------------------------------------------------


def make_requests(SamplingParams):
    """8 requests: prompts of 20..700 byte tokens (one past the 512 bucket),
    max_tokens 32..64, greedy and seeded rows mixed."""
    rng = np.random.default_rng(0)
    lens = [20, 64, 130, 200, 300, 450, 511, 700]
    out = []
    for i, n in enumerate(lens):
        prompt = "".join(chr(c) for c in rng.integers(32, 127, n - 1))  # + BOS = n tokens
        params = SamplingParams(
            max_tokens=int(32 + 32 * i / 7),
            temperature=0.0 if i % 2 == 0 else 0.8,
            seed=None if i % 4 == 1 else 1000 + i,
            top_p=0.9 if i == 3 else 1.0,
        )
        out.append((prompt, params))
    return out


def check_finish(req) -> None:
    p = req.params
    if req.finish_reason == "length":
        ok = req.n_generated == p.max_tokens == len(req.generated_tokens)
    elif req.finish_reason == "stop":  # sampled eos: consumed, not kept
        ok = req.n_generated == len(req.generated_tokens) + 1 <= p.max_tokens
    else:
        ok = False
    if not ok:
        raise AssertionError(
            f"{req.request_id}: finish {req.finish_reason} with {req.n_generated} tokens "
            f"({len(req.generated_tokens)} kept) for max_tokens={p.max_tokens}"
        )


def plain_mm(x, w, layers):
    """``layers.mm`` with no kernel: ``qmm_plain`` for an int8 weight."""
    from modal_examples_tpu_torch.models.quantize import QuantizedWeight
    from modal_examples_tpu_torch.ops.quantized_matmul import qmm_plain

    if isinstance(w, QuantizedWeight):
        return qmm_plain(x.reshape(-1, x.shape[-1]), w.q, w.scale).reshape(*x.shape[:-1], w.shape[-1])
    return layers.mm(x, w)


def dense_reference_logits(params, cfg, tokens, layers, reference, n_cached: int = 0):
    """Last-position logits of a dense causal forward built from the plain
    versions (no kernel): the reference for the served path. Int8 weights go
    through ``qmm_plain``; K and V at the first ``n_cached`` positions (those
    the served path reads back from an int8 cache) go through
    ``dequantize_kv(quantize_kv(.))``."""
    import torch.nn.functional as F

    from modal_examples_tpu_torch.ops.kv_quant import dequantize_kv, quantize_kv

    def cached(t):  # [1, H, S, D]
        if not n_cached:
            return t
        return torch.cat([dequantize_kv(quantize_kv(t[:, :, :n_cached]), t.dtype), t[:, :, n_cached:]], dim=2)

    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)[None]
    cos, sin = layers.rotary_embedding(positions, cfg.head_dim, cfg.rope_theta)
    x = params["embed"][tokens]
    D = cfg.head_dim
    for layer in params["layers"]:
        h = layers.rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q = plain_mm(h, layer["wq"], layers).to(x.dtype).view(1, S, cfg.n_heads, D).transpose(1, 2)
        k = plain_mm(h, layer["wk"], layers).to(x.dtype).view(1, S, cfg.n_kv_heads, D).transpose(1, 2)
        v = plain_mm(h, layer["wv"], layers).to(x.dtype).view(1, S, cfg.n_kv_heads, D).transpose(1, 2)
        o = reference.attention(layers.apply_rope(q, cos, sin), cached(layers.apply_rope(k, cos, sin)), cached(v))
        x = x + plain_mm(o.transpose(1, 2).reshape(1, S, -1), layer["wo"], layers).to(x.dtype)
        h = layers.rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
        gate, up = plain_mm(h, layer["gate"], layers), plain_mm(h, layer["up"], layers)
        x = x + plain_mm((F.silu(gate) * up).to(x.dtype), layer["down"], layers).to(x.dtype)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return plain_mm(x[:, -1], params["lm_head"], layers)


def check_against_dense(eng, llama, layers, reference):
    """Prefill 99 tokens + one decode step (the engine's ``paged_impl``)
    through the kernels (own small cache of the engine's kv dtype) against
    the dense plain forward of the same 100 tokens. Returns (errors, prefill
    logits, tokens)."""
    from modal_examples_tpu_torch.serving.kv_cache import PagedKVCache

    cfg, params = eng.cfg, eng.params
    gen = torch.Generator(device="cuda").manual_seed(5)
    toks = torch.randint(0, 256, (1, 100), generator=gen, device="cuda", dtype=torch.int32)
    cache = PagedKVCache.create(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        n_pages=9, page_size=16, kv_dtype=eng.cache.kv_dtype, device="cuda",
    )
    tables = torch.arange(1, 9, device="cuda", dtype=torch.int32)[None]
    padded = torch.zeros((1, 128), dtype=torch.int32, device="cuda")
    padded[0, :99] = toks[0, :99]
    pre, _, _ = llama.prefill(params, padded, cache.k_pages, cache.v_pages, tables,
                              torch.tensor([99], device="cuda"), cfg)
    dec, _, _ = llama.decode_step(params, toks[0, 99:], torch.tensor([99], device="cuda"),
                                  cache.k_pages, cache.v_pages, tables,
                                  torch.tensor([True], device="cuda"), cfg, impl=eng.paged_impl)
    out = {}
    # prefill attends over its own K/V before they are written; the decode
    # step reads the 99 cached positions back from the cache
    for name, got, n, n_cached in (("prefill", pre, 99, 0), ("decode", dec, 100, 99 if cache.quantized else 0)):
        ref = dense_reference_logits(params, cfg, toks[:, :n], layers, reference, n_cached)
        if got.shape != (1, cfg.vocab_size) or not torch.isfinite(got).all():
            raise AssertionError(f"{name} logits malformed: {tuple(got.shape)}")
        rel = max_err(got, ref) / ref.abs().max().item()
        cos = torch.nn.functional.cosine_similarity(got.float(), ref.float()).item()
        log(f"{name} logits vs dense plain forward: max rel err {rel:.3g}, cosine {cos:.6f}, "
            f"argmax {int(got.argmax())} vs {int(ref.argmax())}")
        if not (rel < 5e-2 and cos > 0.999):
            raise AssertionError(f"{name} logits disagree with the dense plain forward")
        out[name] = {"max_rel_err": rel, "cosine": cos}
    return out, pre, toks


def serve_burst(eng, SamplingParams, label: str):
    """The 8 requests of ``make_requests`` through ``eng``, every finish
    checked. Returns (requests, metrics: burst tok/s, decode tok/s, TTFT
    median, wall, decode steps). Burst tok/s is every generated token over
    the burst's wall time, text delivered included, so it times the same
    work at any ``decode_steps``; decode tok/s is the engine's decode-tick
    clock, which at N > 1 leaves out the detokenization the worker thread
    does."""
    steps0 = eng.stats.steps
    dec_s0, dec_t0 = eng.stats.decode_seconds, eng.stats.decode_tokens
    t0 = time.monotonic()
    # tokenized first, then queued back to back: the running scheduler finds
    # the whole burst at one tick, so every run prefills the same groups
    reqs = [eng.make_request(p, sp) for p, sp in make_requests(SamplingParams)]
    for r in reqs:
        eng.waiting.submit(r)
    texts = ["".join(eng.stream(r)) for r in reqs]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    steps = eng.stats.steps - steps0
    log(f"{label}: {len(reqs)} requests in {wall:.2f}s, decode steps {steps}, decode_steps N={eng.decode_steps}, "
        f"plan {eng.impl_plan}")
    for r, t in zip(reqs, texts):
        check_finish(r)
        log(f"  {r.request_id}: prompt {len(r.prompt_tokens)} tok, {r.finish_reason}, "
            f"{r.n_generated} generated, ttft {r.first_token_at - r.created:.3f}s, {len(t)} chars")
    if eng.cache.allocator.available != eng.cache.n_pages - 1:
        raise AssertionError(f"{label}: pages not all returned after the requests finished")
    return reqs, {
        "burst_tok_per_s": sum(r.n_generated for r in reqs) / wall,
        "decode_tok_per_s": (eng.stats.decode_tokens - dec_t0) / (eng.stats.decode_seconds - dec_s0),
        "ttft_s_median": statistics.median(r.first_token_at - r.created for r in reqs),
        "wall_s": wall,
        "decode_steps": steps,
    }


def check_same_tokens(reqs, ref_reqs, label: str) -> int:
    """Greedy and seeded rows must repeat ``ref_reqs`` token for token (rows
    are independent in every kernel and GEMM); rows with an engine-assigned
    seed draw a new one per submit and are skipped. Returns the rows held."""
    held = 0
    for r, ref in zip(reqs, ref_reqs):
        if r.params.temperature > 0 and r.params.seed is None:
            continue
        if (r.generated_tokens, r.finish_reason) != (ref.generated_tokens, ref.finish_reason):
            raise AssertionError(f"{label}: {r.request_id} tokens differ from the reference run")
        held += 1
    log(f"{label}: {held} greedy and seeded rows token-identical to the reference run")
    return held


def phase_engine(fa, pa, llama, layers, reference, LLMEngine, SamplingParams):
    cfg = llama.LlamaConfig.llama2_7b()
    t0 = time.monotonic()
    params = llama.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"llama2-7b random bf16 init: {time.monotonic() - t0:.1f}s, {cfg.param_count / 1e9:.2f}B params, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    eng = LLMEngine(cfg, params, max_slots=8, max_model_len=1024, prefill_buckets=(128, 256, 512),
                    prefill_batch=4, decode_block=8, seed=0, device="cuda")
    # warm the path (allocator, cuBLAS handles) with one short request, off the count
    eng.generate("warm up", SamplingParams(max_tokens=2, temperature=0.0))
    fa.launches = pa.decode_launches = pa.scatter_launches = 0
    reqs, metrics = serve_burst(eng, SamplingParams, "engine")
    counts = {"flash_fwd": fa.launches, "paged_decode": pa.decode_launches, "kv_scatter": pa.scatter_launches}
    steps = metrics["decode_steps"]
    log(f"engine launches {counts}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {counts}")
    if counts["paged_decode"] != cfg.n_layers * steps:
        raise AssertionError(f"decode launches {counts['paged_decode']} != {cfg.n_layers} x {steps} steps")
    metrics["launches"] = counts
    log(f"engine metrics: {json.dumps(metrics)}")
    metrics["dense_check"] = check_against_dense(eng, llama, layers, reference)[0]
    # the macro-step replay: the same engine and burst, 8 steps per dispatch
    eng.decode_steps = 8
    fa.launches = pa.decode_launches = pa.scatter_launches = 0
    reqs8, m8 = serve_burst(eng, SamplingParams, "engine, macro-step N=8")
    m8["launches"] = {"flash_fwd": fa.launches, "paged_decode": pa.decode_launches, "kv_scatter": pa.scatter_launches}
    # a step that ran launched the decode kernel once a layer; stats.steps
    # counts the steps with a valid row, so the two agree only if every
    # counted step ran and every step that ran was counted
    if m8["launches"]["paged_decode"] != cfg.n_layers * m8["decode_steps"]:
        raise AssertionError(f"macro-step decode launches {m8['launches']} != {cfg.n_layers} x {m8['decode_steps']}")
    m8["rows_held"] = check_same_tokens(reqs8, reqs, "engine, macro-step N=8 against N=1")
    eng.decode_steps = 1
    log(f"engine macro-step N=8 metrics: {json.dumps(m8)} (N=1: burst {metrics['burst_tok_per_s']:.1f} tok/s, "
        f"decode {metrics['decode_tok_per_s']:.1f} tok/s, TTFT median {metrics['ttft_s_median']:.3f}s)")
    metrics["macro_step_8"] = m8
    return eng, metrics


def phase_writeback_engine(fa, pa, llama, layers, reference, LLMEngine, SamplingParams, params) -> dict:
    """Phase 3b: the same weights and burst through ``paged_impl=
    "pallas-writeback"`` at ``decode_steps=8``, counters zeroed just before
    and read just after; then the same engine at N=1; then the dense check
    through the writeback decode step."""
    cfg = llama.LlamaConfig.llama2_7b()
    eng = LLMEngine(cfg, params, paged_impl="pallas-writeback", decode_steps=8, max_slots=8, max_model_len=1024,
                    prefill_buckets=(128, 256, 512), prefill_batch=4, decode_block=8, seed=0, device="cuda")
    eng.generate("warm up", SamplingParams(max_tokens=2, temperature=0.0))
    out = {}
    for n in (8, 1):
        eng.decode_steps = n
        fa.launches = pa.decode_launches = pa.decode_writeback_launches = pa.scatter_launches = 0
        reqs, m = serve_burst(eng, SamplingParams, f"writeback engine, N={n}")
        m["launches"] = {"flash_fwd": fa.launches, "paged_decode_writeback": pa.decode_writeback_launches,
                         "paged_decode": pa.decode_launches, "kv_scatter": pa.scatter_launches}
        steps, counts = m["decode_steps"], m["launches"]
        log(f"writeback engine N={n} launches {counts}")
        if counts["paged_decode_writeback"] != cfg.n_layers * steps or counts["paged_decode"]:
            raise AssertionError(f"writeback launches {counts}: want {cfg.n_layers} x {steps} K4, no K2")
        if counts["kv_scatter"] < cfg.n_layers * steps or counts["flash_fwd"] < 1:
            raise AssertionError(f"writeback launches {counts}: want K3 once a layer a step, and K1")
        out[n] = (reqs, m)
    m8, m1 = out[8][1], out[1][1]
    m8["rows_held"] = check_same_tokens(out[8][0], out[1][0], "writeback engine, N=8 against N=1")
    metrics = {"n8": m8, "n1": m1, "launches": m8["launches"]}
    log(f"writeback engine: burst {m8['burst_tok_per_s']:.1f} tok/s at N=8, {m1['burst_tok_per_s']:.1f} at N=1; "
        f"decode {m8['decode_tok_per_s']:.1f} / {m1['decode_tok_per_s']:.1f} tok/s; "
        f"TTFT median {m8['ttft_s_median']:.3f}s at N=8, {m1['ttft_s_median']:.3f}s at N=1")
    metrics["dense_check"] = check_against_dense(eng, llama, layers, reference)[0]
    eng.stop()
    return metrics


def phase_server(eng, OpenAIServer) -> None:
    srv = OpenAIServer(eng, model_name="llama2-7b", port=0).start()
    base = f"http://{srv.host}:{srv.port}"
    try:
        def post(path, body):
            req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                         headers={"content-type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.status, r.read().decode()

        status, body = post("/v1/completions", {"prompt": "The capital of France is", "max_tokens": 16, "temperature": 0})
        out = json.loads(body)
        if status != 200 or out["choices"][0]["finish_reason"] not in ("length", "stop"):
            raise AssertionError(f"completion failed: {status} {body[:300]}")
        log(f"server /v1/completions: {out['usage']}, finish {out['choices'][0]['finish_reason']}")
        status, body = post("/v1/chat/completions", {
            "messages": [{"role": "user", "content": "Say hello."}], "max_tokens": 16, "seed": 1,
            "stream": True, "stream_options": {"include_usage": True},
        })
        events = [e for e in body.split("\n\n") if e]
        if status != 200 or events[-1] != "data: [DONE]":
            raise AssertionError(f"streamed chat failed: {status} {body[-300:]}")
        usage = json.loads(events[-2][len("data: "):])["usage"]
        log(f"server streamed /v1/chat/completions: {len(events) - 3} content chunks, usage {usage}")
    finally:
        srv.stop()  # also stops the engine


# -- int8 serving -------------------------------------------------------------------


def phase_int8_engine(fa, pa, llama, layers, reference, LLMEngine, SamplingParams, params, bf16_cache_bytes):
    """The same bf16 weights quantized by ``quantize_llama`` (passed to the
    engine with ``quantization=None``), an int8 KV cache, the same 8
    requests; counters zeroed just before the burst and read just after."""
    from modal_examples_tpu_torch.models import quantize
    from modal_examples_tpu_torch.ops import quantized_matmul as qmm

    cfg = llama.LlamaConfig.llama2_7b()
    t0 = time.monotonic()
    qparams = quantize.quantize_llama(params)
    torch.cuda.synchronize()
    w_ratio = quantize.param_bytes(qparams) / quantize.param_bytes(params)
    eng = LLMEngine(cfg, qparams, quantization=None, kv_dtype="int8", max_slots=8, max_model_len=1024,
                    prefill_buckets=(128, 256, 512), prefill_batch=4, decode_block=8, seed=0, device="cuda")
    c_ratio = eng.cache.bytes() / bf16_cache_bytes
    log(f"int8: quantize_llama {time.monotonic() - t0:.1f}s; weights {quantize.param_bytes(qparams) / 1e9:.3f} GB "
        f"({w_ratio:.4f} of bf16), cache {eng.cache.bytes() / 1e9:.3f} GB ({c_ratio:.4f} of bf16), plan {eng.impl_plan}")
    eng.generate("warm up", SamplingParams(max_tokens=2, temperature=0.0))
    fa.launches = pa.decode_launches = pa.scatter_launches = pa.decode_int8_launches = pa.scatter_int8_launches = 0
    qmm.qmm_launches = 0
    _, metrics = serve_burst(eng, SamplingParams, "int8 engine")
    counts = {"flash_fwd": fa.launches, "quantized_matmul": qmm.qmm_launches,
              "paged_decode_int8": pa.decode_int8_launches, "kv_scatter_int8": pa.scatter_int8_launches,
              "paged_decode": pa.decode_launches, "kv_scatter": pa.scatter_launches}
    steps = metrics["decode_steps"]
    log(f"int8 engine launches {counts}")
    per_pass = 7 * cfg.n_layers + 1  # seven projections a layer, then lm_head
    if counts["paged_decode_int8"] != cfg.n_layers * steps:
        raise AssertionError(f"int8 decode launches {counts['paged_decode_int8']} != {cfg.n_layers} x {steps} steps")
    if counts["paged_decode"] or counts["kv_scatter"]:
        raise AssertionError(f"the int8 path launched a bf16 cache kernel: {counts}")
    if counts["kv_scatter_int8"] < 1 or counts["flash_fwd"] < 1:
        raise AssertionError(f"a kernel of the int8 path never launched: {counts}")
    if counts["quantized_matmul"] % per_pass or counts["quantized_matmul"] < per_pass * steps:
        raise AssertionError(f"int8 matmul launches {counts['quantized_matmul']}: want a multiple of {per_pass}, "
                             f"at least {per_pass} x {steps} steps")
    if not (w_ratio <= 0.52 and c_ratio <= 0.52):
        raise AssertionError(f"int8 bytes over 0.52 of bf16: weights {w_ratio}, cache {c_ratio}")
    metrics.update(
        launches=counts, weight_gb=quantize.param_bytes(qparams) / 1e9, weight_ratio=w_ratio,
        cache_gb=eng.cache.bytes() / 1e9, cache_ratio=c_ratio,
    )
    log(f"int8 engine metrics: {json.dumps(metrics)}")
    metrics["dense_check"], pre, toks = check_against_dense(eng, llama, layers, reference)
    bf16_ref = dense_reference_logits(params, cfg, toks[:, :99], layers, reference)
    metrics["prefill_cosine_vs_bf16_model"] = torch.nn.functional.cosine_similarity(pre.float(), bf16_ref.float()).item()
    log(f"int8 prefill logits vs the bf16 model's dense forward (logged, not held to a bound): cosine "
        f"{metrics['prefill_cosine_vs_bf16_model']:.6f}, argmax {int(pre.argmax())} vs {int(bf16_ref.argmax())}")
    eng.stop()
    return metrics, qparams


def phase_int8_writeback_engine(fa, pa, llama, layers, reference, LLMEngine, SamplingParams, qparams) -> dict:
    """Phase 3b over int8 pages: the int8 weights ``qparams`` in an engine
    with an int8 KV cache and ``paged_impl="pallas-writeback"`` at
    ``decode_steps=8``, the 8 requests, counters zeroed just before the burst
    and read just after: K4-int8 n_layers x decode steps times, no other
    decode kernel, K3-int8 at least once a layer a step and no bf16 scatter;
    then prefill + one writeback decode step against the dense plain forward
    over the same int8 weights and cache rows."""
    from modal_examples_tpu_torch.ops import quantized_matmul as qmm

    cfg = llama.LlamaConfig.llama2_7b()
    eng = LLMEngine(cfg, qparams, quantization=None, kv_dtype="int8", paged_impl="pallas-writeback", decode_steps=8,
                    max_slots=8, max_model_len=1024, prefill_buckets=(128, 256, 512), prefill_batch=4,
                    decode_block=8, seed=0, device="cuda")
    eng.generate("warm up", SamplingParams(max_tokens=2, temperature=0.0))
    fa.launches = qmm.qmm_launches = pa.scatter_launches = pa.scatter_int8_launches = 0
    pa.decode_launches = pa.decode_int8_launches = pa.decode_writeback_launches = pa.decode_writeback_int8_launches = 0
    _, metrics = serve_burst(eng, SamplingParams, "int8 writeback engine, N=8")
    counts = {"flash_fwd": fa.launches, "quantized_matmul": qmm.qmm_launches,
              "paged_decode_writeback_int8": pa.decode_writeback_int8_launches,
              "kv_scatter_int8": pa.scatter_int8_launches, "paged_decode_writeback": pa.decode_writeback_launches,
              "paged_decode": pa.decode_launches, "paged_decode_int8": pa.decode_int8_launches,
              "kv_scatter": pa.scatter_launches}
    steps = metrics["decode_steps"]
    log(f"int8 writeback engine N=8 launches {counts}")
    if counts["paged_decode_writeback_int8"] != cfg.n_layers * steps:
        raise AssertionError(f"int8 writeback launches {counts}: want {cfg.n_layers} x {steps} K4-int8")
    if counts["paged_decode_writeback"] or counts["paged_decode"] or counts["paged_decode_int8"] or counts["kv_scatter"]:
        raise AssertionError(f"the int8 writeback path launched another decode or a bf16 scatter kernel: {counts}")
    if counts["kv_scatter_int8"] < cfg.n_layers * steps or counts["flash_fwd"] < 1 or counts["quantized_matmul"] < 1:
        raise AssertionError(f"int8 writeback launches {counts}: want K3-int8 once a layer a step, K1 and K7")
    metrics["launches"] = counts
    log(f"int8 writeback engine metrics: {json.dumps(metrics)}")
    metrics["dense_check"] = check_against_dense(eng, llama, layers, reference)[0]
    eng.stop()
    return metrics


# -- training ---------------------------------------------------------------------


def adapter_grads(loss_fn, adapters, batch, attn_impl):
    leaves = {k: v.detach().requires_grad_(True) for k, v in adapters["layers"].items()}
    loss = loss_fn({"layers": leaves}, batch, attn_impl=attn_impl)
    return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def check_grads_against_xla(loss_fn, adapters, batch, targets) -> dict:
    """The first step's adapter gradients through the flash kernels against
    the plain xla attention (autograd through dense attention) on the card.
    b = 0 at init, so every a-gradient is exactly zero on both paths and the
    b-gradients carry the comparison."""
    flash = adapter_grads(loss_fn, adapters, batch, "flash")
    xla = adapter_grads(loss_fn, adapters, batch, "xla")
    out = {}
    for t in targets:
        if flash[f"{t}_a"].abs().max() != 0 or xla[f"{t}_a"].abs().max() != 0:
            raise AssertionError(f"{t}_a gradient is not zero with b = 0")
        f, x = flash[f"{t}_b"].float().flatten(), xla[f"{t}_b"].float().flatten()
        cos = torch.nn.functional.cosine_similarity(f, x, dim=0).item()
        rel = max_err(f, x) / x.abs().max().item()
        out[t] = {"cosine": cos, "max_rel_err": rel}
        log(f"  {t}_b grad flash vs xla: cosine {cos:.6f}, max rel err {rel:.3g}, max|g| {x.abs().max().item():.3g}")
    worst = min(v["cosine"] for v in out.values())
    if not worst >= GRAD_COSINE_MIN:
        raise AssertionError(f"adapter gradients disagree with attn_impl='xla': cosine {worst} < {GRAD_COSINE_MIN}")
    return out


def lora_training_setup(llama, lora, training, params, steps: int):
    """The training path: Llama-2-7B over the frozen ``params``, rank-16
    LoRA (alpha 16, scale 1.0) on all seven projections, ``steps`` batches
    of B=2 x S=512 random tokens (mask of ones), the masked next-token loss
    through ``llama.forward``. Returns (cfg, lcfg, adapters, batches, loss_fn)."""
    cfg = llama.LlamaConfig.llama2_7b()
    lcfg = lora.LoRAConfig(rank=16)
    B, S = 2, 512
    adapters = lora.init_lora(torch.Generator(device="cuda").manual_seed(0), params, lcfg)
    for p in params["layers"]:
        if any(t.requires_grad for t in p.values()):
            raise AssertionError("the base must be frozen")
    tok_gen = torch.Generator(device="cuda").manual_seed(1)
    batches = [
        {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=tok_gen, device="cuda"),
         "mask": torch.ones((B, S), device="cuda")}
        for _ in range(steps)
    ]

    def loss_fn(ad, batch, attn_impl="flash"):
        logits = llama.forward(params, batch["tokens"], cfg, attn_impl=attn_impl, lora=ad, lora_scale=lcfg.scale)
        return training.cross_entropy_loss(logits[:, :-1], batch["tokens"][:, 1:], batch["mask"][:, 1:])

    return cfg, lcfg, adapters, batches, loss_fn


def phase_training(fa, llama, lora, training, params) -> dict:
    steps = 5
    cfg, lcfg, adapters, batches, loss_fn = lora_training_setup(llama, lora, training, params, steps)
    B, S = batches[0]["tokens"].shape
    log(f"training: llama2-7b frozen bf16 base, LoRA rank {lcfg.rank} scale {lcfg.scale} on {lcfg.targets}, "
        f"{lora.param_count(adapters) / 1e6:.2f}M adapter params, B={B} S={S}")
    grads = check_grads_against_xla(loss_fn, adapters, batches[0], lcfg.targets)
    gc.collect()
    torch.cuda.empty_cache()

    trainer = training.Trainer(loss_fn, training.make_optimizer(1e-4))
    state = trainer.init_state(adapters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    step_s, losses, norms = [], [], []
    for batch in batches:
        t0 = time.monotonic()
        state, m = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    counts = {"flash_fwd": fa.launches, "flash_bwd_dq": fa.dq_launches, "flash_bwd_dkv": fa.dkv_launches}
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"training steps: loss {losses}, grad_norm {norms}, step s {step_s}, launches {counts}")
    want = cfg.n_layers * steps
    if counts != {k: want for k in counts}:
        raise AssertionError(f"training launches {counts}: want {want} each ({cfg.n_layers} layers x {steps} steps)")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"non-finite loss or grad norm: {losses}, {norms}")
    moved = {t: state.params["layers"][f"{t}_b"].abs().max().item() for t in lcfg.targets}
    if min(moved.values()) <= 0:
        raise AssertionError(f"b adapters did not move off zero: {moved}")
    if state.step != steps:
        raise AssertionError(f"state.step {state.step} != {steps}")
    if not peak < total:
        raise AssertionError(f"peak memory {peak} not under the card's {total}")
    step_med = statistics.median(step_s[1:])
    metrics = {
        "train_tok_per_s": B * S / step_med,
        "step_ms_median": 1e3 * step_med,
        "step_ms": [1e3 * x for x in step_s],
        "peak_gb": peak / 1e9,
        "card_gb": total / 1e9,
        "losses": losses,
        "launches": counts,
        "grad_check": grads,
    }
    log(f"training metrics: train {metrics['train_tok_per_s']:.1f} tok/s, step {metrics['step_ms_median']:.1f} ms "
        f"(median of {steps - 1} after 1 warm-up), peak {metrics['peak_gb']:.2f} GB of {metrics['card_gb']:.2f} GB; "
        f"{json.dumps(metrics)}")
    return metrics


# -- phase 5 ----------------------------------------------------------------------


def phase_numbers(fa, pa, counts: dict, errs: dict) -> list:
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = []
    # K1 at the engine's prefill batch: 4 prompts in the 512 bucket
    B, H, S, D = 4, 32, 512, 128
    q, k, v = flash_case(gen, B, H, H, S, S)
    flops = 4 * B * H * S * S * D * 0.5
    nbytes = 4 * B * H * S * D * 2 + B * H * S * 4
    rows.append(dict(
        name="flash_fwd", source="modal_examples_tpu_torch/csrc/flash_fwd.cu",
        replaces="modal_examples_tpu/ops/flash_attention.py:40",
        ms=time_ms(lambda: fa.flash_forward_cuda(q, k, v, causal=True, sm_scale=D**-0.5)),
        ms_b2b=back_to_back_ms(lambda: fa.flash_forward_cuda(q, k, v, causal=True, sm_scale=D**-0.5)),
        plain_ms=time_ms(lambda: fa.flash_forward_plain(q, k, v, causal=True, sm_scale=D**-0.5), reps=5),
        bound_ms=1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES),
        bound_by="operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES else "bytes",
        library_ms=time_ms(lambda: sdpa(q, k, v, True)),
        library_ms_b2b=back_to_back_ms(lambda: sdpa(q, k, v, True)),
    ))
    del q, k, v
    # K2 at a decode step of the engine's shape: 8 slots, ragged prefixes
    # 0..1000, cycled over four layers of one cache
    c = decode_case(gen, 8, 32, 32, L=32)
    per_layer = [decode_args(c, li) for li in CYCLED_LAYERS]
    kernel = cycling([lambda a=a: pa.paged_decode_cuda(*a, sm_scale=D**-0.5) for a in per_layer])
    rows_read = int(c["prefix_lens"].sum())  # the kernel reads each prefix's rows, not whole pages
    nbytes = 2 * rows_read * 32 * 128 * 2 + 4 * 8 * 32 * 128 * 2  # K+V rows; q, o, k_new, v_new
    rows.append(dict(
        name="paged_decode", source="modal_examples_tpu_torch/csrc/paged_decode.cu",
        replaces="modal_examples_tpu/ops/paged_attention.py:284",
        shape=f"B=8 Hq=Hkv=32 D=128 prefixes 0..1000 ({rows_read} rows), layers {CYCLED_LAYERS} in turn",
        ms=time_ms(kernel), ms_b2b=back_to_back_ms(kernel), device_ms=device_ms(kernel),
        plain_ms=time_ms(lambda: pa.paged_decode_plain(*per_layer[0], sm_scale=D**-0.5), reps=5),
        bound_ms=1e3 * nbytes / PEAK_BYTES, bound_by="bytes", library_ms=None, library_ms_b2b=None,
        library_op="none: no PyTorch call attends over a paged cache",
    ))
    # K4 at the same shape over the same layers' pages: contexts count the
    # current token (its K/V already in the cache), so each is K2's prefix
    # plus one
    per_layer = [[c["q"], c["k_pages"][li], c["v_pages"][li], c["page_tables"], c["prefix_lens"] + 1]
                 for li in CYCLED_LAYERS]
    kernel = cycling([lambda a=a: pa.paged_decode_writeback_cuda(*a, sm_scale=D**-0.5) for a in per_layer])
    rows_read = int(c["prefix_lens"].sum()) + 8  # the kernel reads each context's rows, not whole pages
    nbytes = 2 * rows_read * 32 * 128 * 2 + 2 * 8 * 32 * 128 * 2  # K+V rows; q, o
    rows.append(dict(
        name="paged_decode_writeback", source="modal_examples_tpu_torch/csrc/paged_decode_writeback.cu",
        replaces="modal_examples_tpu/ops/paged_attention.py:72",
        shape=f"B=8 Hq=Hkv=32 D=128 one layer's pages, contexts 1..1001 ({rows_read} rows), layers "
              f"{CYCLED_LAYERS} in turn",
        ms=time_ms(kernel), ms_b2b=back_to_back_ms(kernel), device_ms=device_ms(kernel),
        plain_ms=time_ms(lambda: pa.paged_decode_writeback_plain(*per_layer[0], sm_scale=D**-0.5), reps=5),
        bound_ms=1e3 * nbytes / PEAK_BYTES, bound_by="bytes", library_ms=None, library_ms_b2b=None,
        library_op="none: no PyTorch call attends over a paged cache",
    ))
    del c, per_layer, kernel
    rows.append(scatter_row(pa, gen, int8=False))
    # K5/K6 at the training path's shape: B=2, Hq=Hkv=32, S=512, D=128, causal
    B, H, S, D = 2, 32, 512, 128
    args, _ = bwd_case(fa, gen, B, H, H, S, True, False)
    q, k, v, do = args[:4]
    one_product = 2 * 0.5 * S * S * D * B * H  # FLOPs of one causal S x S x D product, all heads
    tensor_bytes, row_bytes = B * H * S * D * 2, B * H * S * 4
    out, lse_l, cq, ck, mq, mk, seed, offset, _ = torch.ops.aten._scaled_dot_product_flash_attention(
        q, k, v, 0.0, True, False, scale=D**-0.5)

    def library():  # PyTorch's flash-attention backward: dQ, dK and dV in one call
        return torch.ops.aten._scaled_dot_product_flash_attention_backward(
            do, q, k, v, out, lse_l, cq, ck, mq, mk, 0.0, True, seed, offset, scale=D**-0.5)

    library_ms, library_ms_b2b = time_ms(library), back_to_back_ms(library)
    for name, fn, plain, n_products, n_tensors, line in (
        ("flash_bwd_dq", fa.flash_bwd_dq_cuda, fa.flash_bwd_dq_plain, 3, 5, 244),
        ("flash_bwd_dkv", fa.flash_bwd_dkv_cuda, fa.flash_bwd_dkv_plain, 4, 6, 278),
    ):
        flops = n_products * one_product
        nbytes = n_tensors * tensor_bytes + 3 * row_bytes  # q,k,v,dO + outputs; lse, delta, dlse
        rows.append(dict(
            name=name, source=f"modal_examples_tpu_torch/csrc/{name}.cu",
            replaces=f"modal_examples_tpu/ops/flash_attention.py:{line}",
            ms=time_ms(lambda: fn(*args, causal=True, sm_scale=D**-0.5)),
            ms_b2b=back_to_back_ms(lambda: fn(*args, causal=True, sm_scale=D**-0.5)),
            plain_ms=time_ms(lambda: plain(*args, causal=True, sm_scale=D**-0.5), reps=5),
            bound_ms=1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES),
            bound_by="operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES else "bytes",
            library_ms=library_ms, library_ms_b2b=library_ms_b2b,
            library_op="aten._scaled_dot_product_flash_attention_backward (dQ, dK and dV together)",
        ))
    del args, q, k, v, do, out
    rows += int8_rows(pa, gen)
    for r in rows:
        r["route"] = "cuda"
        r["launches"] = counts[r["name"]]
        r["max_abs_err"] = errs[r["name"]]
        log(f"{r['name']}: {r['ms']:.4f} ms, back-to-back {r['ms_b2b']:.4f}, device {r.get('device_ms')} (plain {r['plain_ms']:.4f}, library "
            f"{r['library_ms']}, back-to-back {r.get('library_ms_b2b')}, bound {r['bound_ms']:.4f} by {r['bound_by']})"
            + (f"; device time and bound by shape {r['shapes']}" if "shapes" in r else ""))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "ms_b2b", "device_ms", "plain_ms",
            "bound_ms",
            "bound_by", "library_ms", "library_ms_b2b", "library_op", "bf16_mm_ms", "bf16_mm_ms_b2b", "shape", "path",
            "prefill", "shapes")
    return [{k: r[k] for k in keys if k in r} for r in rows]


def scatter_row(pa, gen, int8: bool) -> dict:
    """Phase 5's row of K3 or K3-int8 (``scatter_timed``): single-launch,
    back-to-back and device times, the plain version and one library call at
    the decode shape; the device time and the byte bound at every shape of
    ``SCATTER_SHAPES`` under ``shapes``."""
    from modal_examples_tpu_torch.ops import kv_quant as kvq

    shapes = {}
    for shape, (L, N) in SCATTER_SHAPES.items():
        t = scatter_timed(pa, gen, shape, int8)
        shapes[shape] = dict(L=L, N=N, device_ms=device_ms(t["launch"]), bound_ms=1e3 * t["nbytes"] / PEAK_BYTES)
        if shape != "decode":
            del t
            continue
        kp, vp = t["pages"]
        k_all, v_all, page_idx, slot = t["sets"][0]
        layer_ix = torch.arange(L, device="cuda")[:, None]
        pi, sl = page_idx.long()[None], slot.long()[None]

        def library():
            for pages, new in ((kp, k_all), (vp, v_all)):
                if int8:
                    q = kvq.quantize_kv(new)
                    pages.data.index_put_((layer_ix, pi, sl), q.data)
                    pages.scale.index_put_((layer_ix, pi, sl), q.scale)
                else:
                    pages.index_put_((layer_ix, pi, sl), new)

        decode = dict(
            ms=time_ms(t["launch"]), ms_b2b=back_to_back_ms(t["launch"]), device_ms=shapes[shape]["device_ms"],
            plain_ms=time_ms(t["plain"]), bound_ms=shapes[shape]["bound_ms"],
            library_ms=time_ms(library), library_ms_b2b=back_to_back_ms(library),
        )
        del t, kp, vp, k_all, v_all
    name = "kv_scatter_int8" if int8 else "kv_scatter"
    return dict(
        name=name, source=f"modal_examples_tpu_torch/csrc/{name}.cu",
        replaces="modal_examples_tpu/ops/paged_attention.py:927",
        shape="L={} N={} Hkv=32 D=128, {} sets of rows and targets in turn".format(*SCATTER_SHAPES["decode"], SCATTER_SETS),
        **decode, bound_by="bytes",
        library_op=("quantize_kv + index_put_ (int8 rows and scales, K and V)" if int8
                    else "index_put_ (K and V)"),
        shapes=shapes,
    )


def cycling(fns):
    """One callable that calls ``fns`` in turn: timed over weight copies that
    together exceed the 50 MB L2, so each launch streams its weight from HBM
    as a decode step does."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def int8_library(w):
    """One PyTorch call computing the int8 matmul's function on ``w``:
    ``torch._weight_int8pack_mm`` (weight [N, K], bf16 scales) where this
    build has it for CUDA, else ``torch.mm`` over a bf16 weight dequantized
    beforehand. Returns (fn of x, name)."""
    from modal_examples_tpu_torch.models.quantize import dequantize_weight

    wt, s = w.q.T.contiguous(), w.scale.reshape(-1).to(torch.bfloat16)
    probe = torch.zeros((8, w.q.shape[0]), dtype=torch.bfloat16, device="cuda")
    try:
        torch._weight_int8pack_mm(probe, wt, s)
        torch.cuda.synchronize()
        return (lambda x: torch._weight_int8pack_mm(x, wt, s)), "torch._weight_int8pack_mm (scales rounded to bf16, bf16 out)"
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        log(f"library probe: torch._weight_int8pack_mm has no CUDA path here ({type(e).__name__}: {str(e)[:160]})")
    wd = dequantize_weight(w, torch.bfloat16)
    return (lambda x: torch.mm(x, wd)), "torch.mm over a bf16 weight dequantized beforehand"


def int8_rows(pa, gen) -> list:
    """Phase 5 rows of the int8 kernels: K7 at the decode step's and the
    prefill batch's gate/up shape, K2-int8 at K2's shape, K4-int8 at K4's,
    K3-int8 at ``SCATTER_SHAPES``."""
    from modal_examples_tpu_torch.models.quantize import dequantize_weight, quantize_weight
    from modal_examples_tpu_torch.ops import quantized_matmul as qmm

    rows = []
    K, N = 4096, 11008
    weights = [quantize_weight(torch.randn(K, N, generator=gen, device="cuda")) for _ in range(4)]  # 180 MB of int8
    libs = [int8_library(w) for w in weights]
    # a second yardstick: the bf16 GEMM (cuBLAS) the bf16 path runs on the same shape
    bf16_weights = [dequantize_weight(w, torch.bfloat16) for w in weights]
    timed = {}
    for label, M in (("decode", 8), ("prefill", 2048)):
        x = rand_bf16(gen, M, K)
        flops, nbytes = 2 * M * N * K, M * K * 2 + K * N + N * 4 + M * N * 4  # x, q, scale in; f32 out
        kernel = cycling([lambda w=w: qmm.qmm_cuda(x, w.q, w.scale) for w in weights])
        library = cycling([lambda fn=fn: fn(x) for fn, _ in libs])
        bf16_mm = cycling([lambda wd=wd: torch.mm(x, wd) for wd in bf16_weights])
        timed[label] = dict(
            shape=f"M={M} K={K} N={N}", path=qmm.kernel_path(x, weights[0].q),
            ms=time_ms(kernel), ms_b2b=back_to_back_ms(kernel),
            plain_ms=time_ms(cycling([lambda w=w: qmm.qmm_plain(x, w.q, w.scale) for w in weights]), reps=5),
            bound_ms=1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES),
            bound_by="operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES else "bytes",
            library_ms=time_ms(library), library_ms_b2b=back_to_back_ms(library),
            library_op=libs[0][1],
            bf16_mm_ms=time_ms(bf16_mm), bf16_mm_ms_b2b=back_to_back_ms(bf16_mm),
        )
    rows.append(dict(
        name="quantized_matmul", source="modal_examples_tpu_torch/csrc/quantized_matmul.cu",
        replaces="modal_examples_tpu/ops/quantized_matmul.py:38", **timed["decode"], prefill=timed["prefill"],
    ))
    del weights, libs, bf16_weights
    # K2-int8 at K2's shape: 8 slots, ragged prefixes 0..1000, int8 pages,
    # cycled over four layers of one cache
    c = decode_case(gen, 8, 32, 32, L=32, int8=True)
    per_layer = [decode_args(c, li) for li in CYCLED_LAYERS]
    kernel = cycling([lambda a=a: pa.paged_decode_int8_cuda(*a, sm_scale=128**-0.5) for a in per_layer])
    rows_read = int(c["prefix_lens"].sum())
    nbytes = 2 * rows_read * 32 * (128 + 4) + 4 * 8 * 32 * 128 * 2  # int8 K+V rows and scales; q, o, k_new, v_new
    rows.append(dict(
        name="paged_decode_int8", source="modal_examples_tpu_torch/csrc/paged_decode_int8.cu",
        replaces="modal_examples_tpu/ops/paged_attention.py:284",
        shape=f"B=8 Hq=Hkv=32 D=128 prefixes 0..1000 ({rows_read} rows), layers {CYCLED_LAYERS} in turn",
        ms=time_ms(kernel), ms_b2b=back_to_back_ms(kernel), device_ms=device_ms(kernel),
        plain_ms=time_ms(lambda: pa.paged_decode_int8_plain(*per_layer[0], sm_scale=128**-0.5), reps=5),
        bound_ms=1e3 * nbytes / PEAK_BYTES, bound_by="bytes", library_ms=None, library_ms_b2b=None,
        library_op="none: no PyTorch call attends over a paged cache",
    ))
    # K4-int8 at K4's shape over the same int8 layers' pages: contexts are
    # K2-int8's prefixes plus the current token
    per_layer = [[c["q"], c["k_pages"][li], c["v_pages"][li], c["page_tables"], c["prefix_lens"] + 1]
                 for li in CYCLED_LAYERS]
    kernel = cycling([lambda a=a: pa.paged_decode_writeback_int8_cuda(*a, sm_scale=128**-0.5) for a in per_layer])
    rows_read = int(c["prefix_lens"].sum()) + 8
    nbytes = 2 * rows_read * 32 * (128 + 4) + 2 * 8 * 32 * 128 * 2  # int8 K+V rows and scales; q, o
    rows.append(dict(
        name="paged_decode_writeback_int8", source="modal_examples_tpu_torch/csrc/paged_decode_writeback_int8.cu",
        replaces="modal_examples_tpu/ops/paged_attention.py:72",
        shape=f"B=8 Hq=Hkv=32 D=128 one layer's int8 pages, contexts 1..1001 ({rows_read} rows), layers "
              f"{CYCLED_LAYERS} in turn",
        ms=time_ms(kernel), ms_b2b=back_to_back_ms(kernel), device_ms=device_ms(kernel),
        plain_ms=time_ms(lambda: pa.paged_decode_writeback_int8_plain(*per_layer[0], sm_scale=128**-0.5), reps=5),
        bound_ms=1e3 * nbytes / PEAK_BYTES, bound_by="bytes", library_ms=None, library_ms_b2b=None,
        library_op="none: no PyTorch call attends over a paged cache",
    ))
    del c, per_layer, kernel
    rows.append(scatter_row(pa, gen, int8=True))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script runs on the GPU only", file=sys.stderr)
        return 2
    from modal_examples_tpu_torch import LLMEngine, OpenAIServer, SamplingParams, training
    from modal_examples_tpu_torch.models import layers, llama, lora
    from modal_examples_tpu_torch.ops import _build, reference
    from modal_examples_tpu_torch.ops import flash_attention as fa
    from modal_examples_tpu_torch.ops import paged_attention as pa

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {card}")
    # plain versions in full f32 (no TF32), stated for the comparisons
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("plain versions: torch.backends.cuda.matmul.allow_tf32=False, cudnn.allow_tf32=False")

    t0 = time.monotonic()
    ptxas = _build.build(verbose=True)
    log(f"phase 1 build: {time.monotonic() - t0:.1f}s for {_build.kernel_names()}")
    for name in SASS_CHECKED:  # registers and spills a thread, one pair of lines per kernel instance
        log(f"{name} ptxas: " + " | ".join(
            line.strip() for line in ptxas.get(name, "").splitlines() if "registers" in line or "spill" in line))
    check_sass(_build)
    errs = phase_kernels_vs_plain(fa, pa)
    phase_backward_vs_plain(fa, errs)
    phase_int8_kernels_vs_plain(pa, errs)
    log(f"phase 2 kernels vs plain (tolerances {TOL}): {errs}")
    eng, metrics = phase_engine(fa, pa, llama, layers, reference, LLMEngine, SamplingParams)
    phase_server(eng, OpenAIServer)
    log("phase 4 server: ok")
    params, bf16_cache_bytes = eng.params, eng.cache.bytes()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    wb = phase_writeback_engine(fa, pa, llama, layers, reference, LLMEngine, SamplingParams, params)
    log("phase 3b write-then-attend serving: ok")
    gc.collect()
    torch.cuda.empty_cache()
    int8, qparams = phase_int8_engine(fa, pa, llama, layers, reference, LLMEngine, SamplingParams, params,
                                      bf16_cache_bytes)
    log("phase 4 int8 serving: ok")
    gc.collect()
    torch.cuda.empty_cache()
    wb8 = phase_int8_writeback_engine(fa, pa, llama, layers, reference, LLMEngine, SamplingParams, qparams)
    log("phase 3b write-then-attend serving over int8 pages: ok")
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_training(fa, llama, lora, training, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    serve_counts, int8_counts, train_counts = metrics["launches"], int8["launches"], train["launches"]
    wb_counts = wb["launches"]
    counts = {
        **serve_counts, **train_counts,
        **{k: int8_counts[k] for k in ("quantized_matmul", "paged_decode_int8", "kv_scatter_int8")},
        "paged_decode_writeback": wb_counts["paged_decode_writeback"],
        "paged_decode_writeback_int8": wb8["launches"]["paged_decode_writeback_int8"],
        "flash_fwd": serve_counts["flash_fwd"] + int8_counts["flash_fwd"] + train_counts["flash_fwd"],
    }
    log(f"launches: serving {serve_counts}, write-then-attend serving at N=8 {wb_counts}, int8 serving "
        f"{int8_counts}, int8 write-then-attend serving at N=8 {wb8['launches']}, training {train_counts}; "
        f"kernels line (flash_fwd summed) {counts}")
    rows = phase_numbers(fa, pa, counts, errs)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
