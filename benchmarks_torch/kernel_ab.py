"""One flash kernel of the port built from two source trees, timed in turns
in one process on one card.

``OTHER`` is another ``csrc`` directory: for example the parent commit's,
unpacked with ``git archive`` into a git-ignored directory. Both libraries
build from their sources (``ops/_build.py``; the other one into
``build/kernels_ab/``), both are held against the plain version on the timed
inputs, then each is timed in the order this, other, other, this (``--rounds``
times) two ways: CUDA events around 50 back-to-back launches (the kernel's
time), and the median of 20 single launches each between its own events
(``chip_smoke.py`` phase 5's method, which adds the wrapper's host time
whenever it exceeds the kernel's). Prints one JSON line per shape. Run from
the repository root on one GPU:

    python3 benchmarks_torch/kernel_ab.py OTHER [--kernel flash_fwd|flash_bwd_dkv] [--rounds R]
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

# (B, H, S): phase 5's prefill batch for the forward, the training step's for both
SHAPES = {"flash_fwd": [(4, 32, 512), (2, 32, 512)], "flash_bwd_dkv": [(2, 32, 512)]}
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


def back_to_back_ms(fn, n: int = 50) -> float:
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


def case(kernel: str, gen, B: int, H: int, S: int):
    """(launch, error against the plain version) over one set of inputs."""
    if kernel == "flash_fwd":
        q, k, v = cs.flash_case(gen, B, H, H, S, S, D)

        def launch():
            return fa.flash_forward_cuda(q, k, v, causal=True, sm_scale=D**-0.5)

        want = fa.flash_forward_plain(q, k, v, causal=True, sm_scale=D**-0.5)
        return launch, lambda got: max(cs.max_err(got[0], want[0]), cs.max_err(got[1], want[1]))
    args, _ = cs.bwd_case(fa, gen, B, H, H, S, True, False, D)

    def launch():
        return fa.flash_bwd_dkv_cuda(*args, causal=True, sm_scale=D**-0.5)

    want = fa.flash_bwd_dkv_plain(*args, causal=True, sm_scale=D**-0.5)
    return launch, lambda got: max(cs.rel_err(g, w) for g, w in zip(got, want))


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
    libs = {"this": _build.load(args.kernel), "other": build_other(args.kernel, args.other.resolve())}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, H, S in SHAPES[args.kernel]:
        launch, err = case(args.kernel, gen, B, H, S)
        out = {"card": card, "kernel": args.kernel, "shape": f"B={B} H={H} S={S} D={D} causal", "other": str(args.other)}
        for side, lib in libs.items():
            _build._libs[args.kernel] = lib
            out[f"{side}_err"] = err(launch())
        times = {f"{side}_{how}": [] for side in libs for how in ("ms", "single_ms")}
        for _ in range(args.rounds):
            for side in ("this", "other", "other", "this"):
                _build._libs[args.kernel] = libs[side]
                times[f"{side}_ms"].append(back_to_back_ms(launch))
                times[f"{side}_single_ms"].append(cs.time_ms(launch))
        _build._libs[args.kernel] = libs["this"]
        out.update(times)
        out.update({f"{k}_median": statistics.median(v) for k, v in times.items()})
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
