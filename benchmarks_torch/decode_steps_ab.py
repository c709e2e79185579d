"""Macro-step decode against the decode block, on one engine, in turns.

Builds the engine of ``chip_smoke.py`` phase 3 (Llama-2-7B shapes, random
bf16 weights from seed 0, 8 slots, buckets 128/256/512) with the decode
structure ``--paged-impl``, warms it with one pass of the burst, then serves
``chip_smoke.make_requests``'s 8 requests ``--rounds`` times in the order
N=1, N, N, N=1 (``eng.decode_steps`` flipped between bursts), so neither
side always runs first. Each burst prints its burst tok/s (every generated
token over the burst's wall time, text delivered included: the same work on
both sides), its decode tok/s (the engine's decode-tick clock, which at N > 1
leaves out the detokenization that moves to the worker thread, so it is not
compared across N), TTFT median and decode steps; the last line gives the
medians of each side and the card. Greedy and seeded rows are
checked token-identical to the warm-up pass. Run from the repository root on
one GPU:

    python3 benchmarks_torch/decode_steps_ab.py [--paged-impl IMPL] [--decode-steps N] [--rounds R]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import check_same_tokens, serve_burst  # noqa: E402
from modal_examples_tpu_torch import LLMEngine, SamplingParams  # noqa: E402
from modal_examples_tpu_torch.models import llama  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paged-impl", default="xla", choices=llama.PAGED_IMPLS, help="the decode structure")
    ap.add_argument("--decode-steps", type=int, default=8, help="the macro-step side's N")
    ap.add_argument("--rounds", type=int, default=3, help="rounds of N=1, N, N, N=1")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_steps_ab: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    eng = LLMEngine(llama.LlamaConfig.llama2_7b(), max_slots=8, max_model_len=1024, prefill_buckets=(128, 256, 512),
                    prefill_batch=4, decode_block=8, seed=0, device="cuda", paged_impl=args.paged_impl)
    ref, _ = serve_burst(eng, SamplingParams, "warm-up pass, N=1")
    runs = {1: [], args.decode_steps: []}
    for _ in range(args.rounds):
        for n in (1, args.decode_steps, args.decode_steps, 1):
            eng.decode_steps = n
            reqs, m = serve_burst(eng, SamplingParams, f"N={n}")
            check_same_tokens(reqs, ref, f"N={n} against the warm-up pass")
            runs[n].append(m)
            print(json.dumps({"paged_impl": args.paged_impl, "N": n, **m}), flush=True)
    eng.stop()
    print(json.dumps({
        "card": card, "paged_impl": args.paged_impl,
        **{f"N={n}": {"burst_tok_per_s_median": statistics.median(m["burst_tok_per_s"] for m in ms),
                      "ttft_s_median_median": statistics.median(m["ttft_s_median"] for m in ms),
                      "burst_tok_per_s": [m["burst_tok_per_s"] for m in ms],
                      "decode_tok_per_s": [m["decode_tok_per_s"] for m in ms]}
           for n, ms in runs.items()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
