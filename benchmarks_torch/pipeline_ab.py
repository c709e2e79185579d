"""Phase 3's burst through this tree's engine and another tree's, in turns.

Loads this tree's ``modal_examples_tpu_torch`` and the one under ``OTHER``
(e.g. the parent commit unpacked with ``git archive <sha> | tar -x -C
build/parent``) side by side in one process, the other as a package of
another name (its kernels build into its own ``build/kernels``). Both
engines take ``chip_smoke.py`` phase 3's configuration (Llama-2-7B shapes,
8 slots, buckets 128/256/512, decode block 8, ``--decode-steps``) over one
set of random bf16 weights from seed 0. Each serves
``chip_smoke.make_requests``'s 8 requests once to warm up, then
``--pairs`` times in the order other, this, this, other (so neither side
always runs first). Each burst prints its burst tok/s (every generated token
over the burst's wall time, text delivered included), TTFT median and wall;
greedy and seeded rows must be token-identical across the two trees. The
last line gives each side's medians and the card. Run from the repository
root on one GPU:

    python3 benchmarks_torch/pipeline_ab.py OTHER [--pairs 3] [--decode-steps 1]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import make_requests  # noqa: E402
from modal_examples_tpu_torch import LLMEngine, SamplingParams  # noqa: E402
from modal_examples_tpu_torch.models import llama  # noqa: E402


def load_package(tree: Path, alias: str):
    """``tree``'s ``modal_examples_tpu_torch`` imported as ``alias`` (its own
    relative imports resolve inside it)."""
    pkg = tree / "modal_examples_tpu_torch"
    spec = importlib.util.spec_from_file_location(alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def burst(eng, params_cls) -> tuple[list, dict]:
    """The 8 requests, tokenized first and queued back to back, each streamed
    to its end; then wait until no decode block is left in flight."""
    t0 = time.monotonic()
    reqs = [eng.make_request(p, sp) for p, sp in make_requests(params_cls)]
    for r in reqs:
        eng.submit_request(r)
    for r in reqs:
        "".join(eng.stream(r))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    while getattr(eng, "_inflight", None):
        time.sleep(0.01)
    return reqs, {
        "burst_tok_per_s": sum(r.n_generated for r in reqs) / wall,
        "ttft_s_median": statistics.median(r.first_token_at - r.created for r in reqs),
        "wall_s": wall,
    }


def rows(reqs) -> list:
    """The greedy and seeded rows' tokens (rows with an engine-assigned seed draw anew)."""
    return [(r.generated_tokens, r.finish_reason) for r in reqs
            if r.params.temperature == 0 or r.params.seed is not None]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="the other tree (its modal_examples_tpu_torch/ is loaded)")
    ap.add_argument("--pairs", type=int, default=3, help="pairs of bursts, in the order other, this, this, other")
    ap.add_argument("--decode-steps", type=int, default=1, help="both engines' decode_steps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pipeline_ab: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    other = load_package(args.other.resolve(), "other_port")
    cfg = llama.LlamaConfig.llama2_7b()
    params = llama.init_params(cfg, seed=0, device="cuda")
    kw = dict(max_slots=8, max_model_len=1024, prefill_buckets=(128, 256, 512), prefill_batch=4, decode_block=8,
              seed=0, device="cuda", decode_steps=args.decode_steps)
    sides = {
        "this": (LLMEngine(cfg, params, **kw), SamplingParams),
        "other": (other.LLMEngine(other.models.llama.LlamaConfig.llama2_7b(), params, **kw), other.SamplingParams),
    }
    ref = {}
    for name, (eng, params_cls) in sides.items():
        reqs, _ = burst(eng, params_cls)  # warm-up pass
        ref[name] = rows(reqs)
    if ref["this"] != ref["other"]:
        raise AssertionError("the two trees' greedy and seeded rows differ")
    runs = {"this": [], "other": []}
    for _ in range(args.pairs // 2 + args.pairs % 2):
        for name in ("other", "this", "this", "other"):
            if len(runs[name]) >= args.pairs:
                continue
            eng, params_cls = sides[name]
            reqs, m = burst(eng, params_cls)
            if rows(reqs) != ref[name]:
                raise AssertionError(f"{name}: rows differ from its warm-up pass")
            runs[name].append(m)
            print(json.dumps({"tree": name, "decode_steps": args.decode_steps, **m}), flush=True)
    for eng, _ in sides.values():
        eng.stop()
    print(json.dumps({
        "card": card, "other": str(args.other), "decode_steps": args.decode_steps,
        **{name: {"burst_tok_per_s_median": statistics.median(m["burst_tok_per_s"] for m in ms),
                  "ttft_s_median_median": statistics.median(m["ttft_s_median"] for m in ms),
                  "burst_tok_per_s": [m["burst_tok_per_s"] for m in ms],
                  "ttft_s_median": [m["ttft_s_median"] for m in ms],
                  "wall_s": [m["wall_s"] for m in ms]}
           for name, ms in runs.items()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
