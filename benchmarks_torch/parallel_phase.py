"""Phase 19 of ``chip_smoke.py`` alone: tensor and data parallelism over
``torch.distributed`` on one card.

Builds the kernels, serves phase 3's burst on one card (Llama-2-7B, random
weights from seed 0) for 19a's reference rows, then ``phase_parallel``: 19a
one rank over NCCL behind the OpenAI server, 19b two ranks sharing the card
over gloo (logits, per-shard kernels, four bursts, the dense path), 19c
data-parallel LoRA, 19d ring and Ulysses attention, 19f tensor-parallel
and FSDP training through ``Trainer(param_specs=)``, 19e
``@clustered(size=1)``. ``--only 19f`` builds the kernels and runs 19f
alone (its one-rank references, then its two ranks). Prints each part's
log line and the card. No figure here is a multi-card speed: the two ranks
share one card. Run from the repository root on one GPU:

    python3 benchmarks_torch/parallel_phase.py [--only 19f]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", choices=("19f",), help="run this part of phase 19 alone")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("parallel_phase: no CUDA device available; this script runs on the GPU only", file=sys.stderr)
        return 2
    os.environ.setdefault("MTPU_STATE_DIR", str(cs.ROOT / "build" / "state"))
    from modal_examples_tpu_torch import LLMEngine, SamplingParams
    from modal_examples_tpu_torch.models import llama
    from modal_examples_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.monotonic()
    _build.build()
    cs.log(f"build {time.monotonic() - t0:.1f}s; card: {card}")
    if args.only == "19f":
        out = cs.phase19f(llama, card)
        print(json.dumps({"launches": out["launches"], "seconds": out["seconds"]}), flush=True)
        print(card, flush=True)
        return 0
    eng = LLMEngine(llama.LlamaConfig.llama2_7b(), device="cuda", **cs.tp_engine_kw())
    eng.generate("warm up", SamplingParams(max_tokens=2, temperature=0.0))
    reqs, _ = cs.serve_burst(eng, SamplingParams, "phase 3's burst (the reference rows)")
    eng.stop()
    metrics = {"tokens": [(r.generated_tokens, r.finish_reason) for r in reqs]}
    del eng
    out = cs.phase_parallel(llama, metrics, card)
    cs.log(f"phase 19 ok in {out['seconds']:.1f}s: {json.dumps(out)}")
    print(json.dumps({"launches": out["launches"], "seconds": out["seconds"]}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
