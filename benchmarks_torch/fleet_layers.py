"""Phase 15 of ``chip_smoke.py`` alone: the failure and fleet layers on the card.

Builds the kernels (phase 1), draws phase 3's Llama-2-7B bf16 weights from
its seed, serves phase 3's burst once through a unified engine (the rows
phase 15 compares as "phase 3's batched burst"), then runs
``phase_fleet_layers``: the MTKV1 codec on the card (15a), disaggregated
serving (15b), live migration (15c), the router front (15f), reactive
failover (15d) and the watchdog (15e), then 15a and 15b over int8 pages.
Prints each part's log line and the phase's JSON. Run from the repository
root on one GPU:

    python3 benchmarks_torch/fleet_layers.py
"""

from __future__ import annotations

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

    if not torch.cuda.is_available():
        print("fleet_layers: no CUDA device available; this script runs on the GPU only", file=sys.stderr)
        return 2
    os.environ.setdefault("MTPU_STATE_DIR", str(cs.ROOT / "build" / "state"))
    from modal_examples_tpu_torch import LLMEngine, OpenAIServer, SamplingParams
    from modal_examples_tpu_torch.models import llama
    from modal_examples_tpu_torch.ops import _build
    from modal_examples_tpu_torch.ops import flash_attention as fa
    from modal_examples_tpu_torch.ops import paged_attention as pa
    from modal_examples_tpu_torch.ops import quantized_matmul as qmm

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.monotonic()
    _build.build()
    cs.log(f"build {time.monotonic() - t0:.1f}s; card: {card}")
    cfg = llama.LlamaConfig.llama2_7b()
    params = llama.init_params(cfg, seed=0, device="cuda")
    eng = LLMEngine(cfg, params, **cs.SERVE_KW)
    eng.generate("warm up", SamplingParams(max_tokens=2, temperature=0.0))
    reqs, _ = cs.serve_burst(eng, SamplingParams, "phase 3's burst")
    eng.stop()
    del eng
    cs.free_fleet()
    out = cs.phase_fleet_layers(fa, pa, qmm, llama, LLMEngine, OpenAIServer, SamplingParams, params,
                                [(r.generated_tokens, r.finish_reason) for r in reqs], card)
    cs.log(f"phase 15 ok in {out['seconds']:.1f}s: {json.dumps(out)}")
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
