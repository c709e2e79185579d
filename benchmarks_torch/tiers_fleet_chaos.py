"""Phase 16 of ``chip_smoke.py`` alone: the prefix tiers, the fleet
autoscaler and the chaos runner on the card.

Builds the kernels (phase 1), draws phase 3's Llama-2-7B bf16 weights from
its seed, then runs ``phase_tiers_fleet_chaos``: the HBM, host and Volume
tiers over the 320-token shared prompt (16a, bf16 and int8 pages), a second
replica and the two tier faults over the shared store (16b), the fleet
autoscaler over depth-4 replicas with snapshot warm boots and a drain by
migration (16c), and ``run_chaos`` (16d). Prints each part's log line and
the phase's JSON. Run from the repository root on one GPU:

    python3 benchmarks_torch/tiers_fleet_chaos.py
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
        print("tiers_fleet_chaos: no CUDA device available; this script runs on the GPU only", file=sys.stderr)
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
    params = llama.init_params(llama.LlamaConfig.llama2_7b(), seed=0, device="cuda")
    out = cs.phase_tiers_fleet_chaos(fa, pa, qmm, llama, LLMEngine, OpenAIServer, SamplingParams, params, card)
    cs.log(f"phase 16 ok in {out['seconds']:.1f}s: {json.dumps(out)}")
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
