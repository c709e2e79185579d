"""Phase 14 of ``chip_smoke.py`` alone: the platform layer's rest on the card.

Builds the kernels (phase 1), launches the flash backward kernels twice at
phase 2's shapes to learn whether they are bitwise from launch to launch
(14b's loss tolerance follows from it), then runs ``phase_platform_rest``:
a snapshot-enabled class's miss, hit and fallback boots (14a), the
resumable LoRA fine-tune across a retry (14b), whisper-base over the
gateway's websocket (14c), a sandbox and an OCI export (14d). Prints each
part's log line and the phase's JSON. Run from the repository root on one
GPU (about two minutes):

    python3 benchmarks_torch/platform_rest.py
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    os.environ.setdefault("MTPU_STATE_DIR", str(cs.ROOT / "build" / "state"))
    from modal_examples_tpu_torch import SamplingParams
    from modal_examples_tpu_torch.models import llama
    from modal_examples_tpu_torch.ops import _build
    from modal_examples_tpu_torch.ops import flash_attention as fa

    t0 = time.monotonic()
    _build.build()
    cs.log(f"build {time.monotonic() - t0:.1f}s")
    bitwise = cs.phase_backward_vs_plain(fa, {})
    rest = cs.phase_platform_rest(SamplingParams, llama.LlamaConfig.llama2_7b().n_layers, bitwise)
    cs.log(f"phase 14 ok in {rest['seconds']:.1f}s: {json.dumps(rest)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
