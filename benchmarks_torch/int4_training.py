"""Phase 17 of ``chip_smoke.py`` alone: int4 weights on the int4 matmul
kernel (K7-int4) and the training paths of the diffusion models and Whisper.

Builds the kernels (phase 1: K7-int4's ptxas register and spill report for
each path's instance and the SASS counts of every checked library), runs
phase 2's flash backward checks (K5/K6 at DreamBooth's joint shape among
them), then ``phase_int4_and_training``: K7-int4 against its plain version
on the path each shape takes, with three planted faults, and its timings
(17a), Llama-2-7B served in int4 through the engine and the server (17b),
QLoRA over the int4 base (17c), DreamBooth-LoRA on the SD3-shape MMDiT (17d),
and ControlNet and Whisper training held to the CPU (17e). Prints each
part's log line, K7-int4's kernels-line row and the card. Run from the
repository root on one GPU:

    python3 benchmarks_torch/int4_training.py
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
        print("int4_training: no CUDA device available; this script runs on the GPU only", file=sys.stderr)
        return 2
    os.environ.setdefault("MTPU_STATE_DIR", str(cs.ROOT / "build" / "state"))
    from modal_examples_tpu_torch.ops import _build
    from modal_examples_tpu_torch.ops import flash_attention as fa
    from modal_examples_tpu_torch.ops import paged_attention as pa
    from modal_examples_tpu_torch.ops import quantized_matmul as qmm

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    ptxas = _build.build(verbose=True)
    cs.log(f"build {time.monotonic() - t0:.1f}s; card: {card}")
    cs.log("quantized_matmul_int4 ptxas: " + " | ".join(cs.ptxas_summary(ptxas.get("quantized_matmul_int4", ""))))
    cs.check_sass(_build)
    errs: dict = {}
    cs.phase_backward_vs_plain(fa, errs)
    out = cs.phase_int4_and_training(fa, pa, qmm, errs, cs.INT8_LORA_PEAK_GB, card)
    cs.log(f"phase 17 ok in {out['seconds']:.1f}s")
    print(json.dumps({"kernels": [out["row"]], "joint_bwd": out["dreambooth"]["joint_bwd"]}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
