"""Phase 20 of ``chip_smoke.py`` alone: C11's f32 flash instances and A11's
models on one card.

Builds the kernels, serves phase 3's burst (Llama-2-7B, random bf16 weights
from seed 0) for 20b's reference rows, then ``phase_a11``: 20a the f32
instances against their plain versions (planted faults refused), 20b the
LLaVA-shape VLM behind the OpenAI server, 20c GPT and an f32 Llama's LoRA
through the f32 instances, 20d the detector, OCR, SAM and the video DiT
against their CPU runs, 20e GRPO at llama3.2-1b width; then the f32
instances' rows of the kernels line. Prints each part's log line and the
card. Run from the repository root on one GPU:

    python3 benchmarks_torch/a11_phase.py
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
        print("a11_phase: no CUDA device available; this script runs on the GPU only", file=sys.stderr)
        return 2
    os.environ.setdefault("MTPU_STATE_DIR", str(cs.ROOT / "build" / "state"))
    from modal_examples_tpu_torch import LLMEngine, OpenAIServer, SamplingParams, training
    from modal_examples_tpu_torch.models import layers, llama, lora
    from modal_examples_tpu_torch.ops import _build, reference
    from modal_examples_tpu_torch.ops import flash_attention as fa
    from modal_examples_tpu_torch.ops import paged_attention as pa

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    ptxas = _build.build(verbose=True)
    cs.log(f"build {time.monotonic() - t0:.1f}s; card: {card}")
    for name in ("flash_fwd_f32", "flash_bwd_dq_f32", "flash_bwd_dkv_f32"):
        cs.log(f"{name} ptxas: " + " | ".join(cs.ptxas_summary(ptxas.get(name, ""))))
    cfg = llama.LlamaConfig.llama2_7b()
    params = llama.init_params(cfg, seed=0, device="cuda")
    eng = LLMEngine(cfg, params, **cs.SERVE_KW)
    eng.generate("warm up", SamplingParams(max_tokens=2, temperature=0.0))
    reqs, _ = cs.serve_burst(eng, SamplingParams, "phase 3's burst (the reference rows)")
    eng.stop()
    metrics = {"tokens": [(r.generated_tokens, r.finish_reason) for r in reqs]}
    decode = eng.tokenizer.decode
    del eng
    errs: dict = {}
    out = cs.phase_a11(fa, pa, llama, layers, reference, lora, training, LLMEngine, OpenAIServer, SamplingParams,
                       params, metrics, decode, errs, card)
    cs.log(f"phase 20 ok in {out['seconds']:.1f}s")
    rows = cs.f32_rows(fa, out["launches"], errs)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
