"""Where a served step's time goes on the card, for the port's engine.

Builds the same engine as ``chip_smoke.py`` (Llama-2-7B shapes, random bf16
weights from a seed, 8 slots, buckets 128/256/512), drives the scheduler tick
by hand in this thread, and profiles with ``torch.profiler``: the tick that
admits and prefills 8 prompts (one chunked) and then a tick that runs one
decode block over 8 live slots. For each it prints the host wall time, the
device busy time (sum of kernel times on the one stream), the device idle
share, and the kernels by total device time. Run from the repository root
on one GPU:

    python3 benchmarks_torch/profile_engine.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import make_requests  # noqa: E402
from modal_examples_tpu_torch import LLMEngine, SamplingParams  # noqa: E402
from modal_examples_tpu_torch.models import llama  # noqa: E402

KERNEL_NAMES = {"flash_fwd_kernel": "flash_fwd", "paged_decode_kernel": "paged_decode", "kv_scatter_kernel": "kv_scatter"}


def _dev_us(evt) -> float:
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0)


def profiled_tick(eng: LLMEngine, name: str) -> dict:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [
        e for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA and _dev_us(e) > 0
    ]
    busy_ms = sum(_dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -_dev_us(e))[:12]
    ours = {v: 0.0 for v in KERNEL_NAMES.values()}
    for e in kernels:
        for frag, short in KERNEL_NAMES.items():
            if frag in e.key:
                ours[short] += _dev_us(e) / 1e3
    return {
        "tick": name,
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if kernels else "not measured",
        "device_idle_share": 1 - busy_ms / wall_ms if kernels else "not measured",
        "port_kernels_ms": ours,
        "top_kernels": [
            {"name": e.key[:80], "count": e.count, "device_ms": _dev_us(e) / 1e3} for e in top
        ],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_engine: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    cfg = llama.LlamaConfig.llama2_7b()
    eng = LLMEngine(cfg, llama.init_params(cfg, seed=0, device="cuda"), max_slots=8, max_model_len=1024,
                    prefill_buckets=(128, 256, 512), prefill_batch=4, decode_block=8, seed=0, device="cuda")
    # warm up outside the profile: one request through prefill and decode
    eng.submit("warm up", SamplingParams(max_tokens=10, temperature=0.0))
    while len(eng.waiting) or any(not s.free for s in eng.slots):
        eng.step()
    reqs = [eng.submit(p, sp) for p, sp in make_requests(SamplingParams)]
    results = [profiled_tick(eng, "admit_prefill_decode")]
    results.append(profiled_tick(eng, "decode_block"))
    live = sum(not s.free for s in eng.slots)
    for r in results:
        print(json.dumps(r), flush=True)
    print(json.dumps({"card": card, "live_slots_after": live, "requests": len(reqs), "decode_block": eng.decode_block}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
