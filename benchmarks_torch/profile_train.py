"""Where a LoRA training step's time goes on the card, for the port's trainer.

Builds the training path of ``chip_smoke.py`` (Llama-2-7B, full depth,
frozen random bf16 base from seed 0, or with ``--int4`` the int4 base of
phase 17c (QLoRA, ``init_quantized_llama(bits=4)``, f32 adapters), rank-16
LoRA on all seven projections, B=2 x S=512, ``Trainer(loss_fn,
make_optimizer(1e-4))``; with ``--mixtral`` phase 18's path: Mixtral-8x7B
over an int8 base from seed 0, attention-only LoRA, the capacity experts),
takes two warm-up steps, times two more without the profiler (host clock
around a synchronised step), then profiles one ``Trainer.train_step`` with
``torch.profiler``. Prints the host wall time with and without the profiler
(which adds host time), the device busy time (sum of kernel times on the
one stream), the device idle share against both walls, the time in the
port's kernels (flash forward, dQ, dK/dV; K7-int4's three paths), in
matrix products and in the remaining kernels, and the kernels by total
device time. Run from the repository root on one GPU:

    python3 benchmarks_torch/profile_train.py [--int4 | --mixtral]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmarks_torch.profile_engine import _dev_us  # noqa: E402
from chip_smoke import lora_training_setup, moe_lora_setup  # noqa: E402
from modal_examples_tpu_torch import training  # noqa: E402
from modal_examples_tpu_torch.models import llama, lora, quantize  # noqa: E402

KERNEL_NAMES = {"flash_fwd_kernel": "flash_fwd", "flash_bwd_dq_kernel": "flash_bwd_dq",
                "flash_bwd_dkv_kernel": "flash_bwd_dkv", "qmm4_wgmma_kernel": "quantized_matmul_int4 wgmma",
                "qmm4_ring_kernel": "quantized_matmul_int4 ring", "qmm_int4_kernel": "quantized_matmul_int4 masked"}
# cuBLAS / cuBLASLt / CUTLASS matrix-product kernels (the frozen base's and the
# adapters' products); cuBLASLt names its Hopper kernels nvjet_*
GEMM_FRAGMENTS = ("gemm", "xmma", "cutlass", "gemv", "splitK", "nvjet")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--int4", action="store_true", help="QLoRA over an int4 base (phase 17c) instead of bf16")
    ap.add_argument("--mixtral", action="store_true", help="Mixtral-8x7B LoRA over an int8 base (phase 18)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_train: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.mixtral:
        params = quantize.init_quantized_llama(llama.LlamaConfig.mixtral_8x7b(), seed=0, bits=8, device="cuda")
        _, _, adapters, batches, loss_over = moe_lora_setup(llama, lora, training, params, 5, [])
        loss_fn = loss_over(params)
    else:
        cfg = llama.LlamaConfig.llama2_7b()
        if args.int4:
            params = quantize.init_quantized_llama(cfg, seed=0, bits=4, device="cuda")
        else:
            params = llama.init_params(cfg, seed=0, device="cuda")
        _, _, adapters, batches, loss_fn = lora_training_setup(llama, lora, training, params, steps=5)
    trainer = training.Trainer(loss_fn, training.make_optimizer(1e-4))
    state = trainer.init_state(adapters)
    for batch in batches[:2]:  # warm-up
        state, _ = trainer.train_step(state, batch)
    unprofiled_ms = []
    for batch in batches[2:4]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        unprofiled_ms.append(1e3 * (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, batches[4])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [
        e for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA and _dev_us(e) > 0
    ]
    if not kernels:
        print(json.dumps({"card": card, "wall_ms": wall_ms, "device_busy_ms": "not measured"}))
        return 1
    busy_ms = sum(_dev_us(e) for e in kernels) / 1e3
    ours = {v: {"ms": 0.0, "count": 0} for v in KERNEL_NAMES.values()}
    gemm_ms, gemm_count = 0.0, 0
    for e in kernels:
        short = next((s for frag, s in KERNEL_NAMES.items() if frag in e.key), None)
        if short is not None:
            ours[short]["ms"] += _dev_us(e) / 1e3
            ours[short]["count"] += e.count
        elif any(f in e.key for f in GEMM_FRAGMENTS):
            gemm_ms += _dev_us(e) / 1e3
            gemm_count += e.count
    port_ms = sum(v["ms"] for v in ours.values())
    top = sorted(kernels, key=lambda e: -_dev_us(e))[:15]
    print(json.dumps({
        "card": card,
        "base": "mixtral int8" if args.mixtral else "int4" if args.int4 else "bf16",
        "step": state.step,
        "loss": metrics["loss"].item(),
        "wall_ms": wall_ms,
        "unprofiled_wall_ms": unprofiled_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / wall_ms,
        "device_idle_share_vs_unprofiled": 1 - busy_ms / min(unprofiled_ms),
        "port_kernels": ours,
        "gemm_ms": gemm_ms,
        "gemm_launches": gemm_count,
        "other_ms": busy_ms - port_ms - gemm_ms,
        "other_launches": sum(e.count for e in kernels) - gemm_count - sum(v["count"] for v in ours.values()),
        "top_kernels": [{"name": e.key[:90], "count": e.count, "device_ms": _dev_us(e) / 1e3} for e in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
