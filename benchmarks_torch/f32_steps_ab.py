"""Phase 20c's two f32 training steps, timed for this tree and another tree
of the port in turns, one process a turn, on one card.

``OTHER`` is another checkout's root (for example the parent commit,
unpacked with ``git archive`` into a git-ignored directory); each turn runs
this script again with ``--run ROOT``, which imports that root's
``modal_examples_tpu_torch``, builds its kernels under its own ``build/``
and times, after 3 warm-up steps, ``--steps`` ``Trainer.train_step`` calls
of each model (a host clock around each step, which ends in
``torch.cuda.synchronize()``), and the device time of 5 steps under
``torch.profiler``, all kernels and of those the f32 flash instances':

- GPT at its default config (f32, 6 layers, dim 384, block 256, B=8), the
  full model trained (``chip_smoke.phase20_gpt``'s step);
- the f32 Llama of ``chip_smoke.F32_LORA_CFG`` (head dim 64, 8 layers) with
  rank-16 LoRA on the seven projections, B=2 x S=512
  (``chip_smoke.phase20_llama_f32``'s step).

The turns go this, other, other, this (``--rounds`` times); prints one JSON
line per turn and one with the medians. Run from the repository root on one
GPU:

    python3 benchmarks_torch/f32_steps_ab.py OTHER [--rounds R] [--steps N]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
F32_KERNELS = ("flash_fwd_f32", "flash_bwd_dq_f32", "flash_bwd_dkv_f32")


def profiled_ms(step, n: int = 5) -> dict:
    """Device ms a step under torch.profiler over ``n`` steps: every
    kernel's, and the f32 flash instances' (``flash_*_f32_kernel``)."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0]
    total = sum(e.self_device_time_total for e in events)
    flash = sum(e.self_device_time_total for e in events if "f32_kernel" in e.key and "flash" in e.key)
    return {"device_ms": total / 1e3 / n, "f32_flash_device_ms": flash / 1e3 / n}


def run(root: Path, steps: int) -> dict:
    """The two models' steps with ``root``'s port."""
    sys.path.insert(0, str(root))
    import torch
    import torch.nn.functional as F

    from modal_examples_tpu_torch import training
    from modal_examples_tpu_torch.models import gpt, llama, lora
    from modal_examples_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build(list(F32_KERNELS))
    out = {"root": str(root)}

    def timed(trainer, state, batch) -> dict:
        box = [state]

        def step():
            box[0], _ = trainer.train_step(box[0], batch)

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        walls = []
        for _ in range(steps):
            t0 = time.monotonic()
            step()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.monotonic() - t0))
        return {"step_ms": walls, "step_ms_median": statistics.median(walls), **profiled_ms(step)}

    cfg = gpt.GPTConfig()
    params = gpt.init_params(cfg, seed=20, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(21)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, cfg.block_size + 1), generator=gen, device="cuda")}

    def gpt_loss(p, b):
        logits = gpt.forward(p, b["tokens"][:, :-1], cfg, attn_impl="flash")
        return F.cross_entropy(logits.reshape(-1, cfg.vocab_size), b["tokens"][:, 1:].reshape(-1))

    trainer = training.Trainer(gpt_loss, training.make_optimizer(3e-4))
    out["gpt"] = timed(trainer, trainer.init_state(params), batch)
    del trainer, params

    import chip_smoke as cs  # F32_LORA_CFG, the same config in both trees

    lcfg_model = llama.LlamaConfig(**cs.F32_LORA_CFG)
    base = llama.init_params(lcfg_model, seed=22, device="cuda")
    lcfg = lora.LoRAConfig(rank=16)
    adapters = lora.init_lora(torch.Generator(device="cuda").manual_seed(23), base, lcfg)
    gen = torch.Generator(device="cuda").manual_seed(24)
    batch = {"tokens": torch.randint(0, lcfg_model.vocab_size, (2, 512), generator=gen, device="cuda"),
             "mask": torch.ones((2, 512), device="cuda")}

    def llama_loss(ad, b):
        logits = llama.forward(base, b["tokens"], lcfg_model, attn_impl="flash", lora=ad, lora_scale=lcfg.scale)
        return training.cross_entropy_loss(logits[:, :-1], b["tokens"][:, 1:], b["mask"][:, 1:])

    trainer = training.Trainer(llama_loss, training.make_optimizer(1e-4))
    out["llama_f32_lora"] = timed(trainer, trainer.init_state(adapters), batch)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, nargs="?", help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--run", type=Path, help="(internal) time the steps with this root's port")
    args = ap.parse_args()
    if args.run is not None:
        sys.path.insert(0, str(ROOT))  # chip_smoke's config, imported after the root's package
        print(json.dumps(run(args.run.resolve(), args.steps)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available() or args.other is None:
        print("f32_steps_ab: needs a CUDA device and OTHER", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    sides = {"this": ROOT, "other": args.other.resolve()}
    got = {side: [] for side in sides}
    for _ in range(args.rounds):
        for side in ("this", "other", "other", "this"):
            proc = subprocess.run([sys.executable, __file__, "--run", str(sides[side]), "--steps", str(args.steps)],
                                  capture_output=True, text=True, cwd=ROOT)
            if proc.returncode:
                print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
                return proc.returncode
            turn = json.loads(proc.stdout.strip().splitlines()[-1])
            got[side].append(turn)
            print(json.dumps({"card": card, "side": side, **turn}), flush=True)
    summary = {"card": card, "other": str(args.other)}
    for side, turns in got.items():
        for model in ("gpt", "llama_f32_lora"):
            for key in ("step_ms_median", "device_ms", "f32_flash_device_ms"):
                summary[f"{side}_{model}_{key}"] = statistics.median(t[model][key] for t in turns)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
