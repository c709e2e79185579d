"""The host wall of the port's scheduler ticks, alone and under a competing
thread, for the serving engine at Llama-2-7B shapes.

Builds the kernels, draws phase 3's Llama-2-7B bf16 weights from its seed
and two engines over them with ``chip_smoke.py``'s serving settings (8
slots, decode blocks of 8 steps). Each round serves ``chip_smoke``'s 8
requests on the first engine, its ticks driven by hand on this thread, and
prints the wall time, the tick count and the ticks' p50, p90 and largest
host walls. "alone" runs nothing else; "contended" has a second thread
prefilling the same prompts on the other engine throughout, as a fleet's
caller thread prefills and ships requests beside a decode replica's
scheduler in one process: the two threads share the interpreter (and the
engines' turns at it), so the tick wall, a wait for the other engine's turn
included, is what a progress watchdog reads against its thresholds.
``--profile`` adds ``cProfile``'s top functions (by own time) of the
ticks of one more round of each kind. To compare two trees, run it from a
checkout of each in one call. Run from the repository root on one GPU:

    python3 benchmarks_torch/decode_host.py [--rounds N] [--profile]
"""

from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def serve(eng, other, requests, SamplingParams, contend: bool, prof=None) -> dict:
    """One round: the requests through ``eng``'s ticks on this thread; with
    ``contend``, a second thread prefills the prompts on ``other`` until
    the round ends. Returns the round's walls."""
    reqs = [eng.submit(p, sp) for p, sp in requests]
    stop = threading.Event()
    prefills = [0]

    def compete():
        while not stop.is_set():
            for p, _ in requests:
                r = other.submit(p, SamplingParams(max_tokens=1, temperature=0.0))
                while not r.n_generated and not stop.is_set():
                    other.step()
                prefills[0] += 1
                if stop.is_set():
                    break

    th = threading.Thread(target=compete) if contend else None
    if th is not None:
        th.start()
    ticks, idle = [], 0
    t0 = time.monotonic()
    while idle < 3:  # every request admitted, then three ticks with nothing to do
        a = time.monotonic()
        if prof is not None:
            prof.enable()
        worked = eng.step()
        if prof is not None:
            prof.disable()
        idle = 0 if worked or not all(r.n_generated for r in reqs) else idle + 1
        if worked:
            ticks.append(time.monotonic() - a)
    wall = time.monotonic() - t0
    stop.set()
    if th is not None:
        th.join()
        for _ in range(20):  # the competitor's last prefill read and its slot freed
            other.step()
    ticks.sort()
    return {"wall_s": wall, "ticks": len(ticks), "tick_p50_s": ticks[len(ticks) // 2],
            "tick_p90_s": ticks[int(len(ticks) * 0.9)], "tick_max_s": ticks[-1],
            "tokens": sum(r.n_generated for r in reqs), "other_prefills": prefills[0]}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2, help="rounds of each kind")
    ap.add_argument("--profile", action="store_true", help="one more profiled round of each kind")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_host: no CUDA device available; this script runs on the GPU only", file=sys.stderr)
        return 2
    from modal_examples_tpu_torch import LLMEngine, SamplingParams
    from modal_examples_tpu_torch.models import llama
    from modal_examples_tpu_torch.ops import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; switch interval {sys.getswitchinterval()} s", flush=True)
    _build.build()
    cfg = llama.LlamaConfig.llama2_7b()
    params = llama.init_params(cfg, seed=0, device="cuda")
    eng, other = LLMEngine(cfg, params, **cs.SERVE_KW), LLMEngine(cfg, params, **cs.SERVE_KW)
    for e in (eng, other):
        e.generate("warm up", SamplingParams(max_tokens=2, temperature=0.0))
        e.stop()  # the warm-up started its loop: this thread steps it from here
    requests = cs.make_requests(SamplingParams)
    for _ in range(args.rounds):
        for kind in ("alone", "contended"):
            out = serve(eng, other, requests, SamplingParams, kind == "contended")
            print(f"{kind}: " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                                          for k, v in out.items()), flush=True)
    if args.profile:
        for kind in ("alone", "contended"):
            prof = cProfile.Profile()
            serve(eng, other, requests, SamplingParams, kind == "contended", prof)
            s = io.StringIO()
            pstats.Stats(prof, stream=s).sort_stats("tottime").print_stats(30)
            print(f"{kind}, profiled:\n{s.getvalue()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
