"""Chip smoke test of the PyTorch/CUDA port: builds its kernels, holds each
against its plain version on the card, serves Llama-2-7B-shaped requests
(random bf16 weights from a seed, full width) through the port's engine and
OpenAI server, LoRA-fine-tunes the same model through ``Trainer``, and
prints per-kernel times beside their bounds.

Run from the repository root on a machine with one NVIDIA GPU and nvcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
1. build the CUDA kernels from ``modal_examples_tpu_torch/csrc``;
2. each kernel against its plain version at the main paths' shapes
   (Hq=Hkv=32, D=128, page_size 16) and a GQA shape (Hkv=8); the flash
   backward kernels also non-causal, at a ragged S=300 and with a nonzero
   lse cotangent;
3. the engine serving 8 requests (prompts of 20..700 tokens, one chunked),
   with the launch counters zeroed just before and read just after: every
   serving kernel must have launched, the decode kernel n_layers x decode
   steps times; then prefill + one decode step against a dense plain forward
   on the card;
4. the OpenAI server: one completion, one streamed chat completion;
   then training: Llama-2-7B (full depth, frozen random bf16 base) with
   rank-16 LoRA on all seven projections, B=2 x S=512, through
   ``Trainer.train_step``: the first step's adapter gradients against the
   same step with ``attn_impl="xla"``; then, counters zeroed, 1 warm-up and
   4 timed steps in which the flash forward, dQ and dK/dV kernels must each
   launch exactly n_layers x 5 times;
5. per-kernel numbers (CUDA events, median of repeats) on earlier lines,
   then the card's name and power limit, then the result line.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
import urllib.request

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
# bf16 tolerances against the plain versions (f32 math inside both):
# flash differs by the final bf16 rounding and summation order; decode also
# rounds unnormalised probabilities to bf16 where the plain version rounds
# normalised ones; the scatter is a copy. The flash backward kernels are held
# as max|grad - plain| / max|plain grad| (f32 math in both, one bf16 rounding
# of each gradient, sums in another order).
TOL = {"flash_fwd": 2e-2, "paged_decode": 6e-2, "kv_scatter": 0.0, "flash_bwd_dq": 1e-2, "flash_bwd_dkv": 1e-2}
# training: adapter-gradient cosine between the flash and xla attention paths
GRAD_COSINE_MIN = 0.999


def log(*a) -> None:
    print(*a, flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


# -- phase 2 inputs ---------------------------------------------------------------


def rand_bf16(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32).to(torch.bfloat16)


def flash_case(gen, B, Hq, Hkv, S, Skv, D=128):
    return rand_bf16(gen, B, Hq, S, D), rand_bf16(gen, B, Hkv, Skv, D), rand_bf16(gen, B, Hkv, Skv, D)


def decode_case(gen, B, Hq, Hkv, L, D=128, ps=16, pps=64):
    """Ragged prefix lengths 0..1000 over shuffled pages of the full cache."""
    P = 1 + B * pps
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(1))[: B * pps] + 1
    lens = torch.tensor([0, 1, 15, 16, 17, 333, 777, 1000][:B], dtype=torch.int32)
    return dict(
        q=rand_bf16(gen, B, Hq, D),
        k_pages=rand_bf16(gen, L, P, ps, Hkv, D),
        v_pages=rand_bf16(gen, L, P, ps, Hkv, D),
        page_tables=perm.reshape(B, pps).to(torch.int32).cuda(),
        prefix_lens=lens.cuda(),
        k_new=rand_bf16(gen, B, Hkv, D),
        v_new=rand_bf16(gen, B, Hkv, D),
    )


def scatter_case(gen, L, N, P, Hkv=32, D=128, ps=16):
    """N tokens, distinct targets except two dead ones on trash page 0 slot 0
    (given equal rows, so the race has one possible result)."""
    k_all, v_all = rand_bf16(gen, L, N, Hkv, D), rand_bf16(gen, L, N, Hkv, D)
    flat = torch.randperm((P - 1) * ps, generator=torch.Generator().manual_seed(2))[:N] + ps
    page_idx, slot = (flat // ps).to(torch.int32), (flat % ps).to(torch.int32)
    page_idx[[1, 3]] = 0
    slot[[1, 3]] = 0
    k_all[:, 3], v_all[:, 3] = k_all[:, 1], v_all[:, 1]
    return k_all, v_all, page_idx.cuda(), slot.cuda()


def phase_kernels_vs_plain(fa, pa) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    for B, Hq, Hkv, S, Skv, off in [(4, 32, 32, 512, 512, 0), (1, 32, 32, 512, 1024, 512), (4, 32, 8, 512, 512, 0)]:
        q, k, v = flash_case(gen, B, Hq, Hkv, S, Skv)
        o, lse = fa.flash_forward_cuda(q, k, v, causal=True, sm_scale=128**-0.5, q_offset=off)
        torch.cuda.synchronize()
        o2, lse2 = fa.flash_forward_plain(q, k, v, causal=True, sm_scale=128**-0.5, q_offset=off)
        e, e_lse = max_err(o, o2), max_err(lse, lse2)
        log(f"K1 flash B={B} Hq={Hq} Hkv={Hkv} S={S} Skv={Skv} q_offset={off}: max|o-plain|={e:.3g} max|lse-plain|={e_lse:.3g}")
        if not (e <= TOL["flash_fwd"] and e_lse <= 1e-3):
            raise AssertionError(f"flash kernel disagrees with its plain version: {e}, {e_lse}")
        errs["flash_fwd"] = max(errs.get("flash_fwd", 0.0), e)
    for B, Hq, Hkv in [(8, 32, 32), (8, 32, 8)]:
        c = decode_case(gen, B, Hq, Hkv, L=4)
        args = [c[n] for n in ("q", "k_pages", "v_pages")] + [2] + [c[n] for n in ("page_tables", "prefix_lens", "k_new", "v_new")]
        o = pa.paged_decode_cuda(*args, sm_scale=128**-0.5)
        torch.cuda.synchronize()
        e = max_err(o, pa.paged_decode_plain(*args, sm_scale=128**-0.5))
        log(f"K2 decode B={B} Hq={Hq} Hkv={Hkv} layer=2 prefix 0..1000: max|o-plain|={e:.3g}")
        if not e <= TOL["paged_decode"]:
            raise AssertionError(f"decode kernel disagrees with its plain version: {e}")
        errs["paged_decode"] = max(errs.get("paged_decode", 0.0), e)
    for L, N, P in [(32, 8, 513), (32, 2048, 513)]:  # decode step; prefill batch 4 x 512
        k_all, v_all, page_idx, slot = scatter_case(gen, L, N, P)
        kp, vp = rand_bf16(gen, L, P, 16, 32, 128), rand_bf16(gen, L, P, 16, 32, 128)
        kq, vq = kp.clone(), vp.clone()
        pa.scatter_cuda(kp, vp, k_all, v_all, page_idx, slot)
        torch.cuda.synchronize()
        pa.scatter_plain(kq, vq, k_all, v_all, page_idx.long(), slot.long())
        e = max(max_err(kp, kq), max_err(vp, vq))
        log(f"K3 scatter L={L} N={N} P={P}: max|pages-plain|={e}")
        if e != 0.0:
            raise AssertionError(f"scatter kernel is not bitwise equal to its plain version: {e}")
        errs["kv_scatter"] = e
        del kp, vp, kq, vq
    return errs


def bwd_case(fa, gen, B, Hq, Hkv, S, causal, nonzero_dlse, D=128):
    """Inputs of the two backward kernels: q/k/v/dO bf16, and lse from the
    forward kernel, delta = rowsum(dO*O), dlse f32."""
    q, k, v = flash_case(gen, B, Hq, Hkv, S, S, D)
    do = rand_bf16(gen, B, Hq, S, D)
    o, lse = fa.flash_forward_cuda(q, k, v, causal=causal, sm_scale=D**-0.5)
    dlse = (torch.randn(B, Hq, S, generator=gen, device="cuda") if nonzero_dlse
            else torch.zeros(B, Hq, S, device="cuda"))
    delta = (do.float() * o.float()).sum(dim=-1)
    return (q, k, v, do, lse, delta, dlse), o


def rel_err(a, b) -> float:
    return max_err(a, b) / b.float().abs().max().item()


def phase_backward_vs_plain(fa, errs: dict) -> None:
    """dQ and dK/dV kernels against flash_backward_plain on the same inputs."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = [  # (B, Hq, Hkv, S, causal, nonzero dlse)
        (2, 32, 32, 512, True, False),   # the training path's shape (MHA)
        (2, 32, 8, 512, True, False),    # GQA
        (2, 32, 32, 512, False, False),  # non-causal
        (2, 8, 2, 300, True, False),     # ragged S
        (2, 32, 32, 512, True, True),    # lse cotangent
    ]
    for B, Hq, Hkv, S, causal, nz in cases:
        args, o = bwd_case(fa, gen, B, Hq, Hkv, S, causal, nz)
        dq = fa.flash_bwd_dq_cuda(*args, causal=causal, sm_scale=128**-0.5)
        dk, dv = fa.flash_bwd_dkv_cuda(*args, causal=causal, sm_scale=128**-0.5)
        torch.cuda.synchronize()
        q, k, v, do, lse, _, dlse = args
        want = fa.flash_backward_plain(q, k, v, o, lse, do, dlse, causal=causal, sm_scale=128**-0.5)
        rel = [rel_err(g, w) for g, w in zip((dq, dk, dv), want)]
        log(f"K5/K6 flash bwd B={B} Hq={Hq} Hkv={Hkv} S={S} causal={causal} dlse={'randn' if nz else 0}: "
            f"max|d-plain|/max|plain| dq={rel[0]:.3g} dk={rel[1]:.3g} dv={rel[2]:.3g}")
        if not (rel[0] <= TOL["flash_bwd_dq"] and max(rel[1:]) <= TOL["flash_bwd_dkv"]):
            raise AssertionError(f"flash backward kernels disagree with flash_backward_plain: {rel}")
        errs["flash_bwd_dq"] = max(errs.get("flash_bwd_dq", 0.0), max_err(dq, want[0]))
        errs["flash_bwd_dkv"] = max(errs.get("flash_bwd_dkv", 0.0), max_err(dk, want[1]), max_err(dv, want[2]))


# -- phase 3 ----------------------------------------------------------------------


def make_requests(SamplingParams):
    """8 requests: prompts of 20..700 byte tokens (one past the 512 bucket),
    max_tokens 32..64, greedy and seeded rows mixed."""
    rng = np.random.default_rng(0)
    lens = [20, 64, 130, 200, 300, 450, 511, 700]
    out = []
    for i, n in enumerate(lens):
        prompt = "".join(chr(c) for c in rng.integers(32, 127, n - 1))  # + BOS = n tokens
        params = SamplingParams(
            max_tokens=int(32 + 32 * i / 7),
            temperature=0.0 if i % 2 == 0 else 0.8,
            seed=None if i % 4 == 1 else 1000 + i,
            top_p=0.9 if i == 3 else 1.0,
        )
        out.append((prompt, params))
    return out


def check_finish(req) -> None:
    p = req.params
    if req.finish_reason == "length":
        ok = req.n_generated == p.max_tokens == len(req.generated_tokens)
    elif req.finish_reason == "stop":  # sampled eos: consumed, not kept
        ok = req.n_generated == len(req.generated_tokens) + 1 <= p.max_tokens
    else:
        ok = False
    if not ok:
        raise AssertionError(
            f"{req.request_id}: finish {req.finish_reason} with {req.n_generated} tokens "
            f"({len(req.generated_tokens)} kept) for max_tokens={p.max_tokens}"
        )


def dense_reference_logits(params, cfg, tokens, layers, reference):
    """Last-position logits of a dense causal forward built from the plain
    attention twin (no kernel): the reference for the served path."""
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)[None]
    cos, sin = layers.rotary_embedding(positions, cfg.head_dim, cfg.rope_theta)
    x = params["embed"][tokens]
    D = cfg.head_dim
    for layer in params["layers"]:
        h = layers.rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q = layers.mm(h, layer["wq"]).to(x.dtype).view(1, S, cfg.n_heads, D).transpose(1, 2)
        k = layers.mm(h, layer["wk"]).to(x.dtype).view(1, S, cfg.n_kv_heads, D).transpose(1, 2)
        v = layers.mm(h, layer["wv"]).to(x.dtype).view(1, S, cfg.n_kv_heads, D).transpose(1, 2)
        o = reference.attention(layers.apply_rope(q, cos, sin), layers.apply_rope(k, cos, sin), v)
        x = x + layers.mm(o.transpose(1, 2).reshape(1, S, -1), layer["wo"]).to(x.dtype)
        x = x + layers.swiglu_mlp(layer, layers.rms_norm(x, layer["mlp_norm"], cfg.norm_eps))
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return layers.mm(x[:, -1], params["lm_head"])


def check_against_dense(eng, llama, layers, reference) -> dict:
    """Prefill 99 tokens + one decode step through the kernels (own small
    cache) against the dense plain forward of the same 100 tokens."""
    from modal_examples_tpu_torch.serving.kv_cache import PagedKVCache

    cfg, params = eng.cfg, eng.params
    gen = torch.Generator(device="cuda").manual_seed(5)
    toks = torch.randint(0, 256, (1, 100), generator=gen, device="cuda", dtype=torch.int32)
    cache = PagedKVCache.create(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        n_pages=9, page_size=16, device="cuda",
    )
    tables = torch.arange(1, 9, device="cuda", dtype=torch.int32)[None]
    padded = torch.zeros((1, 128), dtype=torch.int32, device="cuda")
    padded[0, :99] = toks[0, :99]
    pre, _, _ = llama.prefill(params, padded, cache.k_pages, cache.v_pages, tables,
                              torch.tensor([99], device="cuda"), cfg)
    dec, _, _ = llama.decode_step(params, toks[0, 99:], torch.tensor([99], device="cuda"),
                                  cache.k_pages, cache.v_pages, tables,
                                  torch.tensor([True], device="cuda"), cfg)
    out = {}
    for name, got, n in (("prefill", pre, 99), ("decode", dec, 100)):
        ref = dense_reference_logits(params, cfg, toks[:, :n], layers, reference)
        if got.shape != (1, cfg.vocab_size) or not torch.isfinite(got).all():
            raise AssertionError(f"{name} logits malformed: {tuple(got.shape)}")
        rel = max_err(got, ref) / ref.abs().max().item()
        cos = torch.nn.functional.cosine_similarity(got.float(), ref.float()).item()
        log(f"{name} logits vs dense plain forward: max rel err {rel:.3g}, cosine {cos:.6f}, "
            f"argmax {int(got.argmax())} vs {int(ref.argmax())}")
        if not (rel < 5e-2 and cos > 0.999):
            raise AssertionError(f"{name} logits disagree with the dense plain forward")
        out[name] = {"max_rel_err": rel, "cosine": cos}
    return out


def phase_engine(fa, pa, llama, layers, reference, LLMEngine, SamplingParams):
    cfg = llama.LlamaConfig.llama2_7b()
    t0 = time.monotonic()
    params = llama.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"llama2-7b random bf16 init: {time.monotonic() - t0:.1f}s, {cfg.param_count / 1e9:.2f}B params, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    eng = LLMEngine(cfg, params, max_slots=8, max_model_len=1024, prefill_buckets=(128, 256, 512),
                    prefill_batch=4, decode_block=8, seed=0, device="cuda")
    # warm the path (allocator, cuBLAS handles) with one short request, off the count
    eng.generate("warm up", SamplingParams(max_tokens=2, temperature=0.0))
    fa.launches = pa.decode_launches = pa.scatter_launches = 0
    steps0 = eng.stats.steps
    dec_s0, dec_t0 = eng.stats.decode_seconds, eng.stats.decode_tokens
    t0 = time.monotonic()
    reqs = [eng.submit(p, sp) for p, sp in make_requests(SamplingParams)]
    texts = ["".join(eng.stream(r)) for r in reqs]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = {"flash_fwd": fa.launches, "paged_decode": pa.decode_launches, "kv_scatter": pa.scatter_launches}
    steps = eng.stats.steps - steps0
    log(f"engine: {len(reqs)} requests in {wall:.2f}s, decode steps {steps}, launches {counts}, plan {eng.impl_plan}")
    for r, t in zip(reqs, texts):
        check_finish(r)
        log(f"  {r.request_id}: prompt {len(r.prompt_tokens)} tok, {r.finish_reason}, "
            f"{r.n_generated} generated, ttft {r.first_token_at - r.created:.3f}s, {len(t)} chars")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {counts}")
    if counts["paged_decode"] != cfg.n_layers * steps:
        raise AssertionError(f"decode launches {counts['paged_decode']} != {cfg.n_layers} x {steps} steps")
    if eng.cache.allocator.available != eng.cache.n_pages - 1:
        raise AssertionError("pages not all returned after the requests finished")
    dec_tokens = eng.stats.decode_tokens - dec_t0
    metrics = {
        "decode_tok_per_s": dec_tokens / (eng.stats.decode_seconds - dec_s0),
        "ttft_s_median": statistics.median(r.first_token_at - r.created for r in reqs),
        "wall_s": wall,
        "decode_steps": steps,
        "launches": counts,
    }
    log(f"engine metrics: {json.dumps(metrics)}")
    metrics["dense_check"] = check_against_dense(eng, llama, layers, reference)
    return eng, metrics


def phase_server(eng, OpenAIServer) -> None:
    srv = OpenAIServer(eng, model_name="llama2-7b", port=0).start()
    base = f"http://{srv.host}:{srv.port}"
    try:
        def post(path, body):
            req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                         headers={"content-type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.status, r.read().decode()

        status, body = post("/v1/completions", {"prompt": "The capital of France is", "max_tokens": 16, "temperature": 0})
        out = json.loads(body)
        if status != 200 or out["choices"][0]["finish_reason"] not in ("length", "stop"):
            raise AssertionError(f"completion failed: {status} {body[:300]}")
        log(f"server /v1/completions: {out['usage']}, finish {out['choices'][0]['finish_reason']}")
        status, body = post("/v1/chat/completions", {
            "messages": [{"role": "user", "content": "Say hello."}], "max_tokens": 16, "seed": 1,
            "stream": True, "stream_options": {"include_usage": True},
        })
        events = [e for e in body.split("\n\n") if e]
        if status != 200 or events[-1] != "data: [DONE]":
            raise AssertionError(f"streamed chat failed: {status} {body[-300:]}")
        usage = json.loads(events[-2][len("data: "):])["usage"]
        log(f"server streamed /v1/chat/completions: {len(events) - 3} content chunks, usage {usage}")
    finally:
        srv.stop()  # also stops the engine


# -- training ---------------------------------------------------------------------


def adapter_grads(loss_fn, adapters, batch, attn_impl):
    leaves = {k: v.detach().requires_grad_(True) for k, v in adapters["layers"].items()}
    loss = loss_fn({"layers": leaves}, batch, attn_impl=attn_impl)
    return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def check_grads_against_xla(loss_fn, adapters, batch, targets) -> dict:
    """The first step's adapter gradients through the flash kernels against
    the plain xla attention (autograd through dense attention) on the card.
    b = 0 at init, so every a-gradient is exactly zero on both paths and the
    b-gradients carry the comparison."""
    flash = adapter_grads(loss_fn, adapters, batch, "flash")
    xla = adapter_grads(loss_fn, adapters, batch, "xla")
    out = {}
    for t in targets:
        if flash[f"{t}_a"].abs().max() != 0 or xla[f"{t}_a"].abs().max() != 0:
            raise AssertionError(f"{t}_a gradient is not zero with b = 0")
        f, x = flash[f"{t}_b"].float().flatten(), xla[f"{t}_b"].float().flatten()
        cos = torch.nn.functional.cosine_similarity(f, x, dim=0).item()
        rel = max_err(f, x) / x.abs().max().item()
        out[t] = {"cosine": cos, "max_rel_err": rel}
        log(f"  {t}_b grad flash vs xla: cosine {cos:.6f}, max rel err {rel:.3g}, max|g| {x.abs().max().item():.3g}")
    worst = min(v["cosine"] for v in out.values())
    if not worst >= GRAD_COSINE_MIN:
        raise AssertionError(f"adapter gradients disagree with attn_impl='xla': cosine {worst} < {GRAD_COSINE_MIN}")
    return out


def lora_training_setup(llama, lora, training, params, steps: int):
    """The training path: Llama-2-7B over the frozen ``params``, rank-16
    LoRA (alpha 16, scale 1.0) on all seven projections, ``steps`` batches
    of B=2 x S=512 random tokens (mask of ones), the masked next-token loss
    through ``llama.forward``. Returns (cfg, lcfg, adapters, batches, loss_fn)."""
    cfg = llama.LlamaConfig.llama2_7b()
    lcfg = lora.LoRAConfig(rank=16)
    B, S = 2, 512
    adapters = lora.init_lora(torch.Generator(device="cuda").manual_seed(0), params, lcfg)
    for p in params["layers"]:
        if any(t.requires_grad for t in p.values()):
            raise AssertionError("the base must be frozen")
    tok_gen = torch.Generator(device="cuda").manual_seed(1)
    batches = [
        {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=tok_gen, device="cuda"),
         "mask": torch.ones((B, S), device="cuda")}
        for _ in range(steps)
    ]

    def loss_fn(ad, batch, attn_impl="flash"):
        logits = llama.forward(params, batch["tokens"], cfg, attn_impl=attn_impl, lora=ad, lora_scale=lcfg.scale)
        return training.cross_entropy_loss(logits[:, :-1], batch["tokens"][:, 1:], batch["mask"][:, 1:])

    return cfg, lcfg, adapters, batches, loss_fn


def phase_training(fa, llama, lora, training, params) -> dict:
    steps = 5
    cfg, lcfg, adapters, batches, loss_fn = lora_training_setup(llama, lora, training, params, steps)
    B, S = batches[0]["tokens"].shape
    log(f"training: llama2-7b frozen bf16 base, LoRA rank {lcfg.rank} scale {lcfg.scale} on {lcfg.targets}, "
        f"{lora.param_count(adapters) / 1e6:.2f}M adapter params, B={B} S={S}")
    grads = check_grads_against_xla(loss_fn, adapters, batches[0], lcfg.targets)
    gc.collect()
    torch.cuda.empty_cache()

    trainer = training.Trainer(loss_fn, training.make_optimizer(1e-4))
    state = trainer.init_state(adapters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    step_s, losses, norms = [], [], []
    for batch in batches:
        t0 = time.monotonic()
        state, m = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    counts = {"flash_fwd": fa.launches, "flash_bwd_dq": fa.dq_launches, "flash_bwd_dkv": fa.dkv_launches}
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"training steps: loss {losses}, grad_norm {norms}, step s {step_s}, launches {counts}")
    want = cfg.n_layers * steps
    if counts != {k: want for k in counts}:
        raise AssertionError(f"training launches {counts}: want {want} each ({cfg.n_layers} layers x {steps} steps)")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"non-finite loss or grad norm: {losses}, {norms}")
    moved = {t: state.params["layers"][f"{t}_b"].abs().max().item() for t in lcfg.targets}
    if min(moved.values()) <= 0:
        raise AssertionError(f"b adapters did not move off zero: {moved}")
    if state.step != steps:
        raise AssertionError(f"state.step {state.step} != {steps}")
    if not peak < total:
        raise AssertionError(f"peak memory {peak} not under the card's {total}")
    step_med = statistics.median(step_s[1:])
    metrics = {
        "train_tok_per_s": B * S / step_med,
        "step_ms_median": 1e3 * step_med,
        "step_ms": [1e3 * x for x in step_s],
        "peak_gb": peak / 1e9,
        "card_gb": total / 1e9,
        "losses": losses,
        "launches": counts,
        "grad_check": grads,
    }
    log(f"training metrics: train {metrics['train_tok_per_s']:.1f} tok/s, step {metrics['step_ms_median']:.1f} ms "
        f"(median of {steps - 1} after 1 warm-up), peak {metrics['peak_gb']:.2f} GB of {metrics['card_gb']:.2f} GB; "
        f"{json.dumps(metrics)}")
    return metrics


# -- phase 5 ----------------------------------------------------------------------


def phase_numbers(fa, pa, counts: dict, errs: dict) -> list:
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = []
    # K1 at the engine's prefill batch: 4 prompts in the 512 bucket
    B, H, S, D = 4, 32, 512, 128
    q, k, v = flash_case(gen, B, H, H, S, S)
    flops = 4 * B * H * S * S * D * 0.5
    nbytes = 4 * B * H * S * D * 2 + B * H * S * 4
    rows.append(dict(
        name="flash_fwd", source="modal_examples_tpu_torch/csrc/flash_fwd.cu",
        replaces="modal_examples_tpu/ops/flash_attention.py:40",
        ms=time_ms(lambda: fa.flash_forward_cuda(q, k, v, causal=True, sm_scale=D**-0.5)),
        plain_ms=time_ms(lambda: fa.flash_forward_plain(q, k, v, causal=True, sm_scale=D**-0.5), reps=5),
        bound_ms=1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES),
        bound_by="operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES else "bytes",
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)),
    ))
    del q, k, v
    # K2 at a decode step of the engine's shape: 8 slots, ragged prefixes 0..1000
    c = decode_case(gen, 8, 32, 32, L=32)
    args = [c[n] for n in ("q", "k_pages", "v_pages")] + [5] + [c[n] for n in ("page_tables", "prefix_lens", "k_new", "v_new")]
    pages_read = sum(-(-int(n) // 16) for n in c["prefix_lens"].tolist())
    nbytes = 2 * pages_read * 16 * 32 * 128 * 2 + 4 * 8 * 32 * 128 * 2  # K+V pages; q, o, k_new, v_new
    rows.append(dict(
        name="paged_decode", source="modal_examples_tpu_torch/csrc/paged_decode.cu",
        replaces="modal_examples_tpu/ops/paged_attention.py:284",
        ms=time_ms(lambda: pa.paged_decode_cuda(*args, sm_scale=D**-0.5)),
        plain_ms=time_ms(lambda: pa.paged_decode_plain(*args, sm_scale=D**-0.5), reps=5),
        bound_ms=1e3 * nbytes / PEAK_BYTES, bound_by="bytes", library_ms=None,
    ))
    del c, args
    # K3 at the decode step: 8 tokens x 32 layers into the engine's cache shape
    L, N, P = 32, 8, 513
    k_all, v_all, page_idx, slot = scatter_case(gen, L, N, P)
    kp, vp = rand_bf16(gen, L, P, 16, 32, 128), rand_bf16(gen, L, P, 16, 32, 128)
    nbytes = 2 * (2 * L * N * 32 * 128 * 2)
    layer_ix = torch.arange(L, device="cuda")[:, None]
    pi, sl = page_idx.long()[None], slot.long()[None]

    def library():
        kp.index_put_((layer_ix, pi, sl), k_all)
        vp.index_put_((layer_ix, pi, sl), v_all)

    rows.append(dict(
        name="kv_scatter", source="modal_examples_tpu_torch/csrc/kv_scatter.cu",
        replaces="modal_examples_tpu/ops/paged_attention.py:927",
        ms=time_ms(lambda: pa.scatter_cuda(kp, vp, k_all, v_all, page_idx, slot)),
        plain_ms=time_ms(lambda: pa.scatter_plain(kp, vp, k_all, v_all, page_idx.long(), slot.long())),
        bound_ms=1e3 * nbytes / PEAK_BYTES, bound_by="bytes", library_ms=time_ms(library),
    ))
    # K5/K6 at the training path's shape: B=2, Hq=Hkv=32, S=512, D=128, causal
    B, H, S, D = 2, 32, 512, 128
    args, _ = bwd_case(fa, gen, B, H, H, S, True, False)
    q, k, v, do = args[:4]
    one_product = 2 * 0.5 * S * S * D * B * H  # FLOPs of one causal S x S x D product, all heads
    tensor_bytes, row_bytes = B * H * S * D * 2, B * H * S * 4
    out, lse_l, cq, ck, mq, mk, seed, offset, _ = torch.ops.aten._scaled_dot_product_flash_attention(
        q, k, v, 0.0, True, False, scale=D**-0.5)

    def library():  # PyTorch's flash-attention backward: dQ, dK and dV in one call
        return torch.ops.aten._scaled_dot_product_flash_attention_backward(
            do, q, k, v, out, lse_l, cq, ck, mq, mk, 0.0, True, seed, offset, scale=D**-0.5)

    library_ms = time_ms(library)
    for name, fn, plain, n_products, n_tensors, line in (
        ("flash_bwd_dq", fa.flash_bwd_dq_cuda, fa.flash_bwd_dq_plain, 3, 5, 244),
        ("flash_bwd_dkv", fa.flash_bwd_dkv_cuda, fa.flash_bwd_dkv_plain, 4, 6, 278),
    ):
        flops = n_products * one_product
        nbytes = n_tensors * tensor_bytes + 3 * row_bytes  # q,k,v,dO + outputs; lse, delta, dlse
        rows.append(dict(
            name=name, source=f"modal_examples_tpu_torch/csrc/{name}.cu",
            replaces=f"modal_examples_tpu/ops/flash_attention.py:{line}",
            ms=time_ms(lambda: fn(*args, causal=True, sm_scale=D**-0.5)),
            plain_ms=time_ms(lambda: plain(*args, causal=True, sm_scale=D**-0.5), reps=5),
            bound_ms=1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES),
            bound_by="operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES else "bytes",
            library_ms=library_ms,
            library_op="aten._scaled_dot_product_flash_attention_backward (dQ, dK and dV together)",
        ))
    del args, q, k, v, do, out
    for r in rows:
        r["route"] = "cuda"
        r["launches"] = counts[r["name"]]
        r["max_abs_err"] = errs[r["name"]]
        log(f"{r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library {r['library_ms']}, "
            f"bound {r['bound_ms']:.4f} by {r['bound_by']})")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_op")
    return [{k: r[k] for k in keys if k in r} for r in rows]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script runs on the GPU only", file=sys.stderr)
        return 2
    from modal_examples_tpu_torch import LLMEngine, OpenAIServer, SamplingParams, training
    from modal_examples_tpu_torch.models import layers, llama, lora
    from modal_examples_tpu_torch.ops import _build, reference
    from modal_examples_tpu_torch.ops import flash_attention as fa
    from modal_examples_tpu_torch.ops import paged_attention as pa

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {card}")
    # plain versions in full f32 (no TF32), stated for the comparisons
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("plain versions: torch.backends.cuda.matmul.allow_tf32=False, cudnn.allow_tf32=False")

    t0 = time.monotonic()
    _build.build()
    log(f"phase 1 build: {time.monotonic() - t0:.1f}s for {_build.kernel_names()}")
    errs = phase_kernels_vs_plain(fa, pa)
    phase_backward_vs_plain(fa, errs)
    log(f"phase 2 kernels vs plain (tolerances {TOL}): {errs}")
    eng, metrics = phase_engine(fa, pa, llama, layers, reference, LLMEngine, SamplingParams)
    phase_server(eng, OpenAIServer)
    log("phase 4 server: ok")
    params = eng.params
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_training(fa, llama, lora, training, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    serve_counts, train_counts = metrics["launches"], train["launches"]
    counts = {**serve_counts, **train_counts, "flash_fwd": serve_counts["flash_fwd"] + train_counts["flash_fwd"]}
    log(f"launches: serving {serve_counts}, training {train_counts}; kernels line (flash_fwd summed) {counts}")
    rows = phase_numbers(fa, pa, counts, errs)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
