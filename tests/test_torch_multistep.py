"""The port's macro-step decode runtime against the JAX package's.

- ``masked_scan`` against the JAX ``masked_scan`` on a toy step whose lanes
  die at different steps: the same stacked outputs and carry, the dead tail
  held. The port decides each step on the device (it runs ``step`` and
  ``hold`` every step and selects), so it never reads the live mask.
- ``build_multistep_fn`` against the JAX function at tiny f32, read-only and
  writeback structures: tokens, validity and last tokens exactly, pages
  within 1e-5 of their largest value; one lane dies at eos, one at its
  budget, one is dead from the start.
- The JAX ``test_classic_vs_multistep_matrix`` as a port test: N in {8, 4, 1}
  flipped on a live engine, greedy and seeded, f32 and int8 pages, read-only
  and writeback structures. Each run is token-, text- and finish-identical
  to the port's N=1, and matches the JAX engine at ``decode_steps=8`` where
  the reference's top-2 margin exceeds 1e-3.
- The knob rule (argument, then ``MTPU_DECODE_STEPS``, then 1), an abort
  between harvests (every page returned), and the detokenization worker's
  stop strings and unstable-tail holdback against the port's own inline
  path (the JAX worker's stop-string test is red on the reference, so the
  port is held to its inline path there).
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modal_examples_tpu.models import llama as jllama
from modal_examples_tpu.ops.scan_loop import masked_scan as jax_masked_scan
from modal_examples_tpu.serving.engine import LLMEngine as JaxEngine
from modal_examples_tpu.serving.multistep import runtime as jruntime
from modal_examples_tpu.serving.sampling import SamplingParams as JaxParams
from modal_examples_tpu_torch import LLMEngine, SamplingParams
from modal_examples_tpu_torch.models import llama as tllama
from modal_examples_tpu_torch.ops.scan_loop import masked_scan
from modal_examples_tpu_torch.serving import multistep as tms
from modal_examples_tpu_torch.serving.multistep import DetokWorker
from modal_examples_tpu_torch.serving.sampling import prng_key
from test_torch_time_limit import share_cores

share_cores()

PROMPT = "the quick brown fox jumps over the lazy dog and naps in the sun"
MARGIN = 1e-3


# -- masked_scan ---------------------------------------------------------------------


def test_masked_scan_matches_jax_and_holds_the_dead_tail():
    die_at = np.array([1, 3, 2, 0], np.int32)  # lane 3 is dead from the start
    live0 = die_at > 0
    xs = np.arange(1, 7, dtype=np.int32)[:, None] * np.array([1, 10, 100, 1000], np.int32)  # [6, 4]

    def jstep(live, state, x):
        cnt, acc = state
        cnt = cnt + live.astype(cnt.dtype)
        acc = acc + jnp.where(live, x, 0)
        return live & (cnt < die_at), (cnt, acc), (acc, live)

    def jhold(live, state, x):
        return jnp.full_like(state[1], -1), live

    calls = {"step": 0, "hold": 0}

    def tstep(live, state, x):
        calls["step"] += 1
        cnt, acc = state
        cnt = cnt + live.to(cnt.dtype)
        acc = acc + torch.where(live, x, torch.zeros_like(x))
        return live & (cnt < torch.from_numpy(die_at)), (cnt, acc), (acc, live)

    def thold(live, state, x):
        calls["hold"] += 1
        return torch.full_like(state[1], -1), live

    zeros = np.zeros(4, np.int32)
    jlive, (jcnt, jacc), (jouts, jvalid) = jax_masked_scan(
        jstep, jhold, jnp.asarray(live0), (jnp.asarray(zeros), jnp.asarray(zeros)), jnp.asarray(xs)
    )
    tlive, (tcnt, tacc), (touts, tvalid) = masked_scan(
        tstep, thold, torch.from_numpy(live0), (torch.from_numpy(zeros), torch.from_numpy(zeros)),
        torch.from_numpy(xs),
    )
    for port, ref in ((tlive, jlive), (tcnt, jcnt), (tacc, jacc), (touts, jouts), (tvalid, jvalid)):
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    assert touts.shape == (6, 4) and tvalid.dtype == torch.bool
    # the last lane dies after step 3: both branches ran at every step and the
    # device selected the holds for steps 4-6 (no host read of the mask)
    assert calls == {"step": 6, "hold": 6}
    assert (touts[3:] == -1).all() and not tvalid[3:].any()


# -- build_multistep_fn ------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32")
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype="float32")
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, tllama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


def _multistep_inputs(model):
    """Four slots: greedy (it will die at eos), seeded with a budget of 3,
    dead, greedy with a long budget; three prompts prefilled by the JAX
    prefill."""
    jcfg, _, jparams, _ = model
    rng = np.random.default_rng(0)
    ps, pps = 16, 6
    n_pages = 1 + 4 * pps
    tables = (rng.permutation(n_pages - 1)[: 4 * pps] + 1).reshape(4, pps).astype(np.int32)
    shape = (jcfg.n_layers, n_pages, ps, jcfg.n_kv_heads, jcfg.head_dim)
    lens = np.array([20, 32, 1, 9], np.int32)
    tokens = rng.integers(0, jcfg.vocab_size, (4, 32)).astype(np.int32)
    _, jk, jv = jllama.prefill(
        jparams, jnp.asarray(tokens), jnp.zeros(shape), jnp.zeros(shape), jnp.asarray(tables),
        jnp.asarray(lens), jcfg,
    )
    args = dict(
        prev=np.array([5, 9, 0, 17], np.int32),
        # slot 1 is fresh: its first token rides the override lane
        override=np.array([0, 23, 0, 0], np.int32),
        override_mask=np.array([False, True, False, False]),
        positions=lens.copy(),
        active=np.array([True, True, False, True]),
        temps=np.array([0.0, 0.8, 1.0, 0.0], np.float32),
        top_ps=np.ones(4, np.float32),
        top_ks=np.zeros(4, np.int32),
        seeds=np.array([-1, 7, -1, 11], np.int32),
        budgets=np.array([100, 3, 1, 100], np.int32),
    )
    return np.asarray(jk), np.asarray(jv), tables, args


def _jax_multistep(model, kp, vp, tables, a, impl, eos_id, n):
    jcfg, _, jparams, _ = model
    fn = jruntime.build_multistep_fn(jcfg, paged_impl=impl, scatter_impl="xla", mesh=None, eos_id=eos_id, n_steps=n)
    return fn(
        jparams, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(a["prev"]), jnp.asarray(a["override"]),
        jnp.asarray(a["override_mask"]), jnp.asarray(a["positions"]),
        jnp.asarray(tables), jnp.asarray(a["active"]), jax.random.PRNGKey(3),
        *(jnp.asarray(a[k]) for k in ("temps", "top_ps", "top_ks", "seeds", "budgets")),
    )


@pytest.mark.parametrize("impl", ["xla", "pallas-writeback"])
def test_build_multistep_fn_matches_jax(model, impl):
    _, tcfg, _, tparams = model
    kp, vp, tables, a = _multistep_inputs(model)
    n = 6
    free_run = np.asarray(_jax_multistep(model, kp, vp, tables, a, impl, -1, n)[0])
    eos = int(free_run[2, 0])  # lane 0 dies on its third token
    assert eos not in free_run[:2, 0]
    jtoks, jvalid, jlast, jk, jv = _jax_multistep(model, kp, vp, tables, a, impl, eos, n)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    fn = tms.build_multistep_fn(tcfg, paged_impl=impl, scatter_impl="xla", eos_id=eos, n_steps=n)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    toks, valid, last = fn(
        tparams, tk, tv, t["prev"], t["override"], t["override_mask"], t["positions"], torch.from_numpy(tables),
        t["active"], prng_key(3),
        t["temps"], t["top_ps"], t["top_ks"], t["seeds"], t["budgets"],
    )
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(last.numpy(), np.asarray(jlast))
    v = valid.numpy()
    assert v[:3, 0].all() and not v[3:, 0].any()  # died at eos, the eos row valid
    assert v[:3, 1].all() and not v[3:, 1].any()  # spent its budget of 3
    assert not v[:, 2].any() and v[:, 3].all()
    for p, r in ((tk, jk), (tv, jv)):  # page 0, the trash page, excluded
        r = np.asarray(r)
        np.testing.assert_allclose(p.numpy()[:, 1:], r[:, 1:], rtol=0, atol=1e-5 * np.abs(r).max())


# -- the engine ------------------------------------------------------------------------


def _engine(model, kv_dtype="float32", *, jax_engine=False, **kw):
    jcfg, tcfg, jparams, tparams = model
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_model_len", 128)
    kw.setdefault("page_size", 8)
    kw.setdefault("prefill_buckets", (16, 32))
    if jax_engine:
        return JaxEngine(jcfg, jparams, seed=0, kv_dtype=kv_dtype, enable_prefix_cache=False, **kw)
    return LLMEngine(tcfg, tparams, seed=0, kv_dtype=kv_dtype, device="cpu", enable_prefix_cache=False, **kw)


def _pages_returned(eng) -> bool:
    return eng.cache.allocator.available == eng.cache.n_pages - 1 and all(s.free for s in eng.slots)


def _wait_pages_returned(eng, timeout=30.0) -> bool:
    """An abort is reaped at the next scheduler tick: poll."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if _pages_returned(eng):
            return True
        time.sleep(0.02)
    return _pages_returned(eng)


def _settled_steps(eng, timeout=30.0) -> int:
    """``stats.steps`` once the scheduler has read every block in flight (a
    block leaves ``_inflight`` before its read counts its steps, so the
    count must also hold still across two looks)."""
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        now = None if eng._inflight else eng.stats.steps
        if now is not None and now == last:
            return now
        last = now
        time.sleep(0.05)
    raise AssertionError("the engine did not settle")


def _ref_margin(jparams, jcfg, req, j):
    """Top-2 margin of what the reference sampled for generated token j."""
    toks = list(req.prompt_tokens) + list(req.generated_tokens[:j])
    logits = jllama.forward(jparams, jnp.asarray([toks], jnp.int32), jcfg, attn_impl="xla")[0, -1]
    p = req.params
    if p.temperature > 0:
        seed = p.seed if p.seed is not None else req.auto_seed
        step = len(req.prompt_tokens) + max(0, j - 1)  # first decode step reuses the prefill's
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), seed), step)
        logits = logits / p.temperature + jax.random.gumbel(key, logits.shape)
    top2 = np.sort(np.asarray(logits))[-2:]
    return float(top2[1] - top2[0])


SAMPLING = {
    "greedy": dict(max_tokens=16, temperature=0.0),
    "seeded": dict(max_tokens=16, temperature=0.9, seed=7),
}


@pytest.mark.parametrize("paged_impl", ["xla", "pallas-writeback"])
@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_classic_vs_multistep_matrix(model, kv_dtype, paged_impl):
    jcfg, _, jparams, _ = model
    ref_eng = _engine(model, kv_dtype, paged_impl=paged_impl)  # decode_steps unset: 1
    ms_eng = _engine(model, kv_dtype, paged_impl=paged_impl, decode_steps=8)
    jeng = _engine(model, kv_dtype, jax_engine=True, paged_impl=paged_impl, decode_steps=8)
    try:
        refs = {}
        for name, kw in SAMPLING.items():
            r = ref_eng.submit(PROMPT, SamplingParams(**kw))
            refs[name] = ("".join(ref_eng.stream(r)), list(r.generated_tokens), r.finish_reason, r.n_generated)
        ms_steps = {}
        for n in (8, 4, 1):
            ms_eng.decode_steps = n  # read once per dispatch
            for name, kw in SAMPLING.items():
                steps0 = _settled_steps(ms_eng)
                req = ms_eng.submit(PROMPT, SamplingParams(**kw))
                out = "".join(ms_eng.stream(req))
                assert (out, req.generated_tokens, req.finish_reason, req.n_generated) == refs[name], (name, n)
                if n > 1:
                    # a macro-step counts the rows a live lane ran: the decoded
                    # tokens, plus those of the block queued behind the last
                    # one read (the pipeline runs one block ahead)
                    steps = _settled_steps(ms_eng) - steps0
                    assert req.n_generated - 1 <= steps <= req.n_generated - 1 + n, (name, n, steps)
                    ms_steps.setdefault(n, {})[name] = steps
        for name, kw in SAMPLING.items():
            jsteps0 = _settled_steps(jeng)
            jr = jeng.submit(PROMPT, JaxParams(**kw))
            jtext = "".join(jeng.stream(jr))
            text, tokens, finish, n_gen = refs[name]
            assert jr.finish_reason == finish and jr.n_generated == n_gen
            if jr.generated_tokens == tokens:
                assert jtext == text
                assert _settled_steps(jeng) - jsteps0 == ms_steps[8][name]  # the same pipeline, step for step
                continue
            j = next(i for i, (a, b) in enumerate(zip(tokens, jr.generated_tokens)) if a != b)
            assert _ref_margin(jparams, jcfg, jr, j) <= MARGIN, (name, f"token {j} differs past the margin")
        assert _pages_returned(ref_eng) and _pages_returned(ms_eng)
    finally:
        ref_eng.stop()
        ms_eng.stop()
        jeng.stop()


def test_decode_steps_knob_rule(model, monkeypatch):
    monkeypatch.delenv(tms.DECODE_STEPS_ENV, raising=False)
    assert tms.resolve_decode_steps() == 1 == jruntime.resolve_decode_steps()
    assert tms.resolve_decode_steps(0) == 1  # at least one step
    monkeypatch.setenv(tms.DECODE_STEPS_ENV, "4")
    assert tms.DECODE_STEPS_ENV == jruntime.DECODE_STEPS_ENV
    assert tms.resolve_decode_steps() == 4 == jruntime.resolve_decode_steps()
    assert tms.resolve_decode_steps(2) == 2 == jruntime.resolve_decode_steps(2)  # the argument wins
    eng = _engine(model)
    assert eng.decode_steps == 4
    assert _engine(model, decode_steps=3).decode_steps == 3
    monkeypatch.setenv("MTPU_PAGED_IMPL", "pallas-writeback")
    monkeypatch.setenv("MTPU_SCATTER_IMPL", "pallas")
    eng = _engine(model)
    assert (eng.paged_impl, eng.scatter_impl, eng.impl_plan["attention"]) == ("pallas-writeback", "pallas", "writeback")
    assert _engine(model, paged_impl="xla").impl_plan["attention"] == "ragged"  # the argument wins


def test_abort_between_harvests_drains(model):
    eng = _engine(model, decode_steps=8)
    try:
        req = eng.submit(PROMPT, SamplingParams(max_tokens=96, temperature=0.0))
        pieces: list[str] = []
        t = threading.Thread(target=lambda: pieces.extend(eng.stream(req)))
        t.start()
        deadline = time.monotonic() + 60
        while len(req.generated_tokens) < 4 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert len(req.generated_tokens) >= 4  # at least one harvest landed
        eng.abort(req)
        t.join(timeout=120)
        assert not t.is_alive()
        assert req.finish_reason == "stop" and len(req.generated_tokens) < 96
        assert _wait_pages_returned(eng)
    finally:
        eng.stop()


def _serve(eng, sp):
    req = eng.submit(PROMPT, sp)
    return list(eng.stream(req)), req


def test_detok_worker_stop_strings_match_inline_path(model):
    eng1 = _engine(model)  # inline stop matching
    eng8 = _engine(model, decode_steps=8)
    try:
        free = SamplingParams(max_tokens=48, temperature=0.0)
        ref_pieces, _ = _serve(eng1, free)
        ref_text = "".join(ref_pieces)
        assert len(ref_text) > 8
        # a substring from the middle of the free-running output: it matches
        # mid-stream on both engines
        stop = ref_text[len(ref_text) // 2 : len(ref_text) // 2 + 3]
        sp = SamplingParams(max_tokens=48, temperature=0.0, stop=(stop,))
        classic, c = _serve(eng1, sp)
        ms, m = _serve(eng8, sp)
        assert "".join(ms) == "".join(classic)
        assert m.finish_reason == c.finish_reason == "stop"
        assert len("".join(classic)) < len(ref_text) and stop not in "".join(classic)
        assert eng8._detok is not None and not eng8._detok.owns(m)
        assert _wait_pages_returned(eng1) and _wait_pages_returned(eng8)
    finally:
        eng1.stop()
        eng8.stop()


def test_detok_worker_holds_back_unstable_tails_as_inline(model):
    """Byte tokens above 127 decode to mid-codepoint surrogates: the worker
    holds them back exactly as the inline path does, piece for piece."""
    eng1 = _engine(model)
    eng8 = _engine(model, decode_steps=8)
    try:
        for kw in SAMPLING.values():
            sp = SamplingParams(**{**kw, "max_tokens": 48})
            pieces1, r1 = _serve(eng1, sp)
            pieces8, r8 = _serve(eng8, sp)
            assert pieces8 == pieces1 and r8.finish_reason == r1.finish_reason
            assert r8.emitted_len == len("".join(pieces8))
        held = [p for p in pieces1 if any(0xDC80 <= ord(ch) <= 0xDCFF for ch in p)]
        assert held, "the run should emit at least one surrogate-escaped byte"
    finally:
        eng1.stop()
        eng8.stop()


def test_dead_detok_worker_falls_back_to_inline(model):
    eng1 = _engine(model)
    eng8 = _engine(model, decode_steps=8)
    dead = DetokWorker(tokenizer=eng8.tokenizer, deliver=eng8._deliver_finish, safe_len=None, unstable_tail=None)
    dead.stop()
    eng8._detok = dead
    eng8._ensure_detok = lambda: dead  # a worker that cannot be replaced
    try:
        sp = SamplingParams(max_tokens=24, temperature=0.9, seed=3)
        pieces1, r1 = _serve(eng1, sp)
        pieces8, r8 = _serve(eng8, sp)
        assert pieces8 == pieces1 and r8.generated_tokens == r1.generated_tokens
        assert not dead.owns(r8)  # the worker never saw the stream
        assert r8.emitted_len == len("".join(pieces8))  # the inline path's cursor, mirrored as in the JAX engine
        assert _pages_returned(eng8)
    finally:
        eng1.stop()
        eng8.stop()


def test_stop_drains_the_worker_before_releasing(model):
    """``stop()`` with streams mid-flight: the worker's queued text lands
    before the release sweep's marker, and every page comes back."""
    eng = _engine(model, decode_steps=8)
    req = eng.submit(PROMPT, SamplingParams(max_tokens=96, temperature=0.0))
    eng.start()
    deadline = time.monotonic() + 60
    while len(req.generated_tokens) < 4 and time.monotonic() < deadline:
        time.sleep(0.005)
    eng.stop()
    items = []
    while not req.out_queue.empty():
        items.append(req.out_queue.get_nowait())
    assert items and not isinstance(items[-1], str) and all(isinstance(i, str) for i in items[:-1])
    assert _pages_returned(eng)
