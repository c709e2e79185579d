"""The port's engine and OpenAI server against the JAX engine.

Both engines serve the same tiny f32 model (the JAX ``init_params`` weights
through ``params_from_jax``) with the same requests: prompts on both sides of
the largest bucket (so ``prefill_chunk`` runs), greedy and seeded rows.
Finish reasons, token counts and page accounting must match exactly; tokens
must match wherever the reference's top-2 margin (of the logits, plus the
row's gumbel noise for sampled rows) exceeds 1e-3 — across frameworks the
accumulation order differs, so a near-tie may break either way.
"""

import dataclasses
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from modal_examples_tpu.models import llama as jllama
from modal_examples_tpu.serving.engine import LLMEngine as JaxEngine
from modal_examples_tpu.serving.sampling import SamplingParams as JaxParams
from modal_examples_tpu_torch import LLMEngine, OpenAIServer, SamplingParams
from modal_examples_tpu_torch.models import llama as tllama

MARGIN = 1e-3
ENGINE_KW = dict(
    max_slots=4, max_model_len=256, page_size=16, prefill_buckets=(32, 64),
    seed=0, kv_dtype="float32", decode_block=4,
)
REQUESTS = [  # (prompt, params): prompt lengths 11, 41, 64, 101 and 151 tokens
    ("a" * 10, dict(max_tokens=9, temperature=0.0)),
    ("the quick brown fox jumps over a lazy dog", dict(max_tokens=12, temperature=0.8, seed=7)),
    ("b" * 63, dict(max_tokens=6, temperature=1.0)),  # engine-assigned seed
    ("c" * 100, dict(max_tokens=10, temperature=0.0, stop=("zz",))),
    ("0123456789" * 15, dict(max_tokens=8, temperature=0.7, seed=123)),
]


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32")
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype="float32")
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _run(engine, params_cls):
    reqs = [engine.submit(prompt, params_cls(**kw)) for prompt, kw in REQUESTS]
    pieces = [list(engine.stream(r)) for r in reqs]
    return reqs, pieces


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


def test_engine_matches_jax_engine(weights):
    jcfg, tcfg, jparams, tparams = weights
    jeng = JaxEngine(jcfg, jparams, enable_prefix_cache=False, **ENGINE_KW)
    teng = LLMEngine(tcfg, tparams, device="cpu", **ENGINE_KW)
    try:
        jreqs, jpieces = _run(jeng, JaxParams)
        treqs, tpieces = _run(teng, SamplingParams)
        assert jeng.cache.allocator.available == jeng.cache.n_pages - 1
        assert teng.cache.allocator.available == teng.cache.n_pages - 1
    finally:
        jeng.stop()
        teng.stop()
    assert any(len(r.prompt_tokens) > 64 for r in treqs)  # chunked prefill ran
    for jr, tr, jp, tp in zip(jreqs, treqs, jpieces, tpieces):
        assert tr.finish_reason == jr.finish_reason
        assert tr.n_generated == jr.n_generated
        assert len(tr.generated_tokens) == len(jr.generated_tokens)
        same = tr.generated_tokens == jr.generated_tokens
        if same:
            assert tp == jp  # stream pieces
            continue
        j = next(i for i, (a, b) in enumerate(zip(tr.generated_tokens, jr.generated_tokens)) if a != b)
        assert _ref_margin(jparams, jcfg, jr, j) <= MARGIN, f"token {j} differs past the margin"


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), headers={"content-type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


def test_openai_server_completions_chat_sse_and_errors(weights):
    _, tcfg, _, tparams = weights
    srv = OpenAIServer(LLMEngine(tcfg, tparams, device="cpu", **ENGINE_KW), port=0).start()
    shed = OpenAIServer(LLMEngine(tcfg, tparams, device="cpu", max_queue=0, **ENGINE_KW), port=0).start()
    base = f"http://{srv.host}:{srv.port}"
    try:
        with urllib.request.urlopen(base + "/v1/models", timeout=30) as r:
            assert json.loads(r.read())["data"][0]["object"] == "model"

        status, _, body = _post(base + "/v1/completions", {"prompt": "hello", "max_tokens": 5, "temperature": 0})
        assert status == 200
        out = json.loads(body)
        assert out["object"] == "text_completion"
        assert out["choices"][0]["finish_reason"] in ("length", "stop")
        assert out["usage"]["prompt_tokens"] == 6
        assert out["usage"]["total_tokens"] == 6 + out["usage"]["completion_tokens"]

        status, headers, body = _post(base + "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hi"}], "max_tokens": 6, "seed": 3,
            "stream": True, "stream_options": {"include_usage": True},
        })
        assert status == 200 and headers["content-type"] == "text/event-stream"
        events = [e for e in body.split("\n\n") if e]
        assert all(e.startswith("data: ") for e in events) and events[-1] == "data: [DONE]"
        chunks = [json.loads(e[len("data: "):]) for e in events[:-1]]
        usage = chunks[-1]
        assert usage["choices"] == [] and usage["usage"]["completion_tokens"] >= 1
        final = chunks[-2]
        assert final["choices"][0]["finish_reason"] in ("length", "stop")
        assert all(c["object"] == "chat.completion.chunk" and c["usage"] is None for c in chunks[:-1])
        text = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks[:-1])
        assert isinstance(text, str)

        status, _, body = _post(base + "/v1/completions", {"prompt": "x", "top_p": 1.5})
        assert status == 400 and "top_p" in json.loads(body)["error"]["message"]

        status, headers, body = _post(f"http://{shed.host}:{shed.port}/v1/completions", {"prompt": "x"})
        assert status == 429 and int(headers["retry-after"]) >= 1
        assert json.loads(body)["error"]["type"] == "rate_limit_error"
    finally:
        srv.stop()
        shed.stop()


def test_scheduler_error_fails_loudly(weights):
    _, tcfg, _, tparams = weights
    eng = LLMEngine(tcfg, tparams, device="cpu", **ENGINE_KW)
    n_reports = len(LLMEngine._error_reports)

    def broken_tick():
        raise RuntimeError("injected scheduler bug")

    eng._decode_tick = broken_tick
    try:
        req = eng.submit("hello", SamplingParams(max_tokens=4))
        assert "".join(eng.stream(req)) == ""
        assert req.finish_reason == "error"
        assert "injected scheduler bug" in eng.error_log[-1]
        assert len(LLMEngine._error_reports) == n_reports + 1
        assert eng.cache.allocator.available == eng.cache.n_pages - 1  # claim released
        with pytest.raises(RuntimeError, match="scheduler error"):
            eng.start()
    finally:
        del LLMEngine._error_reports[n_reports:]
        eng.stop()


def test_abort_and_queue_bound(weights):
    from modal_examples_tpu_torch.scheduling.admission import ShedError

    _, tcfg, _, tparams = weights
    eng = LLMEngine(tcfg, tparams, device="cpu", max_queue=1, **ENGINE_KW)
    try:
        queued = eng.submit("never scheduled", SamplingParams(max_tokens=4))
        with pytest.raises(ShedError):
            eng.submit("one too many")
        eng.abort(queued)  # still queued: finishes at once, engine never started
        assert list(eng.stream(queued)) == [] and queued.finish_reason == "stop"
        running = eng.submit("x" * 20, SamplingParams(max_tokens=200, temperature=0.0))
        eng.start()
        eng.abort(running)  # queued or mid-decode: either way it ends as "stop"
        list(eng.stream(running))
        assert running.finish_reason == "stop" and running.n_generated < 200
        assert eng.cache.allocator.available == eng.cache.n_pages - 1
        with pytest.raises(ValueError, match="top_p"):
            eng.submit("x", SamplingParams(top_p=0.0))
    finally:
        eng.stop()
