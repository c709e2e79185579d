"""The port's speculating engine against the JAX engine's, and against itself.

- Tick by tick: both engines serve one burst (the tiny llama, the JAX
  ``init_params`` weights through ``params_from_jax``, f32 compute; more
  requests than slots, chunked prompts, repetitive prompts, greedy and
  sampled rows), stepped by hand, in draft mode with a random one-layer draft
  and with a self-draft, and in prompt-lookup mode, over bf16 and int8 pages,
  with the adaptive controller on and off. After every tick they agree on the
  tokens of every request, which slots hold which request and which are
  decodable, the free pages, the step counts (a fallback's decode block
  counted with the steps the port did not dispatch past every budget,
  ROADMAP §C departure 1), the prompt and generated tokens, the proposals
  and acceptances, the rounds and fallbacks, and the γ each round
  dispatched to each slot. After the burst: the finish reasons, every page
  back, and the speculation series each engine's ``/metrics`` serves.
- The greedy speculating engine against the port's non-speculating one:
  token-identical in both modes, sampled rows (top_p included) too.
- A hostile (random) draft under the adaptive controller retreats to
  whole-round fallbacks and stays token-identical; a self-draft keeps full
  depth; ``spec_depth`` changes at runtime (0: every round falls back).
- The constructor's refusals, each the JAX engine's ``ValueError``; a draft
  from ``draft_model_dir`` is the checkpoint's weights.
"""

import dataclasses
import json
import queue
import urllib.request

import numpy as np
import pytest
import torch

import jax

from modal_examples_tpu.models import llama as jllama
from modal_examples_tpu.serving.engine import LLMEngine as JaxEngine
from modal_examples_tpu.serving.openai_api import OpenAIServer as JaxServer
from modal_examples_tpu.serving.sampling import SamplingParams as JaxParams
from modal_examples_tpu.utils.prometheus import default_registry as jax_registry
from modal_examples_tpu_torch import LLMEngine, OpenAIServer, SamplingParams
from modal_examples_tpu_torch.models import llama as tllama
from modal_examples_tpu_torch.observability import catalog as C
from modal_examples_tpu_torch.utils.prometheus import default_registry
from modal_examples_tpu_torch.utils.safetensors import save_file
from test_torch_time_limit import share_cores

share_cores()

ENGINE_KW = dict(max_slots=4, max_model_len=96, page_size=8, prefill_buckets=(16, 32), decode_block=4, seed=0)
#: prompt lengths 24 (a repeated phrase), 41 (chunked), 20, 27 (repeated), 71
#: (chunked), 12, 8
BURST = [
    ("one two one two one two", dict(max_tokens=24, temperature=0.0)),
    ("a" * 40, dict(max_tokens=9, temperature=0.0)),
    ("the quick brown fox", dict(max_tokens=5, temperature=0.8, seed=11)),
    ("red blue red blue red blue", dict(max_tokens=20, temperature=0.0)),
    ("x" * 70, dict(max_tokens=6, temperature=0.0)),
    ("hello there", dict(max_tokens=4, temperature=0.7, top_p=0.5, seed=3)),
    ("short q", dict(max_tokens=28, temperature=0.0)),
]
#: (mode, kv dtype, adaptive controller): each mode over both kv dtypes,
#: the controller on and off
GRID = [("draft", "bfloat16", True), ("self", "int8", False), ("ngram", "bfloat16", False), ("ngram", "int8", True)]
GRID_IDS = [f"{m}-{kv}-{'adaptive' if a else 'fixed'}" for m, kv, a in GRID]
TICKS = 16


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _pair(seed: int, **shape):
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32", **shape)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype="float32", **shape)
    jparams = jllama.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jparams, tllama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


@pytest.fixture(scope="module")
def weights():
    return _pair(0), _pair(1, n_layers=1, dim=64, ffn_dim=128)


def _spec_kw(weights, mode: str, side: str) -> dict:
    """The speculation arguments of one engine: ``side`` "jax" or "port"."""
    (jcfg, tcfg, jparams, tparams), (djcfg, dtcfg, djparams, dtparams) = weights
    if mode == "ngram":
        return dict(speculative=("ngram", 4))
    if mode == "self":
        return dict(speculative=(jcfg, 4), draft_params=jparams) if side == "jax" else dict(
            speculative=(tcfg, 4), draft_params=tparams)
    return dict(speculative=(djcfg, 4), draft_params=djparams) if side == "jax" else dict(
        speculative=(dtcfg, 4), draft_params=dtparams)


def _steps_saved(eng) -> float:
    reg = default_registry if isinstance(eng, LLMEngine) else jax_registry
    return reg.total(C.MULTISTEP_EARLY_EXIT_STEPS_TOTAL)


def _finish_of(req):
    while req.finish_reason is None:
        try:
            item = req.out_queue.get_nowait()
        except queue.Empty:
            return None
        if hasattr(item, "reason"):
            req.finish_reason = item.reason
    return req.finish_reason


def _record_gammas(eng) -> list:
    """Wrap the instance's ``_spec_round`` to log each round's (slot, γ)."""
    log, spec_round = [], eng._spec_round

    def wrapped(live, gammas, ngram_props=None):
        log.append(tuple((i, int(gammas[i])) for i in live))
        return spec_round(live, gammas, ngram_props)

    eng._spec_round = wrapped
    return log


def _state(eng, reqs, gammas) -> tuple:
    held = {id(s.request): i for i, s in enumerate(eng.slots) if s.request is not None}
    st = eng.stats
    return (
        tuple(tuple(r.generated_tokens) for r in reqs),
        tuple(held.get(id(r)) for r in reqs),
        tuple(i for i, s in enumerate(eng.slots) if s.decodable),
        eng.cache.allocator.available,
        st.steps + _steps_saved(eng) - eng.saved_before, st.prompt_tokens, st.generated_tokens,
        st.spec_proposed, st.spec_accepted, eng._spec_rounds, eng._spec_fallbacks, eng._spec_round_tokens,
        tuple(gammas),
    )


def _clear(reg) -> None:
    with reg._lock:
        reg._counters.clear()
        reg._gauges.clear()
        reg._histograms.clear()


def _metrics(server_cls, eng) -> dict:
    """The speculation series of the engine's ``/metrics``, served by its
    package's OpenAI server."""
    eng._metrics_wall = 0.0
    eng._refresh_gauges()
    srv = server_cls(eng, model_name="tiny", port=0).start()
    try:
        with urllib.request.urlopen(f"http://{srv.host}:{srv.port}/metrics", timeout=30) as r:
            text = r.read().decode()
    finally:
        srv.stop()
    return {line.split()[0]: float(line.split()[1]) for line in text.splitlines()
            if line.startswith("mtpu_spec_")}


@pytest.mark.parametrize("mode,kv,adaptive", GRID, ids=GRID_IDS)
def test_spec_engine_matches_the_jax_engine_tick_by_tick(weights, mode, kv, adaptive):
    (jcfg, tcfg, jparams, tparams), _ = weights
    _clear(default_registry)
    _clear(jax_registry)
    kw = dict(ENGINE_KW, kv_dtype=kv, spec_adaptive=adaptive)
    runs = {}
    for side, cls, P, cfg, params, server in (
        ("jax", JaxEngine, JaxParams, jcfg, jparams, JaxServer),
        ("port", LLMEngine, SamplingParams, tcfg, tparams, OpenAIServer),
    ):
        extra = {} if side == "jax" else {"device": "cpu"}
        eng = cls(cfg, params, clock=FakeClock(), **kw, **extra, **_spec_kw(weights, mode, side))
        eng.saved_before = _steps_saved(eng)
        eng._metrics_wall = float("inf")  # no gauge refresh until the burst is done
        gammas = _record_gammas(eng)
        try:
            reqs = [eng.submit(p, P(**sp)) for p, sp in BURST]
            states = []
            for _ in range(TICKS):
                eng.step()
                states.append(_state(eng, reqs, gammas))
            metrics = _metrics(server, eng)  # the server stops the engine
        finally:
            eng.stop()
        leftover = eng.cache.occupancy()["pages_used"] - eng.prefix_cache.cached_pages
        runs[side] = (states, [_finish_of(r) for r in reqs], leftover, metrics, eng)
    for t, (j, p) in enumerate(zip(runs["jax"][0], runs["port"][0])):
        assert p == j, f"tick {t}: port {p} != jax {j}"
    assert runs["port"][1] == runs["jax"][1]
    assert all(r in ("stop", "length") for r in runs["port"][1])
    assert runs["port"][2] == runs["jax"][2] == 0  # every page back
    assert runs["port"][3] == runs["jax"][3]
    final, eng = runs["port"][0][-1], runs["port"][4]
    assert final[9] > 0  # rounds ran
    assert runs["port"][3][C.SPEC_PROPOSED_TOTAL] == eng.stats.spec_proposed > 0
    assert runs["port"][3][C.SPEC_ACCEPTED_TOTAL] == eng.stats.spec_accepted
    if mode == "self":
        assert eng.stats.acceptance_rate() > 0.95
    if mode == "draft" and adaptive:
        assert final[10] > 0 and runs["port"][3][C.SPEC_FALLBACK_TOTAL] == final[10]


# -- the port against itself ---------------------------------------------------------

SELF_KW = dict(max_slots=2, max_model_len=128, page_size=8, prefill_buckets=(16, 32), seed=0, device="cpu")
PROMPTS = ["counting one two three", "one two one two one two", "red blue red blue red", "the tiny engine test"]


@pytest.mark.parametrize("mode", ["draft", "ngram"])
def test_greedy_spec_engine_is_token_identical_to_the_plain_engine(weights, mode):
    """Greedy rows commit only the target's argmax; sampled rows (top_p too)
    never speculate and keep their (seed, position)-keyed tokens."""
    (_, tcfg, _, tparams), (_, dtcfg, _, dtparams) = weights
    spec = dict(speculative=("ngram", 4)) if mode == "ngram" else dict(speculative=(dtcfg, 3), draft_params=dtparams)
    plain = LLMEngine(tcfg, tparams, **SELF_KW)
    eng = LLMEngine(tcfg, tparams, **SELF_KW, **spec)
    try:
        for p in [SamplingParams(max_tokens=24, temperature=0.0),
                  SamplingParams(max_tokens=12, temperature=0.8, top_p=0.5, seed=7)]:
            for prompt in PROMPTS:
                assert eng.generate(prompt, p) == plain.generate(prompt, p), (prompt, p)
        assert eng.stats.spec_proposed > 0
        if mode == "ngram":
            assert eng.stats.spec_accepted > 0  # repetition makes lookups fire and land
        assert eng.error_count == 0, eng.error_log
    finally:
        plain.stop()
        eng.stop()


def test_hostile_draft_retreats_to_fallbacks(weights):
    """A random draft under the adaptive controller: acceptance collapses,
    whole rounds fall back to the decode block, tokens stay the plain
    engine's."""
    (_, tcfg, _, tparams), (_, dtcfg, _, dtparams) = weights
    plain = LLMEngine(tcfg, tparams, **SELF_KW)
    eng = LLMEngine(tcfg, tparams, **SELF_KW, speculative=(dtcfg, 4), draft_params=dtparams, spec_adaptive=True)
    try:
        assert eng.spec_adaptive is True
        sp = SamplingParams(max_tokens=40, temperature=0.0)
        prompt = "the quick brown fox jumps over the lazy dog and naps in the sun"
        assert eng.generate(prompt, sp) == plain.generate(prompt, sp)
        assert eng.stats.acceptance_rate() < 0.6
        assert eng._spec_fallbacks > 0
    finally:
        plain.stop()
        eng.stop()


def test_self_draft_keeps_full_depth(weights):
    (_, tcfg, _, tparams), _ = weights
    eng = LLMEngine(tcfg, tparams, **SELF_KW, speculative=(tcfg, 4), draft_params=tparams, spec_adaptive=True)
    try:
        eng.generate("the quick brown fox jumps", SamplingParams(max_tokens=24, temperature=0.0))
        assert eng.stats.acceptance_rate() > 0.95
        assert eng._spec_fallbacks == 0 and eng._spec_rounds > 0
        assert eng._spec_round_tokens / eng._spec_rounds > 2.0
    finally:
        eng.stop()


def test_spec_depth_is_runtime_mutable(weights):
    (_, tcfg, _, tparams), _ = weights
    eng = LLMEngine(tcfg, tparams, **SELF_KW, speculative=("ngram", 4))
    try:
        sp = SamplingParams(max_tokens=16, temperature=0.0)
        want = eng.generate("one two one two one two", sp)
        rounds = eng._spec_rounds
        assert rounds > 0
        eng.spec_depth = 0  # speculation off: every round falls back
        assert eng.generate("one two one two one two", sp) == want
        assert eng._spec_rounds == rounds and eng._spec_fallbacks > 0
        eng.spec_depth = eng.spec_gamma
        assert eng.generate("one two one two one two", sp) == want
        assert eng._spec_rounds > rounds
    finally:
        eng.stop()


REFUSALS = [
    (dict(speculative=("ngram", 0)), "gamma"),
    (dict(speculative=("ngram", 2), draft_params={}), "incompatible"),
    (dict(speculative=("ngram", 2), draft_model_dir="/nonexistent"), "incompatible"),
    (dict(speculative=("llama9", 2)), "unknown draft preset"),
    (dict(speculative=("llama2-7b", 2)), "vocab_size"),
]


@pytest.mark.parametrize("kw,match", REFUSALS, ids=["gamma", "ngram-params", "ngram-dir", "preset", "vocab"])
def test_the_constructor_refuses_as_the_jax_engine(weights, kw, match):
    (jcfg, tcfg, jparams, tparams), _ = weights
    with pytest.raises(ValueError, match=match):
        JaxEngine(jcfg, jparams, max_slots=2, max_model_len=64, **kw)
    with pytest.raises(ValueError, match=match):
        LLMEngine(tcfg, tparams, max_slots=2, max_model_len=64, device="cpu", **kw)


def test_draft_model_dir_loads_the_checkpoint(weights, tmp_path):
    """``draft_model_dir=`` reads the draft's own ``config.json`` and its
    weights (bf16 as stored); the engine serves the plain engine's greedy
    tokens with it."""
    (_, tcfg, _, tparams), (_, dtcfg, _, dtparams) = weights
    hf = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
          "gate": "mlp.gate_proj", "up": "mlp.up_proj", "down": "mlp.down_proj"}
    bf = {k: v.to(torch.bfloat16) for k, v in (("embed", dtparams["embed"]), ("final_norm", dtparams["final_norm"]),
                                                ("lm_head", dtparams["lm_head"]))}
    tensors = {"model.embed_tokens.weight": bf["embed"], "model.norm.weight": bf["final_norm"],
               "lm_head.weight": bf["lm_head"].T.contiguous()}
    for li, layer in enumerate(dtparams["layers"]):
        for name, key in hf.items():
            tensors[f"model.layers.{li}.{key}.weight"] = layer[name].to(torch.bfloat16).T.contiguous()
        tensors[f"model.layers.{li}.input_layernorm.weight"] = layer["attn_norm"].to(torch.bfloat16)
        tensors[f"model.layers.{li}.post_attention_layernorm.weight"] = layer["mlp_norm"].to(torch.bfloat16)
    save_file(tensors, tmp_path / "model.safetensors")
    (tmp_path / "config.json").write_text(json.dumps({
        "model_type": "llama", "vocab_size": dtcfg.vocab_size, "hidden_size": dtcfg.dim,
        "num_hidden_layers": dtcfg.n_layers, "num_attention_heads": dtcfg.n_heads,
        "num_key_value_heads": dtcfg.n_kv_heads, "intermediate_size": dtcfg.ffn_dim,
        "max_position_embeddings": dtcfg.max_seq_len,
    }))
    plain = LLMEngine(tcfg, tparams, **SELF_KW)
    eng = LLMEngine(tcfg, tparams, **SELF_KW, speculative=("tiny", 3), draft_model_dir=str(tmp_path))
    try:
        assert eng.draft_cfg == tllama.LlamaConfig.from_hf_config(tmp_path / "config.json")
        assert torch.equal(eng.draft_params["embed"], bf["embed"])
        assert torch.equal(eng.draft_params["layers"][0]["wq"], dtparams["layers"][0]["wq"].to(torch.bfloat16))
        sp = SamplingParams(max_tokens=12, temperature=0.0)
        assert eng.generate("counting one two three", sp) == plain.generate("counting one two three", sp)
        assert eng.stats.spec_proposed > 0
    finally:
        plain.stop()
        eng.stop()
