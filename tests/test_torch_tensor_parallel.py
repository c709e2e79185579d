"""The port's tensor-parallel serving against the JAX package's, the
counterparts of ``tests/test_tensor_parallel.py:93-400``.

Two CPU rank processes over gloo run the port at TP=2: rank 0's
``LLMEngine(mesh=)`` decides everything and ships each device call to rank
1, which follows (``serving.engine.follow``). The JAX side runs here on a
2-device ``tensor`` mesh. Weights are the JAX ``init_params`` draw carried
across with ``llama.params_from_jax`` and cut by ``shard_params``. In f32:

- the model: prefill and two decode steps (read-only and write-then-attend
  structures, f32 and int8 pages) within 1e-3 of the JAX TP=2 run and of
  the one-rank port; the TP forward within 1e-3 of the one-rank forward;
- the engine against the JAX TP engine: tokens, stream pieces, finish
  reasons and pages returned exactly, and a replay equal to the first run;
- the engine over int8 pages, the write-then-attend structure, int8 and
  int4 weights against the one-rank port's engine: tokens and finish
  reasons exactly, pages returned, ``tp="2"`` on ``/metrics``, one kv head
  a rank;
- a tiny MoE at TP=2 against the JAX MoE engine on ``mesh2``;
- a hand-stepped burst under a fake clock, one deadline expiring
  mid-decode: the follower ran exactly rank 0's calls with the same inputs;
- the options whose tensor-parallel form waits raise, and so does an
  engine without a process group;
- the dense path: ``decode_step_dense`` and ``generate_tp`` (f32 and int8
  caches) against the JAX ones on ``mesh2``.
"""

import dataclasses
import functools

import numpy as np
import pytest

from test_torch_time_limit import share_cores, time_limits
import torch_rank_cases as cases

share_cores()

_limit_module, _limit_test = time_limits(test_s=150, module_s=240)
gang = cases.gang_fixture(2)

CFG = dict(vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128, max_seq_len=128, dtype="float32")
ENGINE_KW = dict(max_slots=2, max_model_len=64, page_size=16, prefill_buckets=(32,), seed=0, enable_prefix_cache=False)
BURST = [
    ("sharded decode test", dict(max_tokens=10, temperature=0.0)),
    ("one flag not a fork", dict(max_tokens=8, temperature=0.8, seed=7)),
    ("q" * 45, dict(max_tokens=6, temperature=0.0)),  # longer than the bucket: chunked
    ("the last one", dict(max_tokens=5, temperature=0.0, stop=("zz",))),
]


@pytest.fixture(scope="module")
def jax(jax_cpu):
    return jax_cpu


@pytest.fixture(scope="module")
def mesh2(jax):
    from modal_examples_tpu.parallel import make_mesh

    return make_mesh({"tensor": 2}, devices=jax.devices()[:2])


@pytest.fixture(scope="module")
def weights(jax):
    from modal_examples_tpu.models import llama as jllama

    jcfg = jllama.LlamaConfig(**CFG)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, jax.tree.map(np.asarray, jparams)


def _jax_tp_logits(jax, mesh, jparams, jcfg, kv_dtype, impl, inp):
    import jax.numpy as jnp

    from modal_examples_tpu.models import llama as jllama
    from modal_examples_tpu.ops.kv_quant import kv_empty
    from modal_examples_tpu.ops.sharded import shard_cache_pages
    from modal_examples_tpu.serving.engine import _shard_params

    shape = (jcfg.n_layers, inp["n_pages"], inp["page_size"], jcfg.n_kv_heads, jcfg.head_dim)
    kvd = "int8" if kv_dtype == "int8" else jnp.float32
    kp, vp = shard_cache_pages(mesh, kv_empty(shape, kvd), kv_empty(shape, kvd))
    params = _shard_params(jparams, jcfg, mesh)
    tables, lens = jnp.asarray(inp["tables"]), jnp.asarray(inp["lens"])
    pre, kp, vp = jax.jit(functools.partial(jllama.prefill, cfg=jcfg, mesh=mesh))(
        params, jnp.asarray(inp["tokens"]), kp, vp, tables, lens)
    step = jax.jit(functools.partial(jllama.decode_step, cfg=jcfg, impl=impl, mesh=mesh))
    out, tok, pos = [np.asarray(pre)], jnp.argmax(pre, -1).astype(jnp.int32), lens
    for _ in range(2):
        d, kp, vp = step(params, tok, pos, kp, vp, tables, jnp.ones(lens.shape, bool))
        out.append(np.asarray(d))
        tok, pos = jnp.argmax(d, -1).astype(jnp.int32), pos + 1
    return out


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("impl", ["xla", "xla-writeback"])
def test_tp2_logits_match_jax_tp2_and_one_rank(jax, mesh2, gang, weights, kv_dtype, impl):
    from modal_examples_tpu.models import llama as jllama

    jcfg, jparams, np_params = weights
    rng = np.random.default_rng(3)
    inp = {"tokens": rng.integers(0, 512, (2, 16)).astype(np.int32), "lens": np.array([12, 16], np.int32),
           "tables": (1 + np.arange(8).reshape(2, 4)).astype(np.int32), "n_pages": 9, "page_size": 16}
    want = _jax_tp_logits(jax, mesh2, jparams, jcfg, kv_dtype, impl, inp)
    fwd = np.asarray(jllama.forward(jparams, jax.numpy.asarray(inp["tokens"]), jcfg, attn_impl="xla"))
    for out in gang.run(cases.tp_model_logits, np_params, CFG, kv_dtype, impl, inp):
        for got, one, ref in zip(out["tp"][:3], out["one"][:3], want):
            assert np.abs(got - ref).max() < 1e-3
            assert np.abs(got - one).max() < 1e-3
        assert np.abs(out["tp"][3] - out["one"][3]).max() < 1e-3
        assert np.abs(out["tp"][3] - fwd).max() < 1e-3


def _jax_serve(eng, burst):
    from modal_examples_tpu.serving.sampling import SamplingParams as JaxParams

    reqs = [eng.submit(p, JaxParams(**kw)) for p, kw in burst]
    pieces = [list(eng.stream(r)) for r in reqs]
    return {"tokens": [list(r.generated_tokens) for r in reqs], "finish": [r.finish_reason for r in reqs],
            "pieces": pieces, "prompts": [list(r.prompt_tokens) for r in reqs]}


@pytest.fixture(scope="module")
def jax_tp_run(jax, mesh2, weights):
    import jax.numpy as jnp

    from modal_examples_tpu.serving.engine import LLMEngine as JaxEngine

    jcfg, jparams, _ = weights
    eng = JaxEngine(jcfg, jparams, mesh=mesh2, kv_dtype=jnp.float32, **ENGINE_KW)
    try:
        out = _jax_serve(eng, BURST)
        out["pages_back"] = eng.cache.allocator.available == eng.cache.n_pages - 1
        out["replay"] = _jax_serve(eng, BURST[:1])["tokens"][0]
    finally:
        eng.stop()
    return out


@pytest.fixture(scope="module")
def port_tp_run(gang, weights):
    _, _, np_params = weights
    return gang.run(cases.tp_engine_serve, np_params, CFG, dict(ENGINE_KW, kv_dtype="float32"), BURST + BURST[:1])


def test_tp_engine_matches_the_jax_tp_engine(jax_tp_run, port_tp_run):
    out = port_tp_run[0]
    n = len(BURST)
    assert out["prompts"][:n] == jax_tp_run["prompts"]
    assert out["tokens"][:n] == jax_tp_run["tokens"]
    assert out["pieces"][:n] == jax_tp_run["pieces"]
    assert out["finish"][:n] == jax_tp_run["finish"]
    assert out["pages_back"] and jax_tp_run["pages_back"]


def test_tp_engine_replays_deterministically(jax_tp_run, port_tp_run):
    out = port_tp_run[0]
    assert out["tokens"][-1] == out["tokens"][0] == jax_tp_run["replay"]


def test_tp_engine_equals_the_one_rank_engine(port_tp_run):
    out = port_tp_run[0]
    assert out["tokens"] == out["one"]["tokens"]
    assert out["finish"] == out["one"]["finish"]


def test_follower_ran_rank_zeros_calls(port_tp_run):
    lead, follower = port_tp_run[0]["journal"], port_tp_run[1]["journal"]
    assert lead and lead == follower
    names = {name for name, _ in lead}
    assert {"prefill", "prefill_chunk", "sample_first", "decode_block"} <= names


def test_tp_engine_reports_the_sharded_plan(port_tp_run):
    out = port_tp_run[0]
    assert out["plan"]["tp"] == 2 and out["plan"]["ragged_variant"] == "grouped"
    assert out["local_kv_heads"] == 1
    assert 'tp="2"' in out["metrics"]


VARIANTS = {
    "int8-pages": dict(kv_dtype="int8"),
    "writeback": dict(kv_dtype="float32", paged_impl="xla-writeback"),
    "int8-writeback": dict(kv_dtype="int8", paged_impl="pallas-writeback"),
    "int8-weights": dict(kv_dtype="float32", quantization="int8"),
    "int4-weights": dict(kv_dtype="float32", quantization="int4"),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_tp_engine_variants_equal_the_one_rank_engine(gang, weights, variant):
    _, _, np_params = weights
    kw = dict(VARIANTS[variant])
    quant = kw.pop("quantization", None)
    out, follower = gang.run(cases.tp_engine_serve, np_params, CFG, dict(ENGINE_KW, **kw), BURST, quant)
    assert out["tokens"] == out["one"]["tokens"]
    assert out["finish"] == out["one"]["finish"]
    assert out["pages_back"]
    assert out["journal"] == follower["journal"]
    assert out["plan"]["tp"] == 2 and 'tp="2"' in out["metrics"]
    assert out["plan"]["weights"] == (quant or "float32")


def test_moe_engine_tp2_matches_the_jax_moe_engine(jax, mesh2, gang):
    import jax.numpy as jnp

    from modal_examples_tpu.models import llama as jllama
    from modal_examples_tpu.serving.engine import LLMEngine as JaxEngine

    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny_moe(), dtype="float32")
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    burst = [("moe sharded decode", dict(max_tokens=12, temperature=0.0)),
             ("expert routing test", dict(max_tokens=12, temperature=0.0))]
    eng = JaxEngine(jcfg, jparams, mesh=mesh2, kv_dtype=jnp.float32, **ENGINE_KW)
    try:
        want = _jax_serve(eng, burst)
    finally:
        eng.stop()
    cfg_kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    out, _ = gang.run(cases.tp_engine_serve, jax.tree.map(np.asarray, jparams), cfg_kw,
                      dict(ENGINE_KW, kv_dtype="float32"), burst)
    assert out["tokens"] == want["tokens"] == out["one"]["tokens"]
    assert out["finish"] == want["finish"]


def test_deadline_under_a_fake_clock_leaves_the_follower_in_step(gang, weights):
    _, _, np_params = weights
    kw = dict(ENGINE_KW, kv_dtype="float32", prefill_buckets=(16, 32))
    (lead, (finish, tokens)), (follower, _) = gang.run(cases.tp_deadline_journal, np_params, CFG, kw)
    assert finish == ["deadline", "length", "length"]
    assert 0 < tokens[0] < 24 and tokens[1:] == [10, 6]
    assert lead == follower and len(lead) > 4


def test_follower_builds_from_rank_zeros_settings_not_its_environment(gang, weights):
    _, _, np_params = weights
    env = {"MTPU_KV_DTYPE": "int8", "MTPU_PAGED_IMPL": "xla-writeback", "MTPU_SCATTER_IMPL": "pallas"}
    kw = dict(ENGINE_KW, n_pages=9, decode_block=4)
    lead, follower = gang.run(cases.tp_follower_settings, np_params, CFG, kw, env, BURST[:2])
    got = follower["settings"]
    assert (got["kv_dtype"], got["paged_impl"], got["scatter_impl"]) == ("bfloat16", "xla", "xla")
    assert (got["kv_dtype"], got["paged_impl"], got["scatter_impl"]) == (
        lead["kv_dtype"], lead["paged_impl"], lead["scatter_impl"])
    assert (got["n_pages"], got["page_size"], got["decode_block"], got["seed"]) == (9, 16, 4, 0)
    assert (got["n_pages"], got["decode_block"]) == (lead["n_pages"], lead["decode_block"])
    assert got["weights"] == "given"
    assert lead["journal"] == follower["journal"]
    assert lead["tokens"] == lead["one"]["tokens"]


def test_tp_engine_refusals(gang, weights):
    _, _, np_params = weights
    for msgs in gang.run(cases.tp_engine_refusals, np_params, CFG):
        assert "ROADMAP A10b" in msgs["speculative"]
        assert "ROADMAP A10b" in msgs["macro-step"]
        assert "ROADMAP A10b" in msgs["tiered"]
        assert "divisible by the tensor axis size 2" in msgs["heads"]


def test_tp_engine_without_a_process_group_raises(weights):
    import types

    from modal_examples_tpu_torch.models import llama as tllama
    from modal_examples_tpu_torch.serving.engine import LLMEngine

    mesh = types.SimpleNamespace(mesh_dim_names=("tensor",), shape=(2,))
    with pytest.raises(RuntimeError, match="process group"):
        LLMEngine(tllama.LlamaConfig(**CFG), device="cpu", mesh=mesh, **ENGINE_KW)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_dense_tp_path_matches_jax(jax, mesh2, gang, weights, kv_dtype):
    import jax.numpy as jnp

    from modal_examples_tpu.serving import tensor_parallel as jtp

    jcfg, jparams, np_params = weights
    prompts = np.random.default_rng(5).integers(0, 512, (2, 8)).astype(np.int32)
    lens = np.array([8, 5], np.int32)
    sharded = jtp.shard_params_tp(jparams, jcfg, mesh2)
    cache = jtp.DenseKVCache.create(jcfg, 2, 32, mesh2, dtype=jnp.float32, kv_dtype=kv_dtype)
    want_logits, _ = jtp.decode_step_dense(sharded, jnp.asarray(prompts[:, 0]), cache, jnp.zeros((2,), jnp.int32), jcfg)
    want = np.asarray(jtp.generate_tp(jparams, jcfg, jnp.asarray(prompts), jnp.asarray(lens), 6, mesh=mesh2,
                                      max_len=32, kv_dtype=kv_dtype))
    for out in gang.run(cases.dense_tp, np_params, CFG, prompts, lens, 6, kv_dtype):
        assert out["cache_heads"] == 1
        assert np.abs(out["logits"] - np.asarray(want_logits)).max() < 1e-4
        np.testing.assert_array_equal(out["gen_tp"], want)
        np.testing.assert_array_equal(out["gen_one"], want)
