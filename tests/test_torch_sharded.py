"""The port's tensor-parallel dispatch (``ops/sharded.py``) and parameter
placement (``llama.partition_specs``/``shard_params``) against the JAX
package's, the counterparts of ``tests/test_sharded_pallas.py``.

Two CPU rank processes over gloo hold the port at TP=2, each on its local
kv heads; the JAX side runs in this process on a 2-device ``tensor`` mesh,
its Pallas kernels in interpret mode. Held:

- every wrapper at TP=2 against the JAX ``ops/sharded.py`` on ``mesh2``
  (f32, within 1e-5 of the largest value) and against the port's own
  fall-through with no mesh on every head. The scatter is bitwise against
  the JAX ``kv_scatter`` (eager), int8 pages too; against the jitted JAX
  sharded scatter its int8 data are bitwise and its scales within one ulp:
  XLA under ``jit`` turns ``amax / 127`` into a product with the
  reciprocal, which the eager reference and the port do not. Held:
  the ragged decode (f32 and int8 pages, prefixes across page edges; held
  against the JAX single-device ragged kernel, since the JAX sharded ragged
  tests are a standing reference failure), the scatter, flash and chunked
  flash, and the write-then-attend step and its read-only twin;
- a head count the degree does not divide raises, as in JAX, and so does a
  shard of the wrong width;
- ``paged_impl_plan(mesh=)`` against the JAX plan table
  (``tests/test_sharded_pallas.py:225-277``): the same variant and ``tp``
  wherever the JAX plan runs the kernel, a ValueError where it downgrades;
- ``partition_specs`` equal to the JAX specs, and each rank's
  ``shard_params`` block bitwise equal to the JAX ``_shard_params`` tree's
  addressable shard on that device, for bf16, int8 and int4 weights (an
  int4 weight split on its contraction rows keeps whole bytes).
"""

import types

import numpy as np
import pytest

from test_torch_time_limit import share_cores, time_limits
import torch_rank_cases as cases

share_cores()

_limit_module, _limit_test = time_limits(test_s=90, module_s=150)
gang = cases.gang_fixture(2)


@pytest.fixture(scope="module")
def jax(jax_cpu):
    return jax_cpu


@pytest.fixture(scope="module")
def mesh2(jax):
    from modal_examples_tpu.parallel import make_mesh

    return make_mesh({"tensor": 2}, devices=jax.devices()[:2])


def _side(p):
    from modal_examples_tpu.ops.kv_quant import is_quantized

    return (np.asarray(p.data), np.asarray(p.scale)) if is_quantized(p) else (np.asarray(p), None)


@pytest.fixture(scope="module", params=["float32", "int8"])
def op_run(request, jax, mesh2, gang):
    """The JAX references and both ranks' outputs for one kv dtype."""
    import jax.numpy as jnp

    from modal_examples_tpu.ops import kv_quant as jkv
    from modal_examples_tpu.ops import paged_attention as jpa
    from modal_examples_tpu.ops import sharded as jsh

    kv_dtype = request.param
    rng = np.random.default_rng(7)
    L, Pn, ps, Hkv, D, B, Hq = 2, 9, 16, 2, 8, 2, 4

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    k, v = normal(L, Pn, ps, Hkv, D), normal(L, Pn, ps, Hkv, D)
    kp, vp = (jkv.quantize_kv(jnp.asarray(k)), jkv.quantize_kv(jnp.asarray(v))) if kv_dtype == "int8" else (
        jnp.asarray(k), jnp.asarray(v))
    tables = (1 + np.arange(B * 4).reshape(B, 4)).astype(np.int32)
    prefix = np.array([17, 33], np.int32)
    pos = np.array([17, 33], np.int32)
    inp = {
        "heads": (Hq, Hkv), "kp": _side(kp), "vp": _side(vp), "q": normal(B, Hq, D), "k_new": normal(B, Hkv, D),
        "v_new": normal(B, Hkv, D), "tables": tables, "prefix": prefix, "k_all": normal(L, 3, Hkv, D),
        "v_all": normal(L, 3, Hkv, D), "page_idx": np.array([1, 3, 5], np.int32),
        "slot": np.array([0, 7, 15], np.int32), "fq": normal(B, Hq, 32, 32), "fk": normal(B, Hkv, 32, 32),
        "fv": normal(B, Hkv, 32, 32), "ctx": pos + 1, "w_page": tables[np.arange(B), pos // ps],
        "w_slot": (pos % ps).astype(np.int32),
    }
    a = {k_: jnp.asarray(v_) for k_, v_ in inp.items() if isinstance(v_, np.ndarray)}
    want = {
        "scatter_eager": (jkv.kv_scatter(kp, a["k_all"], a["page_idx"], a["slot"]),
                          jkv.kv_scatter(vp, a["v_all"], a["page_idx"], a["slot"])),
        "ragged": jpa.paged_decode_attention_ragged(a["q"], kp, vp, jnp.int32(1), a["tables"], a["prefix"],
                                                     a["k_new"], a["v_new"], variant="grouped"),
        "scatter": jax.jit(lambda *x: jsh.sharded_scatter_kv_pages(mesh2, *x))(
            kp, vp, a["k_all"], a["v_all"], a["page_idx"], a["slot"]),
        "flash": jax.jit(lambda q, k_, v_: jsh.sharded_flash_attention(mesh2, q, k_, v_))(a["fq"], a["fk"], a["fv"]),
        "chunked": jax.jit(lambda q, k_, v_: jsh.sharded_flash_attention_chunked(mesh2, q, k_, v_, q_offset=16))(
            a["fq"][:, :, 16:], a["fk"], a["fv"]),
    }
    wk = jkv.kv_scatter(kp[0], a["k_new"], a["w_page"], a["w_slot"], leading_layer=False)
    wv = jkv.kv_scatter(vp[0], a["v_new"], a["w_page"], a["w_slot"], leading_layer=False)
    want["wta"] = jax.jit(lambda q, k_, v_: jsh.sharded_paged_decode_attention(
        mesh2, q, k_, v_, a["tables"], a["ctx"], impl="xla"))(a["q"], wk, wv)
    want["wk"] = _side(wk)
    return kv_dtype, want, gang.run(cases.sharded_ops, inp)


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, float(np.abs(want).max())), rtol=0)


def _heads(a, axis, r):
    return np.split(np.asarray(a), 2, axis=axis)[r]


def test_ragged_decode_at_tp2(op_run):
    _, want, out = op_run
    for r, o in enumerate(out):
        _close(o["tp"]["ragged"], _heads(want["ragged"], 1, r))
        _close(o["tp"]["ragged"], _heads(o["none"]["ragged"], 1, r))


def test_scatter_at_tp2_is_bitwise(op_run):
    _, want, out = op_run
    for r, o in enumerate(out):
        for side in ("k_pages", "v_pages"):
            got, none = o["tp"][side], o["none"][side]
            eager = _side(want["scatter_eager"][side == "v_pages"])
            sharded = _side(want["scatter"][side == "v_pages"])
            for i in (0, 1) if eager[1] is not None else (0,):
                np.testing.assert_array_equal(got[i], _heads(eager[i], 3, r))
                np.testing.assert_array_equal(got[i], _heads(none[i], 3, r))
            np.testing.assert_array_equal(got[0], _heads(sharded[0], 3, r))
            if sharded[1] is not None:
                ulps = np.abs(got[1].view(np.int32) - _heads(sharded[1], 3, r).view(np.int32))
                assert ulps.max() <= 1


@pytest.mark.parametrize("op", ["flash", "chunked"])
def test_flash_at_tp2(op_run, op):
    _, want, out = op_run
    for r, o in enumerate(out):
        _close(o["tp"][op], _heads(want[op], 1, r))
        np.testing.assert_array_equal(o["tp"][op], _heads(o["none"][op], 1, r))


def test_write_then_attend_at_tp2(op_run):
    _, want, out = op_run
    for r, o in enumerate(out):
        _close(o["tp"]["wta"], _heads(want["wta"], 1, r))
        _close(o["tp"]["read"], o["tp"]["wta"])
        np.testing.assert_array_equal(o["tp"]["wk"][0], _heads(want["wk"][0], 2, r))
        _close(o["tp"]["wta"], _heads(o["none"]["wta"], 1, r))


def test_indivisible_heads_raise(jax, gang):
    import jax.numpy as jnp

    from modal_examples_tpu.ops import sharded_ragged_decode
    from modal_examples_tpu.parallel import make_mesh

    mesh4 = make_mesh({"tensor": 4}, devices=jax.devices()[:4])
    kp = jnp.zeros((1, 5, 16, 2, 8), jnp.float32)
    with pytest.raises(ValueError, match="divisible"):
        sharded_ragged_decode(mesh4, jnp.zeros((1, 4, 8), jnp.float32), kp, kp, jnp.int32(0),
                              jnp.zeros((1, 4), jnp.int32), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 2, 8)),
                              jnp.zeros((1, 2, 8)))
    for msgs in gang.run(cases.sharded_refusals):
        assert "n_kv_heads=3 is not divisible" in msgs[0]
        assert "is not 8/2" in msgs[1]
        assert "n_heads=3 is not divisible" in msgs[2]


def _stub_mesh(tp):
    return None if tp == 1 else types.SimpleNamespace(mesh_dim_names=("tensor",), shape=(tp,))


@pytest.mark.parametrize(
    "n_kv_heads,n_heads,tp,kv_dtype,want_attn,want_variant",
    [
        (32, 32, 1, "bfloat16", "ragged", "flat"),
        (32, 32, 2, "bfloat16", "ragged", "flat"),
        (16, 32, 2, "bfloat16", "ragged", "grouped"),
        (32, 32, 1, "int8", "ragged", "flat"),
        (32, 32, 2, "int8", "ragged", "grouped"),
        (8, 32, 2, "bfloat16", "ragged", "grouped"),
        (2, 4, 2, "float32", "ragged", "grouped"),
        (2, 4, 4, "bfloat16", "xla-gather", None),
    ],
)
def test_plan_table_matches_jax(jax, n_kv_heads, n_heads, tp, kv_dtype, want_attn, want_variant):
    from modal_examples_tpu.models import llama as jllama
    from modal_examples_tpu.parallel import make_mesh
    from modal_examples_tpu_torch.models import llama as tllama

    kw = dict(vocab_size=128, dim=n_heads * 128, n_layers=1, n_heads=n_heads, n_kv_heads=n_kv_heads, ffn_dim=128)
    jmesh = make_mesh({"tensor": tp}, devices=jax.devices()[:tp]) if tp > 1 else None
    jplan = jllama.paged_impl_plan(jllama.LlamaConfig(**kw), 16, "pallas", "pallas", kv_dtype=kv_dtype, mesh=jmesh,
                                   warn=False)
    assert (jplan["attention"], jplan["ragged_variant"], jplan["tp"]) == (want_attn, want_variant, tp)
    cfg = tllama.LlamaConfig(**kw)
    if want_attn == "xla-gather":  # the JAX plan's way around the kernel; the port refuses the shape
        with pytest.raises(ValueError, match="not divisible by tp=4"):
            tllama.paged_impl_plan(cfg, "cpu", kv_dtype, impl="pallas", scatter_impl="pallas", mesh=_stub_mesh(tp))
        return
    plan = tllama.paged_impl_plan(cfg, "cpu", kv_dtype, impl="pallas", scatter_impl="pallas", mesh=_stub_mesh(tp))
    assert (plan["attention"], plan["ragged_variant"], plan["tp"], plan["downgraded"]) == (
        "ragged", want_variant, tp, [])


@pytest.mark.parametrize("moe", [False, True])
def test_partition_specs_match_jax(jax, moe):
    from modal_examples_tpu.models import llama as jllama
    from modal_examples_tpu_torch.models import llama as tllama

    kw = dict(vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128, n_experts=4 if moe else 0)
    for tie in (False, True):
        want = jllama.partition_specs(jllama.LlamaConfig(**kw, tie_embeddings=tie))
        got = tllama.partition_specs(tllama.LlamaConfig(**kw, tie_embeddings=tie))
        assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
        for k in got:
            if k != "layers":
                assert tuple(got[k]) == tuple(want[k]), k
        for k in got["layers"]:
            assert tuple(got["layers"][k]) == tuple(want["layers"][k]), k


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_shard_params_equals_the_jax_shards(jax, mesh2, gang, quant):
    from modal_examples_tpu.models import llama as jllama
    from modal_examples_tpu.models import quantize as jquant
    from modal_examples_tpu.models.quantize import QuantizedWeight as JQ
    from modal_examples_tpu.serving.engine import _shard_params

    kw = dict(vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128, max_seq_len=128)
    cfg = jllama.LlamaConfig(**kw)
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    if quant:
        params = jquant.quantize_llama(params, bits=jquant.bits_of(quant))
    sharded = _shard_params(params, cfg, mesh2)
    devs = list(mesh2.devices.ravel())

    def shard(arr, r):
        (s,) = [s for s in arr.addressable_shards if s.device == devs[r]]
        return np.asarray(s.data)

    def to_np(w):
        if isinstance(w, JQ):
            return JQ(q=np.asarray(w.q), scale=np.asarray(w.scale))
        return np.asarray(w)

    def check(leaf, want, r, li, name):
        take = (lambda a: a) if li is None else (lambda a: a[li])
        if isinstance(want, JQ):
            vals, scale, bits = leaf
            assert bits == (4 if quant == "int4" else 8)
            np.testing.assert_array_equal(vals, take(shard(want.q, r)).astype(np.int8), err_msg=name)
            np.testing.assert_array_equal(scale, take(shard(want.scale, r)), err_msg=name)
        else:
            np.testing.assert_array_equal(leaf, take(shard(want, r)).astype(np.float32), err_msg=name)

    out = gang.run(cases.shard_params_of, jax.tree.map(to_np, params, is_leaf=lambda x: isinstance(x, JQ)),
                   {**kw, "dtype": "bfloat16"})
    for r, got in enumerate(out):
        for name in ("embed", "lm_head", "final_norm"):
            check(got[name], sharded[name], r, None, name)
        for li, layer in enumerate(got["layers"]):
            for name, leaf in layer.items():
                check(leaf, sharded["layers"][name], r, li, name)
