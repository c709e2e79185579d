"""The port's speculative decoding against the JAX package's, piece by piece.

- ``paged_verify_attention`` (the plain twin of the verify route) against the
  JAX ``reference.paged_verify_attention`` over f32, bf16 and int8 pages with
  f32 queries, within 1e-5 (bf16 pages: their output is bf16, so also one
  bf16 rounding of the value): a slot whose chain runs past the table's
  capacity and an inactive lane on trash page 0 included. The card's route
  (``verify_by_rows``: the write-then-attend decode over one row a chain
  position, here through its plain twins) against the same reference: f32 and
  int8 pages within 1e-5; bf16 pages within 1e-2 of each row's largest value
  (the bf16 kernel keeps its probabilities f32 where the reference rounds
  them to bf16).
- ``llama.verify_step`` against the JAX function (tiny f32): logits within
  1e-5 of their largest value, bf16 pages bitwise, int8 pages as the
  writeback decode's int8 test holds them (data within one step, scales
  within 1e-5); and against T sequential port write-then-attend
  ``decode_step`` calls, which read the current token back from the cache as
  the verify does.
- ``accept_reject`` and ``_emit_plane`` against the JAX functions on the same
  logits and keys: greedy lanes, sampled lanes with draft log-probs, the
  delta proposals of prompt lookup, all-false ``prop_valid`` rows, an
  inactive lane; ``out``, ``n_emit`` and the planes identical.
- ``sampling.uniform`` and ``categorical`` bitwise to ``jax.random``.
- Both round programs against the JAX ones on the same state (a random
  draft, a self-draft, prompt lookup; greedy lanes, a classic γ=0 lane, a
  lane near capacity, an inactive lane): ``toks``, ``valid`` and ``last``
  identical; target and draft pages one bf16 rounding apart on under 0.1%
  of their elements (bitwise elsewhere), int8 pages as above (page 0, the
  trash page, aside).
- The adaptive-γ controller, the ngram index and the single-sequence oracle
  against their JAX counterparts.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modal_examples_tpu.models import llama as jllama
from modal_examples_tpu.ops import kv_quant as jkv
from modal_examples_tpu.serving import speculative as jspec
from modal_examples_tpu.serving.engine import _NgramIndex as JaxNgramIndex
from modal_examples_tpu.serving.spec_runtime import controller as jctrl
from modal_examples_tpu.serving.spec_runtime import runtime as jrt
from modal_examples_tpu_torch.models import llama as tllama
from modal_examples_tpu_torch.ops import kv_quant as tkv
from modal_examples_tpu_torch.ops import paged_attention as tpa
from modal_examples_tpu_torch.ops import reference as tref
from modal_examples_tpu_torch.serving import sampling as tsampling
from modal_examples_tpu_torch.serving import speculative as tspec
from modal_examples_tpu_torch.serving.engine import _NgramIndex
from modal_examples_tpu_torch.serving.spec_runtime import controller as tctrl
from modal_examples_tpu_torch.serving.spec_runtime import runtime as trt
from test_torch_time_limit import share_cores

share_cores()

# the JAX package's ops/__init__ re-exports functions under their modules' names
jref = importlib.import_module("modal_examples_tpu.ops.reference")

PS, PPS, D = 8, 4, 32


def _tk(key) -> torch.Tensor:
    """A JAX key (uint32 [..., 2]) as the port's int64 key."""
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def _pages_pair(a: np.ndarray, kind: str):
    """(JAX pages, port pages) of one f32 array at ``kind``: float32,
    bfloat16, or int8 (quantized by the JAX function, the same values given
    to the port)."""
    if kind == "int8":
        j = jkv.quantize_kv(jnp.asarray(a))
        return j, tkv.QuantizedKV(torch.from_numpy(np.array(j.data)), torch.from_numpy(np.array(j.scale)))
    if kind == "bfloat16":
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _to_np(pages) -> np.ndarray:
    if tkv.is_quantized(pages):
        return np.concatenate([pages.data.numpy().astype(np.float32).ravel(), pages.scale.numpy().ravel()])
    return pages.float().numpy()


# -- the verify attention --------------------------------------------------------


def _verify_case(seed: int, hq: int, hkv: int, T: int = 3):
    """Four lanes over one layer's pages: chains starting at 0, 5 and 7, and
    one from capacity - 2 whose last position is past the table; lane 3 is
    inactive (its table all trash page 0)."""
    rng = np.random.default_rng(seed)
    B = 4
    n_pages = 1 + B * PPS
    tables = (rng.permutation(n_pages - 1)[: B * PPS] + 1).reshape(B, PPS).astype(np.int32)
    tables[3] = 0
    pos0 = np.array([0, 5, PPS * PS - 2, 7], np.int32)
    return dict(
        q=rng.standard_normal((B, T, hq, D)).astype(np.float32),
        kp=rng.standard_normal((n_pages, PS, hkv, D)).astype(np.float32),
        vp=rng.standard_normal((n_pages, PS, hkv, D)).astype(np.float32),
        tables=tables,
        positions=pos0[:, None] + np.arange(T, dtype=np.int32)[None, :],
    )


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
def test_paged_verify_attention_matches_jax(kind, hq, hkv):
    c = _verify_case(1, hq, hkv)
    jk, tk = _pages_pair(c["kp"], kind)
    jv, tv = _pages_pair(c["vp"], kind)
    ref = np.asarray(jref.paged_verify_attention(
        jnp.asarray(c["q"]), jk, jv, jnp.asarray(c["tables"]), jnp.asarray(c["positions"])), np.float32)
    got = tpa.paged_verify_attention(
        torch.from_numpy(c["q"]), tk, tv, torch.from_numpy(c["tables"]), torch.from_numpy(c["positions"]))
    assert got.shape == ref.shape
    # the output is at the pages' dtype: bf16 pages round it once (one bf16
    # ulp is at most 2^-7 of the value)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2**-7 if kind == "bfloat16" else 0, atol=1e-5)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_the_card_route_computes_the_verify_attention(kind):
    """``verify_by_rows`` on CPU tensors runs the card's route through the
    kernels' plain twins. f32 and int8 pages: the reference within 1e-5 (the
    int8 kernel rounds its probabilities as the reference does). bf16 pages
    and queries: within 1e-2 of each row's largest value, the tolerance of
    the write-then-attend kernel, whose probabilities stay f32."""
    c = _verify_case(2, 4, 2, T=5)
    dt = torch.bfloat16 if kind == "bfloat16" else torch.float32
    _, tk = _pages_pair(c["kp"], kind)
    _, tv = _pages_pair(c["vp"], kind)
    q, tables, positions = torch.from_numpy(c["q"]).to(dt), torch.from_numpy(c["tables"]), torch.from_numpy(c["positions"])
    ref = tref.paged_verify_attention(q, tk, tv, tables, positions).float()
    got = tpa.verify_by_rows(q, tk, tv, tables, positions).float()
    if kind == "bfloat16":
        row_err = (got - ref).abs().amax(-1) / ref.abs().amax(-1)
        assert row_err.max().item() <= 1e-2
    else:
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)


# -- the verify step ---------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32")
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype="float32")
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, tllama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


def _prefilled(cfg, jparams, kv_dtype: str, seed: int = 6, pps: int = 4, lens=(20, 13, 27)):
    """A cache of three prompts written by the JAX prefill, its page tables
    for four slots (the fourth claims nothing: all trash page 0), as JAX
    arrays."""
    rng = np.random.default_rng(seed)
    B = len(lens) + 1
    n_pages = 1 + B * pps
    tables = (rng.permutation(n_pages - 1)[: B * pps] + 1).reshape(B, pps).astype(np.int32)
    tables[-1] = 0
    shape = (cfg.n_layers, n_pages, PS, cfg.n_kv_heads, cfg.head_dim)
    tokens = rng.integers(0, cfg.vocab_size, (len(lens), 32)).astype(np.int32)
    _, jk, jv = jllama.prefill(
        jparams, jnp.asarray(tokens), jkv.kv_empty(shape, kv_dtype), jkv.kv_empty(shape, kv_dtype),
        jnp.asarray(tables[: len(lens)]), jnp.asarray(lens, jnp.int32), cfg,
    )
    return jk, jv, tables


def _port_pages(jpages):
    if isinstance(jpages, jkv.QuantizedKV):
        return tkv.QuantizedKV(torch.from_numpy(np.array(jpages.data)), torch.from_numpy(np.array(jpages.scale)))
    return torch.from_numpy(np.array(jpages, np.float32)).to(
        torch.bfloat16 if jpages.dtype == jnp.bfloat16 else torch.float32)


def _assert_pages_match(tpages, jpages, *, bitwise: bool = False):
    """Every page but page 0 (the trash page dead lanes write). The two
    frameworks' f32 K/V rows may differ in their last bit, which a rounding
    to the page dtype shows now and then: bf16 pages bitwise, or (after
    several layers and draft steps) one bf16 rounding apart on under 0.1% of
    their elements; int8 pages within one int8 step and their scales (a
    row's amax / 127) within 1e-5, as the writeback decode's int8 test holds
    them."""
    if tkv.is_quantized(tpages):
        np.testing.assert_allclose(tpages.scale.numpy()[:, 1:], np.asarray(jpages.scale)[:, 1:], rtol=1e-5)
        diff = np.abs(tpages.data.numpy()[:, 1:].astype(np.int32) - np.asarray(jpages.data)[:, 1:].astype(np.int32))
        assert diff.max() <= 1 and diff.mean() < 1e-3
        return
    got, want = tpages.float().numpy()[:, 1:], np.asarray(jpages, np.float32)[:, 1:]
    if bitwise:
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_allclose(got, want, rtol=2**-7, atol=0)
    assert (got != want).mean() < 1e-3


# chains from the prompts' ends; lane 2 starts 3 before the capacity of 32,
# so two of its positions go to the trash page; lane 3 is inactive
CHAIN = np.array([[5, 9, 2, 7, 1], [3, 3, 8, 0, 4], [11, 6, 6, 9, 2], [1, 2, 3, 4, 5]], np.int32)
POS0 = np.array([20, 13, PPS * PS - 3, 0], np.int32)
ACTIVE = np.array([True, True, True, False])


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_verify_step_matches_jax(model, kv_dtype):
    jcfg, tcfg, jparams, tparams = model
    jk, jv, tables = _prefilled(jcfg, jparams, kv_dtype)
    tk, tv = _port_pages(jk), _port_pages(jv)
    j_logits, jk, jv = jllama.verify_step(
        jparams, jnp.asarray(CHAIN), jnp.asarray(POS0), jk, jv, jnp.asarray(tables), jnp.asarray(ACTIVE), jcfg)
    t_logits, _, _ = tllama.verify_step(
        tparams, torch.from_numpy(CHAIN), torch.from_numpy(POS0), tk, tv, torch.from_numpy(tables),
        torch.from_numpy(ACTIVE), tcfg)
    ref = np.asarray(j_logits)
    assert t_logits.shape == ref.shape == (4, 5, tcfg.vocab_size)
    np.testing.assert_allclose(t_logits.numpy()[:3], ref[:3], rtol=0, atol=1e-5 * np.abs(ref).max())
    _assert_pages_match(tk, jk, bitwise=True)
    _assert_pages_match(tv, jv, bitwise=True)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_verify_step_equals_sequential_decode_steps(model, kv_dtype):
    """One verify over a T-token chain against T port write-then-attend
    ``decode_step`` calls (each writes its token, then reads it back from the
    cache, as the verify does): the same logits at the live lanes' positions
    and the same pages (page 0, the trash page, aside)."""
    jcfg, tcfg, jparams, tparams = model
    jk, jv, tables = _prefilled(jcfg, jparams, kv_dtype)
    pos0 = np.array([20, 13, 9, 0], np.int32)  # every chain inside its table
    k1, v1 = _port_pages(jk), _port_pages(jv)
    k2, v2 = _port_pages(jk), _port_pages(jv)
    t_tables, active = torch.from_numpy(tables), torch.from_numpy(ACTIVE)
    logits_v, _, _ = tllama.verify_step(tparams, torch.from_numpy(CHAIN), torch.from_numpy(pos0), k1, v1, t_tables,
                                        active, tcfg)
    seq = []
    for t in range(CHAIN.shape[1]):
        lg, _, _ = tllama.decode_step(tparams, torch.from_numpy(CHAIN[:, t]), torch.from_numpy(pos0 + t), k2, v2,
                                      t_tables, active, tcfg, impl="pallas-writeback")
        seq.append(lg)
    want = torch.stack(seq, dim=1)
    np.testing.assert_allclose(logits_v.numpy()[:3], want.numpy()[:3], rtol=0, atol=2e-4)
    for a, b in ((k1, k2), (v1, v2)):
        np.testing.assert_allclose(_to_np(a[:, 1:]), _to_np(b[:, 1:]), rtol=0, atol=2e-5)


# -- sampling -----------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1])
def test_uniform_and_categorical_are_jax_bit_for_bit(seed):
    key = jax.random.PRNGKey(seed)
    for shape in [(1,), (4, 3), (8, 5)]:
        ref = np.asarray(jax.random.uniform(key, shape))
        got = tsampling.uniform(_tk(key), shape).numpy()
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    logits = np.random.default_rng(seed % 1000).standard_normal((6, 97)).astype(np.float32) * 3
    ref = np.asarray(jax.vmap(jax.random.categorical)(jax.random.split(key, 6), jnp.asarray(logits)))
    got = tsampling.categorical(tsampling.split(_tk(key), 6), torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, ref)


# -- the accept/reject cut --------------------------------------------------------------


def _accept_case(seed: int, B: int = 6, gamma: int = 4, V: int = 40):
    """Target logits, proposals and draft log-probs for B lanes: lane 0
    proposes the target's argmax throughout, lane 1 up to a mismatch at 2,
    the rest random; the draft's log-probs near the target's, so sampled
    lanes accept some and reject some."""
    rng = np.random.default_rng(seed)
    t_logits = (rng.standard_normal((B, gamma + 1, V)) * 2).astype(np.float32)
    proposals = rng.integers(0, V, (B, gamma)).astype(np.int32)
    argmax = t_logits.argmax(-1)
    proposals[0] = argmax[0, :gamma]
    proposals[1, :2] = argmax[1, :2]
    proposals[1, 2] = (argmax[1, 2] + 1) % V
    d_logits = t_logits[:, :gamma] + rng.standard_normal((B, gamma, V)).astype(np.float32) * 0.5
    d_logps = np.asarray(jax.nn.log_softmax(jnp.asarray(d_logits), axis=-1))
    return t_logits, proposals, d_logps


_jax_accept_reject = jax.jit(jrt.accept_reject, static_argnames=("gamma",))


def _both_accept(t_logits, proposals, temps, seed, active, gamma, logps=None, prop_valid=None):
    keys = jax.random.split(jax.random.PRNGKey(seed), 2)
    j_out, j_n = _jax_accept_reject(
        jnp.asarray(t_logits), jnp.asarray(proposals), jnp.asarray(temps), (keys[0], keys[1]), jnp.asarray(active),
        gamma=gamma, proposal_logps=None if logps is None else jnp.asarray(logps),
        prop_valid=None if prop_valid is None else jnp.asarray(prop_valid),
    )
    t_out, t_n = trt.accept_reject(
        torch.from_numpy(t_logits), torch.from_numpy(proposals), torch.from_numpy(temps), (_tk(keys[0]), _tk(keys[1])),
        torch.from_numpy(active), gamma=gamma, proposal_logps=None if logps is None else torch.from_numpy(logps),
        prop_valid=None if prop_valid is None else torch.from_numpy(prop_valid),
    )
    return (np.asarray(j_out), np.asarray(j_n)), (t_out.numpy(), t_n.numpy())


@pytest.mark.parametrize("mode", ["draft", "delta"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accept_reject_and_the_plane_match_jax(mode, seed):
    gamma = 4
    t_logits, proposals, d_logps = _accept_case(seed)
    B = proposals.shape[0]
    temps = np.array([0.0, 0.0, 0.0, 0.9, 1.3, 0.7], np.float32)  # greedy lanes, then sampled
    active = np.array([True, True, True, True, True, False])
    prop_valid = np.ones((B, gamma), bool)
    prop_valid[2] = False  # a lane with nothing to verify: one plain target step
    prop_valid[4, 2:] = False  # a budget of 2
    (j_out, j_n), (t_out, t_n) = _both_accept(
        t_logits, proposals, temps, seed + 10, active, gamma, d_logps if mode == "draft" else None, prop_valid)
    np.testing.assert_array_equal(t_out, j_out)
    np.testing.assert_array_equal(t_n, j_n)
    assert t_n[0] == gamma + 1 and t_n[1] == 3 and t_n[2] == 1 and t_n[5] == 0  # all, the cut, one, none
    # the plane: lane 3 at γ=0 takes the classic token
    gammas = np.array([4, 4, 0, 0, 2, 4], np.int32)
    classic = np.arange(100, 100 + B, dtype=np.int32)
    jp = jrt._emit_plane(jnp.asarray(j_out), jnp.asarray(j_n), jnp.asarray(active), jnp.asarray(gammas),
                         jnp.asarray(classic))
    tp = trt._emit_plane(torch.from_numpy(t_out), torch.from_numpy(t_n), torch.from_numpy(active),
                         torch.from_numpy(gammas), torch.from_numpy(classic))
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_accept_reject_all_valid_by_default():
    t_logits, proposals, d_logps = _accept_case(5, B=3)
    temps = np.array([0.0, 1.0, 0.5], np.float32)
    (j_out, j_n), (t_out, t_n) = _both_accept(t_logits, proposals, temps, 4, np.ones(3, bool), 4, d_logps)
    np.testing.assert_array_equal(t_out, j_out)
    np.testing.assert_array_equal(t_n, j_n)


# -- the round programs ------------------------------------------------------------------


@pytest.fixture(scope="module")
def draft_model():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32", n_layers=1, dim=64, ffn_dim=128)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype="float32", n_layers=1, dim=64, ffn_dim=128)
    jparams = jllama.init_params(jax.random.PRNGKey(1), jcfg)
    return jcfg, tcfg, jparams, tllama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


# lanes: greedy from each prompt's end; lane 2 greedy, 2 short of capacity;
# lane 3 inactive. The round's γ is 4; lane 1 at γ=2.
ROUND_TOKENS = np.array([5, 9, 2, 0], np.int32)
ROUND_POS = np.array([20, 13, PPS * PS - 2, 0], np.int32)
ROUND_GAMMAS = np.array([4, 2, 4, 0], np.int32)


def _round_args(temps=None):
    temps = np.array([0.0, 0.0, 0.0, 1.0], np.float32) if temps is None else temps
    return dict(tokens=ROUND_TOKENS, positions=ROUND_POS, active=ACTIVE, gammas=ROUND_GAMMAS, temps=temps,
                top_ps=np.ones(4, np.float32), top_ks=np.zeros(4, np.int32), seeds=np.array([-1, 7, -1, -1], np.int32))


@pytest.mark.parametrize("draft,kv_dtype", [("random", "bfloat16"), ("random", "int8"), ("self", "bfloat16")])
def test_spec_round_matches_jax(model, draft_model, draft, kv_dtype):
    jcfg, tcfg, jparams, tparams = model
    if draft == "self":
        djcfg, dtcfg, djparams, dtparams = model
    else:
        djcfg, dtcfg, djparams, dtparams = draft_model
    jk, jv, tables = _prefilled(jcfg, jparams, kv_dtype)
    jdk, jdv, _ = _prefilled(djcfg, djparams, kv_dtype)
    tk, tv, tdk, tdv = (_port_pages(a) for a in (jk, jv, jdk, jdv))
    a = _round_args(np.array([0.0, 0.0, 0.0, 1.0], np.float32) if draft == "self" else
                    np.array([0.0, 0.8, 0.0, 1.0], np.float32))  # lane 1 sampled: its γ=2 proposals drawn
    key = jax.random.PRNGKey(3)
    jfn = jax.jit(jrt.build_spec_round_fn(jcfg, djcfg, paged_impl="xla", scatter_impl="xla", mesh=None, gamma=4))
    j_toks, j_valid, j_last, jk, jv, jdk, jdv = jfn(
        jparams, djparams, jk, jv, jdk, jdv, *(jnp.asarray(a[n]) for n in ("tokens", "positions")),
        jnp.asarray(tables), jnp.asarray(a["active"]), jnp.asarray(a["gammas"]), key,
        *(jnp.asarray(a[n]) for n in ("temps", "top_ps", "top_ks", "seeds")),
    )
    tfn = trt.build_spec_round_fn(tcfg, dtcfg, paged_impl="xla", scatter_impl="xla", gamma=4)
    t_toks, t_valid, t_last = tfn(
        tparams, dtparams, tk, tv, tdk, tdv, *(torch.from_numpy(a[n]) for n in ("tokens", "positions")),
        torch.from_numpy(tables), torch.from_numpy(a["active"]), torch.from_numpy(a["gammas"]), _tk(key),
        *(torch.from_numpy(a[n]) for n in ("temps", "top_ps", "top_ks", "seeds")),
    )
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
    np.testing.assert_array_equal(t_toks.numpy(), np.asarray(j_toks))
    np.testing.assert_array_equal(t_last.numpy(), np.asarray(j_last))
    if draft == "self":  # every greedy proposal of a self-draft is accepted
        assert t_valid.numpy()[:, 0].all()
    for t, j in ((tk, jk), (tv, jv), (tdk, jdk), (tdv, jdv)):
        _assert_pages_match(t, j)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_ngram_round_matches_jax(model, kv_dtype):
    jcfg, tcfg, jparams, tparams = model
    jk, jv, tables = _prefilled(jcfg, jparams, kv_dtype)
    tk, tv = _port_pages(jk), _port_pages(jv)
    a = _round_args()
    # lane 0: the target's own greedy continuation (from a verify of a probe
    # chain), so lookups that match are accepted; lane 1: two tokens; lane 2
    # an empty lookup
    probe, _, _ = jllama.verify_step(jparams, jnp.asarray(np.tile(ROUND_TOKENS[:, None], (1, 5))),
                                     jnp.asarray(ROUND_POS), jk, jv, jnp.asarray(tables), jnp.asarray(ACTIVE), jcfg)
    jk, jv, _ = _prefilled(jcfg, jparams, kv_dtype)  # the probe wrote the pages: start again
    props = np.zeros((4, 4), np.int32)
    props[0, 0] = int(np.asarray(probe)[0, 0].argmax())
    props[0, 1:] = [3, 1, 4]
    props[1, :2] = [7, 8]
    n_prop = np.array([4, 2, 0, 0], np.int32)
    gammas = np.minimum(a["gammas"], n_prop)
    key = jax.random.PRNGKey(4)
    jfn = jax.jit(jrt.build_ngram_round_fn(jcfg, gamma=4))
    j_toks, j_valid, j_last, jk, jv = jfn(
        jparams, jk, jv, jnp.asarray(props), jnp.asarray(n_prop), jnp.asarray(gammas), jnp.asarray(a["tokens"]),
        jnp.asarray(a["positions"]), jnp.asarray(tables), jnp.asarray(a["active"]), key,
        *(jnp.asarray(a[n]) for n in ("temps", "top_ps", "top_ks", "seeds")),
    )
    tfn = trt.build_ngram_round_fn(tcfg, gamma=4)
    t_toks, t_valid, t_last = tfn(
        tparams, tk, tv, torch.from_numpy(props), torch.from_numpy(n_prop), torch.from_numpy(gammas),
        torch.from_numpy(a["tokens"]), torch.from_numpy(a["positions"]), torch.from_numpy(tables),
        torch.from_numpy(a["active"]), _tk(key), *(torch.from_numpy(a[n]) for n in ("temps", "top_ps", "top_ks", "seeds")),
    )
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
    np.testing.assert_array_equal(t_toks.numpy(), np.asarray(j_toks))
    np.testing.assert_array_equal(t_last.numpy(), np.asarray(j_last))
    assert t_valid.numpy()[:2, 0].all()  # lane 0's first lookup was the target's own token
    for t, j in ((tk, jk), (tv, jv)):
        _assert_pages_match(t, j)


# -- host pieces --------------------------------------------------------------------------


def test_the_controller_is_the_jax_controllers():
    """The same rounds (observe) and dispatches (gamma_for) give the same γs,
    through collapse, probes, recovery, batch pressure and prefill
    pressure."""
    rng = np.random.default_rng(0)
    j, t = jctrl.AdaptiveGammaController(4, probe_every=3), tctrl.AdaptiveGammaController(4, probe_every=3)
    seen = []
    for r in range(300):
        rid = f"r{rng.integers(3)}"
        kw = dict(gamma_cap=int(rng.integers(0, 6)), batch_fill=float(rng.choice([0.1, 0.5, 0.96])),
                  prefill_pressure=bool(rng.random() < 0.2))
        g = t.gamma_for(rid, **kw)
        assert g == j.gamma_for(rid, **kw)
        seen.append(g)
        acc = int(rng.integers(0, g + 1)) if r < 150 else 0  # acceptance collapses halfway
        j.observe(rid, g, acc)
        t.observe(rid, g, acc)
        if r % 97 == 96:
            j.forget(rid)
            t.forget(rid)
        assert t.snapshot() == j.snapshot()
    assert {0, 1, 4} <= set(seen)


def test_ngram_index_proposes_as_jax():
    rng = np.random.default_rng(1)
    for trial in range(20):
        prompt = [int(x) for x in rng.integers(0, 6, int(rng.integers(0, 30)))]
        lookback = int(rng.choice([4, 16, 1024]))
        j, t = JaxNgramIndex(2, prompt, lookback), _NgramIndex(2, prompt, lookback)
        for _ in range(40):
            g = int(rng.integers(1, 6))
            assert t.propose(g) == j.propose(g)
            tok = int(rng.integers(0, 6))
            j.push(tok)
            t.push(tok)


@pytest.fixture(scope="module")
def oracle_models():
    def both(seed, **shape):
        jcfg = jllama.LlamaConfig(vocab_size=64, max_seq_len=128, dtype="float32", **shape)
        tcfg = tllama.LlamaConfig(vocab_size=64, max_seq_len=128, dtype="float32", **shape)
        jp = jllama.init_params(jax.random.PRNGKey(seed), jcfg)
        return jcfg, tcfg, jp, tllama.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")

    return (both(0, dim=64, n_layers=2, n_heads=2, n_kv_heads=2, ffn_dim=128),
            both(1, dim=32, n_layers=1, n_heads=2, n_kv_heads=2, ffn_dim=64))


@pytest.mark.parametrize("max_new", [16, 14])  # γ divides 16, not 14
def test_the_oracle_matches_jax_greedy(oracle_models, max_new):
    (jt, tt, jtp, ttp), (jd, td, jdp, tdp) = oracle_models
    prompt = np.array([1, 2, 3, 4, 5, 6, 7, 8], np.int32)
    key = jax.random.PRNGKey(2)
    j_buf, j_n = jspec.speculative_generate(jtp, jdp, jt, jd, jnp.asarray(prompt), 8, key, max_new=max_new,
                                            gamma=4, greedy=True)
    t_prompt = torch.from_numpy(prompt)
    t_buf, t_n = tspec.speculative_generate(ttp, tdp, tt, td, t_prompt, 8, _tk(key), max_new=max_new, gamma=4,
                                            greedy=True)
    assert t_n == int(j_n) == max_new
    np.testing.assert_array_equal(t_buf.numpy(), np.asarray(j_buf))
    # greedy speculation reproduces the target's greedy decode
    np.testing.assert_array_equal(t_buf.numpy(), tspec.greedy_generate(ttp, tt, t_prompt, 8, max_new).numpy())
