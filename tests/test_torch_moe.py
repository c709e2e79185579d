"""The port's mixture of experts against the JAX package, on the CPU.

Every function of ``models/moe.py`` against its JAX counterpart on the same
numpy inputs (the JAX test's config: 8 experts, top 2, D=32, F=64, 64
tokens): f32 at 1e-5; bf16 trees at ``BF16_TOL`` of the largest value (the
port's experts round the SwiGLU product to bf16 before the down projection,
where the reference keeps f32); int8 trees bitwise in their quantization and
at 1e-5 in f32 activations. Capacity routing at a generous, a middling and a
tight capacity (tokens dropped), with the aux loss. Expert choices agree
wherever the k-th and (k+1)-th probabilities differ by more than
``TIE_MARGIN``; ties are counted and, planted, broken as ``lax.top_k``
breaks them (lower index first).

Then the llama pieces: ``forward(return_aux=, moe_impl=)``, prefill and
paged decode (both structures) against the dense forward and the JAX
serving functions, ``verify_step`` against decode, the engine against the
JAX engine (f32 weights over f32, bf16 and int8 pages; int8 weights over
int8 pages), the Mixtral checkpoint loader bitwise to the JAX loader plus
``params_from_jax``, and the int8 quantization of expert stacks. The
gpu-marked test holds the int8 matmul kernel at Mixtral's expert shapes
(``python3 chip_smoke.py`` phase 10a does the same and times it).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modal_examples_tpu.models import llama as jllama
from modal_examples_tpu.models import lora as jlora
from modal_examples_tpu.models import moe as jmoe
from modal_examples_tpu.models import quantize as jquant
from modal_examples_tpu.serving.engine import LLMEngine as JaxEngine
from modal_examples_tpu.serving.sampling import SamplingParams as JaxParams
from modal_examples_tpu_torch import LLMEngine, SamplingParams
from modal_examples_tpu_torch.models import llama as tllama
from modal_examples_tpu_torch.models import lora as tlora
from modal_examples_tpu_torch.models import moe as tmoe
from modal_examples_tpu_torch.models import quantize as tquant
from modal_examples_tpu_torch.models.quantize import QuantizedWeight
from modal_examples_tpu_torch.observability.usage import WorkModel
from test_torch_checkpoint import _assert_tree_equal, write_checkpoint
from test_torch_time_limit import share_cores

share_cores()

F32_TOL = 1e-5
#: bf16 trees: one bf16 rounding of the SwiGLU product, relative to the largest output
BF16_TOL = 1e-2
#: routing: choices must agree where the k-th and (k+1)-th probabilities differ by more
TIE_MARGIN = 1e-6
CFG = jmoe.MoEConfig(n_experts=8, top_k=2, capacity_factor=1.5, d_model=32, d_ff=64)
#: the JAX serving test's model: dim 32, 2 layers, 4 experts, f32
SERVED = dict(vocab_size=64, dim=32, n_layers=2, n_heads=2, n_kv_heads=2, ffn_dim=64, max_seq_len=128,
              dtype="float32", n_experts=4, top_k_experts=2)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol=F32_TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def moe_case():
    """The JAX test's gelu MoE (params, x) and a SwiGLU expert set, numpy."""
    rng = np.random.default_rng(0)
    D, Fd, E = CFG.d_model, CFG.d_ff, CFG.n_experts
    gelu = {
        "router": rng.standard_normal((D, E)).astype(np.float32) * D**-0.5,
        "w_in": rng.standard_normal((E, D, Fd)).astype(np.float32) * D**-0.5,
        "w_out": rng.standard_normal((E, Fd, D)).astype(np.float32) * Fd**-0.5,
    }
    swiglu = {
        "router": rng.standard_normal((D, E)).astype(np.float32) * D**-0.5,
        "w_gate": rng.standard_normal((E, D, Fd)).astype(np.float32) * D**-0.5,
        "w_up": rng.standard_normal((E, D, Fd)).astype(np.float32) * D**-0.5,
        "w_down": rng.standard_normal((E, Fd, D)).astype(np.float32) * Fd**-0.5,
    }
    x = rng.standard_normal((64, D)).astype(np.float32)
    return gelu, swiglu, x


def _margins(probs, k):
    """The k-th minus the (k+1)-th largest probability per token."""
    s = np.sort(probs, axis=-1)[:, ::-1]
    return s[:, k - 1] - s[:, k]


# -- routing ------------------------------------------------------------------------


@pytest.mark.parametrize("factor,tokens", [(1.25, 64), (1.5, 16), (0.25, 64), (0.01, 8), (100.0, 3)])
def test_capacity_is_the_reference_formula(factor, tokens):
    kw = dict(n_experts=8, top_k=2, capacity_factor=factor, d_model=32, d_ff=64)
    assert tmoe.MoEConfig(**kw).capacity(tokens) == jmoe.MoEConfig(**kw).capacity(tokens)


@pytest.mark.parametrize("factor", [100.0, 1.5, 0.25], ids=["generous", "middling", "tight"])
def test_route_matches_jax(moe_case, factor):
    gelu, _, x = moe_case
    cfg = dataclasses.replace(CFG, capacity_factor=factor)
    cap = cfg.capacity(x.shape[0])
    jd, jc, jaux = jmoe._route(jnp.asarray(x), jnp.asarray(gelu["router"]), cfg, cap)
    td, tc, taux = tmoe._route(_t(x), _t(gelu["router"]), tmoe.MoEConfig(**dataclasses.asdict(cfg)), cap)
    probs = np.asarray(jax.nn.softmax(x @ gelu["router"], -1))
    assert (_margins(probs, cfg.top_k) > TIE_MARGIN).all()  # no near-tie in these inputs
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))  # the same slots, drops included
    _close(tc, jc)
    _close(taux, jaux)
    kept = td.numpy().sum(axis=(1, 2))
    if factor < 1:
        assert (kept < cfg.top_k).any()  # tokens were dropped at this capacity
    else:
        assert factor < 100 or (kept == cfg.top_k).all()


def test_topk_breaks_ties_as_lax_top_k():
    """Planted ties: equal probabilities pick the lower expert index first,
    and the aux loss's top 1 is the first maximum, as in JAX."""
    probs = np.array([[0.2, 0.3, 0.3, 0.2], [0.25] * 4, [0.1, 0.1, 0.4, 0.4], [0.4, 0.1, 0.1, 0.4]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = tmoe._topk(_t(probs), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(_t(probs).argmax(-1).numpy(), np.asarray(jnp.argmax(jnp.asarray(probs), -1)))
    # a router with two equal columns ties those experts on every token
    rng = np.random.default_rng(4)
    router = rng.standard_normal((16, 4)).astype(np.float32)
    router[:, 3] = router[:, 1]
    x = rng.standard_normal((12, 16)).astype(np.float32)
    cfg = jmoe.MoEConfig(n_experts=4, top_k=2, capacity_factor=100.0, d_model=16, d_ff=8)
    jd, _, _ = jmoe._route(jnp.asarray(x), jnp.asarray(router), cfg, 12)
    td, _, _ = tmoe._route(_t(x), _t(router), tmoe.MoEConfig(**dataclasses.asdict(cfg)), 12)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    ties = int((np.abs(_margins(np.asarray(jax.nn.softmax(x @ router, -1)), 1)) < TIE_MARGIN).sum())
    assert ties > 0  # the planted tie decided some first choices


# -- the layers ---------------------------------------------------------------------


def test_expert_ffn_matches_jax(moe_case):
    gelu, _, x = moe_case
    h = x[:10]
    want = jmoe._expert_ffn(jnp.asarray(gelu["w_in"][2]), jnp.asarray(gelu["w_out"][2]), jnp.asarray(h))
    _close(tmoe._expert_ffn(_t(gelu["w_in"][2]), _t(gelu["w_out"][2]), _t(h)), want)


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("factor", [100.0, 1.5, 0.25], ids=["generous", "middling", "tight"])
def test_moe_mlp_matches_jax(moe_case, factor, groups):
    gelu, _, x = moe_case
    cfg = dataclasses.replace(CFG, capacity_factor=factor)
    jout, jaux = jmoe.moe_mlp({k: jnp.asarray(v) for k, v in gelu.items()}, jnp.asarray(x), cfg, groups=groups)
    tout, taux = tmoe.moe_mlp({k: _t(v) for k, v in gelu.items()}, _t(x), tmoe.MoEConfig(**dataclasses.asdict(cfg)),
                              groups=groups)
    _close(tout, jout)
    _close(taux, jaux)
    if factor < 1:
        assert float(np.linalg.norm(np.asarray(jout), axis=-1).min()) == 0.0  # a fully dropped token
        assert float(tout.norm(dim=-1).min()) == 0.0


def test_moe_mlp_ep_waits_for_a10(moe_case):
    gelu, _, x = moe_case
    # A10 landed: expert parallelism runs over a mesh (tests/test_torch_parallel.py); without one it refuses
    with pytest.raises(ValueError, match="mesh"):
        tmoe.moe_mlp_ep({k: _t(v) for k, v in gelu.items()}, _t(x), tmoe.MoEConfig(), mesh=None)
    with pytest.raises(ValueError, match="groups"):
        tmoe.moe_mlp({k: _t(v) for k, v in gelu.items()}, _t(x), tmoe.MoEConfig(), groups=3)


def test_init_params_shapes_and_scales():
    cfg = tmoe.MoEConfig(n_experts=8, d_model=32, d_ff=64)
    p = tmoe.init_params(cfg, seed=0, device="cpu")
    jp = jmoe.init_params(jax.random.PRNGKey(0), jmoe.MoEConfig(n_experts=8, d_model=32, d_ff=64))
    for k in jp:
        assert tuple(p[k].shape) == jp[k].shape and p[k].dtype == torch.float32
        np.testing.assert_allclose(p[k].std().item(), float(jnp.std(jp[k])), rtol=0.15)
    again = tmoe.init_params(cfg, seed=0, device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)


def _swiglu_tree(swiglu, dtype):
    """(JAX leaves, port leaves) of the expert set: f32, bf16 or int8 (the
    JAX ``quantize_weight`` of the f32 stacks, converted as
    ``params_from_jax`` converts a quantized leaf)."""
    names = ("w_gate", "w_up", "w_down")
    if dtype == "int8":
        jq = {n: jquant.quantize_weight(jnp.asarray(swiglu[n])) for n in names}
        tq = {n: QuantizedWeight(q=torch.from_numpy(np.asarray(w.q)), scale=torch.from_numpy(np.asarray(w.scale)))
              for n, w in jq.items()}
        return jq, tq
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    return ({n: jnp.asarray(swiglu[n], jdt) for n in names}, {n: _t(swiglu[n]).to(tdt) for n in names})


@pytest.mark.parametrize("weights,acts", [("float32", "float32"), ("bfloat16", "bfloat16"), ("int8", "float32"),
                                          ("int8", "bfloat16")])
def test_nodrop_matches_jax(moe_case, weights, acts):
    """The serving formulation over f32, bf16 and int8 expert trees; the
    activations in the model's dtype (f32 exact; bf16 at ``BF16_TOL``)."""
    _, swiglu, x = moe_case
    jw, tw = _swiglu_tree(swiglu, weights)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if acts == "bfloat16" else (jnp.float32, torch.float32)
    xj = jnp.asarray(x, jdt)
    xt = _t(np.asarray(xj, np.float32)).to(tdt)  # the same values
    jout, jaux = jmoe.moe_swiglu_nodrop(jnp.asarray(swiglu["router"]), jw["w_gate"], jw["w_up"], jw["w_down"], xj, 2)
    tout, taux = tmoe.moe_swiglu_nodrop(_t(swiglu["router"]), tw["w_gate"], tw["w_up"], tw["w_down"], xt, 2)
    assert tout.dtype == torch.float32 and tout.shape == x.shape
    _close(tout, jout, F32_TOL if acts == "float32" else BF16_TOL)
    _close(taux, jaux)


def test_nodrop_is_every_token_through_its_top_k(moe_case):
    """The explicit loop of the reference's test: each token through its
    top-k SwiGLU experts, weighted by its renormalised probabilities."""
    _, swiglu, x = moe_case
    w = {k: _t(v) for k, v in swiglu.items()}
    out, aux = tmoe.moe_swiglu_nodrop(w["router"], w["w_gate"], w["w_up"], w["w_down"], _t(x[:16]), 2)
    assert aux.item() >= 1.0 - 1e-5
    probs = torch.softmax(_t(x[:16]) @ w["router"], -1)
    p, idx = torch.topk(probs, 2)
    p = p / p.sum(-1, keepdim=True)
    for t in range(16):
        want = sum(p[t, j] * ((torch.nn.functional.silu(_t(x[t]) @ w["w_gate"][e]) * (_t(x[t]) @ w["w_up"][e]))
                              @ w["w_down"][e]) for j, e in enumerate(idx[t].tolist()))
        _close(out[t], want.numpy())


@pytest.mark.parametrize("weights", ["float32", "int8"])
def test_swiglu_expert_and_mm_match_jax(moe_case, weights):
    _, swiglu, x = moe_case
    jw, tw = _swiglu_tree(swiglu, weights)
    e = 5
    pick = lambda w: w[e] if not isinstance(w, QuantizedWeight) else QuantizedWeight(q=w.q[e], scale=w.scale[e])  # noqa: E731
    jpick = lambda w: w[e] if not isinstance(w, jquant.QuantizedWeight) else jquant.QuantizedWeight(  # noqa: E731
        q=w.q[e], scale=w.scale[e])
    _close(tmoe._mm(_t(x), pick(tw["w_gate"])), jmoe._mm(jnp.asarray(x), jpick(jw["w_gate"])))
    want = jmoe._swiglu_expert(jpick(jw["w_gate"]), jpick(jw["w_up"]), jpick(jw["w_down"]), jnp.asarray(x))
    _close(tmoe._swiglu_expert(pick(tw["w_gate"]), pick(tw["w_up"]), pick(tw["w_down"]), _t(x)), want)
    if weights == "int8":
        assert tw["w_gate"].q[e].is_contiguous() and tmoe._expert(tw["w_gate"], e).scale.is_contiguous()


@pytest.mark.parametrize("weights", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("factor", [100.0, 1.5, 0.25], ids=["generous", "middling", "tight"])
def test_capacity_path_matches_jax(moe_case, factor, weights):
    """GShard dispatch: the reference's f32 arithmetic (int8 leaves
    dequantized to bf16 first), drops included."""
    _, swiglu, x = moe_case
    jw, tw = _swiglu_tree(swiglu, weights)
    jout, jaux = jmoe.moe_swiglu_capacity(jnp.asarray(swiglu["router"]), jw["w_gate"], jw["w_up"], jw["w_down"],
                                          jnp.asarray(x), 2, factor)
    tout, taux = tmoe.moe_swiglu_capacity(_t(swiglu["router"]), tw["w_gate"], tw["w_up"], tw["w_down"], _t(x), 2,
                                          factor)
    _close(tout, jout)
    _close(taux, jaux)
    if factor == 100.0:  # nothing drops: the no-drop serving path's result (which keeps int8 leaves exact,
        # where the capacity path multiplies their bf16 dequantization)
        jnd, _ = jmoe.moe_swiglu_nodrop(jnp.asarray(swiglu["router"]), jw["w_gate"], jw["w_up"], jw["w_down"],
                                        jnp.asarray(x), 2)
        _close(tout, jnd, BF16_TOL if weights == "int8" else 1e-4)


# -- the llama model ----------------------------------------------------------------


def _pair(cfg_kw: dict, seed: int = 0, quantize: bool = False):
    jcfg = jllama.LlamaConfig(**cfg_kw)
    tcfg = tllama.LlamaConfig(**cfg_kw)
    jp = jllama.init_params(jax.random.PRNGKey(seed), jcfg)
    if quantize:
        jp = jquant.quantize_llama(jp)
    return jcfg, tcfg, jp, tllama.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.fixture(scope="module")
def served():
    return _pair(SERVED)


def test_config_presets_and_param_count():
    for name in ("mixtral_8x7b", "tiny_moe"):
        t, j = getattr(tllama.LlamaConfig, name)(), getattr(jllama.LlamaConfig, name)()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count == j.param_count
    mixtral = tllama.LlamaConfig.mixtral_8x7b()
    assert mixtral.param_count == 46_702_792_704
    meter = WorkModel.from_engine(mixtral, cache=type("C", (), {"bytes": lambda s: 1, "n_pages": 1,
                                                                 "page_size": 1})(), weight_bytes=1)
    assert meter.n_params == jllama.LlamaConfig.mixtral_8x7b().param_count


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_draws_the_expert_leaves(dtype):
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny_moe(), dtype=dtype)
    p = tllama.init_params(cfg, seed=3, device="cpu")
    jp = jllama.init_params(jax.random.PRNGKey(0), dataclasses.replace(jllama.LlamaConfig.tiny_moe(), dtype=dtype))
    for k, v in jp["layers"].items():
        assert tuple(p["layers"][1][k].shape) == v.shape[1:] and p["layers"][1][k].dtype == cfg.torch_dtype, k
    assert sum(t.numel() for t in jax.tree.leaves(p) if isinstance(t, torch.Tensor)) == cfg.param_count
    q = tquant.init_quantized_llama(cfg, seed=3, device="cpu")  # one layer at a time, the same values
    _assert_tree_equal(q, tquant.quantize_llama(p))
    assert q["layers"][0]["moe_down"].scale.shape == (4, 1, 128) and q["layers"][0]["router"].dtype == cfg.torch_dtype


def test_quantize_llama_over_expert_stacks_is_bitwise_jax():
    cfg_kw = dataclasses.asdict(dataclasses.replace(jllama.LlamaConfig.tiny_moe(), dtype="float32"))
    jcfg, tcfg, jp, tp = _pair(cfg_kw)
    want = tllama.params_from_jax(jax.tree.map(np.asarray, jquant.quantize_llama(jp)), tcfg, device="cpu")
    got = tquant.quantize_llama(tp)
    _assert_tree_equal(got, want)
    assert tquant.param_bytes(got) == jquant.param_bytes(jquant.quantize_llama(jp))


@pytest.mark.parametrize("moe_impl", ["nodrop", "capacity"])
@pytest.mark.parametrize("model", ["served", "tiny_moe"])
def test_forward_with_aux_matches_jax(served, model, moe_impl):
    if model == "served":
        jcfg, tcfg, jp, tp = served
    else:
        jcfg, tcfg, jp, tp = _pair(dataclasses.asdict(dataclasses.replace(jllama.LlamaConfig.tiny_moe(),
                                                                          dtype="float32")), seed=1)
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    jl, jaux = jllama.forward(jp, jnp.asarray(tokens), jcfg, attn_impl="xla", return_aux=True, moe_impl=moe_impl)
    tl, taux = tllama.forward(tp, torch.from_numpy(tokens).long(), tcfg, attn_impl="xla", return_aux=True,
                              moe_impl=moe_impl)
    _close(tl, jl)
    _close(taux, jaux)
    assert float(taux) > 0
    _close(tllama.forward(tp, torch.from_numpy(tokens).long(), tcfg, attn_impl="flash", moe_impl=moe_impl), jl)


def test_forward_adapters_on_an_expert_model(served):
    """Attention adapters apply as in JAX; MLP adapters raise the reference's
    ValueError."""
    jcfg, tcfg, jp, tp = served
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (1, 12)).astype(np.int32)
    lcfg = jlora.LoRAConfig(rank=4, targets=("wq", "wv"))
    np_lora = jax.tree.map(np.asarray, jlora.init_lora(jax.random.PRNGKey(5), jp, lcfg))
    rng = np.random.default_rng(6)
    np_lora = {"layers": {k: (rng.standard_normal(v.shape).astype(np.float32) * 0.1 if k.endswith("_b") else v)
                          for k, v in np_lora["layers"].items()}}
    jl = jllama.forward(jp, jnp.asarray(tokens), jcfg, attn_impl="xla", lora=jax.tree.map(jnp.asarray, np_lora),
                        lora_scale=lcfg.scale)
    tl = tllama.forward(tp, torch.from_numpy(tokens).long(), tcfg, attn_impl="xla",
                        lora=tlora.lora_from_jax(np_lora, device="cpu"), lora_scale=lcfg.scale)
    _close(tl, jl)
    bad = {"layers": {"gate_a": torch.zeros(2, 32, 4), "gate_b": torch.zeros(2, 4, 64)}}
    with pytest.raises(ValueError, match="not supported for MoE"):
        tllama.forward(tp, torch.from_numpy(tokens).long(), tcfg, attn_impl="xla", lora=bad)


# -- serving --------------------------------------------------------------------------


def _pages(cfg, n_pages):
    shape = (cfg.n_layers, n_pages, 16, cfg.n_kv_heads, cfg.head_dim)
    return (jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32),
            torch.zeros(shape), torch.zeros(shape))


@pytest.mark.parametrize("impl", ["xla", "pallas-writeback"])
def test_paged_decode_matches_dense_forward(served, impl):
    """The reference test's exactness: prefill and 4 teacher-forced decode
    steps equal the full-sequence forward (the port's and JAX's), through
    the read-only and the write-then-attend structure; the logits equal the
    JAX serving functions' step by step."""
    jcfg, tcfg, jp, tp = served
    B, pps = 2, 4
    pt = (1 + np.arange(B * pps, dtype=np.int32)).reshape(B, pps)
    active = np.ones((B,), bool)
    prompt = np.array([[1, 2, 3, 5, 0, 0], [7, 8, 9, 11, 13, 2]], np.int32)
    seq_lens = np.array([4, 6], np.int32)
    jk, jv, tk, tv = _pages(tcfg, 1 + B * pps)
    jlog, jk, jv = jllama.prefill(jp, jnp.asarray(prompt), jk, jv, jnp.asarray(pt), jnp.asarray(seq_lens), jcfg,
                                  attn_impl="xla")
    tlog, _, _ = tllama.prefill(tp, torch.from_numpy(prompt), tk, tv, torch.from_numpy(pt),
                                torch.from_numpy(seq_lens), tcfg)
    _close(tlog, jlog)
    chain = np.array([[3, 5, 2, 9], [1, 4, 6, 8]], np.int32)
    dec = []
    for t in range(4):
        jlog, jk, jv = jllama.decode_step(jp, jnp.asarray(chain[:, t]), jnp.asarray(seq_lens + t), jk, jv,
                                          jnp.asarray(pt), jnp.asarray(active), jcfg, impl=impl)
        tlog, _, _ = tllama.decode_step(tp, torch.from_numpy(chain[:, t]), torch.from_numpy(seq_lens + t), tk, tv,
                                        torch.from_numpy(pt), torch.from_numpy(active), tcfg, impl=impl)
        _close(tlog, jlog)
        dec.append(tlog)
    full = np.stack([np.pad(np.concatenate([prompt[b, :n], chain[b]]), (0, 10 - n)) for b, n in enumerate([4, 6])])
    want = tllama.forward(tp, torch.from_numpy(full).long(), tcfg, attn_impl="xla")
    jwant = np.asarray(jllama.forward(jp, jnp.asarray(full), jcfg, attn_impl="xla"))
    for b, n in enumerate([4, 6]):
        for t in range(4):
            np.testing.assert_allclose(dec[t][b].numpy(), want[b, n + t].detach().numpy(), atol=2e-4)
            np.testing.assert_allclose(dec[t][b].numpy(), jwant[b, n + t], atol=2e-4)


def test_prefill_chunk_matches_jax(served):
    jcfg, tcfg, jp, tp = served
    prompt = np.random.default_rng(7).integers(0, jcfg.vocab_size, 45).astype(np.int32)
    table = np.array([[3, 1, 4, 2]], np.int32)
    jk, jv, tk, tv = _pages(tcfg, 5)
    for off in (0, 32):
        chunk = np.zeros((1, 32), np.int32)
        part = prompt[off : off + 32]
        chunk[0, : len(part)] = part
        lens = np.array([len(part)], np.int32)
        jlog, jk, jv = jllama.prefill_chunk(jp, jnp.asarray(chunk), jk, jv, jnp.asarray(table), jnp.asarray(lens),
                                            jcfg, q_offset=off, attn_impl="xla")
        tlog, _, _ = tllama.prefill_chunk(tp, torch.from_numpy(chunk), tk, tv, torch.from_numpy(table),
                                          torch.from_numpy(lens), tcfg, q_offset=off)
        _close(tlog, jlog)
    _close(tk[:, 1:], np.asarray(jk)[:, 1:])


def test_verify_step_matches_decode(served):
    jcfg, tcfg, jp, tp = served
    B, pps = 2, 4
    pt = torch.from_numpy((1 + np.arange(B * pps, dtype=np.int32)).reshape(B, pps))
    active = torch.ones((B,), dtype=torch.bool)
    prompt = torch.tensor([[1, 2, 3, 5], [7, 8, 9, 11]], dtype=torch.int32)
    seq_lens = torch.tensor([4, 4], dtype=torch.int32)
    _, _, k1, v1 = _pages(tcfg, 1 + B * pps)
    tllama.prefill(tp, prompt, k1, v1, pt, seq_lens, tcfg)
    k2, v2 = k1.clone(), v1.clone()
    chain = torch.tensor([[3, 5, 2], [1, 4, 6]], dtype=torch.int32)
    logits_v, _, _ = tllama.verify_step(tp, chain, seq_lens, k1, v1, pt, active, tcfg)
    for t in range(3):
        lg, _, _ = tllama.decode_step(tp, chain[:, t], seq_lens + t, k2, v2, pt, active, tcfg)
        np.testing.assert_allclose(logits_v[:, t].numpy(), lg.numpy(), atol=2e-4)
    np.testing.assert_allclose(k1.numpy(), k2.numpy(), atol=1e-5)


ENGINE_REQUESTS = [
    ("mixture of experts", dict(max_tokens=8, temperature=0.0)),
    ("x" * 40, dict(max_tokens=6, temperature=0.0)),
    ("routed tokens", dict(max_tokens=7, temperature=0.9, seed=11)),
]
ENGINE_KW = dict(max_slots=2, max_model_len=64, page_size=16, prefill_buckets=(32,), seed=0, decode_block=4,
                 enable_prefix_cache=False)


def _serve(engine, params_cls):
    reqs = [engine.submit(p, params_cls(**kw)) for p, kw in ENGINE_REQUESTS]
    pieces = [list(engine.stream(r)) for r in reqs]
    return reqs, pieces


@pytest.mark.parametrize("kv_dtype,quantization", [("float32", None), ("bfloat16", None), ("int8", "int8")])
def test_engine_matches_jax_engine(kv_dtype, quantization):
    """The reference test's engine config (vocab 512, dim 32, 4 experts, f32
    weights) through both engines: f32 pages give the JAX engine's tokens
    exactly, and the dense forward's greedy loop; bf16 and int8 pages (int8
    weights over int8 pages) give its finish reasons, counts and every
    greedy token."""
    kw = {**SERVED, "vocab_size": 512, "max_seq_len": 256}
    jcfg, tcfg, jp, tp = _pair(kw, seed=3)
    jeng = JaxEngine(jcfg, jp, kv_dtype=kv_dtype, quantization=quantization, **ENGINE_KW)
    teng = LLMEngine(tcfg, tp, kv_dtype=kv_dtype, quantization=quantization, device="cpu", **ENGINE_KW)
    try:
        jreqs, jpieces = _serve(jeng, JaxParams)
        treqs, tpieces = _serve(teng, SamplingParams)
        assert teng.cache.allocator.available == teng.cache.n_pages - 1
    finally:
        jeng.stop()
        teng.stop()
    for jr, tr, jpc, tpc in zip(jreqs, treqs, jpieces, tpieces):
        assert (tr.finish_reason, tr.n_generated) == (jr.finish_reason, jr.n_generated)
        assert tr.generated_tokens == jr.generated_tokens
        assert tpc == jpc
    if kv_dtype == "float32":  # the JAX test's exact-vs-dense greedy loop, in the port
        ids, gen = list(treqs[0].prompt_tokens), []
        for _ in range(8):
            nxt = int(tllama.forward(tp, torch.tensor([ids + gen]), tcfg, attn_impl="xla")[0, -1].argmax())
            if nxt == teng.tokenizer.eos_id:
                break
            gen.append(nxt)
        assert treqs[0].generated_tokens == gen


# -- the Mixtral checkpoint -----------------------------------------------------------


def _mixtral_config() -> dict:
    return {
        "model_type": "mixtral", "vocab_size": 64, "hidden_size": 32, "num_hidden_layers": 2,
        "num_attention_heads": 2, "num_key_value_heads": 1, "intermediate_size": 48,
        "max_position_embeddings": 256, "num_local_experts": 4, "num_experts_per_tok": 2,
        "rope_theta": 1e6,
    }


@pytest.mark.parametrize("dtype,quantization", [("float32", None), ("bfloat16", None), ("float32", "int8"),
                                                ("bfloat16", "int8")])
def test_mixtral_loader_is_bitwise_the_jax_loader(tmp_path, dtype, quantization):
    write_checkpoint(tmp_path, _mixtral_config())
    jcfg = dataclasses.replace(jllama.LlamaConfig.from_hf_config(tmp_path / "config.json"), dtype=dtype)
    tcfg = dataclasses.replace(tllama.LlamaConfig.from_hf_config(tmp_path / "config.json"), dtype=dtype)
    assert tcfg.n_experts == 4 and dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    want = tllama.params_from_jax(jax.tree.map(np.asarray, jllama.load_hf_weights(
        tmp_path, jcfg, quantization=quantization)), tcfg, device="cpu")
    got = tllama.load_hf_weights(tmp_path, tcfg, quantization=quantization, device="cpu")
    _assert_tree_equal(got, want)
    layer = got["layers"][1]
    assert layer["router"].dtype == tcfg.torch_dtype  # the router is never quantized
    if quantization:
        assert isinstance(layer["moe_gate"], QuantizedWeight) and layer["moe_gate"].scale.shape == (4, 1, 48)


# -- on the card ----------------------------------------------------------------------


@pytest.mark.gpu
def test_int8_matmul_at_the_expert_shapes_on_card():
    """The int8 matmul kernel at Mixtral's expert shapes (``python3
    chip_smoke.py`` phase 10a holds and times the same): within 1e-3 of the
    largest value of its plain version, bitwise run to run, and the check
    refuses the product with the last K tile left out."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernels have no CPU mode")
    from modal_examples_tpu_torch.ops import quantized_matmul as qmm

    gen = torch.Generator(device="cuda").manual_seed(0)
    for K, N in ((4096, 14336), (14336, 4096)):
        w = tquant.quantize_weight(torch.randn(K, N, generator=gen, device="cuda"))
        for M in (8, 2048):
            x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
            want = qmm.qmm_plain(x, w.q, w.scale)
            got = qmm.qmm_cuda(x, w.q, w.scale)
            tol = 1e-3 * want.abs().max().item()
            assert (got - want).abs().max().item() <= tol
            assert torch.equal(got, qmm.qmm_cuda(x, w.q, w.scale))
            cut = x.clone()
            cut[:, -128:] = 0
            assert (qmm.qmm_cuda(cut, w.q, w.scale) - want).abs().max().item() > tol
