"""The port's GPT (``models/gpt.py``) and the f32 instances' plain twins of
the flash kernels (C11) against the JAX package, on the CPU.

Same weights (the JAX init, perturbed by a seeded N(0, 0.02) so the zero
biases and unit norms carry a signal), same numpy inputs. The JAX flash
path runs its Pallas kernels in interpret mode; the port's runs the f32
instances' plain twins (a CPU tensor never reaches a kernel). Tolerances,
f32: logits within 1e-5 of their largest value; gradients per leaf within
1e-4 of the leaf's largest gradient (sums in another order through the
layers and the flash backward); the flash twins within 1e-5 of the largest
value (o, lse) and 1e-4 (gradients); generated tokens equal.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modal_examples_tpu.models import gpt as jgpt
from modal_examples_tpu_torch.models import gpt as tgpt
from modal_examples_tpu_torch.ops import flash_attention as tfa
from modal_examples_tpu_torch.serving import sampling
from modal_examples_tpu_torch.utils import tree
from test_torch_time_limit import share_cores

share_cores()

jfa = importlib.import_module("modal_examples_tpu.ops.flash_attention")

LOGIT_TOL = 1e-5
GRAD_TOL = 1e-4


def _perturbed(tree_, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a, np.float32) + rng.normal(0, 0.02, a.shape)).astype(np.float32),
                        tree_)


def _model(jcfg, seed=0):
    np_params = _perturbed(jgpt.init_params(jax.random.PRNGKey(seed), jcfg), seed + 7)
    tcfg = tgpt.GPTConfig(**dataclasses.asdict(jcfg))
    return tcfg, np_params, tgpt.params_from_jax(np_params, tcfg, device="cpu")


def _tokens(seed, B, S, V):
    return np.random.default_rng(seed).integers(0, V, (B, S)).astype(np.int32)


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("attn_impl", ["flash", "xla"])
def test_forward_matches_jax(attn_impl):
    jcfg = jgpt.GPTConfig.tiny()
    tcfg, np_params, params = _model(jcfg)
    toks = _tokens(1, 2, jcfg.block_size, jcfg.vocab_size)
    want = jgpt.forward(jax.tree.map(jnp.asarray, np_params), jnp.asarray(toks), jcfg, attn_impl=attn_impl)
    got = tgpt.forward(params, torch.from_numpy(toks).long(), tcfg, attn_impl=attn_impl)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, jcfg.block_size, jcfg.vocab_size)
    _close(got.numpy(), want, LOGIT_TOL)


def _flat(node, prefix=""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, node


@pytest.mark.parametrize("attn_impl", ["flash", "xla"])
def test_gradients_match_jax(attn_impl):
    """Next-token cross entropy through ``attention_op(attn_impl)``: the port's
    flash path (the f32 twins of K1, K5, K6) against ``jax.grad`` through
    the Pallas kernels."""
    jcfg = dataclasses.replace(jgpt.GPTConfig.tiny(), block_size=48)
    tcfg, np_params, params = _model(jcfg, seed=3)
    toks = _tokens(4, 2, jcfg.block_size, jcfg.vocab_size)

    def jloss(p):
        logits = jgpt.forward(p, jnp.asarray(toks[:, :-1]), jcfg, attn_impl=attn_impl)
        lp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.mean(jnp.take_along_axis(lp, jnp.asarray(toks[:, 1:])[..., None], axis=-1))

    want_loss, want = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, np_params))
    leaves = [p.detach().clone().requires_grad_(True) for p in tree.leaves(params)]
    logits = tgpt.forward(tree.unflatten(params, leaves), torch.from_numpy(toks[:, :-1]).long(), tcfg,
                          attn_impl=attn_impl)
    lp = torch.log_softmax(logits, dim=-1)
    loss = -torch.gather(lp, -1, torch.from_numpy(toks[:, 1:]).long()[..., None]).mean()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = dict(_flat(tree.unflatten(params, list(torch.autograd.grad(loss, leaves)))))
    want = dict(_flat(jax.tree.map(np.asarray, want)))
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        w = want[path]
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=GRAD_TOL * max(np.abs(w).max(), 1e-6), err_msg=path)


def test_generate_draws_the_jax_tokens():
    jcfg = jgpt.GPTConfig.tiny()
    tcfg, np_params, params = _model(jcfg, seed=5)
    prompt = _tokens(6, 1, 10, jcfg.vocab_size)[0]
    for temperature in (1.0, 0.7):
        want = jgpt.generate(jax.tree.map(jnp.asarray, np_params), jcfg, jnp.asarray(prompt), 12,
                             jax.random.PRNGKey(9), temperature=temperature)
        got = tgpt.generate(params, tcfg, torch.from_numpy(prompt), 12, sampling.prng_key(9),
                            temperature=temperature)
        assert got.tolist() == np.asarray(want).tolist()


def test_generate_past_the_window_keeps_the_last_position():
    """Past ``block_size`` the reference keeps writing the window's last
    slot and reading the logits before it: the port does the same."""
    jcfg = dataclasses.replace(jgpt.GPTConfig.tiny(), block_size=16)
    tcfg, np_params, params = _model(jcfg, seed=8)
    prompt = _tokens(9, 1, 12, jcfg.vocab_size)[0]
    want = jgpt.generate(jax.tree.map(jnp.asarray, np_params), jcfg, jnp.asarray(prompt), 8, jax.random.PRNGKey(2))
    got = tgpt.generate(params, tcfg, torch.from_numpy(prompt), 8, sampling.prng_key(2))
    assert got.tolist() == np.asarray(want).tolist()


def test_init_params_mirrors_the_jax_tree():
    jcfg = jgpt.GPTConfig.tiny()
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jgpt.init_params(jax.random.PRNGKey(0), jcfg))
    got = tgpt.init_params(tgpt.GPTConfig(**dataclasses.asdict(jcfg)), seed=0, device="cpu")
    got = tree.map(lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")), got)
    assert got == jax.tree.map(lambda s: s, want, is_leaf=lambda x: isinstance(x, tuple))


def test_char_tokenizer_matches_jax():
    text = "To be, or not to be: that is the question.\nWhether 'tis nobler"
    j, t = jgpt.CharTokenizer(text), tgpt.CharTokenizer(text)
    assert (t.stoi, t.itos, t.vocab_size) == (j.stoi, j.itos, j.vocab_size)
    s = "the question, not the answer?"
    assert t.encode(s) == j.encode(s) and t.decode(t.encode(s)) == j.decode(j.encode(s))


# -- C11: the f32 instances' plain twins against the Pallas kernels ---------------

F32_SHAPES = [  # (B, Hq, Hkv, S, D)
    (2, 6, 6, 96, 64),    # GPT's head dim
    (1, 2, 2, 64, 32),    # GPT's tiny head dim
    (1, 4, 2, 80, 128),   # GQA, ragged against the kernels' blocks
]


def _qkv(seed, B, Hq, Hkv, S, D, Skv=None):
    rng = np.random.default_rng(seed)
    Skv = Skv or S
    return (rng.standard_normal((B, Hq, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", F32_SHAPES, ids=lambda s: "B{}-Hq{}-Hkv{}-S{}-D{}".format(*s))
def test_f32_forward_twin_matches_the_pallas_kernel(shape, causal):
    q, k, v = _qkv(1, *shape)
    D = shape[-1]
    want_o, want_lse = jfa.flash_attention_with_lse(*map(jnp.asarray, (q, k, v)), causal=causal)
    o, lse = tfa.flash_forward_f32_plain(*map(torch.from_numpy, (q, k, v)), causal=causal, sm_scale=D**-0.5)
    assert o.dtype == torch.float32
    _close(o.numpy(), want_o, LOGIT_TOL)
    _close(lse.numpy(), want_lse, LOGIT_TOL)


def test_f32_chunk_twin_matches_the_pallas_kernel():
    """A chunk at q_offset > 0 against a longer K/V (forward only, as in JAX)."""
    q, k, v = _qkv(2, 1, 4, 4, 64, 64, Skv=192)
    want = jfa.flash_attention_chunked(*map(jnp.asarray, (q, k, v)), q_offset=128, causal=True)
    o, _ = tfa.flash_forward_f32_plain(*map(torch.from_numpy, (q, k, v)), causal=True, sm_scale=64**-0.5,
                                       q_offset=128)
    _close(o.numpy(), want, LOGIT_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", F32_SHAPES, ids=lambda s: "B{}-Hq{}-Hkv{}-S{}-D{}".format(*s))
def test_f32_backward_twins_match_the_pallas_kernels(shape, causal):
    """dQ and dK/dV from the f32 twins against ``jax.vjp`` of the Pallas
    forward with a nonzero lse cotangent (``_dq_kernel``, ``_dkv_kernel``)."""
    q, k, v = _qkv(3, *shape)
    D = shape[-1]
    rng = np.random.default_rng(4)
    do = rng.standard_normal(q.shape).astype(np.float32)
    dlse = rng.standard_normal(q.shape[:3]).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention_with_lse(q, k, v, causal=causal), *map(jnp.asarray, (q, k, v)))
    want = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    tq, tk, tv, tdo, tdlse = map(torch.from_numpy, (q, k, v, do, dlse))
    o, lse = tfa.flash_forward_f32_plain(tq, tk, tv, causal=causal, sm_scale=D**-0.5)
    delta = (tdo * o).sum(dim=-1)
    args = (tq, tk, tv, tdo, lse, delta, tdlse)
    dq = tfa.flash_bwd_dq_f32_plain(*args, causal=causal, sm_scale=D**-0.5)
    dk, dv = tfa.flash_bwd_dkv_f32_plain(*args, causal=causal, sm_scale=D**-0.5)
    for got, w in zip((dq, dk, dv), want):
        assert got.dtype == torch.float32
        _close(got.numpy(), w, GRAD_TOL)


def test_f32_instances_take_no_bf16_launch_on_the_cpu():
    """On CPU tensors the f32 path is the twins: no kernel counter moves."""
    before = (tfa.launches, tfa.f32_launches, tfa.dq_f32_launches, tfa.dkv_f32_launches)
    q, k, v = (torch.randn(1, 2, 16, 32, requires_grad=True) for _ in range(3))
    tfa.flash_attention(q, k, v, causal=True).sum().backward()
    assert (tfa.launches, tfa.f32_launches, tfa.dq_f32_launches, tfa.dkv_f32_launches) == before
    assert q.grad is not None and q.grad.dtype == torch.float32
