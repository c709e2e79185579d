"""The port's flash attention gradients against the JAX package's Pallas
backward (``_dq_kernel``/``_dkv_kernel``, interpret mode on the CPU).

On the CPU the port's backward is ``flash_backward_plain`` behind the
``torch.autograd.Function``; the JAX side is ``jax.grad``/``jax.vjp`` of its
custom-VJP functions. Inputs are made with numpy from a seed. Tolerance:
atol = rtol = 1e-4 in f32, as ``tests/test_ops.py`` holds the JAX kernels
against reference gradients (products accumulate in another order).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modal_examples_tpu_torch.ops import flash_attention as tfa
from modal_examples_tpu_torch.ops import reference as tref
from test_torch_time_limit import share_cores

share_cores()

jfa = importlib.import_module("modal_examples_tpu.ops.flash_attention")

TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(seed, B, Hq, Hkv, S, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, S, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    return q, k, v


def _torch_grads(fn, arrays, cotangents):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cotangents])
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 4, 2, 256, 64), (1, 2, 2, 96, 32)], ids=["gqa-multiblock", "ragged-one-block"])
def test_flash_attention_grads_match_jax(causal, shape):
    q, k, v = _inputs(11, *shape)
    do = np.random.default_rng(12).standard_normal(q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(q, k, v, causal), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    got = _torch_grads(lambda q, k, v: tfa.flash_attention(q, k, v, causal), (q, k, v), (do,))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_with_lse_grads_match_jax(causal):
    """Nonzero cotangents on both outputs: the lse cotangent enters dS."""
    q, k, v = _inputs(21, 2, 4, 2, 128, 64)
    rng = np.random.default_rng(22)
    do = rng.standard_normal(q.shape).astype(np.float32)
    dlse = rng.standard_normal(q.shape[:3]).astype(np.float32)
    _, vjp = jax.vjp(
        lambda q, k, v: jfa.flash_attention_with_lse(q, k, v, causal=causal), *map(jnp.asarray, (q, k, v))
    )
    want = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    got = _torch_grads(
        lambda q, k, v: tfa.flash_attention_with_lse(q, k, v, causal=causal), (q, k, v), (do, dlse)
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


def test_plain_backward_matches_autograd_of_dense_attention():
    """flash_backward_plain is the kernels' function, not autograd: it agrees
    with autograd through the dense twin."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(31, 1, 4, 1, 80, 32))
    do = torch.from_numpy(np.random.default_rng(32).standard_normal(q.shape).astype(np.float32))
    o, lse = tfa.flash_forward_plain(q, k, v, causal=True, sm_scale=32**-0.5)
    got = tfa.flash_backward_plain(q, k, v, o, lse, do, torch.zeros_like(lse), causal=True, sm_scale=32**-0.5)
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    tref.attention(qs, ks, vs, causal=True).backward(do)
    for g, w in zip(got, (qs.grad, ks.grad, vs.grad)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


def test_fully_masked_rows_get_zero_gradients():
    """lse = -inf rows (a fully masked row) give P = 0: finite, zero grads."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(41, 1, 2, 2, 16, 32))
    o, lse = tfa.flash_forward_plain(q, k, v, causal=True, sm_scale=32**-0.5)
    lse[:, :, :3] = float("-inf")
    do = torch.ones_like(o)
    dq, dk, dv = tfa.flash_backward_plain(q, k, v, o, lse, do, torch.zeros_like(lse), causal=True, sm_scale=32**-0.5)
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
    assert dq[:, :, :3].abs().max() == 0


def test_chunked_stays_forward_only_and_training_path_is_differentiable():
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _inputs(51, 1, 2, 2, 32, 32))
    out = tfa.flash_attention(q, k, v)
    assert out.grad_fn is not None
    with torch.no_grad():
        assert tfa.flash_attention_chunked(q, k, v, q_offset=0).grad_fn is None


@pytest.mark.gpu
@pytest.mark.parametrize(
    "B,hq,hkv,s,d,causal",
    [(1, 4, 4, 200, 64, True), (2, 8, 2, 300, 128, True), (1, 4, 4, 200, 64, False), (2, 8, 2, 300, 32, True),
     (1, 4, 2, 200, 256, True), (1, 4, 2, 200, 256, False)],
    ids=["causal", "ragged-gqa", "non-causal", "d32", "d256", "d256-non-causal"],
)
def test_cuda_backward_launches_the_kernels(B, hq, hkv, s, d, causal):
    """On a CUDA tensor the backward runs the dQ and dK/dV kernels, once each
    per call, and agrees with the plain backward (bf16 inputs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the backward kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(B, hq, s, d, generator=g, device="cuda").bfloat16().requires_grad_(True)
    k, v = (torch.randn(B, hkv, s, d, generator=g, device="cuda").bfloat16().requires_grad_(True) for _ in range(2))
    n_dq, n_dkv = tfa.dq_launches, tfa.dkv_launches
    tfa.flash_attention(q, k, v, causal).float().square().sum().backward()
    assert (tfa.dq_launches - n_dq, tfa.dkv_launches - n_dkv) == (1, 1)
    o, lse = tfa.flash_forward_plain(q.detach(), k.detach(), v.detach(), causal=causal, sm_scale=d**-0.5)
    want = tfa.flash_backward_plain(q.detach(), k.detach(), v.detach(), o, lse, 2 * o.float(),
                                    torch.zeros_like(lse), causal=causal, sm_scale=d**-0.5)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        err = (got.float() - w.float()).abs().max() / w.float().abs().max()
        assert err < 2e-2
