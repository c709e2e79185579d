"""Ring and Ulysses attention (``ops/ring_attention.py``) over a ``seq``
mesh of two CPU rank processes, against the JAX package's.

Each rank holds one block of the sequence; the flash kernel (K1, its plain
version here) runs at each ring hop and on the Ulysses heads. Held, in
f32: the forward against the JAX ``ring_attention_sharded`` and
``ulysses_attention_sharded`` on a ``seq`` mesh of 2 (causal and full;
3e-5 absolute and 1e-4 relative, ``tests/test_ops.py``'s tolerance); a GQA
ring against the port's one-rank flash attention; the ring's gradients
(the flash backward, K5/K6, through the ring shift's reverse permutation)
against the dense plain attention's at ``tests/test_ops.py:380-402``'s
tolerance (5e-5 absolute, 1e-4 relative) at 256 tokens; heads that the
ranks do not divide raise.
"""

import numpy as np
import pytest

from test_torch_time_limit import share_cores, time_limits
import torch_rank_cases as cases

share_cores()

_limit_module, _limit_test = time_limits(test_s=120, module_s=180)
gang = cases.gang_fixture(2)

TOL = dict(atol=3e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def jax(jax_cpu):
    return jax_cpu


def _qkv(jax, shape_q, shape_kv, seed):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    return (np.asarray(jax.random.normal(ks[0], shape_q)), np.asarray(jax.random.normal(ks[1], shape_kv)),
            np.asarray(jax.random.normal(ks[2], shape_kv)))


@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_the_jax_ring_and_ulysses(jax, gang, causal):
    from modal_examples_tpu.ops.ring_attention import ring_attention_sharded, ulysses_attention_sharded
    from modal_examples_tpu.parallel import make_mesh

    mesh = make_mesh({"seq": 2}, devices=jax.devices()[:2])
    q, k, v = _qkv(jax, (1, 4, 128, 32), (1, 4, 128, 32), 13)
    want_ring = np.asarray(ring_attention_sharded(q, k, v, mesh, causal=causal))
    want_uly = np.asarray(ulysses_attention_sharded(q, k, v, mesh, causal=causal))
    for out in gang.run(cases.ring_and_ulysses, q, k, v, causal, False):
        np.testing.assert_allclose(out["ring"], want_ring, **TOL)
        np.testing.assert_allclose(out["ulysses"], want_uly, **TOL)


def test_gqa_ring_matches_one_rank_flash(jax, gang):
    import torch

    from modal_examples_tpu_torch.ops import flash_attention as tfa

    q, k, v = _qkv(jax, (1, 4, 128, 32), (1, 2, 128, 32), 5)
    want = tfa.flash_attention(*(torch.from_numpy(a.copy()) for a in (q, k, v)), True).numpy()
    for out in gang.run(cases.ring_and_ulysses, q, k, v, True, False):
        np.testing.assert_allclose(out["ring"], want, **TOL)
        np.testing.assert_allclose(out["ulysses"], want, **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_gradients_match_dense(jax, gang, causal):
    import jax.numpy as jnp

    from modal_examples_tpu.ops import reference

    q, k, v = _qkv(jax, (1, 2, 256, 64), (1, 2, 256, 64), 9)
    want = jax.grad(lambda q, k, v: reference.attention(q, k, v, causal=causal).sum(), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for r, out in enumerate(gang.run(cases.ring_and_ulysses, q, k, v, causal, True)):
        for got, ref in zip(out["grads"], want):
            np.testing.assert_allclose(got, np.split(np.asarray(ref), 2, axis=2)[r], atol=5e-5, rtol=1e-4)


def test_ulysses_rejects_indivisible_heads(gang):
    assert all("divisible by seq shards 2" in m for m in gang.run(cases.ulysses_refused))
