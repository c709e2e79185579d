"""The port's sampling against the JAX package's: seeded row keys must be
bit-identical (threefry with the partitionable derivation) and sampled
tokens identical for greedy, seeded temperature, top-k and top-p rows on the
same f32 logits."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modal_examples_tpu.serving import sampling as js
from modal_examples_tpu_torch.serving import sampling as ts
from test_torch_time_limit import share_cores

share_cores()


def test_jax_derivation_is_the_partitionable_one():
    # the port reproduces this derivation of split/random_bits
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("engine_key", [0, 42, 2**31 - 1])
def test_seeded_row_keys_bit_identical(engine_key):
    seeds = np.array([0, 1, 7, 123456, 2**31 - 2, -1, 5, -1], np.int32)
    for step0 in (0, 1, 4095, 10**6):
        steps = (np.arange(8) * 37 + step0).astype(np.int32)
        ref = js.seeded_row_keys(jax.random.PRNGKey(engine_key), jnp.asarray(seeds), jnp.asarray(steps))
        out = ts.seeded_row_keys(ts.prng_key(engine_key), torch.from_numpy(seeds), torch.from_numpy(steps))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref).astype(np.int64))


def test_prng_primitives_bit_identical():
    key = jax.random.PRNGKey(3)
    np.testing.assert_array_equal(ts.split(ts.prng_key(3), 5).numpy(), np.asarray(jax.random.split(key, 5)))
    np.testing.assert_array_equal(
        ts.fold_in(ts.prng_key(3), 99).numpy(), np.asarray(jax.random.fold_in(key, 99))
    )
    bits = ts.random_bits32(ts.prng_key(3)[None], 1000)[0].numpy()
    np.testing.assert_array_equal(bits, np.asarray(jax.random.bits(key, (1000,))).astype(np.int64))
    # the bits are exact; -log(-log(u)) differs from XLA's log by a few ulps
    np.testing.assert_allclose(
        ts.gumbel(ts.prng_key(3)[None], 1000)[0].numpy(), np.asarray(jax.random.gumbel(key, (1000,))),
        rtol=1e-5, atol=1e-6,
    )


@pytest.mark.parametrize("trial", range(6))
def test_sample_token_identical(trial):
    rng = np.random.default_rng(trial)
    logits = (rng.standard_normal((8, 512)) * 3).astype(np.float32)
    temps = np.array([0, 1, 0.7, 1.3, 1, 0.5, 2, 1], np.float32)  # row 0 greedy
    top_p = np.array([1, 1, 0.9, 1, 0.5, 1, 1, 1], np.float32)
    top_k = np.array([0, 0, 0, 5, 0, 40, 0, 0], np.int32)
    seeds = np.array([3, 1, 7, 123, 9, 11, 5, 2], np.int32)
    steps = (np.arange(8) + 100 * trial).astype(np.int32)
    args_j = [jnp.asarray(a) for a in (temps, top_p, top_k)]
    args_t = [torch.from_numpy(a) for a in (temps, top_p, top_k)]
    ref = js.sample(jnp.asarray(logits), jax.random.PRNGKey(trial), *args_j,
                    seeds=jnp.asarray(seeds), step_ids=jnp.asarray(steps))
    out = ts.sample(torch.from_numpy(logits), ts.prng_key(trial), *args_t,
                    seeds=torch.from_numpy(seeds), step_ids=torch.from_numpy(steps))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # engine-key rows (no seeds) follow the same key stream
    ref = js.sample(jnp.asarray(logits), jax.random.PRNGKey(trial), jnp.asarray(temps),
                    jnp.ones(8), jnp.zeros(8, jnp.int32))
    out = ts.sample(torch.from_numpy(logits), ts.prng_key(trial), torch.from_numpy(temps),
                    torch.ones(8), torch.zeros(8, dtype=torch.int32))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
