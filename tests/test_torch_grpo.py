"""The port's GRPO (``training/grpo.py``) against the JAX package's, on the
CPU, over a tiny f32 Llama: the rollouts (tokens drawn from the same key,
their behavior log-probabilities), the group advantages, ``grpo_loss`` and
its gradients, and one ``GRPOTrainer.step`` against the JAX trainer (optax
``adamw`` at its defaults).

Same weights (the JAX ``init_params`` through ``params_from_jax``; the
policy perturbed away from the reference by a seeded N(0, 0.02) where the
loss's KL term needs them apart), same prompt and key. Tolerances, f32:
tokens equal; log-probabilities and losses within 1e-5; gradients within
1e-4 of each leaf's largest; parameters after the step at
``test_torch_lora_int8.py``'s rule (99.9% of entries within rtol 1e-4 and
atol 1e-3 x lr, every entry within lr: Adam's first step moves an entry by
about lr x the sign of its gradient, so a gradient near zero may flip).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modal_examples_tpu.models import llama as jllama
from modal_examples_tpu.training import grpo as jgrpo
from modal_examples_tpu_torch.models import llama as tllama
from modal_examples_tpu_torch.serving import sampling
from modal_examples_tpu_torch.training import grpo as tgrpo
from modal_examples_tpu_torch.utils import tree
from test_torch_time_limit import share_cores

share_cores()

TOL = 1e-5
GRAD_TOL = 1e-4
LR = 1e-4
PROMPT_LEN = 12


def _models(seed=0, perturb=None):
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(vocab_size=256), dtype="float32")
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(vocab_size=256), dtype="float32")
    jp = jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(seed), jcfg))
    if perturb is not None:
        rng = np.random.default_rng(perturb)
        jp = jax.tree.map(lambda a: (a + rng.normal(0, 0.02, a.shape)).astype(np.float32), jp)
    return jcfg, tcfg, jp, tllama.params_from_jax(jp, tcfg, device="cpu")


def _prompt(seed=1, V=256):
    return np.random.default_rng(seed).integers(0, V, PROMPT_LEN).astype(np.int32)


def _jtree(t):
    return jax.tree.map(jnp.asarray, t)


def _reward(tokens):
    """A deterministic reward of the completion: its tokens divisible by 5."""
    rows = np.asarray(tokens)
    return [float((r[PROMPT_LEN:] % 5 == 0).sum()) + 0.25 * float(r[PROMPT_LEN] % 2) for r in rows]


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_sample_group_draws_the_jax_rollouts(temperature):
    jcfg, tcfg, jp, tp = _models()
    G, max_new = 4, 6
    prompts = np.tile(_prompt()[None], (G, 1))
    jt, jlps = jgrpo.sample_group(_jtree(jp), jcfg, jnp.asarray(prompts), PROMPT_LEN, jax.random.PRNGKey(3),
                                  max_new=max_new, temperature=temperature)
    tt, tlps = tgrpo.sample_group(tp, tcfg, torch.from_numpy(prompts).long(), PROMPT_LEN, sampling.prng_key(3),
                                  max_new=max_new, temperature=temperature)
    assert tt.tolist() == np.asarray(jt).tolist()
    np.testing.assert_allclose(tlps.numpy(), np.asarray(jlps), rtol=0, atol=TOL * np.abs(np.asarray(jlps)).max())
    assert len({tuple(r) for r in tt[:, PROMPT_LEN:].tolist()}) > 1  # the group's rows differ


def test_grpo_advantages_match_jax():
    r = np.array([1.0, 0.0, 3.0, 0.5, 2.0, 2.0, 0.0, 1.5], np.float32)
    np.testing.assert_allclose(tgrpo.grpo_advantages(torch.from_numpy(r)).numpy(),
                               np.asarray(jgrpo.grpo_advantages(jnp.asarray(r))), rtol=1e-6, atol=1e-6)
    flat = np.ones(8, np.float32)  # a group with one reward: zero advantages, no division by zero
    assert tgrpo.grpo_advantages(torch.from_numpy(flat)).abs().max().item() == 0.0


def _flat(node, prefix=""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, node


def _port_tree_as_jax(tcfg, t):
    """The port's llama tree (layers a list) stacked as the JAX tree."""
    stacked = {k: np.stack([layer[k].detach().numpy() for layer in t["layers"]]) for k in t["layers"][0]}
    return {**{k: v.detach().numpy() for k, v in t.items() if k != "layers"}, "layers": stacked}


def test_grpo_loss_and_grads_match_jax():
    jcfg, tcfg, jref, tref = _models(seed=0)
    _, _, jpol, tpol = _models(seed=0, perturb=5)
    G, max_new = 4, 5
    prompts = np.tile(_prompt(2)[None], (G, 1))
    tokens, blps = jgrpo.sample_group(_jtree(jref), jcfg, jnp.asarray(prompts), PROMPT_LEN, jax.random.PRNGKey(4),
                                      max_new=max_new, temperature=1.0)
    adv = np.array([1.2, -0.4, 0.3, -1.1], np.float32)
    kw = dict(prompt_len=PROMPT_LEN, max_new=max_new, clip_eps=0.2, kl_coef=0.02, temperature=1.0)

    def jloss(p):
        return jgrpo.grpo_loss(p, _jtree(jref), jcfg, tokens, blps, jnp.asarray(adv), **kw)

    (want_loss, want_aux), want = jax.value_and_grad(jloss, has_aux=True)(_jtree(jpol))
    leaves = [p.detach().clone().requires_grad_(True) for p in tree.leaves(tpol)]
    loss, aux = tgrpo.grpo_loss(tree.unflatten(tpol, leaves), tref, tcfg, torch.from_numpy(np.asarray(tokens)).long(),
                                torch.from_numpy(np.asarray(blps)), torch.from_numpy(adv), **kw)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL)
    np.testing.assert_allclose(aux["kl"].item(), float(want_aux["kl"]), rtol=1e-4)
    assert float(want_aux["kl"]) > 0  # the perturbed policy is away from the reference
    grads = _port_tree_as_jax(tcfg, tree.unflatten(tpol, list(torch.autograd.grad(loss, leaves))))
    got, want = dict(_flat(grads)), dict(_flat(jax.tree.map(np.asarray, want)))
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        w = want[path]
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * max(np.abs(w).max(), 1e-6), err_msg=path)


def test_trainer_step_matches_jax_and_optax():
    jcfg, tcfg, jp, tp = _models(seed=6)
    grpo = dict(group_size=6, clip_eps=0.2, kl_coef=0.02, temperature=1.0, max_new=5)
    jt = jgrpo.GRPOTrainer(jcfg, _jtree(jp), _reward, jgrpo.GRPOConfig(**grpo), learning_rate=LR)
    tt = tgrpo.GRPOTrainer(tcfg, tp, _reward, tgrpo.GRPOConfig(**grpo), learning_rate=LR)
    prompt = _prompt(7)
    for step in range(2):
        want = jt.step(jnp.asarray(prompt), PROMPT_LEN, jax.random.PRNGKey(10 + step))
        got = tt.step(torch.from_numpy(prompt).long(), PROMPT_LEN, sampling.prng_key(10 + step))
        assert got["mean_reward"] == pytest.approx(want["mean_reward"]) and got["max_reward"] == want["max_reward"]
        assert got["adv_std"] == pytest.approx(want["adv_std"], rel=1e-5)
    assert want["adv_std"] > 0  # the rewards differed: the step moved the policy
    got_p, want_p = dict(_flat(_port_tree_as_jax(tcfg, tt.policy))), dict(_flat(jax.tree.map(np.asarray, jt.policy)))
    moved = 0
    for path, g in got_p.items():
        w = want_p[path]
        diff = np.abs(g - w)
        assert diff.max() <= LR, path
        assert (diff <= 1e-4 * np.abs(w) + 1e-3 * LR).mean() >= 0.999, path
        moved += int((np.abs(g - dict(_flat(jax.tree.map(np.asarray, jp)))[path]) > 0).sum())
    assert moved > 0
    ref = dict(_flat(_port_tree_as_jax(tcfg, tt.ref)))
    for path, w in dict(_flat(jax.tree.map(np.asarray, jp))).items():
        np.testing.assert_array_equal(ref[path], w, err_msg=path)  # the reference policy stays frozen


def test_trainer_refuses_a_reward_of_the_wrong_shape():
    _, tcfg, _, tp = _models(seed=1)
    tt = tgrpo.GRPOTrainer(tcfg, tp, lambda t: [1.0, 2.0], tgrpo.GRPOConfig(group_size=4, max_new=2))
    with pytest.raises(ValueError, match="expected \\(4,\\)"):
        tt.step(torch.from_numpy(_prompt()).long(), PROMPT_LEN, sampling.prng_key(0))
