"""GRPO: group-relative policy optimization for LLM fine-tuning.

Counterpart of ``modal_examples_tpu/training/grpo.py`` (``GRPOConfig``,
``sample_group``, ``_completion_logprobs``, ``grpo_advantages``,
``grpo_loss``, ``GRPOTrainer``):

- rollouts: a group of stochastic completions of one prompt, the whole
  sequence re-run every step through ``llama.forward`` with the plain
  attention (``attn_impl="xla"``, as the reference's rollouts), step i's
  tokens drawn with key i of ``split(key, max_new)`` by JAX's threefry
  categorical (``serving/sampling.py``: one key's gumbel noise over the
  whole [G, vocab] array), so the port and the JAX package draw the same
  tokens from the same key;
- advantages: each reward normalized within its group (no value network);
- loss: the PPO-style clipped importance ratio against the behavior
  policy's log-probabilities, plus a k3 KL penalty to a frozen reference
  policy;
- the update: every floating parameter of the policy trained by AdamW at
  optax's ``adamw`` defaults (b1 0.9, b2 0.999, eps 1e-8, weight decay
  1e-4, no clipping: the port's ``AdamW`` with an infinite clip norm).

Rewards are any Python function of the rollout tokens [G, S].
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..models import llama
from ..serving import sampling
from ..utils import tree
from .trainer import AdamW, apply_updates


@dataclasses.dataclass(frozen=True)
class GRPOConfig:
    group_size: int = 8
    clip_eps: float = 0.2
    kl_coef: float = 0.02
    temperature: float = 1.0
    max_new: int = 8


def _categorical_shared(key, logits):
    """``jax.random.categorical(key, logits, axis=-1)`` for logits [G, V]:
    one key's gumbel noise over the whole array (not a key a row)."""
    G, V = logits.shape
    noise = sampling.gumbel(key[None], G * V)[0].reshape(G, V)
    return torch.argmax(logits + noise, dim=-1)


@torch.no_grad()
def sample_group(params, cfg: llama.LlamaConfig, prompts, prompt_len: int, key, *, max_new: int,
                 temperature: float):
    """Stochastic rollouts of prompts [G, S0] from position ``prompt_len``:
    returns (tokens [G, S0 + max_new] int64, the behavior policy's
    log-probabilities of the drawn tokens [G, max_new] f32)."""
    G, S0 = prompts.shape
    dev = prompts.device
    buf = torch.zeros((G, S0 + max_new), dtype=torch.int64, device=dev)
    buf[:, :S0] = prompts
    keys = sampling.split(key.to(dev), max_new)
    pos, lps = int(prompt_len), []
    for i in range(max_new):
        logits = llama.forward(params, buf, cfg, attn_impl="xla")
        lp = torch.log_softmax(logits[:, pos - 1] / max(temperature, 1e-6), dim=-1)
        tok = _categorical_shared(keys[i], lp)
        lps.append(torch.gather(lp, 1, tok[:, None])[:, 0])
        buf[:, pos] = tok
        pos += 1
    return buf, torch.stack(lps, dim=1)


def _completion_logprobs(params, cfg, tokens, prompt_len: int, max_new: int, temperature: float = 1.0):
    """Per-token log-probabilities of the completion region [G, max_new]
    under ``params``, at the behavior policy's temperature (the ratio means
    something only when both sides use one distribution)."""
    logits = llama.forward(params, tokens, cfg, attn_impl="xla")
    idx = prompt_len - 1 + torch.arange(max_new, device=tokens.device)  # predicts positions idx + 1
    lp = torch.log_softmax(logits[:, idx] / max(temperature, 1e-6), dim=-1)  # the same rows the reference takes
    targets = tokens[:, prompt_len : prompt_len + max_new]
    return torch.gather(lp, -1, targets[..., None])[..., 0]


def grpo_advantages(rewards):
    """Group-normalized advantages (r - mean) / (std + 1e-6), one group."""
    return (rewards - rewards.mean()) / (rewards.std(unbiased=False) + 1e-6)


def grpo_loss(policy_params, ref_params, cfg: llama.LlamaConfig, tokens, behavior_lps, advantages, *,
              prompt_len: int, max_new: int, clip_eps: float, kl_coef: float, temperature: float = 1.0):
    """The clipped policy-gradient loss plus ``kl_coef`` x the k3 KL to the
    reference policy. Returns (loss, {"pg_loss", "kl"})."""
    new_lps = _completion_logprobs(policy_params, cfg, tokens, prompt_len, max_new, temperature)
    ratio = torch.exp(new_lps - behavior_lps)
    adv = advantages[:, None]
    pg = -torch.minimum(ratio * adv, torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps) * adv).mean()
    with torch.no_grad():
        ref_lps = _completion_logprobs(ref_params, cfg, tokens, prompt_len, max_new, temperature)
    log_r = ref_lps - new_lps
    kl = (torch.exp(log_r) - log_r - 1.0).mean()
    return pg + kl_coef * kl, {"pg_loss": pg, "kl": kl}


class GRPOTrainer:
    """Rollout, reward, advantage, clipped update: one prompt group a step.
    ``params`` (every leaf a floating tensor) is the policy, replaced by its
    update at each step (``self.policy``); ``ref`` is a frozen copy taken
    here. ``last`` keeps the latest step's
    rollout (tokens, behavior log-probabilities, advantages)."""

    def __init__(self, cfg: llama.LlamaConfig, params, reward_fn: Callable, grpo: GRPOConfig = GRPOConfig(),
                 learning_rate: float = 1e-4):
        self.cfg, self.grpo, self.reward_fn = cfg, grpo, reward_fn
        self.policy = tree.map(lambda x: x.detach().requires_grad_(True), params)
        self.ref = tree.map(lambda x: x.detach().clone(), params)
        # optax.adamw(learning_rate)'s defaults; no gradient clipping
        self.opt = AdamW(learning_rate, weight_decay=1e-4, b1=0.9, b2=0.999, eps=1e-8, grad_clip=float("inf"))
        self.opt_state = self.opt.init(self.policy)
        self.last: dict = {}

    def step(self, prompt, prompt_len: int, key, reward_fn: Callable | None = None) -> dict:
        g = self.grpo
        reward_fn = reward_fn or self.reward_fn
        prompts = prompt[None].expand(g.group_size, -1)
        tokens, behavior_lps = sample_group(self.policy, self.cfg, prompts, prompt_len, key, max_new=g.max_new,
                                            temperature=g.temperature)
        rewards = torch.as_tensor(reward_fn(tokens), dtype=torch.float32, device=tokens.device)
        if tuple(rewards.shape) != (g.group_size,):
            raise ValueError(f"reward_fn returned shape {tuple(rewards.shape)}, expected ({g.group_size},)")
        adv = grpo_advantages(rewards)
        loss, _ = grpo_loss(self.policy, self.ref, self.cfg, tokens, behavior_lps, adv, prompt_len=prompt_len,
                            max_new=g.max_new, clip_eps=g.clip_eps, kl_coef=g.kl_coef, temperature=g.temperature)
        leaves = tree.leaves(self.policy)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = tree.unflatten(self.policy, [torch.zeros_like(x) if gr is None else gr for x, gr in zip(leaves, grads)])
        with torch.no_grad():
            updates, self.opt_state = self.opt.update(grads, self.opt_state, self.policy)
            new = apply_updates(self.policy, updates)
        self.policy = tree.map(lambda x: x.detach().requires_grad_(True), new)
        self.last = {"tokens": tokens, "behavior_lps": behavior_lps, "advantages": adv}
        return {"mean_reward": float(rewards.mean()), "max_reward": float(rewards.max()),
                "adv_std": float(adv.std(unbiased=False))}
