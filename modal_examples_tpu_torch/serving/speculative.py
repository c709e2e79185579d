"""Speculative decoding's reference oracle: single-sequence propose/verify.

Counterpart of ``modal_examples_tpu/serving/speculative.py``
(``speculative_generate``, ``greedy_generate``). It is not the serving path:
the engine speculates with the batched, paged round of
:mod:`~.spec_runtime`. This is the textbook algorithm in its simplest form,
the yardstick the round is tested against; nothing in the package imports
it.

A small draft llama proposes γ tokens one at a time, the target scores them
in one teacher-forced forward, and speculative sampling accepts a prefix
(greedy: while the draft's token is the target's argmax; sampled: token x
with probability min(1, p_t(x)/p_d(x)), the rejected position resampled from
the normalised residual max(p_t - p_d, 0)), so the output distribution is the
target's. Every forward runs over the whole fixed-size token buffer (no
cache), as the JAX oracle does; its keys and draws are the JAX oracle's.
"""

from __future__ import annotations

import torch

from ..models import llama
from .sampling import categorical, split, uniform


def _logits_at(params, cfg, buf):
    """[S] token buffer -> [S, V] next-token logits (teacher-forced, plain attention)."""
    return llama.forward(params, buf[None], cfg, attn_impl="xla")[0]


def speculative_generate(
    target_params, draft_params, target_cfg, draft_cfg, prompt, prompt_len: int, key, *, max_new: int = 32,
    gamma: int = 4, greedy: bool = True, temperature: float = 1.0,
):
    """Returns (buffer [S0 + max_new], n_generated). ``prompt`` [S0] int32,
    ``key`` a ``sampling.prng_key``. Greedy mode reproduces the target's
    greedy decode exactly; sampled mode draws from the target's distribution
    through accept/reject."""
    S = prompt.shape[0] + max_new
    dev = prompt.device
    buf = torch.zeros((S,), dtype=torch.int32, device=dev)
    buf[: prompt.shape[0]] = prompt
    pos, n_gen = int(prompt_len), 0
    temp = max(temperature, 1e-6)
    while n_gen < max_new and pos < S:
        key, k_draft, k_acc, k_res = split(key, 4)

        # 1) the draft proposes gamma tokens one at a time
        buf_d, p = buf.clone(), pos
        draft_toks, draft_logits = [], []
        for k in split(k_draft, gamma):
            lp = _logits_at(draft_params, draft_cfg, buf_d)[min(max(p - 1, 0), S - 1)] / temp
            tok = torch.argmax(lp) if greedy else categorical(k[None], lp[None])[0]
            buf_d[min(p, S - 1)] = tok.to(torch.int32)
            p = min(p + 1, S)
            draft_toks.append(tok.to(torch.int32))
            draft_logits.append(lp)
        draft_toks, draft_logits = torch.stack(draft_toks), torch.stack(draft_logits)

        # 2) the target scores the whole chain in one forward
        t_all = _logits_at(target_params, target_cfg, buf_d)
        idx = (pos - 1 + torch.arange(gamma, device=dev)).clamp(0, S - 1)
        t_logits = t_all[idx] / temp  # [gamma, V]

        # 3) acceptance: n_acc is the first rejection (gamma when none)
        if greedy:
            t_choice = torch.argmax(t_logits, dim=-1).to(torch.int32)
            accept = t_choice == draft_toks
            n_acc = int(torch.argmin(torch.cat([accept.int(), accept.new_zeros(1, dtype=torch.int32)])))
            fix_tok = t_choice[min(n_acc, gamma - 1)]
        else:
            p_t, p_d = torch.softmax(t_logits, dim=-1), torch.softmax(draft_logits, dim=-1)
            rows = torch.arange(gamma, device=dev)
            tok_pt, tok_pd = p_t[rows, draft_toks.long()], p_d[rows, draft_toks.long()]
            u = uniform(k_acc, (gamma,))
            accept = u < torch.clamp(tok_pt / torch.clamp(tok_pd, min=1e-20), max=1.0)
            n_acc = int(torch.argmin(torch.cat([accept.int(), accept.new_zeros(1, dtype=torch.int32)])))
            j = min(n_acc, gamma - 1)
            residual = torch.clamp(p_t[j] - p_d[j], min=0.0)
            total = residual.sum()
            residual = residual / total if total > 0 else p_t[j]
            fix_tok = categorical(k_res[None], torch.log(residual + 1e-20)[None])[0].to(torch.int32)

        # 4) commit the accepted draft tokens, then the fix token, within the budget
        take = min(n_acc, max_new - n_gen)
        buf[pos : pos + take] = draft_toks[:take]
        fix = n_acc < gamma and n_acc < max_new - n_gen
        if fix:
            buf[pos + n_acc] = fix_tok
        pos += take + fix
        n_gen += take + fix
    return buf, n_gen


def greedy_generate(params, cfg, prompt, prompt_len: int, max_new: int):
    """Plain greedy decode: what speculative greedy must reproduce."""
    S = prompt.shape[0] + max_new
    buf = torch.zeros((S,), dtype=torch.int32, device=prompt.device)
    buf[: prompt.shape[0]] = prompt
    p = int(prompt_len)
    for _ in range(max_new):
        logits = _logits_at(params, cfg, buf)
        buf[min(p, S - 1)] = torch.argmax(logits[min(max(p - 1, 0), S - 1)]).to(torch.int32)
        p = min(p + 1, S)
    return buf
