"""The speculative round programs: propose(γ), verify and accept in one
dispatch.

Counterpart of ``modal_examples_tpu/serving/spec_runtime/runtime.py``
(``SPEC_ADAPTIVE_ENV``, ``resolve_spec_adaptive``, ``accept_reject``,
``_emit_plane``, ``build_spec_round_fn``, ``build_ngram_round_fn``).

One engine round of draft-model speculation is a γ-step propose loop of the
draft model on :func:`~...ops.scan_loop.masked_scan` (a lane dies when its
per-slot γ is spent or it runs out of page-table capacity), one step that
writes the draft's K/V of its last proposal, one teacher-forced target pass
over all γ+1 chain positions against the paged cache
(``llama.verify_step``), and the accept/reject cut. Prompt-lookup (ngram)
mode takes its proposals from the host and runs the same verify and
accept. As everywhere in the port, the pages are updated in place and every
step runs on the card without a host read: the scan decides on the device
whether a step had a live lane.

Per-slot γ rides the batch as ``gammas [B]``: a lane at 0 proposes nothing
and takes the classic sampling path, its token drawn by the same
``sampling.sample`` call the decode block makes ((seed, position)-keyed, with
top_p/top_k), from the verify's first position. That is what lets the
adaptive controller take γ to 0 per request, and what keeps sampled requests
(never given γ > 0 by the engine) token-identical to the non-speculative
engine.

The output is the macro-step harvest plane: ``(toks [γ+1, B], valid [γ+1,
B], last [B])``; ``valid[k, i]`` marks row k of lane i as an accepted token,
so the engine harvests spec rounds and macro-step blocks at one site.

Rollback is implicit: ``verify_step`` writes K/V for every chain position,
rejected positions are overwritten as the accepted position advances and
are never attended past the accept point, and the prefix trie indexes only
tokens the host accepted.

Exactness: greedy lanes commit only the target's argmax tokens, so the
greedy engine is token-identical to the non-speculative one; sampled lanes
accept with the standard rule (min(1, p_t/p_d), resampling a rejection from
max(p_t - p_d, 0)), whose output distribution is the target's. The random
draws are the JAX program's: ``sampling.split``, ``uniform`` and
``categorical`` reproduce ``jax.random`` bit for bit.
"""

from __future__ import annotations

import os

import torch

from ...models import llama
from ...ops.scan_loop import masked_scan
from ..sampling import categorical, sample, split, uniform

#: the adaptive-γ knob (explicit engine argument, then this variable, then off)
SPEC_ADAPTIVE_ENV = "MTPU_SPEC_ADAPTIVE"


def resolve_spec_adaptive(arg: bool | None = None) -> bool:
    """Whether the adaptive-γ controller is on: an explicit ``arg`` beats
    ``MTPU_SPEC_ADAPTIVE``, which beats off. Resolved once at engine build
    into a runtime-mutable attribute."""
    if arg is None:
        raw = os.environ.get(SPEC_ADAPTIVE_ENV, "")
        arg = raw.strip().lower() in ("1", "true", "yes", "on")
    return bool(arg)


def accept_reject(t_logits, proposals, temps, keys2, active, *, gamma: int, proposal_logps=None, prop_valid=None):
    """The accept/reject cut of both modes. ``t_logits`` [B, γ+1, V] are the
    target's logits over the chain, ``proposals`` [B, γ] int32.
    ``proposal_logps`` [B, γ, V] are the draft's log-probs; None means a
    delta proposal (prompt lookup), accepted with probability p_t(x), its
    rejection residual p_t with x zeroed. ``prop_valid`` [B, γ] marks the
    real proposal slots (None: all); a slot past it is never accepted, and an
    all-false row is one plain target step. ``keys2`` are two keys: the
    acceptance uniforms' and the resampling's.

    Greedy lanes (temperature 0) accept while the proposal is the target's
    argmax; sampled lanes accept x with probability min(1, p_t(x)/p_d(x)),
    the token at the cut resampled from max(p_t - p_d, 0), or a bonus token
    from p_t when every real proposal was accepted. Returns (out [B, γ+1]
    int32, n_emit [B])."""
    B = proposals.shape[0]
    dev = proposals.device
    t_scaled = t_logits / torch.clamp(temps, min=1e-6)[:, None, None]
    t_logp = torch.log_softmax(t_scaled, dim=-1)
    greedy_choice = torch.argmax(t_logits, dim=-1).to(torch.int32)
    rows = torch.arange(B, device=dev)
    valid = torch.ones((B, gamma), dtype=torch.bool, device=dev) if prop_valid is None else prop_valid
    n_prop = valid.sum(dim=1)
    match = (proposals == greedy_choice[:, :gamma]) & valid
    idx = proposals.long()[..., None]
    lp_t = torch.gather(t_logp[:, :gamma], 2, idx)[..., 0]
    if proposal_logps is None:
        accept_prob = torch.exp(lp_t)  # min(1, p_t / 1)
    else:
        lp_d = torch.gather(proposal_logps, 2, idx)[..., 0]
        accept_prob = torch.exp(torch.clamp(lp_t - lp_d, max=0.0))
    u = uniform(keys2[0], (B, gamma))
    accept = torch.where((temps <= 0.0)[:, None], match, (u < accept_prob) & valid)
    # the first rejection; gamma when every slot was accepted
    zeros = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    n_acc = torch.argmin(torch.cat([accept.to(torch.int32), zeros], dim=1), dim=1)

    # the token at the cut: the target's fix on a rejection, a fresh bonus
    # sample when every real proposal was accepted
    j = n_acc
    p_t_row = torch.exp(t_logp[rows, j])  # [B, V]
    j_prop = j.clamp(max=gamma - 1)
    if proposal_logps is None:
        residual = p_t_row.index_put((rows, proposals[rows, j_prop].long()), torch.zeros((), device=dev))
    else:
        residual = torch.clamp(p_t_row - torch.exp(proposal_logps[rows, j_prop]), min=0.0)
    rejected = j < n_prop
    has_res = residual.sum(-1, keepdim=True) > 0
    residual = torch.where(rejected[:, None] & has_res, residual, p_t_row)
    sampled_fix = categorical(split(keys2[1], B), torch.log(residual + 1e-20)).to(torch.int32)
    fix = torch.where(temps <= 0.0, greedy_choice[rows, j], sampled_fix)
    out = torch.cat([proposals, zeros], dim=1)
    out[rows, j] = fix
    n_emit = torch.where(active, n_acc + 1, torch.zeros_like(n_acc))
    return out, n_emit


def _emit_plane(out, n_emit, active, gammas, classic_tok):
    """An accept/reject result as the harvest plane. ``classic_tok``
    replaces row 0 of γ=0 lanes: the token the classic sampling path drew
    from the verify's first position, which is the classic decode's
    distribution there. Returns (toks [N, B], valid [N, B], last [B])."""
    B, N = out.shape
    rows = torch.arange(B, device=out.device)
    out = out.clone()
    out[:, 0] = torch.where(active & (gammas == 0), classic_tok, out[:, 0])
    valid = torch.arange(N, device=out.device)[:, None] < n_emit[None, :]
    last = out[rows, (n_emit - 1).clamp(min=0)]
    return out.T.contiguous(), valid, last


def build_spec_round_fn(cfg, draft_cfg, *, paged_impl: str, scatter_impl: str, gamma: int):
    """The draft-mode round for one engine config: γ draft steps on
    ``masked_scan``, the draft's completion step, one target verify, the
    accept cut, the harvest plane.

    The returned function takes ``(params, d_params, tk, tv, dk, dv, tokens,
    positions, page_tables, active, gammas, key, temps, top_ps, top_ks,
    seeds)`` as the JAX program does, plus ``needs_filter`` (whether any row
    has top_p < 1 or top_k > 0, known on the host), and returns ``(toks [γ+1,
    B], valid [γ+1, B], last [B])``; the target pages (tk, tv) and the draft
    pages (dk, dv) are updated in place. ``gammas [B]`` is the per-slot
    proposal budget (at most ``gamma``); lanes at 0 take the classic path.
    """

    def spec_round_fn(
        params, d_params, tk, tv, dk, dv, tokens, positions, page_tables, active, gammas, key, temps, top_ps,
        top_ks, seeds, *, needs_filter: bool | None = None,
    ):
        B = tokens.shape[0]
        cap = page_tables.shape[1] * tk.shape[2]
        keys = split(key, gamma + 3)
        spec_lane = active & (gammas > 0)
        temp_div = torch.clamp(temps, min=1e-6)[:, None]

        def step(live, state, k_i):
            tok, pos, taken = state
            logits, _, _ = llama.decode_step(
                d_params, tok, pos, dk, dv, page_tables, live, draft_cfg, impl=paged_impl,
                scatter_impl=scatter_impl,
            )
            scaled = (logits / temp_div).float()
            proposed = torch.where(
                temps <= 0.0, torch.argmax(logits, dim=-1), categorical(split(k_i, B), scaled)
            ).to(torch.int32)
            proposed = torch.where(live, proposed, tok)  # dead lanes hold
            logp = torch.log_softmax(scaled, dim=-1)
            one = live.to(taken.dtype)
            taken = taken + one
            pos = pos + one  # dead lanes stop advancing
            new_live = live & (taken < gammas) & (pos < cap)
            return new_live, (proposed, pos, taken), (proposed, logp, live)

        def hold(live, state, k_i):
            # every draft lane dead: hold the tokens, zero log-probs under an
            # all-false validity row (never accepted)
            zero_logp = torch.zeros((B, cfg.vocab_size), dtype=torch.float32, device=tokens.device)
            return state[0], zero_logp, torch.zeros_like(live)

        _live, (last_d, last_pos, _taken), (draft_toks, draft_logps, prop_valid) = masked_scan(
            step, hold, spec_lane & (positions < cap), (tokens, positions, torch.zeros_like(positions)),
            keys[:gamma],
        )
        # the draft's completion step: the scan proposed its last token but
        # never wrote its K/V; without it a fully accepted round leaves a hole
        # at position + γ that the next round's draft attends (logits dropped)
        llama.decode_step(
            d_params, last_d, last_pos, dk, dv, page_tables, spec_lane & (last_pos < cap), draft_cfg,
            impl=paged_impl, scatter_impl=scatter_impl,
        )
        draft_toks = draft_toks.T  # [B, γ]
        draft_logps = draft_logps.transpose(0, 1)  # [B, γ, V]
        prop_valid = prop_valid.T  # [B, γ]

        # the target scores the whole chain in one pass (γ=0 lanes still
        # write their committed token's K/V, chain position 0)
        chain = torch.cat([tokens[:, None], draft_toks], dim=1)
        t_logits, _, _ = llama.verify_step(params, chain, positions, tk, tv, page_tables, active, cfg)
        out, n_emit = accept_reject(
            t_logits, draft_toks, temps, (keys[gamma], keys[gamma + 1]), active, gamma=gamma,
            proposal_logps=draft_logps, prop_valid=prop_valid,
        )
        classic_tok = sample(
            t_logits[:, 0], keys[gamma + 2], temps, top_ps, top_ks, seeds=seeds, step_ids=positions,
            needs_filter=needs_filter,
        )
        return _emit_plane(out, n_emit, active, gammas, classic_tok)

    return spec_round_fn


def build_ngram_round_fn(cfg, *, gamma: int):
    """The prompt-lookup round: host proposals, one target verify, the
    accept cut, the harvest plane; no draft model, no draft cache.

    The returned function takes ``(params, tk, tv, proposals [B, γ], n_prop
    [B], gammas [B], tokens, positions, page_tables, active, key, temps,
    top_ps, top_ks, seeds)`` as the JAX program does, plus ``needs_filter``,
    and returns ``(toks [γ+1, B], valid [γ+1, B], last [B])`` with the pages
    updated in place. ``n_prop`` counts each lane's real proposals (at most
    its γ); an empty lookup is one plain target step."""

    def ngram_round_fn(
        params, tk, tv, proposals, n_prop, gammas, tokens, positions, page_tables, active, key, temps, top_ps,
        top_ks, seeds, *, needs_filter: bool | None = None,
    ):
        k1, k2, k3 = split(key, 3)
        chain = torch.cat([tokens[:, None], proposals], dim=1)
        t_logits, _, _ = llama.verify_step(params, chain, positions, tk, tv, page_tables, active, cfg)
        prop_valid = torch.arange(gamma, device=tokens.device)[None, :] < n_prop[:, None]
        out, n_emit = accept_reject(t_logits, proposals, temps, (k1, k2), active, gamma=gamma, prop_valid=prop_valid)
        classic_tok = sample(
            t_logits[:, 0], k3, temps, top_ps, top_ks, seeds=seeds, step_ids=positions, needs_filter=needs_filter,
        )
        return _emit_plane(out, n_emit, active, gammas, classic_tok)

    return ngram_round_fn
