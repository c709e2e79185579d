"""The macro-step decode program: N decode+sample steps per dispatch.

Counterpart of ``modal_examples_tpu/serving/multistep/runtime.py``
(``DECODE_STEPS_ENV``, ``resolve_decode_steps``, ``build_multistep_fn``).
The per-step body is the engine's own: ``llama.decode_step`` (its kernels,
the pages updated in place) followed by ``sample``, looped by
:func:`~...ops.scan_loop.masked_scan` so a step whose every lane is dead
runs no model. Each lane (slot) carries a ``live`` bit that drops at its
stop token or when its per-slot length budget is spent; besides the token
matrix the program returns a ``[N, B]`` validity mask, and the host accepts
exactly the valid prefix of each slot.

Exactness: sampling is (seed, position)-keyed, so a seeded row's token
depends only on its request seed and absolute position, never on how many
steps share a dispatch; every kernel and GEMM treats rows independently, so
N>1 is token-identical to N=1 on the same engine.
"""

from __future__ import annotations

import os

import torch

from ...models import llama
from ...ops.scan_loop import masked_scan
from ..sampling import sample, split

#: the runtime knob: decode steps fused into one dispatch (1 = the block path)
DECODE_STEPS_ENV = "MTPU_DECODE_STEPS"


def resolve_decode_steps(arg: int | None = None) -> int:
    """The macro-step count: an explicit ``arg`` beats ``MTPU_DECODE_STEPS``,
    which beats 1. The engine keeps the result on a plain attribute that it
    reads once per dispatch, so it can change at runtime."""
    if arg is None:
        raw = os.environ.get(DECODE_STEPS_ENV, "")
        arg = int(raw) if raw else 1
    return max(1, int(arg))


def build_multistep_fn(cfg, *, paged_impl: str, scatter_impl: str, eos_id: int, n_steps: int):
    """The N-step decode program for one engine config.

    The returned function takes the JAX program's arguments less its
    pipelined-dispatch override lane (the engine always feeds each slot's
    last accepted token): ``(params, k_pages, v_pages, tokens, positions,
    page_tables, active, key, temps, top_ps, top_ks, seeds, budgets)``, plus
    ``needs_filter`` (whether any row has top_p < 1 or top_k > 0, known on
    the host). ``budgets`` [B] is each slot's count of tokens the host would
    still accept. A lane dies when it samples ``eos_id`` or spends its
    budget; the token it dies on is still valid.

    Returns ``(toks [N, B], valid [N, B] bool, last [B])``; the pages are
    updated in place. ``valid[k, i]`` means lane ``i`` was live entering step
    ``k``; invalid rows are holds and must not be accepted. Step keys are
    ``split(key, n_steps)``.
    """

    def multistep_fn(
        params, k_pages, v_pages, tokens, positions, page_tables, active, key,
        temps, top_ps, top_ks, seeds, budgets, *, needs_filter: bool | None = None,
    ):
        taken0 = torch.zeros_like(budgets)

        def step(live, state, k_i):
            tok, pos, taken = state
            logits, _, _ = llama.decode_step(
                params, tok, pos, k_pages, v_pages, page_tables, live, cfg,
                impl=paged_impl, scatter_impl=scatter_impl,
            )
            nxt = sample(logits, k_i, temps, top_ps, top_ks, seeds=seeds, step_ids=pos, needs_filter=needs_filter)
            nxt = torch.where(live, nxt.to(tok.dtype), tok)  # dead lanes hold steady
            valid = live
            taken = taken + live.to(taken.dtype)
            pos = pos + live.to(pos.dtype)  # dead lanes stop advancing (position-keyed)
            live = live & (nxt != eos_id) & (taken < budgets)
            return live, (nxt, pos, taken), (nxt, valid)

        def hold(live, state, k_i):
            # every lane dead: hold the tokens, an all-false validity row
            return state[0], live

        _live, state, (toks, valid) = masked_scan(
            step, hold, active, (tokens, positions, taken0), split(key, n_steps)
        )
        return toks, valid, state[0]

    return multistep_fn
