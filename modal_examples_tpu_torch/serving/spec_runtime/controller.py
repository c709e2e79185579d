"""Adaptive speculation depth: the γ-schedule policy.

Copy of ``modal_examples_tpu/serving/spec_runtime/controller.py``
(``AdaptiveGammaController``): a pure host-side policy, the same in both
packages.

Speculation competes with continuous batching for the same flops: a draft
chain that gets rejected is a pure tax on every other slot sharing the
round, and a full batch amortizes the host round-trip so well that the
marginal win of speculation inverts. This controller answers that inside
the SCHEDULER — per request, per round — instead of leaving it to offline
bench tuning:

- **Acceptance EWMA (per request):** each request carries an exponentially
  weighted acceptance rate, initialized optimistically (speculate until
  proven wasteful). γ scales with the EWMA, so a request whose draft stops
  predicting it (topic shift, code → prose) spends fewer draft steps.
- **Collapse + probe recovery (hysteresis):** below ``collapse_below`` the
  request stops speculating entirely (γ=0 — the fused program's classic
  lane, docs/speculative.md#program-shape). Every ``probe_every``-th round
  it proposes a single probe token; only a recovered EWMA ≥
  ``recover_above`` (> collapse_below — the hysteresis band) re-enables
  full speculation, so a borderline request cannot flap.
- **Batch-fill pressure:** at ``batch_fill_cutoff`` occupancy the round
  speculates for no one — verify flops scale with γ+1 per lane, and a full
  batch is already amortized; the marginal token is cheaper decoded than
  speculated.
- **Prefill contention:** while chunked prefills or queued admissions are
  waiting (the stall-free prefill budget is actively slicing), γ caps at 1 —
  long speculative rounds stretch the tick and starve admission cadence.

Everything is a pure function of observed (proposed, accepted) pairs and
the pressure flags passed in — no clocks, no engine state — so the whole
matrix is unit-testable with hand-fed rounds.
The engine calls :meth:`observe` at harvest (the controller sees exactly
what the host accepted), :meth:`gamma_for` at dispatch, and
:meth:`forget` at slot release.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class _ReqState:
    ewma: float
    collapsed: bool = False
    rounds_since_probe: int = 0


class AdaptiveGammaController:
    """Per-request speculation depth from acceptance history + pressure."""

    def __init__(
        self,
        gamma_max: int,
        *,
        ewma_alpha: float = 0.4,
        collapse_below: float = 0.3,
        recover_above: float = 0.6,
        probe_every: int = 16,
        batch_fill_cutoff: float = 0.95,
        init_acceptance: float = 1.0,
    ):
        if not (0.0 <= collapse_below <= recover_above <= 1.0):
            raise ValueError(
                "need 0 <= collapse_below <= recover_above <= 1 (the "
                f"hysteresis band), got {collapse_below}/{recover_above}"
            )
        self.gamma_max = int(gamma_max)
        self.ewma_alpha = float(ewma_alpha)
        self.collapse_below = float(collapse_below)
        self.recover_above = float(recover_above)
        self.probe_every = max(1, int(probe_every))
        self.batch_fill_cutoff = float(batch_fill_cutoff)
        self.init_acceptance = float(init_acceptance)
        self._reqs: dict[str, _ReqState] = {}

    def _state(self, request_id: str) -> _ReqState:
        st = self._reqs.get(request_id)
        if st is None:
            st = self._reqs[request_id] = _ReqState(
                ewma=self.init_acceptance
            )
        return st

    def gamma_for(
        self,
        request_id: str,
        *,
        gamma_cap: int | None = None,
        batch_fill: float = 0.0,
        prefill_pressure: bool = False,
    ) -> int:
        """Proposal budget for this request's next round. Advances the
        request's probe counter when collapsed (each call = one dispatched
        round), so callers must call it exactly once per round per live
        request."""
        cap = self.gamma_max if gamma_cap is None else min(
            int(gamma_cap), self.gamma_max
        )
        if cap <= 0:
            return 0
        if batch_fill >= self.batch_fill_cutoff:
            # global pressure: nobody speculates this round, and nobody's
            # per-request state is touched — pressure is not evidence of
            # bad acceptance
            return 0
        st = self._state(request_id)
        if st.collapsed:
            st.rounds_since_probe += 1
            if st.rounds_since_probe >= self.probe_every:
                st.rounds_since_probe = 0
                return 1  # probe: one cheap proposal feeds the EWMA
            return 0
        g = max(1, round(st.ewma * cap))
        if prefill_pressure:
            g = min(g, 1)
        return min(g, cap)

    def observe(self, request_id: str, proposed: int, accepted: int) -> None:
        """Fold one harvested round's (proposed, accepted) into the
        request's EWMA. Rounds that proposed nothing (classic lanes,
        collapsed non-probe rounds) carry no acceptance evidence and are
        ignored."""
        if proposed <= 0:
            return
        rate = min(1.0, max(0.0, accepted / proposed))
        st = self._state(request_id)
        a = self.ewma_alpha
        st.ewma = (1.0 - a) * st.ewma + a * rate
        if st.collapsed:
            if st.ewma >= self.recover_above:
                st.collapsed = False
        elif st.ewma < self.collapse_below:
            st.collapsed = True
            st.rounds_since_probe = 0

    def forget(self, request_id: str) -> None:
        """Drop a finished request's state (slot release)."""
        self._reqs.pop(request_id, None)

    def snapshot(self) -> dict:
        """Debug/stats view: per-request EWMA + collapse flags."""
        return {
            rid: {
                "ewma": round(st.ewma, 4),
                "collapsed": st.collapsed,
            }
            for rid, st in self._reqs.items()
        }
