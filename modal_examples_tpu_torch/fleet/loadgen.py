"""The open-loop load generator, a copy of
``modal_examples_tpu/fleet/loadgen.py``: production-shaped traffic for the
serving fleet's OpenAI endpoint (``serving/openai_api.py``).

Arrivals follow a seeded stochastic process at a fixed offered rate,
whatever the system does, so a saturated fleet shows up as a latency and
goodput knee instead of the self-throttling a closed loop hides:

- **arrival processes**: ``poisson`` (exponential inter-arrivals) and
  ``heavy_tail`` (Pareto inter-arrivals, alpha 1.5: bursts and gaps at the
  same mean rate), both seeded;
- **mixed request classes**: interactive, streaming and batch, each with its
  own prompt shape, token budget, engine priority class and latency SLO
  (the goodput denominator);
- **multi-tenant shared-prefix populations**: every tenant draws from a
  small pool of shared system-prompt prefixes, so the prefix cache and the
  affinity router see production-shaped reuse;
- **client-side measurement**: TTFT at the first SSE chunk's arrival, TPOT
  as ``(last_chunk - first_chunk) / (completion_tokens - 1)`` from the
  ``stream_options.include_usage`` totals; an HTTP 429 is a shed, a socket
  error an error, a stream that never terminates inside the drain window a
  wedge.

:meth:`LoadGenerator.sweep` runs a saturating rate ladder and finds the
knee; :func:`fleet_section` folds a pinned-fleet sweep, an autoscaled sweep
and the autoscaler's scale events into one report.

This module is a driver, like ``faults.chaos``: tests and operators import
it; no module of the port does.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import random
import threading
import time
import urllib.parse

#: a request whose stream stays silent this long after the submit window
#: closes is WEDGED (the invariant the chaos harness hunts for)
DRAIN_TIMEOUT_S = 120.0

#: goodput shortfall that marks the knee: the first sweep step where
#: goodput < KNEE_GOODPUT_FRACTION * offered is past saturation
KNEE_GOODPUT_FRACTION = 0.8

_FILLER = "the quick brown fox jumps over the lazy dog "


@dataclasses.dataclass(frozen=True)
class RequestClass:
    """One traffic class: prompt shape, token budget, engine priority, and
    the latency SLO that decides whether a completion counts as goodput."""

    name: str
    priority: str  # engine priority class (scheduling/policy.py)
    weight: float  # sampling weight within the mix
    filler_sentences: tuple[int, int]  # prompt length range beyond the prefix
    max_tokens: int
    ttft_slo_s: float
    tpot_slo_s: float
    stream: bool = True  # SSE streaming vs one-shot JSON

    def met_slo(self, r: dict) -> bool:
        """Did this completed request land inside its latency SLO?"""
        if self.stream:
            if r["ttft_s"] is None or r["ttft_s"] > self.ttft_slo_s:
                return False
            return r["tpot_s"] is None or r["tpot_s"] <= self.tpot_slo_s
        # non-streamed: the whole response inside TTFT + tokens x TPOT
        budget = self.ttft_slo_s + self.max_tokens * self.tpot_slo_s
        return r["e2e_s"] <= budget


#: the default production-shaped mix: mostly interactive
#: chat turns, a long-form streaming tail, and heavyweight batch jobs
DEFAULT_CLASSES: tuple[RequestClass, ...] = (
    RequestClass("interactive", "interactive", 0.6, (1, 3), 16, 2.0, 0.5),
    RequestClass("streaming", "default", 0.25, (2, 5), 48, 4.0, 0.5),
    RequestClass("batch", "batch", 0.15, (6, 12), 32, 30.0, 2.0, stream=False),
)

ARRIVAL_PROCESSES = ("poisson", "heavy_tail")


def _percentile(values: list[float], p: float) -> float:
    """The repo-wide nearest-rank percentile (``utils/stats.py``), the rank
    convention of the profiler's ``overhead`` section."""
    from ..utils.stats import percentile_nearest_rank

    return percentile_nearest_rank(values, p)


class LoadGenerator:
    """Open-loop traffic against one OpenAI endpoint base URL."""

    def __init__(
        self,
        base_url: str,
        *,
        classes: tuple[RequestClass, ...] = DEFAULT_CLASSES,
        arrival: str = "poisson",
        tenants: int = 4,
        shared_prefixes: int = 2,
        seed: int = 0,
        request_timeout_s: float = DRAIN_TIMEOUT_S,
    ):
        if arrival not in ARRIVAL_PROCESSES:
            raise ValueError(
                f"unknown arrival process {arrival!r}; one of {ARRIVAL_PROCESSES}"
            )
        parsed = urllib.parse.urlparse(base_url)
        if parsed.scheme != "http" or not parsed.hostname:
            raise ValueError(f"base_url must be http://host:port, got {base_url!r}")
        self.host = parsed.hostname
        self.port = parsed.port or 80
        self.classes = tuple(classes)
        self.arrival = arrival
        self.seed = seed
        self.request_timeout_s = float(request_timeout_s)
        self._seq = 0
        self._seq_lock = threading.Lock()
        # tenant -> pool of shared system-prompt prefixes: repeats within a
        # (tenant, pool slot) share their first prefix-cache block, which is
        # exactly what the affinity router keys on
        self.prefixes = {
            f"tenant-{t}": [
                f"[tenant-{t} system prompt {k}] " + _FILLER
                for k in range(max(1, shared_prefixes))
            ]
            for t in range(max(1, tenants))
        }

    # -- arrivals ------------------------------------------------------------

    def _interarrival(self, rng: random.Random, rate_rps: float) -> float:
        if self.arrival == "poisson":
            return rng.expovariate(rate_rps)
        # heavy_tail: Pareto(alpha) with the same MEAN inter-arrival
        # 1/rate — alpha 1.5 gives infinite variance, i.e. real bursts
        alpha = 1.5
        mean = 1.0 / rate_rps
        scale = mean * (alpha - 1) / alpha
        return scale * rng.paretovariate(alpha)

    def _pick(self, rng: random.Random):
        cls = rng.choices(
            self.classes, weights=[c.weight for c in self.classes]
        )[0]
        tenant = rng.choice(sorted(self.prefixes))
        prefix = rng.choice(self.prefixes[tenant])
        with self._seq_lock:  # calibrate picks from worker threads
            self._seq += 1
            seq = self._seq
        n = rng.randint(*cls.filler_sentences)
        prompt = f"{prefix}request {seq}: " + _FILLER * n
        return cls, tenant, prompt

    # -- one request on the wire ---------------------------------------------

    def _do_request(self, cls: RequestClass, tenant: str, prompt: str) -> dict:
        out = {
            "class": cls.name,
            "tenant": tenant,
            "status": "error",
            "ttft_s": None,
            "tpot_s": None,
            "completion_tokens": None,
            # prompt tokens the server answered from its prefix cache
            # (usage.prompt_tokens_details.cached_tokens) — the client-side
            # check that shared-prefix traffic actually hits the trie
            "cached_tokens": None,
            "e2e_s": 0.0,
            "finish_reason": None,
            "pieces": 0,
        }
        body = json.dumps({
            "prompt": prompt,
            "max_tokens": cls.max_tokens,
            "stream": cls.stream,
            "priority": cls.priority,
            "user": tenant,
            "temperature": 1.0,
            # usage totals ride the stream's final chunk: TPOT is computed
            # as (e2e - ttft) / (completion_tokens - 1) — chunk-arrival
            # gaps are meaningless when a starved client thread drains a
            # burst of queued SSE chunks at once
            "stream_options": {"include_usage": True},
        })
        t0 = time.monotonic()
        conn = http.client.HTTPConnection(
            self.host, self.port, timeout=self.request_timeout_s
        )
        try:
            conn.request(
                "POST", "/v1/completions", body=body,
                headers={"content-type": "application/json"},
            )
            resp = conn.getresponse()
            if resp.status == 429:
                out["status"] = "shed"
                return out
            if resp.status != 200:
                return out
            if not cls.stream:
                payload = json.loads(resp.read())
                out["e2e_s"] = time.monotonic() - t0
                out["finish_reason"] = payload["choices"][0].get("finish_reason")
                usage = payload.get("usage") or {}
                out["completion_tokens"] = usage.get("completion_tokens")
                out["cached_tokens"] = (
                    usage.get("prompt_tokens_details") or {}
                ).get("cached_tokens")
                out["status"] = "ok" if out["finish_reason"] != "error" else "error"
                return out
            t_last = None
            for raw in resp:
                line = raw.strip()
                if not line.startswith(b"data: "):
                    continue
                data = line[len(b"data: "):]
                if data == b"[DONE]":
                    break
                event = json.loads(data)
                if "error" in event:
                    out["e2e_s"] = time.monotonic() - t0
                    return out
                choices = event.get("choices") or []
                if not choices:
                    usage = event.get("usage") or {}
                    if usage.get("completion_tokens") is not None:
                        out["completion_tokens"] = usage["completion_tokens"]
                    details = usage.get("prompt_tokens_details") or {}
                    if details.get("cached_tokens") is not None:
                        out["cached_tokens"] = details["cached_tokens"]
                    continue
                now = time.monotonic()
                finish = choices[0].get("finish_reason")
                if finish is not None:
                    out["finish_reason"] = finish
                    continue
                if out["ttft_s"] is None:
                    out["ttft_s"] = now - t0
                t_last = now
                out["pieces"] += 1
            out["e2e_s"] = time.monotonic() - t0
            n = out["completion_tokens"]
            if out["ttft_s"] is not None and n and n > 1 and t_last is not None:
                out["tpot_s"] = max(0.0, (t_last - t0 - out["ttft_s"]) / (n - 1))
            if out["finish_reason"] is not None:
                out["status"] = "ok"
            else:
                # no terminal chunk: a stream that went SILENT past the
                # drain window is the wedge invariant; one whose socket
                # closed early is an ordinary server error
                out["status"] = (
                    "wedged"
                    if out["e2e_s"] >= self.request_timeout_s
                    else "error"
                )
            return out
        except (OSError, http.client.HTTPException, json.JSONDecodeError,
                KeyError, IndexError):
            out["e2e_s"] = time.monotonic() - t0
            # a timeout on a stream that never finished is the wedge signal;
            # anything else is a transport error
            out["status"] = (
                "wedged" if out["e2e_s"] >= self.request_timeout_s else "error"
            )
            return out
        finally:
            conn.close()

    # -- one offered-load step -----------------------------------------------

    def run_step(
        self, rate_rps: float, duration_s: float, *, label: str = ""
    ) -> dict:
        """Offer ``rate_rps`` for ``duration_s`` (open loop: arrivals never
        wait for completions), drain every in-flight stream, and return the
        step report: goodput, shed rate, client-observed TTFT/TPOT
        p50/p99, and per-class breakdowns."""
        # str seeds hash through sha512 inside Random — deterministic
        # across processes, unlike tuple hashes under PYTHONHASHSEED
        rng = random.Random(f"{self.seed}|{self.arrival}|{rate_rps:.6f}")
        results: list[dict] = []
        lock = threading.Lock()
        threads: list[threading.Thread] = []
        by_name = {c.name: c for c in self.classes}

        def worker(cls, tenant, prompt):
            r = self._do_request(cls, tenant, prompt)
            with lock:
                results.append(r)

        start = time.monotonic()
        next_at = start
        offered = 0
        offered_by_class = {c.name: 0 for c in self.classes}
        while True:
            next_at += self._interarrival(rng, rate_rps)
            if next_at - start > duration_s:
                break
            delay = next_at - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            cls, tenant, prompt = self._pick(rng)
            t = threading.Thread(
                target=worker, args=(cls, tenant, prompt), daemon=True
            )
            t.start()
            threads.append(t)
            offered += 1
            offered_by_class[cls.name] += 1
        deadline = time.monotonic() + self.request_timeout_s
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        with lock:
            done = list(results)
        # a worker thread still running past the drain window IS a wedge
        wedged = offered - len(done) + sum(
            1 for r in done if r["status"] == "wedged"
        )
        ok = [r for r in done if r["status"] == "ok"]
        shed = sum(1 for r in done if r["status"] == "shed")
        errors = sum(1 for r in done if r["status"] == "error")
        good = [r for r in ok if by_name[r["class"]].met_slo(r)]
        ttfts = [r["ttft_s"] for r in ok if r["ttft_s"] is not None]
        tpots = [r["tpot_s"] for r in ok if r["tpot_s"] is not None]
        per_class: dict[str, dict] = {}
        for cls in self.classes:
            mine = [r for r in ok if r["class"] == cls.name]
            c_ttfts = [r["ttft_s"] for r in mine if r["ttft_s"] is not None]
            per_class[cls.name] = {
                # counted at SUBMIT: a worker that never returns (wedge)
                # must still appear in its class's offered count
                "offered": offered_by_class[cls.name],
                "completed": len(mine),
                "good": sum(1 for r in mine if cls.met_slo(r)),
                "ttft_p99": round(_percentile(c_ttfts, 0.99), 6),
            }
        return {
            "label": label,
            "offered_rps": round(rate_rps, 4),
            "duration_s": round(duration_s, 3),
            "offered": offered,
            "completed": len(ok),
            "shed": shed,
            "errors": errors,
            "wedged": wedged,
            "achieved_rps": round(len(ok) / duration_s, 4),
            "goodput_rps": round(len(good) / duration_s, 4),
            "shed_rate": round(shed / offered, 6) if offered else 0.0,
            "ttft": {
                "p50": round(_percentile(ttfts, 0.50), 6),
                "p99": round(_percentile(ttfts, 0.99), 6),
            },
            "tpot": {
                "p50": round(_percentile(tpots, 0.50), 6),
                "p99": round(_percentile(tpots, 0.99), 6),
            },
            # prefix-cache effectiveness as the CLIENT sees it, summed over
            # completed requests that reported usage details
            "cached_tokens": sum(
                r["cached_tokens"] for r in ok
                if r.get("cached_tokens") is not None
            ),
            "per_class": per_class,
        }

    def warm(self, n_per_class: int = 1) -> None:
        """Send ``n_per_class`` requests of EVERY class synchronously
        before measuring: first-touch kernel builds and prefix-cache cold
        misses belong to warmup, not to the capacity estimate or the first
        sweep step."""
        rng = random.Random(f"{self.seed}|warm")
        for cls in self.classes:
            for _ in range(n_per_class):
                _c, tenant, prompt = self._pick(rng)
                self._do_request(cls, tenant, prompt)

    def calibrate(
        self, duration_s: float = 2.0, *, concurrency: int = 8
    ) -> float:
        """CLOSED-loop capacity probe: ``concurrency`` workers each run
        back-to-back requests of the configured mix for ``duration_s``, so
        the fleet serves flat out with no open-loop backlog; completions
        per second IS single-fleet capacity. Used to place the sweep
        ladder relative to the hardware instead of hardcoding rates (an
        open-loop probe would count completions that drained after the
        submit window and overestimate wildly)."""
        counts = [0] * concurrency
        stop_at = time.monotonic() + duration_s

        def worker(i: int) -> None:
            rng = random.Random(f"{self.seed}|calibrate|{i}")
            while time.monotonic() < stop_at:
                cls, tenant, prompt = self._pick(rng)
                if self._do_request(cls, tenant, prompt)["status"] == "ok":
                    counts[i] += 1

        threads = [
            threading.Thread(target=worker, args=(i,), daemon=True)
            for i in range(concurrency)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=duration_s + self.request_timeout_s)
        return max(0.5, sum(counts) / duration_s)

    def sweep(
        self, rates: list[float], duration_s: float, *, settle_s: float = 0.25
    ) -> dict:
        """The saturating rate ladder: one step per offered rate, knee
        detection over the ladder. ``knee_index`` is the first step whose
        goodput falls below ``KNEE_GOODPUT_FRACTION`` x offered (the
        latency-vs-offered-load knee of arxiv 2511.17593); the step before
        it is the pre-knee operating point."""
        steps = []
        for rate in rates:
            steps.append(self.run_step(rate, duration_s, label=f"{rate:g}rps"))
            time.sleep(settle_s)
        # saturation is judged against the ACTUAL arrivals the process
        # produced (offered/duration), not the nominal rate — at small
        # samples a Poisson shortfall would otherwise mislabel an
        # underloaded step as the knee
        knee = next(
            (
                i for i, s in enumerate(steps)
                if s["offered"] > 0
                and s["goodput_rps"]
                < KNEE_GOODPUT_FRACTION * (s["offered"] / s["duration_s"])
            ),
            len(steps) - 1,
        )
        return {
            "arrival": self.arrival,
            "rates": [round(r, 4) for r in rates],
            "steps": steps,
            "knee_index": knee,
            "knee_rps": steps[knee]["offered_rps"] if steps else 0.0,
        }


def ab_index(sweep: dict) -> int:
    """The ladder index the fleet A/B lands on: the knee-adjacent step —
    the knee's lower neighbour when the knee is the ladder's top, else the
    knee itself (a knee at the bottom step means the ladder was misplaced;
    the A/B then lands there honestly)."""
    return max(0, min(sweep["knee_index"], max(0, len(sweep["steps"]) - 2)))


def fleet_section(
    pinned: dict,
    autoscaled: dict,
    *,
    scale_events: list[dict],
    capacity_rps: float,
    scaled_step: dict | None = None,
) -> dict:
    """Fold the two sweep arms and the autoscaler's journal slice into one
    ``fleet`` report.

    The headline A/B (``ab``) lands at the knee-adjacent offered load —
    the rate a single pinned replica is just failing to serve inside SLO.
    ``scaled_step`` is that rate re-measured AFTER the ascending
    autoscaled sweep, while the fleet is still scaled out: the ascending
    ladder only triggers scale-out at its saturating step, so comparing
    ladder position i against ladder position i would compare two
    identical one-replica fleets. Closing the loop must show up as higher
    goodput and a lower shed rate / p99 TTFT; ``goodput`` and
    ``p99_tpot_at_knee`` are the headline numbers. Without ``scaled_step``
    the A/B falls back to the autoscaled ladder's knee-adjacent step."""
    idx = ab_index(pinned)
    p_step = pinned["steps"][idx]
    a_step = scaled_step or autoscaled["steps"][
        min(idx, len(autoscaled["steps"]) - 1)
    ]
    ups = [e for e in scale_events if e.get("action") == "scale_up"]
    downs = [e for e in scale_events if e.get("action") == "scale_down"]

    def arm(step: dict) -> dict:
        return {
            "goodput_rps": step["goodput_rps"],
            "achieved_rps": step["achieved_rps"],
            "shed_rate": step["shed_rate"],
            "ttft_p99": step["ttft"]["p99"],
            "tpot_p99": step["tpot"]["p99"],
            "wedged": step["wedged"],
        }

    return {
        "arrival": pinned["arrival"],
        "capacity_rps": round(capacity_rps, 4),
        "rates": pinned["rates"],
        "knee_rps": pinned["knee_rps"],
        "goodput": a_step["goodput_rps"],
        "p99_tpot_at_knee": a_step["tpot"]["p99"],
        "shed_rate": a_step["shed_rate"],
        "ab": {
            "offered_rps": p_step["offered_rps"],
            "scaled_out": scaled_step is not None,
            "pinned": arm(p_step),
            "autoscaled": arm(a_step),
            "improvement_goodput": round(
                a_step["goodput_rps"] / max(p_step["goodput_rps"], 1e-9), 3
            ),
            "improvement_p99_ttft": round(
                p_step["ttft"]["p99"] / max(a_step["ttft"]["p99"], 1e-9), 3
            ),
            "improvement_p99_tpot": round(
                p_step["tpot"]["p99"] / max(a_step["tpot"]["p99"], 1e-9), 3
            ),
        },
        "sweep": {
            "pinned": pinned["steps"],
            "autoscaled": autoscaled["steps"],
        },
        "scale_events": {
            "up": len(ups),
            "down": len(downs),
            "warm_boots": sum(1 for e in ups if e.get("boot") == "warm"),
        },
    }
