"""Correctness canary, after ``modal_examples_tpu/observability/canary.py``:
golden-set probing with numeric drift sentinels.

Every other observability organ is *passive*: it measures whatever traffic
arrives, so a replica that serves fast-but-*wrong* tokens is invisible until
a user complains. The canary is an *active* probe: :func:`probe_engine`
submits a small pinned golden set (seeded prompts, greedy sampling, short
``max_tokens``) through the engine's real submit/stream path, measures
TTFT/TPOT/e2e from the client's seat into the canary series
(``mtpu_canary_probes_total`` and friends) and checks the generated token
ids BIT-EXACT against a content-addressed golden store.
:class:`CanaryProber` runs rounds over the one local engine, in the
background or one :meth:`~CanaryProber.probe_once` at a time.

Identity discipline: a golden transcript is only comparable against the
exact numeric identity that recorded it. Golden files live at
``<state_dir>/canary/golden-<model>-<fp>.json`` where ``<fp>`` hashes the
backend (``cuda`` or ``cpu``), the card's name
(``torch.cuda.get_device_name``), the kv dtype, the tensor-parallel degree,
the weights' dtype and the resolved decode plan (the ``paged_impl``, the
attention structure and the kernels it launches), so a golden recorded on
the CPU can never gate a card run and one card's golden never gates another
card's. A stored file whose embedded fingerprint disagrees with the live
engine's raises :class:`CanaryIdentityError` with a loud banner instead of
producing a false drift verdict.

Synthetic-traffic hygiene: probes run as tenant ``__canary__`` in the
lowest-rank ``canary`` priority class, are excluded from per-tenant usage
billing and the usage journal (counted in ``mtpu_canary_tokens_total``
instead) and skip the unlabeled TTFT/TPOT histograms that feed the SLO
burn gauges.

Drift handling: journal the round (the ``canary`` journal), capture a
``canary_drift`` incident bundle naming the mismatching probe request, and
keep the failing streak in ``mtpu_canary_failing``. Over a router the
prober walks ``router.replicas`` (the healthy non-prefill ones) and, at
``fail_threshold`` failing rounds, down-weights the drifting replica
(``router.set_health_weight``) until a passing round restores it.

torch-light and engine-lazy: importable without torch (the CLI and gateway
read side); torch is touched only through an engine that already exists.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from pathlib import Path

from .._internal import config as _config
from . import metrics as _obs
from .journal import named_journal

#: the synthetic probe tenant — excluded from usage billing, gates the
#: chaos corruption fault point (engine.canary_token_corrupt)
CANARY_TENANT = "__canary__"
#: the probe priority class (scheduling/policy.py PRIORITY_CLASSES member,
#: lowest rank: probes never starve real traffic)
CANARY_CLASS = "canary"
#: probe-round interval override (seconds)
INTERVAL_ENV = "MTPU_CANARY_INTERVAL"
DEFAULT_INTERVAL_S = 30.0
#: the golden-store directory name under ``<state_dir>``
DIR_NAME = "canary"

#: the pinned golden set: seeded greedy probes, short enough that a full
#: round is a few dozen decode ticks. Prompts are fixed forever — a probe
#: is only comparable to a golden recorded from the SAME prompt/seed/
#: max_tokens triple, so editing one means re-recording every golden.
GOLDEN_SET = (
    {"id": "g0", "prompt": "The quick brown fox", "max_tokens": 8, "seed": 11},
    {"id": "g1", "prompt": "Counting up: one two three", "max_tokens": 8,
     "seed": 23},
    {"id": "g2", "prompt": "A canary in a coal mine", "max_tokens": 8,
     "seed": 37},
)


class CanaryIdentityError(RuntimeError):
    """A golden transcript and a live engine disagree on numeric identity
    (backend/generation/kv_dtype/tp/impl plan) — comparing them would
    produce a false drift verdict, so the store refuses loudly."""


def _backend(engine) -> str:
    """``cuda`` or ``cpu``: the device type the engine serves on."""
    dev = getattr(engine, "device", None)
    return str(getattr(dev, "type", dev) or "unknown")


def _device_name(engine) -> str:
    """The card's name (``torch.cuda.get_device_name``) or ``cpu``."""
    from .usage import _device_name as name_of

    return name_of(getattr(engine, "device", None) or "cpu")


#: the kernels (``csrc/<name>.cu``) a decode plan launches, by attention
#: structure and cache dtype; int8 weights add the int8 matmul
_PLAN_KERNELS = {
    ("ragged", False): ("flash_fwd", "kv_scatter", "paged_decode"),
    ("ragged", True): ("flash_fwd", "kv_scatter_int8", "paged_decode_int8"),
    ("writeback", False): ("flash_fwd", "kv_scatter", "paged_decode_writeback"),
    ("writeback", True): ("flash_fwd", "kv_scatter_int8", "paged_decode_writeback_int8"),
}


def plan_kernels(plan: dict) -> list[str]:
    """The kernels the resolved decode plan launches on the card (their
    plain versions on the CPU, where ``plan["impl"]`` is ``plain``)."""
    int8_kv = str(plan.get("kv_dtype")) == "int8"
    names = list(_PLAN_KERNELS.get((plan.get("attention"), int8_kv), ()))
    if plan.get("weights") == "int8":
        names.append("quantized_matmul")
    return sorted(names)


def fingerprint(engine) -> dict:
    """The numeric identity a golden transcript is pinned to: everything
    that can legitimately change the bit pattern of a greedy decode."""
    plan = dict(getattr(engine, "impl_plan", None) or {})
    return {
        "backend": _backend(engine),
        "device": _device_name(engine),
        "paged_impl": getattr(engine, "paged_impl", plan.get("requested")),
        "attention": plan.get("attention"),
        "ragged_variant": plan.get("ragged_variant"),
        "scatter": plan.get("scatter"),
        "kernels": plan_kernels(plan),
        "kernel_impl": plan.get("impl"),
        "weights": plan.get("weights"),
        "kv_dtype": plan.get("kv_dtype", getattr(engine, "kv_dtype", None)),
        "tp": int(plan.get("tp", 1) or 1),
    }


def fingerprint_hash(fp: dict) -> str:
    return hashlib.sha1(
        json.dumps(fp, sort_keys=True).encode()
    ).hexdigest()[:12]


def model_id(cfg) -> str:
    """A compact model identity from the config dims (the engine does not
    know its checkpoint name; two different geometries can never collide)."""
    return (
        f"l{cfg.n_layers}d{cfg.dim}h{cfg.n_heads}"
        f"kv{cfg.n_kv_heads}v{cfg.vocab_size}"
    )


def verify_identity(stored: dict, live: dict) -> None:
    """Refuse a cross-identity comparison with a loud banner naming every
    differing key — the benchdiff discipline, not a tolerance knob."""
    diffs = {
        k: (stored.get(k), live.get(k))
        for k in sorted(set(stored) | set(live))
        if stored.get(k) != live.get(k)
    }
    if not diffs:
        return
    lines = [
        "=" * 66,
        "CANARY IDENTITY REFUSED: golden transcript does not match the",
        "live engine's numeric identity — comparing them would report",
        "false drift. Record a fresh golden for this identity instead.",
    ]
    for k, (s, l) in diffs.items():
        lines.append(f"  {k}: golden={s!r} live={l!r}")
    if stored.get("tp") != live.get("tp"):
        lines.append(
            "  cross-TP token exactness is UNDEFINED (psum/bf16 reordering"
        )
        lines.append(
            "  flips greedy argmaxes) — use the logit-tolerance contract,"
        )
        lines.append("  docs/tensor_parallel.md")
    lines.append("=" * 66)
    raise CanaryIdentityError("\n".join(lines))


class GoldenStore:
    """Content-addressed golden transcripts under ``<state_dir>/canary``.

    One JSON file per (model, fingerprint): the fingerprint is both in the
    file NAME (so two identities never race one path) and in the file BODY
    (so a hand-copied file from another chip still refuses at load)."""

    def __init__(self, root=None):
        self.dir = Path(root or _config.state_dir()) / DIR_NAME

    def path_for(self, model: str, fp: dict) -> Path:
        return self.dir / f"golden-{model}-{fingerprint_hash(fp)}.json"

    def load(self, model: str, fp: dict) -> dict | None:
        """The golden document for this identity, or None when unrecorded.
        Raises :class:`CanaryIdentityError` when the stored fingerprint
        disagrees with ``fp`` (a copied/tampered file)."""
        path = self.path_for(model, fp)
        try:
            doc = json.loads(path.read_text())
        except FileNotFoundError:
            return None
        except (OSError, json.JSONDecodeError) as e:
            raise CanaryIdentityError(
                f"golden store file {path} is unreadable/corrupt: {e}"
            )
        verify_identity(doc.get("fingerprint", {}), fp)
        return doc

    def record(self, model: str, fp: dict, probes: dict) -> Path:
        """Write (atomically) the golden document for this identity.
        ``probes`` maps probe id -> {"tokens": [...], "text": ...}."""
        self.dir.mkdir(parents=True, exist_ok=True)
        path = self.path_for(model, fp)
        doc = {
            "model": model,
            "fingerprint": fp,
            "fp": fingerprint_hash(fp),
            "recorded_at": time.time(),
            "probes": probes,
        }
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(doc, indent=1, sort_keys=True))
        tmp.replace(path)
        return path


def probe_engine(
    engine, *, submit=None, replica: str = "engine", golden: dict | None,
    registry=None, clock=time.monotonic,
) -> list[dict]:
    """Run the full golden set once against one engine and return per-probe
    results. ``submit`` defaults to ``engine.submit`` — the prober passes
    ``replica.submit``; both go through the engine's admission.

    Without a ``golden`` document every probe reports ``"recorded"`` and
    carries its tokens for :meth:`GoldenStore.record`; with one, tokens are
    compared bit-exact and report ``"pass"`` or ``"drift"``. A probe that
    dies (shed, engine error) reports ``"error"`` — an unreachable replica
    is a health problem, not numeric drift. A probe whose stream fails after
    its submit (an engine stopped on a scheduler error refuses to start) is
    aborted, so it does not sit in the queue and decode, unread, once the
    replica is revived (the JAX package leaves it queued)."""
    from ..serving.sampling import SamplingParams

    submit = submit or engine.submit
    results = []
    for g in GOLDEN_SET:
        params = SamplingParams(
            temperature=0.0, max_tokens=g["max_tokens"], seed=g["seed"]
        )
        t0 = clock()
        ttft = None
        gaps = []
        rec: dict = {"probe": g["id"], "replica": replica}
        req = None
        try:
            req = submit(
                g["prompt"], params, tenant=CANARY_TENANT,
                priority=CANARY_CLASS,
            )
            last = t0
            for _piece in engine.stream(req):
                now = clock()
                if ttft is None:
                    ttft = now - t0
                else:
                    gaps.append(now - last)
                last = now
            e2e = clock() - t0
            tokens = [int(t) for t in req.generated_tokens]
            rec.update(
                request_id=req.request_id,
                finish_reason=req.finish_reason,
                tokens=tokens,
                ttft=ttft, e2e=e2e,
                tpot=(sum(gaps) / len(gaps)) if gaps else None,
            )
            if req.finish_reason not in ("stop", "length"):
                rec["result"] = "error"
            elif golden is None:
                rec["result"] = "recorded"
            else:
                expected = [
                    int(t)
                    for t in golden["probes"][g["id"]]["tokens"]
                ]
                if tokens == expected:
                    rec["result"] = "pass"
                else:
                    rec["result"] = "drift"
                    rec["expected"] = expected
                    rec["mismatch_at"] = next(
                        (
                            i
                            for i, (a, b) in enumerate(zip(tokens, expected))
                            if a != b
                        ),
                        min(len(tokens), len(expected)),
                    )
        except Exception as e:  # shed / engine stopped: health, not drift
            rec.update(result="error", error=f"{type(e).__name__}: {e}")
            if req is not None and req.finish_reason is None:
                engine.abort(req)
        _obs.record_canary_probe(replica, rec["result"], registry=registry)
        if rec["result"] == "drift":
            _obs.record_canary_drift(replica, registry=registry)
        if rec.get("e2e") is not None:
            _obs.record_canary_latency(
                replica, ttft=rec.get("ttft"), tpot=rec.get("tpot"),
                e2e=rec.get("e2e"), registry=registry,
            )
        results.append(rec)
    return results


# -- the fleet prober ---------------------------------------------------------

#: the live prober (gateway /canary and the CLI's canary read it when the
#: serving process answers its own snapshot) — the incident live-engine
#: registry pattern, single-slot because one process runs one prober
_live_lock = threading.Lock()
_live_prober = None


def live_prober():
    with _live_lock:
        return _live_prober


class _LocalReplica:
    """The one local engine as the prober's replica: its name is the
    engine's ``trace_name``, it submits through ``engine.submit`` and is
    healthy while the engine is not poisoned by a scheduler error."""

    role = "unified"

    def __init__(self, engine):
        self.engine = engine

    @property
    def name(self) -> str:
        return getattr(self.engine, "trace_name", "engine")

    def submit(self, prompt, params, **kw):
        return self.engine.submit(prompt, params, **kw)

    def healthy(self) -> bool:
        return not getattr(self.engine, "_stopped_on_error", False)


class CanaryProber:
    """Background golden-set prober over a router's serving replicas, or
    over one local engine.

    ``target`` is a router (anything with ``replicas``: each round probes
    every healthy non-prefill replica) or an ``LLMEngine`` (probed as the one
    replica). The first contact with a (model, fingerprint) identity records
    the golden instead of gating. Consecutive failing rounds (any drift in
    the round) count in the streak (``mtpu_canary_failing``); at
    ``fail_threshold`` a router's replica is down-weighted to
    ``degraded_weight`` through ``router.set_health_weight``, and the first
    passing round clears the streak and restores weight 1.0. Every round
    lands in the ``canary`` journal; every drift captures a ``canary_drift``
    incident bundle whose reason names the mismatching probe request id, so
    the bundle's open-trace section contains the probe's trace."""

    def __init__(
        self, target, *, interval_s=None, store=None, registry=None,
        journal_path=None, fail_threshold: int = 2,
        degraded_weight: float = 0.25, clock=time.monotonic,
    ):
        if interval_s is None:
            raw = os.environ.get(INTERVAL_ENV, "")
            interval_s = float(raw) if raw else DEFAULT_INTERVAL_S
        if hasattr(target, "replicas"):
            self.router, self.replica = target, None
        else:
            self.router, self.replica = None, _LocalReplica(target)
        self.fail_threshold = max(1, int(fail_threshold))
        self.degraded_weight = float(degraded_weight)
        #: replicas this prober down-weighted (it only restores its own)
        self._downweighted: set[str] = set()
        self.interval_s = float(interval_s)
        self.store = store or GoldenStore()
        self.registry = registry
        self._clock = clock
        self._journal = named_journal("canary", path=journal_path)
        self._lock = threading.Lock()
        #: replica -> consecutive failing rounds (any drift in the round)
        self._streaks: dict[str, int] = {}
        #: replica -> last round's per-probe results
        self._last: dict[str, list[dict]] = {}
        self.rounds = 0
        self.drifts = 0
        self._stop = threading.Event()
        self._thread = None

    # -- journal plumbing (the watchdog's "at"-stamped record convention) -----

    def _record(self, **rec) -> None:
        self._journal.record({"at": time.time(), **rec})

    # -- one round ------------------------------------------------------------

    def _serving_replicas(self) -> list:
        if self.router is None:
            return [self.replica] if self.replica.healthy() else []
        return [
            r for r in self.router.replicas
            if getattr(r, "role", "unified") != "prefill" and r.healthy()
        ]

    def probe_replica(self, replica) -> list[dict]:
        engine = replica.engine
        model = model_id(engine.cfg)
        fp = fingerprint(engine)
        golden = self.store.load(model, fp)  # CanaryIdentityError is loud
        results = probe_engine(
            engine, submit=replica.submit, replica=replica.name,
            golden=golden, registry=self.registry, clock=self._clock,
        )
        if golden is None:
            recorded = {
                r["probe"]: {"tokens": r["tokens"]}
                for r in results
                if r["result"] == "recorded"
            }
            if len(recorded) == len(GOLDEN_SET):
                path = self.store.record(model, fp, recorded)
                self._record(
                    action="recorded", replica=replica.name, model=model,
                    fp=fingerprint_hash(fp), path=str(path),
                )
        self._note_round(replica, results)
        return results

    def _note_round(self, replica, results: list[dict]) -> None:
        name = replica.name
        drifted = [r for r in results if r["result"] == "drift"]
        compared = [r for r in results if r["result"] in ("pass", "drift")]
        with self._lock:
            if drifted:
                self.drifts += len(drifted)
                self._streaks[name] = self._streaks.get(name, 0) + 1
            elif compared:
                self._streaks[name] = 0
            streak = self._streaks.get(name, 0)
            self._last[name] = results
        _obs.set_canary_failing(name, streak, registry=self.registry)
        self._record(
            action="round", replica=name, streak=streak,
            results={r["probe"]: r["result"] for r in results},
        )
        if drifted:
            worst = drifted[0]
            # lazy: the capture leg pulls in the tsdb/trace machinery the
            # pure probe path never needs
            from . import incident as _incident

            _incident.capture(
                "canary_drift", replica=name,
                reason=(
                    f"canary probe {worst['probe']} ({worst['request_id']}) "
                    f"drifted at token {worst.get('mismatch_at')} "
                    f"(streak {streak})"
                ),
            )
            if streak >= self.fail_threshold and hasattr(self.router, "set_health_weight"):
                self.router.set_health_weight(name, self.degraded_weight)
                with self._lock:
                    self._downweighted.add(name)
                self._record(
                    action="down_weight", replica=name,
                    weight=self.degraded_weight, streak=streak,
                )
        elif compared:
            with self._lock:
                restore = name in self._downweighted
                self._downweighted.discard(name)
            if restore:
                self.router.set_health_weight(name, 1.0)
                self._record(action="restore_weight", replica=name, weight=1.0)

    def probe_once(self) -> dict:
        """One full round over every healthy serving replica."""
        per_replica = {}
        for replica in self._serving_replicas():
            try:
                per_replica[replica.name] = self.probe_replica(replica)
            except CanaryIdentityError as e:
                # refusal is a configuration fault, not drift: journal the
                # banner and keep probing the rest of the fleet
                self._record(
                    action="identity_refused", replica=replica.name,
                    error=str(e),
                )
                _obs.record_canary_probe(
                    replica.name, "error", registry=self.registry
                )
        with self._lock:
            self.rounds += 1
        return per_replica

    # -- the background loop --------------------------------------------------

    def start(self):
        global _live_prober
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="canary-prober", daemon=True
        )
        self._thread.start()
        with _live_lock:
            _live_prober = self
        return self

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.probe_once()
            except Exception as e:  # a probe round must never kill the loop
                try:
                    self._record(
                        action="round_error",
                        error=f"{type(e).__name__}: {e}",
                    )
                except Exception:
                    pass

    def stop(self):
        global _live_prober
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        with _live_lock:
            if _live_prober is self:
                _live_prober = None

    # -- read side ------------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "interval_s": self.interval_s,
                "rounds": self.rounds,
                "drifts": self.drifts,
                "fail_threshold": self.fail_threshold,
                "streaks": dict(self._streaks),
                "downweighted": sorted(self._downweighted),
                "last": {
                    name: [
                        {
                            k: r.get(k)
                            for k in (
                                "probe", "result", "request_id",
                                "mismatch_at", "ttft", "tpot", "e2e",
                            )
                            if r.get(k) is not None
                        }
                        for r in results
                    ]
                    for name, results in self._last.items()
                },
            }
