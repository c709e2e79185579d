"""Memory-snapshot subsystem: checkpoint/restore of initialized containers;
after ``modal_examples_tpu/snapshot/__init__.py``.

The reference's GPU memory snapshots (gpu_snapshot.py), as state snapshots:
``@app.cls(enable_memory_snapshot=True)`` + ``@mtpu.enter(snap=True)`` mark
the expensive load-once stage of a container boot; after the first warm boot
captures it, every later cold start restores the serialized state (tensors
back onto the container's card) instead of re-running the hooks. Hooks whose
state cannot cross (kernel-library handles, engines with threads) re-run,
and find the kernel libraries already built in the checkout.

Pieces:

- :mod:`.store`   — content-addressed, LRU-evicted entry store
- :mod:`.codec`   — tensor-aware state serialization
- :mod:`.capture` — post-``snap=True`` state capture (container side)
- :mod:`.restore` — boot-time restore with cold-boot fallback

:func:`build_and_enter` is the single entry point the executor's container
boot (and the inline backend) calls for every Cls container.
"""

from __future__ import annotations

import contextlib
import time

from .capture import capture
from .codec import CodecError
from .restore import RestoreResult, try_restore
from .store import SnapshotStore, compute_snapshot_key, default_root, snapshots_enabled

__all__ = [
    "CodecError",
    "RestoreResult",
    "SnapshotStore",
    "build_and_enter",
    "capture",
    "compute_snapshot_key",
    "default_root",
    "snapshots_enabled",
    "try_restore",
]


def build_and_enter(
    user_cls: type,
    params: dict | None,
    meta: dict,
    *,
    snapshot_key: str | None = None,
    snapshot_dir: str | None = None,
    tag: str = "",
    timings: dict | None = None,
) -> tuple[object, dict]:
    """Construct the user object and run its ``@enter`` hooks, restoring past
    ``snap=True`` hooks from a memory snapshot when one exists.

    Returns ``(obj, boot_info)`` where ``boot_info["snapshot"]`` is one of:

    - ``"off"``      — snapshots not enabled for this spec (plain boot)
    - ``"hit"``      — restored; covered snap hooks were skipped
    - ``"miss"``     — no entry; cold boot, then first-warm-boot capture
    - ``"fallback"`` — an entry existed but couldn't be used; cold boot

    ``boot_info["captured"]`` reports whether this boot published a snapshot.
    ``timings``, when given, receives the seconds of the boot's parts:
    ``snap_hooks`` (the ``snap=True`` hooks), ``restore`` (reading and
    applying an entry), ``capture`` (encoding and publishing one) and
    ``enter_hooks`` (every other hook).
    """
    timings = {} if timings is None else timings

    @contextlib.contextmanager
    def clock(part: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            timings[part] = timings.get(part, 0.0) + time.perf_counter() - t0

    def fresh():
        obj = user_cls()
        for k, v in (params or {}).items():
            setattr(obj, k, v)
        return obj

    enter: list[str] = meta.get("enter", [])
    snap_hooks: list[str] = meta.get("snap_enter", [])

    obj = fresh()
    if not (snapshot_key and snap_hooks and snapshots_enabled()):
        for name in enter:
            with clock("snap_hooks" if name in snap_hooks else "enter_hooks"):
                getattr(obj, name)()
        return obj, {"snapshot": "off"}

    store = SnapshotStore(root=snapshot_dir)
    had_entry = store.has(snapshot_key)
    with clock("restore"):
        res = try_restore(store, snapshot_key, obj, snap_hooks)
    if res is not None:
        ran_non_snap = False
        try:
            for name in enter:
                if name in res.skipped_hooks:
                    continue
                with clock("snap_hooks" if name in snap_hooks else "enter_hooks"):
                    getattr(obj, name)()
                if name not in snap_hooks:
                    ran_non_snap = True
            return obj, {
                "snapshot": "hit",
                "captured": False,
                "skipped_hooks": res.skipped_hooks,
                "rerun_hooks": res.rerun_hooks,
            }
        except Exception:
            # restored state may have broken the hook: the entry could be
            # poison — drop it so the next boot goes cold either way
            store.delete(snapshot_key)
            if ran_non_snap:
                # a non-snap hook already completed this boot; silently
                # re-running it on the cold path would double its side
                # effects — fail the boot exactly like a cold boot whose
                # hook raised, and let the pool retry cold
                raise

    # cold boot; try_restore may have half-applied state, start over
    obj = fresh()
    baseline = set(obj.__dict__)
    baseline_vals = dict(obj.__dict__)
    hook_attrs: dict[str, list[str]] = {}
    seen = set(baseline)
    for name in enter:
        if name in snap_hooks:
            with clock("snap_hooks"):
                getattr(obj, name)()
            created = set(obj.__dict__) - seen
            # a hook also *owns* baseline attrs it rebinds (identity check):
            # if the new value can't be captured, restore must re-run this
            # hook rather than silently serving the __init__ placeholder
            mutated = {
                a
                for a, v in baseline_vals.items()
                if a in obj.__dict__ and obj.__dict__[a] is not v
            }
            hook_attrs[name] = sorted(created | mutated)
            seen |= created
            for a in mutated:
                baseline_vals[a] = obj.__dict__[a]
    with clock("capture"):
        captured = capture(
            store,
            snapshot_key,
            obj,
            tag=tag,
            baseline_attrs=baseline,
            hook_attrs=hook_attrs,
        )
    for name in enter:
        if name not in snap_hooks:
            with clock("enter_hooks"):
                getattr(obj, name)()
    return obj, {
        "snapshot": "fallback" if had_entry else "miss",
        "captured": captured,
    }

