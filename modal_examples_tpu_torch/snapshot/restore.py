"""Restore path: resume a container boot past snapshot-eligible enter hooks;
a copy of ``modal_examples_tpu/snapshot/restore.py``.

On boot, the container worker checks the store for the spec's snapshot key.
On a hit, the captured attrs are decoded (each tensor rebuilt from its host
bytes onto its device, a CUDA tensor onto the container's card) and applied
to a freshly constructed user object, and the boot **skips** every
``@enter(snap=True)`` hook whose state was fully captured — the load-once
work is already done. Hooks that produced rebuild-marked attrs (kernel
handles, engines with threads, locks) are re-run; the kernel libraries are
already built in the checkout, so "rebuild" loads them.

Failure policy: any mismatch — unknown hooks, unattributable rebuild attrs,
checksum/codec errors (a CUDA tensor with no card to go to among them), a
hook raising against restored state — returns the boot to the cold path. Restore must never be less reliable than a cold
start.
"""

from __future__ import annotations

import dataclasses

from . import codec
from .store import SnapshotStore


@dataclasses.dataclass
class RestoreResult:
    skipped_hooks: list[str]  # snap hooks whose work the snapshot covers
    rerun_hooks: list[str]  # snap hooks that must re-run (rebuild markers)
    restored_attrs: list[str]


def try_restore(
    store: SnapshotStore, key: str, obj, snap_hooks: list[str]
) -> RestoreResult | None:
    """Apply the snapshot under ``key`` to ``obj``. Returns None (cold boot)
    on miss or on any inconsistency; never raises."""
    try:
        entry = store.get(key)
        if entry is None:
            return None
        payload, meta = entry
        manifest = meta.get("manifest") or {}
        hook_attrs: dict[str, list[str]] = manifest.get("hook_attrs") or {}
        if sorted(hook_attrs) != sorted(snap_hooks):
            return None  # lifecycle shape changed under a stale key
        rebuild = set(manifest.get("rebuild") or [])
        rerun = [h for h in snap_hooks if rebuild & set(hook_attrs.get(h, []))]
        attributed = set()
        for h in rerun:
            attributed |= set(hook_attrs.get(h, []))
        if rebuild - attributed:
            # an unpicklable attr no hook owns: nothing can rebuild it
            return None
        state = codec.decode_state(payload)
        for name, value in state.items():
            setattr(obj, name, value)
        return RestoreResult(
            skipped_hooks=[h for h in snap_hooks if h not in rerun],
            rerun_hooks=rerun,
            restored_attrs=sorted(state),
        )
    except Exception:
        return None
