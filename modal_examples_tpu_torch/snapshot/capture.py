"""Capture path: serialize a container's post-``@enter(snap=True)`` state;
after ``modal_examples_tpu/snapshot/capture.py``.

Runs inside the container worker right after the snapshot-eligible enter
hooks complete (and before the non-snap hooks, matching the reference's
snapshot point — gpu_snapshot.py takes the memory image after ``snap=True``
setup). The user object's ``__dict__`` goes through the tensor codec; attrs
that can't cross the boundary (locks, clients, open handles, threads,
kernel-library handles, CUDA streams) become rebuild markers attributed to
the hook that created them, so the restore path knows to re-run exactly
that hook. The manifest records where a rebuilt hook finds the kernel
libraries (the checkout's ``build/kernels``, ``ops/_build.py``), where the
reference records its persistent XLA compile cache, and the torch version
that wrote the tensors.
"""

from __future__ import annotations

import sys
import time

from ..ops import _build
from . import codec
from .store import SnapshotStore


def capture(
    store: SnapshotStore,
    key: str,
    obj,
    *,
    tag: str = "",
    baseline_attrs: set[str] | frozenset[str] = frozenset(),
    hook_attrs: dict[str, list[str]] | None = None,
) -> bool:
    """Snapshot ``obj``'s state under ``key``. Returns True when an entry is
    in place (this capture's or a racing replica's). Never raises."""
    hook_attrs = hook_attrs or {}
    try:
        t0 = time.monotonic()
        payload, rebuild = codec.encode_state(dict(obj.__dict__))
        # Attrs created by __init__/cls-params and untouched by the snap
        # hooks are recreated by fresh construction on every boot; but a
        # baseline attr a hook *rebound* to something uncapturable must stay
        # a rebuild marker so the restore re-runs the owning hook.
        hook_owned = {a for attrs in hook_attrs.values() for a in attrs}
        rebuild = [a for a in rebuild if a not in baseline_attrs or a in hook_owned]
        manifest = {
            "tag": tag,
            "type": type(obj).__name__,
            "hook_attrs": hook_attrs,
            "rebuild": sorted(rebuild),
            "baseline": sorted(baseline_attrs),
            "kernel_libraries": str(_build.BUILD_DIR),
            "torch": getattr(sys.modules.get("torch"), "__version__", ""),
            "python": sys.version.split()[0],
            "encode_s": round(time.monotonic() - t0, 4),
        }
        return store.put(key, payload, manifest)
    except Exception:
        return False  # capture must never take down a healthy boot
