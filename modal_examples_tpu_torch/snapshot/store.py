"""Copy of ``modal_examples_tpu/snapshot/store.py``: the content-addressed
store for container memory snapshots.

A snapshot entry is the serialized post-``@enter(snap=True)`` state of one
container's user object (see :mod:`.capture`), keyed by everything that could
change what that state looks like:

- the **image digest** (layer chain hash, core/image.py),
- the **function source hash** (source text of the target class, falling back
  to its pickled definition bytes),
- the **env fingerprint** (the container env the spec resolves: image env +
  secrets + the ``gpu=`` request in ``MTPU_GPU_SPEC``, so a ``gpu=``
  container's entry is never the key of a container without ``gpu=``, nor
  the reverse),
- the **cls-params hash** (``modal.parameter`` overrides), and
- the host **CPU machine tag** (:func:`_machine_tag`, a copy of the JAX
  package's ``utils/compile_cache.py`` one, whose module imports jax):
  pickled host state is only trusted on the microarch that produced it.

Layout: one directory per key under the store root (default
``<state_dir>/snapshots``, override with ``MTPU_SNAPSHOT_DIR`` — point it at a
mounted Volume to share snapshots between replicas, or use
:meth:`SnapshotStore.from_volume`), holding ``state.bin`` (payload) and
``meta.json`` (checksum + manifest). Writes are atomic (temp dir + rename,
first writer wins) and reads verify the checksum, deleting corrupt entries —
a bad snapshot degrades to a cold boot, never an error. Eviction is LRU on
``last_used``, bounded by ``MTPU_SNAPSHOT_MAX_ENTRIES`` (default 16) and
optionally ``MTPU_SNAPSHOT_MAX_BYTES``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
import uuid
from pathlib import Path

import functools

from .._internal import config as _config
from ..observability import metrics as _obs

_DISABLED = ("0", "off", "none")

DEFAULT_MAX_ENTRIES = 16


@functools.lru_cache(maxsize=1)
def _machine_tag() -> str:
    """Short fingerprint of the host CPU: the machine, and the ``flags``,
    ``Features``, ``model name`` and ``CPU part`` lines of ``/proc/cpuinfo``
    (x86 and arm)."""
    import platform

    parts = set()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("flags", "Features", "model name", "CPU part"):
                    parts.add(" ".join(line.split(":", 1)[1].split()))
    except OSError:
        pass
    return hashlib.md5(
        (platform.machine() + ":" + "|".join(sorted(parts))).encode()
    ).hexdigest()[:8]


def snapshots_enabled() -> bool:
    """Process-wide kill switch: ``MTPU_SNAPSHOT=0`` disables capture/restore
    even for ``enable_memory_snapshot=True`` functions."""
    return os.environ.get("MTPU_SNAPSHOT", "").lower() not in _DISABLED


def default_root() -> Path:
    env = os.environ.get("MTPU_SNAPSHOT_DIR", "")
    if env:
        return Path(env)
    return _config.state_dir() / "snapshots"


def source_hash_for(target, fn_bytes: bytes = b"") -> str:
    """Code-identity hash of the snapshot target: source text when the class
    is importable from a file, else the cloudpickled definition bytes."""
    import inspect

    obj = target[0] if isinstance(target, tuple) else target
    try:
        src = inspect.getsource(obj)
    except (OSError, TypeError):
        src = ""
    h = hashlib.sha256()
    h.update(getattr(obj, "__qualname__", repr(obj)).encode())
    h.update(src.encode() if src else fn_bytes)
    return h.hexdigest()[:24]


def compute_snapshot_key(
    *,
    image_digest: str,
    source_hash: str,
    env: dict[str, str] | None = None,
    cls_params: bytes | None = None,
    machine_tag: str | None = None,
) -> str:
    env_fp = hashlib.sha256(
        json.dumps(sorted((env or {}).items())).encode()
    ).hexdigest()
    params_fp = hashlib.sha256(cls_params or b"").hexdigest()
    blob = "|".join([image_digest, source_hash, env_fp, params_fp])
    tag = machine_tag or _machine_tag()
    return f"{tag}-{hashlib.sha256(blob.encode()).hexdigest()[:24]}"


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


class SnapshotStore:
    """Filesystem-backed snapshot store (get/put/list/inspect/clear)."""

    def __init__(
        self,
        root: str | os.PathLike | None = None,
        *,
        max_entries: int | None = None,
        max_bytes: int | None = None,
    ):
        self.root = Path(root) if root else default_root()
        # malformed env knobs degrade to defaults — snapshot config can
        # never turn into a boot outage (the store runs inside every
        # snapshot-enabled container's boot path)
        if max_entries is None:
            try:
                max_entries = int(
                    os.environ.get("MTPU_SNAPSHOT_MAX_ENTRIES", DEFAULT_MAX_ENTRIES)
                )
            except ValueError:
                max_entries = DEFAULT_MAX_ENTRIES
        if max_bytes is None:
            try:
                max_bytes = int(os.environ.get("MTPU_SNAPSHOT_MAX_BYTES", 0)) or None
            except ValueError:
                max_bytes = None
        self.max_entries = max_entries
        self.max_bytes = max_bytes

    @classmethod
    def from_volume(cls, volume, **kw) -> "SnapshotStore":
        """A Volume-backed store, so autoscaled replicas share snapshots."""
        return cls(root=Path(str(volume.local_path)) / ".snapshots", **kw)

    # -- paths ---------------------------------------------------------------

    def _entry_dir(self, key: str) -> Path:
        return self.root / key

    def _meta_path(self, key: str) -> Path:
        return self._entry_dir(key) / "meta.json"

    def _state_path(self, key: str) -> Path:
        return self._entry_dir(key) / "state.bin"

    # -- read ----------------------------------------------------------------

    def has(self, key: str) -> bool:
        # parse, don't stat: a corrupt meta.json must read as a miss, or the
        # autoscaler gate and put() racers treat a dead entry as live
        return self.inspect(key) is not None

    def inspect(self, key: str) -> dict | None:
        try:
            return json.loads(self._meta_path(key).read_text())
        except (OSError, json.JSONDecodeError):
            return None

    def get(self, key: str) -> tuple[bytes, dict] | None:
        """Payload + meta for ``key``, or None on miss/corruption (corrupt
        entries are deleted so the next boot re-captures). Lookups feed the
        ``mtpu_snapshot_store_gets_total{result=hit|miss}`` hit-ratio
        counters — once per container boot, never a hot path."""
        meta = self.inspect(key)
        if meta is None:
            if self._entry_dir(key).exists():
                self.delete(key)  # corrupt meta.json: self-heal
            _obs.record_snapshot_store_get("miss")
            return None
        try:
            payload = self._state_path(key).read_bytes()
        except OSError:
            self.delete(key)
            _obs.record_snapshot_store_get("miss")
            return None
        if _sha256(payload) != meta.get("checksum"):
            self.delete(key)
            _obs.record_snapshot_store_get("miss")
            return None
        self._touch(key, meta)
        _obs.record_snapshot_store_get("hit")
        return payload, meta

    def _touch(self, key: str, meta: dict) -> None:
        """Bump last_used for LRU (best-effort, atomic)."""
        meta["last_used"] = time.time()
        try:
            tmp = self._entry_dir(key) / f".meta.{os.getpid()}.tmp"
            tmp.write_text(json.dumps(meta, indent=2))
            os.replace(tmp, self._meta_path(key))
        except OSError:
            pass

    # -- write ---------------------------------------------------------------

    def put(self, key: str, payload: bytes, manifest: dict | None = None) -> bool:
        """Atomically publish an entry; first writer wins. Returns True when
        this call's entry (or a racing writer's) is in place."""
        now = time.time()
        meta = {
            "key": key,
            "checksum": _sha256(payload),
            "size_bytes": len(payload),
            "created_at": now,
            "last_used": now,
            "manifest": manifest or {},
        }
        tmp = self.root / f".tmp-{uuid.uuid4().hex[:12]}"
        try:
            tmp.mkdir(parents=True, exist_ok=True)
            (tmp / "state.bin").write_bytes(payload)
            (tmp / "meta.json").write_text(json.dumps(meta, indent=2))
            os.rename(tmp, self._entry_dir(key))
        except OSError:
            if not self.has(key):
                # the blocking dir is a corrupt entry, not a racing capture:
                # replace it so the key can't wedge permanently
                self.delete(key)
                try:
                    os.rename(tmp, self._entry_dir(key))
                except OSError:
                    shutil.rmtree(tmp, ignore_errors=True)
                    return self.has(key)
                self._evict()
                return True
            shutil.rmtree(tmp, ignore_errors=True)
            return True  # lost the race to a concurrent capture
        self._evict()
        return True

    def delete(self, key: str) -> bool:
        d = self._entry_dir(key)
        if not d.exists():
            return False
        shutil.rmtree(d, ignore_errors=True)
        return True

    def clear(self) -> int:
        """Delete every entry dir, including corrupt ones entries() skips."""
        n = 0
        if not self.root.is_dir():
            return 0
        for d in self.root.iterdir():
            if d.name.startswith(".") or not d.is_dir():
                continue
            n += self.delete(d.name)
        self.publish_size_gauges()
        return n

    # -- listing / eviction --------------------------------------------------

    def entries(self) -> list[dict]:
        """All entry metas, most-recently-used first."""
        out = []
        if not self.root.is_dir():
            return out
        for d in self.root.iterdir():
            if d.name.startswith(".") or not d.is_dir():
                continue
            meta = self.inspect(d.name)
            if meta is not None:
                out.append(meta)
        out.sort(key=lambda m: m.get("last_used", 0), reverse=True)
        return out

    def _evict(self) -> None:
        entries = self.entries()
        # entry-count bound
        while len(entries) > self.max_entries:
            victim = entries.pop()
            self.delete(victim["key"])
        # optional byte bound
        if self.max_bytes:
            total = sum(e.get("size_bytes", 0) for e in entries)
            while entries and total > self.max_bytes:
                victim = entries.pop()
                total -= victim.get("size_bytes", 0)
                self.delete(victim["key"])
        self.publish_size_gauges(entries)

    def publish_size_gauges(self, entries: list[dict] | None = None) -> dict:
        """Refresh ``mtpu_snapshot_store_entries`` / ``_bytes`` from the
        store's current contents (called after every put/evict, and by
        anything that wants a fresh reading, e.g. `tpurun top`)."""
        if entries is None:
            entries = self.entries()
        total = sum(e.get("size_bytes", 0) for e in entries)
        _obs.set_snapshot_store_size(entries=len(entries), total_bytes=total)
        return {"entries": len(entries), "bytes": total}
