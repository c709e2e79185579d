"""Copy of ``modal_examples_tpu/storage/dict_queue.py``: Dict / Queue,
distributed KV and FIFO primitives.

Reference spec: ``modal.Queue.ephemeral()`` / ``modal.Dict.ephemeral()``,
``q.put_many``, blocking ``q.get``, dict-based coordination & termination
signalling in the distributed crawler (09_job_queues/dicts_and_queues.py:53-80)
and the sandbox warm-pool registry (13_sandboxes/sandbox_pool.py:20-24).

Local control plane: pickled state files under the state dir guarded by
``fcntl`` locks, so every container process on the host shares one view —
the same consistency contract (single linearizable store) the reference's
metadata service provides. Blocking reads poll; a networked service can
replace :class:`_Store` later. The on-disk format is the JAX package's: both
packages pointed at one state directory read each other's dicts and queues.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
import pickle
import time
from collections import deque
from pathlib import Path
from typing import Any, Iterator

from .._internal import config as _config


class Empty(Exception):
    """Raised by non-blocking/timed-out queue reads."""


class _Store:
    """A pickled python object on disk with advisory-locked read-modify-write."""

    def __init__(self, path: Path, initial):
        self._path = path
        self._lock_path = path.with_suffix(".lock")
        self._initial = initial
        self._path.parent.mkdir(parents=True, exist_ok=True)
        self._lock_path.touch(exist_ok=True)

    @contextlib.contextmanager
    def locked(self):
        with open(self._lock_path, "r+") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lf, fcntl.LOCK_UN)

    def load(self):
        try:
            with open(self._path, "rb") as f:
                return pickle.load(f)
        except (FileNotFoundError, EOFError):
            return self._initial()

    def save(self, obj) -> None:
        tmp = self._path.with_suffix(f".tmp.{os.getpid()}")
        with open(tmp, "wb") as f:
            pickle.dump(obj, f)
        os.replace(tmp, self._path)

    def destroy(self) -> None:
        for p in (self._path, self._lock_path):
            try:
                p.unlink()
            except FileNotFoundError:
                pass


def _objects_root(kind: str) -> Path:
    p = _config.state_dir() / kind
    p.mkdir(parents=True, exist_ok=True)
    return p


class Dict:
    def __init__(self, name: str):
        self.name = name
        self._store = _Store(_objects_root("dicts") / f"{name}.pkl", dict)

    @classmethod
    def from_name(cls, name: str, create_if_missing: bool = True) -> "Dict":
        return cls(name)

    @classmethod
    @contextlib.contextmanager
    def ephemeral(cls) -> Iterator["Dict"]:
        name = f"ephemeral-{os.getpid()}-{time.monotonic_ns()}"
        d = cls(name)
        try:
            yield d
        finally:
            d._store.destroy()

    @staticmethod
    def delete(name: str) -> None:
        _Store(_objects_root("dicts") / f"{name}.pkl", dict).destroy()

    def __setitem__(self, key, value) -> None:
        self.put(key, value)

    def put(self, key, value) -> None:
        with self._store.locked():
            d = self._store.load()
            d[key] = value
            self._store.save(d)

    def __getitem__(self, key):
        with self._store.locked():
            return self._store.load()[key]

    def get(self, key, default=None):
        with self._store.locked():
            return self._store.load().get(key, default)

    def pop(self, key, *default):
        with self._store.locked():
            d = self._store.load()
            val = d.pop(key, *default)
            self._store.save(d)
            return val

    def put_if_absent(self, key, value) -> bool:
        """Atomically claim ``key``; True iff this caller won (the primitive
        behind exactly-once work claiming in the crawler pattern)."""
        with self._store.locked():
            d = self._store.load()
            if key in d:
                return False
            d[key] = value
            self._store.save(d)
            return True

    def update(self, **kwargs) -> None:
        with self._store.locked():
            d = self._store.load()
            d.update(kwargs)
            self._store.save(d)

    def __contains__(self, key) -> bool:
        with self._store.locked():
            return key in self._store.load()

    def contains(self, key) -> bool:
        return key in self

    def __len__(self) -> int:
        with self._store.locked():
            return len(self._store.load())

    def len(self) -> int:
        return len(self)

    def keys(self):
        with self._store.locked():
            return list(self._store.load().keys())

    def values(self):
        with self._store.locked():
            return list(self._store.load().values())

    def items(self):
        with self._store.locked():
            return list(self._store.load().items())

    def clear(self) -> None:
        with self._store.locked():
            self._store.save({})


class Queue:
    """FIFO queue with optional partitions (reference: partition kwarg)."""

    def __init__(self, name: str):
        self.name = name
        self._store = _Store(_objects_root("queues") / f"{name}.pkl", dict)

    @classmethod
    def from_name(cls, name: str, create_if_missing: bool = True) -> "Queue":
        return cls(name)

    @classmethod
    @contextlib.contextmanager
    def ephemeral(cls) -> Iterator["Queue"]:
        name = f"ephemeral-{os.getpid()}-{time.monotonic_ns()}"
        q = cls(name)
        try:
            yield q
        finally:
            q._store.destroy()

    @staticmethod
    def delete(name: str) -> None:
        _Store(_objects_root("queues") / f"{name}.pkl", dict).destroy()

    def _partition(self, d: dict, partition: str | None) -> deque:
        return d.setdefault(partition or "", deque())

    def put(self, item, partition: str | None = None) -> None:
        with self._store.locked():
            d = self._store.load()
            self._partition(d, partition).append(item)
            self._store.save(d)

    def put_many(self, items, partition: str | None = None) -> None:
        with self._store.locked():
            d = self._store.load()
            self._partition(d, partition).extend(items)
            self._store.save(d)

    def get(
        self,
        block: bool = True,
        timeout: float | None = None,
        partition: str | None = None,
    ):
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._store.locked():
                d = self._store.load()
                dq = self._partition(d, partition)
                if dq:
                    item = dq.popleft()
                    self._store.save(d)
                    return item
            if not block:
                raise Empty(self.name)
            if deadline is not None and time.monotonic() >= deadline:
                raise Empty(self.name)
            time.sleep(0.02)

    def get_many(
        self,
        n_values: int,
        block: bool = True,
        timeout: float | None = None,
        partition: str | None = None,
    ) -> list:
        """Up to ``n_values`` items; blocks for at least one if ``block``."""
        first = self.get(block=block, timeout=timeout, partition=partition)
        out = [first]
        with self._store.locked():
            d = self._store.load()
            dq = self._partition(d, partition)
            while dq and len(out) < n_values:
                out.append(dq.popleft())
            self._store.save(d)
        return out

    def __len__(self) -> int:
        return self.len()

    def len(self, partition: str | None = None, total: bool = False) -> int:
        with self._store.locked():
            d = self._store.load()
            if total:
                return sum(len(dq) for dq in d.values())
            return len(self._partition(d, partition))

    def clear(self, partition: str | None = None, all: bool = False) -> None:
        with self._store.locked():
            d = self._store.load()
            if all:
                d = {}
            else:
                d[partition or ""] = deque()
            self._store.save(d)
