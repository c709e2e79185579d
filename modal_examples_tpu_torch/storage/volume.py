"""Copy of ``modal_examples_tpu/storage/volume.py``: a shared durable
filesystem with commit/reload semantics. ``CloudBucketMount`` (and
``storage/gcs.py`` behind it) waits (ROADMAP A13).

Reference spec: ``modal.Volume.from_name(name, create_if_missing=True)``
mounted at a path in the container (vllm_inference.py:77-81), with explicit
``volume.commit()`` after writes (openai_whisper/finetuning/train/train.py:469)
and ``volume.reload()`` to pick up other writers' commits
(torch_profiling.py:279). Volumes back weight caches and checkpoints.

Local control plane: each volume is a directory under the state dir. commit()
fsyncs and bumps a version file; reload() re-reads it.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

from .._internal import config as _config

_NAME_RE = re.compile(r"^[a-zA-Z0-9][a-zA-Z0-9._-]*$")


class VolumeNotFound(KeyError):
    pass


def _volumes_root() -> Path:
    p = _config.state_dir() / "volumes"
    p.mkdir(parents=True, exist_ok=True)
    return p


class Volume:
    def __init__(self, name: str, path: Path):
        self.name = name
        self._path = path
        self._seen_version = self.version

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_name(cls, name: str, create_if_missing: bool = False, environment_name: str | None = None) -> "Volume":
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid volume name {name!r}")
        path = _volumes_root() / name
        if not path.exists():
            if not create_if_missing:
                raise VolumeNotFound(name)
            path.mkdir(parents=True, exist_ok=True)
            (path / ".version").write_text("0")
        return cls(name, path)

    @classmethod
    def ephemeral(cls):
        import contextlib
        import tempfile

        @contextlib.contextmanager
        def _ctx():
            with tempfile.TemporaryDirectory(prefix="mtpu-vol-") as d:
                p = Path(d)
                (p / ".version").write_text("0")
                yield cls(f"ephemeral-{os.path.basename(d)}", p)

        return _ctx()

    @staticmethod
    def delete(name: str) -> None:
        import shutil

        path = _volumes_root() / name
        if path.exists():
            shutil.rmtree(path)

    # -- filesystem ---------------------------------------------------------

    @property
    def local_path(self) -> Path:
        """Host path of the volume (containers mount this path)."""
        return self._path

    @property
    def version(self) -> int:
        vf = self._path / ".version"
        try:
            return int(vf.read_text() or "0")
        except (FileNotFoundError, ValueError):
            return 0

    def commit(self) -> None:
        """Flush writes; makes them visible to other readers at reload()."""
        vf = self._path / ".version"
        v = self.version + 1
        tmp = self._path / f".version.tmp.{os.getpid()}"
        tmp.write_text(str(v))
        os.replace(tmp, vf)
        self._seen_version = v

    def reload(self) -> None:
        """Pick up commits made by other containers since our last look."""
        self._seen_version = self.version

    # -- convenience API (modeled on modal's volume file API) ----------------

    def listdir(self, path: str = "/", recursive: bool = False):
        # dotfiles are volume internals (.version, in-flight .tmp-* atomic
        # writes) — listing them would hand readers a torn file
        if recursive:
            for root, _dirs, files in os.walk(self._resolve(path)):
                for f in sorted(files):
                    if f.startswith("."):
                        continue
                    full = Path(root) / f
                    yield str(full.relative_to(self._path))
        else:
            for entry in sorted(self._resolve(path).iterdir()):
                if entry.name.startswith("."):
                    continue
                yield str(entry.relative_to(self._path))

    def read_file(self, path: str) -> bytes:
        return self._resolve(path).read_bytes()

    def write_file(self, path: str, data: bytes) -> None:
        """Atomic durable write: uuid temp file, fsync, rename. A crash at
        ANY point leaves either the old content or the new — never a torn
        file that passes a size check (the KV spill tier and the shared
        prefix store both lean on this; a torn block would otherwise only
        be caught at crc time, after a wasted read)."""
        import uuid

        p = self._resolve(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.parent / f".tmp-{uuid.uuid4().hex}-{p.name}"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, p)
        except BaseException:
            tmp.unlink(missing_ok=True)
            raise

    def remove_file(self, path: str, recursive: bool = False) -> None:
        import shutil

        p = self._resolve(path)
        if p.is_dir():
            if not recursive:
                raise IsADirectoryError(path)
            shutil.rmtree(p)
        else:
            p.unlink()

    def restricted(self, subpath: str) -> "Volume":
        """A view of this volume rooted at ``subpath`` — per-user restricted
        mounts (08_advanced/restricted_volumes.py:8-35): mount
        ``vol.restricted(f"users/{user_id}")`` and the container can only
        see/write that subtree."""
        root = self._resolve(subpath)
        root.mkdir(parents=True, exist_ok=True)
        view = Volume(f"{self.name}/{subpath.strip('/')}", root)
        return view

    def _resolve(self, path: str) -> Path:
        p = (self._path / path.lstrip("/")).resolve()
        root = self._path.resolve()
        if p != root and root not in p.parents:
            raise PermissionError(f"path escapes volume: {path}")
        return p

    def __repr__(self) -> str:
        return f"Volume({self.name!r})"
