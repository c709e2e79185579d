"""Copy of ``modal_examples_tpu/storage/volume.py``: a shared durable
filesystem with commit/reload semantics, and ``CloudBucketMount``, a GCS
bucket synced through ``storage/gcs.py``.

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


class CloudBucketMount:
    """Mount an object-store bucket as a filesystem path.

    Reference: S3/GCS mounts in 12_datasets/coco.py:26-29 and
    10_integrations/s3_bucket_mount.py. Here it is a GCS bucket:
    ``pull()``/``push()`` sync objects through a real GCS JSON-API client
    (storage.gcs — stdlib urllib, bearer auth via Secret env or the GCE
    metadata server). The mount path itself is a host directory, so dataset
    examples also run end-to-end with no cloud credentials at all (the
    zero-egress dev mode).
    """

    def __init__(
        self,
        bucket_name: str,
        *,
        bucket_endpoint_url: str | None = None,
        key_prefix: str | None = None,
        secret=None,
        read_only: bool = False,
    ):
        self.bucket_name = bucket_name
        self.key_prefix = key_prefix or ""
        self.read_only = read_only
        self.bucket_endpoint_url = bucket_endpoint_url
        self.secret = secret  # may carry GCS_TOKEN for authenticated pulls
        root = _config.state_dir() / "buckets" / bucket_name
        root.mkdir(parents=True, exist_ok=True)
        self.local_path = root / self.key_prefix if self.key_prefix else root
        self.local_path.mkdir(parents=True, exist_ok=True)

    def _client(self):
        """The real GCS JSON-API client (storage.gcs). ``bucket_endpoint_
        url`` overrides the endpoint — production GCS by default, a local
        fake-gcs-server in tests, an S3-compatible proxy if needed."""
        from .gcs import GCSClient

        kw = {}
        if self.bucket_endpoint_url:
            kw["endpoint"] = self.bucket_endpoint_url
        if self.secret is not None:
            # Secret-provided credential wins over process env / metadata
            token = self.secret.env_vars().get("GCS_TOKEN")
            if token:
                kw["token"] = token
        return GCSClient(**kw)

    def pull(self) -> int:
        """Materialize gs://bucket/prefix into the local mount path (the
        reference's read-mount semantics: coco.py:26-29 reads the bucket
        through the filesystem). Returns the number of objects pulled."""
        from .gcs import sync_prefix_to_dir

        return sync_prefix_to_dir(
            self._client(), self.bucket_name, self.key_prefix, self.local_path
        )

    def push(self) -> int:
        """Upload the local mount path back under gs://bucket/prefix (the
        write-back half for read-write mounts). Returns objects pushed."""
        if self.read_only:
            raise PermissionError("read_only mount cannot push")
        from .gcs import sync_dir_to_prefix

        return sync_dir_to_prefix(
            self._client(), self.local_path, self.bucket_name, self.key_prefix
        )

    def __repr__(self) -> str:
        return f"CloudBucketMount({self.bucket_name!r}, prefix={self.key_prefix!r})"
