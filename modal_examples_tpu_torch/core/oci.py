"""Copy of ``modal_examples_tpu/core/oci.py``: OCI image-layout export for
the Image DSL.

The reference's platform builds real container images from its
``modal.Image`` chains (02_building_containers; the builder runs
server-side). This is the framework's offline equivalent: serialize
an :class:`~.image.Image` into a spec-valid **OCI Image Layout**
(opencontainers/image-spec v1.0) that any registry/runtime tool
(skopeo, podman, crane) can consume — without a docker daemon and
without network:

- ``add_local_dir`` / ``add_local_file`` / ``add_local_python_source``
  layers become real gzip'd tar layer blobs (deterministic: sorted
  entries, zeroed mtimes, fixed uid/gid — identical inputs give
  identical digests, the content-addressed build-cache property);
- ``env`` / ``workdir`` / ``entrypoint`` layers land in the image
  config (no filesystem blob);
- network-dependent steps (``pip_install`` / ``apt_install`` /
  ``run_commands`` / ``run_function`` — unexecutable in this zero-egress
  environment) are recorded as ``empty_layer`` history entries carrying
  the exact command a connected builder would run, so the recipe
  survives in the artifact's provenance.

The base layer is history only: ``Image.cuda_base()`` records
``BASE ["cuda_base", ...]`` and its torch/CUDA-toolkit install steps where
the JAX package's ``tpu_base()`` records its jax/libtpu ones, so two chains
that differ only in the base give the same layer blobs and diff_ids.

Layout per the spec::

    dest/
      oci-layout          {"imageLayoutVersion": "1.0.0"}
      index.json          -> manifest descriptor
      blobs/sha256/<hex>  config, manifest, layer tars
"""

from __future__ import annotations

import gzip
import hashlib
import json
import os
import tarfile
import uuid
from pathlib import Path

from .image import Image

MEDIA_CONFIG = "application/vnd.oci.image.config.v1+json"
MEDIA_MANIFEST = "application/vnd.oci.image.manifest.v1+json"
MEDIA_LAYER = "application/vnd.oci.image.layer.v1.tar+gzip"


def _blob(dest: Path, data: bytes) -> tuple[str, int]:
    """Write a small blob under blobs/sha256/<digest>; returns
    (digest, size). Layer tars stream via :func:`_write_layer_blob`."""
    digest = "sha256:" + hashlib.sha256(data).hexdigest()
    p = dest / "blobs" / "sha256" / digest.split(":", 1)[1]
    p.parent.mkdir(parents=True, exist_ok=True)
    if not p.exists():
        p.write_bytes(data)
    return digest, len(data)


class _HashingWriter:
    """write()-only tee: hashes everything passing through to ``sink``."""

    def __init__(self, sink):
        self._sink = sink
        self.hash = hashlib.sha256()
        self._pos = 0

    def write(self, b) -> int:
        self.hash.update(b)
        self._sink.write(b)
        self._pos += len(b)
        return len(b)

    def tell(self) -> int:  # tarfile (PAX) tracks offsets via tell()
        return self._pos

    def flush(self) -> None:  # gzip/tarfile call this on close
        self._sink.flush()


def _write_layer_blob(
    dest: Path, entries: list[tuple[str, Path]]
) -> tuple[str, int, str]:
    """Stream a deterministic gzip'd tar layer into the blob store;
    returns (digest, size, diff_id of the UNCOMPRESSED tar).

    ``entries`` maps archive paths to local files/dirs (which must
    exist — a missing path raises instead of silently exporting an
    empty layer). Determinism: sorted paths, mtime 0, uid/gid 0, gzip
    mtime 0; the exec bit is the only mode bit carried from the source
    (an entrypoint script stripped to 0644 couldn't exec in a runtime).
    Nothing is buffered whole — tar streams through the diff_id hasher
    into gzip, gzip streams through the blob hasher to disk — so
    multi-GB weight layers don't triple in RAM.
    """
    expanded: list[tuple[str, Path]] = []
    for arcname, local in entries:
        local = Path(local)
        if local.is_dir():
            for f in sorted(local.rglob("*")):
                if f.is_file():
                    rel = f.relative_to(local)
                    expanded.append((f"{arcname.rstrip('/')}/{rel}", f))
        elif local.is_file():
            expanded.append((arcname, local))
        else:
            raise FileNotFoundError(
                f"add_local source {str(local)!r} does not exist"
            )
    expanded.sort(key=lambda e: e[0])

    blob_dir = dest / "blobs" / "sha256"
    blob_dir.mkdir(parents=True, exist_ok=True)
    # unique per-writer staging name: a fixed ".layer.tmp" raced when two
    # exports shared a dest (one writer's replace() shipped the other's
    # half-written bytes under a wrong digest); the rename into the
    # content-addressed final name stays atomic either way
    tmp = blob_dir / f".layer.{uuid.uuid4().hex}.tmp"
    try:
        with open(tmp, "wb") as raw:
            outer = _HashingWriter(raw)  # hashes the COMPRESSED blob
            with gzip.GzipFile(fileobj=outer, mode="wb", mtime=0) as gz:
                inner = _HashingWriter(gz)  # hashes the UNCOMPRESSED tar
                with tarfile.open(
                    fileobj=inner, mode="w", format=tarfile.PAX_FORMAT
                ) as tf:
                    seen_dirs: set[str] = set()
                    for arcname, local in expanded:
                        arcname = arcname.lstrip("/")
                        parts = arcname.split("/")[:-1]
                        for i in range(1, len(parts) + 1):
                            d = "/".join(parts[:i])
                            if d and d not in seen_dirs:
                                seen_dirs.add(d)
                                ti = tarfile.TarInfo(d)
                                ti.type = tarfile.DIRTYPE
                                ti.mode = 0o755
                                ti.mtime = 0
                                tf.addfile(ti)
                        ti = tarfile.TarInfo(arcname)
                        ti.size = local.stat().st_size
                        ti.mode = (
                            0o755 if os.access(local, os.X_OK) else 0o644
                        )
                        ti.mtime = 0
                        with open(local, "rb") as f:
                            tf.addfile(ti, f)
                diff_id = "sha256:" + inner.hash.hexdigest()
            digest = "sha256:" + outer.hash.hexdigest()
        size = tmp.stat().st_size
        final = blob_dir / digest.split(":", 1)[1]
        if final.exists():
            tmp.unlink()
        else:
            tmp.replace(final)
    finally:
        tmp.unlink(missing_ok=True)  # no orphaned staging file on failure
    return digest, size, diff_id


def export_oci(
    image: Image,
    dest: str | Path,
    *,
    tag: str = "latest",
    architecture: str = "amd64",
    os_name: str = "linux",
) -> dict:
    """Export ``image`` as an OCI image layout at ``dest``.

    Returns a summary dict (manifest digest, layer count, history).
    """
    dest = Path(dest)
    dest.mkdir(parents=True, exist_ok=True)

    history: list[dict] = []
    diff_ids: list[str] = []
    layer_descriptors: list[dict] = []
    env: dict[str, str] = {}
    workdir: str | None = None
    entrypoint: list[str] | None = None

    for layer in image.layers:
        kind, payload = layer.kind, layer.payload
        if kind == "env":
            env.update(dict(payload))
            history.append(_hist(f"ENV {dict(payload)}", empty=True))
        elif kind == "workdir":
            workdir = payload[0]
            history.append(_hist(f"WORKDIR {workdir}", empty=True))
        elif kind == "entrypoint":
            entrypoint = list(payload)
            history.append(_hist(f"ENTRYPOINT {entrypoint}", empty=True))
        elif kind == "add_local":
            mode = payload[0]
            if mode == "pysource":
                import importlib.util

                entries = []
                for mod in payload[1:]:
                    spec = importlib.util.find_spec(mod)
                    if spec is None or spec.origin is None:
                        raise FileNotFoundError(f"module {mod!r} not found")
                    if spec.submodule_search_locations:
                        entries.append(
                            (f"/root/{mod}",
                             Path(spec.origin).parent)
                        )
                    else:
                        entries.append((f"/root/{mod}.py", Path(spec.origin)))
                created_by = f"ADD (pysource) {list(payload[1:])}"
            else:
                local, remote = payload[1], payload[2]
                entries = [(remote, Path(local))]
                created_by = f"ADD ({mode}) {local} {remote}"
            digest, size, diff_id = _write_layer_blob(dest, entries)
            diff_ids.append(diff_id)
            layer_descriptors.append(
                {"mediaType": MEDIA_LAYER, "digest": digest, "size": size}
            )
            history.append(_hist(created_by))
        else:
            # base / pip / apt / run_commands / run_function: the step a
            # connected builder would execute, preserved as provenance
            history.append(
                _hist(f"{kind.upper()} {json.dumps(list(map(str, payload)))}",
                      empty=True)
            )

    if not layer_descriptors:
        # the image spec requires a base layer at index 0; a chain with no
        # local content gets an empty scratch layer so runtimes accept it
        digest, size, diff_id = _write_layer_blob(dest, [])
        diff_ids.append(diff_id)
        layer_descriptors.append(
            {"mediaType": MEDIA_LAYER, "digest": digest, "size": size}
        )
        history.append(_hist("SCRATCH (no local-content layers)"))

    config = {
        "architecture": architecture,
        "os": os_name,
        "config": {
            **({"Env": [f"{k}={v}" for k, v in env.items()]} if env else {}),
            **({"WorkingDir": workdir} if workdir else {}),
            **({"Entrypoint": entrypoint} if entrypoint else {}),
            "Labels": {
                "org.mtpu.image.digest": image.digest(),
            },
        },
        "rootfs": {"type": "layers", "diff_ids": diff_ids},
        "history": history,
    }
    cfg_bytes = json.dumps(config, sort_keys=True).encode()
    cfg_digest, cfg_size = _blob(dest, cfg_bytes)

    manifest = {
        "schemaVersion": 2,
        "mediaType": MEDIA_MANIFEST,
        "config": {
            "mediaType": MEDIA_CONFIG, "digest": cfg_digest, "size": cfg_size,
        },
        "layers": layer_descriptors,
    }
    man_bytes = json.dumps(manifest, sort_keys=True).encode()
    man_digest, man_size = _blob(dest, man_bytes)

    (dest / "oci-layout").write_text(
        json.dumps({"imageLayoutVersion": "1.0.0"})
    )
    index = {
        "schemaVersion": 2,
        "manifests": [
            {
                "mediaType": MEDIA_MANIFEST,
                "digest": man_digest,
                "size": man_size,
                "annotations": {"org.opencontainers.image.ref.name": tag},
            }
        ],
    }
    (dest / "index.json").write_text(json.dumps(index, sort_keys=True))
    return {
        "manifest_digest": man_digest,
        "config_digest": cfg_digest,
        "n_layers": len(layer_descriptors),
        "n_history": len(history),
    }


def _hist(created_by: str, empty: bool = False) -> dict:
    h = {"created_by": created_by}
    if empty:
        h["empty_layer"] = True
    return h
