"""The port's OCI image-layout export (``core/oci.py``, ``Image.export_oci``)
held against the JAX package's: the seven cases of ``tests/test_oci.py`` on
the port (spec-valid layout and digests, layer contents, determinism, the
exec bit, a missing path, the scratch layer, a Python-source layer), the
same layout byte for byte for a chain both packages build, and, for the
CUDA base against the TPU base, the same layer blobs and diff_ids with the
config's differing fields named.
"""

from __future__ import annotations

import gzip
import hashlib
import io
import json
import tarfile
from pathlib import Path

import pytest

import modal_examples_tpu as jm
import modal_examples_tpu_torch as mtpu
from test_torch_time_limit import share_cores, time_limits

share_cores()

#: exports of a few small files (well under a second each)
_limit_module, _limit_test = time_limits(test_s=60, module_s=120)


def _build_image(pkg, tmp_path: Path, base: str = "debian_slim"):
    src = tmp_path / "srcdir"
    if not src.exists():
        src.mkdir()
        (src / "model.txt").write_text("weights v1")
        (src / "sub").mkdir()
        (src / "sub" / "cfg.json").write_text('{"a": 1}')
        (tmp_path / "start.sh").write_text("#!/bin/sh\necho hi\n")
    img = getattr(pkg.Image, base)("3.12") if base == "debian_slim" else getattr(pkg.Image, base)()
    return (
        img.apt_install("curl")
        .pip_install("numpy")
        .env({"MODEL": "llama", "PRECISION": "bf16"})
        .add_local_dir(str(src), "/assets")
        .add_local_file(str(tmp_path / "start.sh"), "/start.sh")
        .workdir("/app")
        .entrypoint(["/start.sh"])
    )


def _read_blob(dest: Path, digest: str) -> bytes:
    algo, hexd = digest.split(":")
    data = (dest / "blobs" / algo / hexd).read_bytes()
    assert hashlib.sha256(data).hexdigest() == hexd
    return data


def _layout(dest: Path) -> tuple[dict, dict]:
    index = json.loads((dest / "index.json").read_text())
    manifest = json.loads(_read_blob(dest, index["manifests"][0]["digest"]))
    return manifest, json.loads(_read_blob(dest, manifest["config"]["digest"]))


def test_layout_is_spec_valid_and_digests_check(tmp_path):
    img = _build_image(mtpu, tmp_path)
    dest = tmp_path / "oci"
    summary = img.export_oci(str(dest), tag="v1")

    assert json.loads((dest / "oci-layout").read_text()) == {"imageLayoutVersion": "1.0.0"}
    index = json.loads((dest / "index.json").read_text())
    (mdesc,) = index["manifests"]
    assert mdesc["annotations"]["org.opencontainers.image.ref.name"] == "v1"
    manifest = json.loads(_read_blob(dest, mdesc["digest"]))
    assert mdesc["size"] == len(_read_blob(dest, mdesc["digest"]))
    assert summary["manifest_digest"] == mdesc["digest"]

    config = json.loads(_read_blob(dest, manifest["config"]["digest"]))
    assert "MODEL=llama" in config["config"]["Env"]
    assert config["config"]["WorkingDir"] == "/app"
    assert config["config"]["Entrypoint"] == ["/start.sh"]
    assert len(manifest["layers"]) == 2
    assert len(config["rootfs"]["diff_ids"]) == 2
    for ldesc, diff_id in zip(manifest["layers"], config["rootfs"]["diff_ids"]):
        gz_bytes = _read_blob(dest, ldesc["digest"])
        assert ldesc["size"] == len(gz_bytes)
        assert "sha256:" + hashlib.sha256(gzip.decompress(gz_bytes)).hexdigest() == diff_id
    empties = [h for h in config["history"] if h.get("empty_layer")]
    assert any("APT" in h["created_by"] for h in empties)
    assert any("PIP" in h["created_by"] for h in empties)
    assert len(config["history"]) - len(empties) == 2


def test_layer_contents_roundtrip(tmp_path):
    dest = tmp_path / "oci"
    _build_image(mtpu, tmp_path).export_oci(str(dest))
    manifest, _ = _layout(dest)
    files: dict[str, bytes] = {}
    for ldesc in manifest["layers"]:
        with tarfile.open(fileobj=io.BytesIO(gzip.decompress(_read_blob(dest, ldesc["digest"])))) as tf:
            for m in tf.getmembers():
                if m.isfile():
                    files[m.name] = tf.extractfile(m).read()
    assert files["assets/model.txt"] == b"weights v1"
    assert json.loads(files["assets/sub/cfg.json"]) == {"a": 1}
    assert files["start.sh"].startswith(b"#!/bin/sh")


def test_export_is_deterministic(tmp_path):
    img = _build_image(mtpu, tmp_path)
    s1 = img.export_oci(str(tmp_path / "a"))
    s2 = img.export_oci(str(tmp_path / "b"))
    assert s1 == s2
    assert (tmp_path / "a" / "index.json").read_bytes() == (tmp_path / "b" / "index.json").read_bytes()


def test_exec_bit_preserved(tmp_path):
    script = tmp_path / "run.sh"
    script.write_text("#!/bin/sh\n")
    script.chmod(0o755)
    plain = tmp_path / "data.txt"
    plain.write_text("x")
    img = mtpu.Image.debian_slim().add_local_file(str(script), "/run.sh").add_local_file(str(plain), "/data.txt")
    dest = tmp_path / "oci"
    img.export_oci(str(dest))
    manifest, _ = _layout(dest)
    modes = {}
    for ldesc in manifest["layers"]:
        with tarfile.open(fileobj=io.BytesIO(gzip.decompress(_read_blob(dest, ldesc["digest"])))) as tf:
            for m in tf.getmembers():
                modes[m.name] = m.mode
    assert modes["run.sh"] == 0o755
    assert modes["data.txt"] == 0o644


def test_missing_local_path_raises(tmp_path):
    img = mtpu.Image.debian_slim().add_local_file(str(tmp_path / "nope.bin"), "/model.bin")
    with pytest.raises(FileNotFoundError, match="does not exist"):
        img.export_oci(str(tmp_path / "oci"))


def test_no_content_image_gets_scratch_layer(tmp_path):
    img = mtpu.Image.debian_slim().env({"A": "b"}).pip_install("torch")
    dest = tmp_path / "oci"
    assert img.export_oci(str(dest))["n_layers"] == 1
    manifest, config = _layout(dest)
    assert len(config["rootfs"]["diff_ids"]) == 1
    with tarfile.open(fileobj=io.BytesIO(gzip.decompress(_read_blob(dest, manifest["layers"][0]["digest"])))) as tf:
        assert tf.getnames() == []


def test_python_source_layer(tmp_path):
    dest = tmp_path / "oci"
    assert mtpu.Image.debian_slim().add_local_python_source("json").export_oci(str(dest))["n_layers"] == 1
    manifest, _ = _layout(dest)
    with tarfile.open(fileobj=io.BytesIO(gzip.decompress(_read_blob(dest, manifest["layers"][0]["digest"])))) as tf:
        names = tf.getnames()
    assert any(n.startswith("root/json") for n in names), names


def _files(dest: Path) -> dict[str, bytes]:
    return {str(p.relative_to(dest)): p.read_bytes() for p in sorted(dest.rglob("*")) if p.is_file()}


def test_a_chain_both_packages_build_exports_byte_for_byte(tmp_path):
    """``debian_slim`` and the same layers: the same blobs, config, manifest
    and index, file for file."""
    sp = _build_image(mtpu, tmp_path).export_oci(str(tmp_path / "port"))
    sj = _build_image(jm, tmp_path).export_oci(str(tmp_path / "jax"))
    assert sp == sj
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def test_the_cuda_base_differs_from_the_tpu_base_in_named_fields_only(tmp_path):
    """``Image.cuda_base()`` stands where ``Image.tpu_base()`` stands: the
    layer blobs and diff_ids are equal, and the config differs in the base's
    history (its BASE, PIP and APT steps) and in the image digest label, so
    in the config's and the manifest's digests."""
    _build_image(mtpu, tmp_path, "cuda_base").export_oci(str(tmp_path / "port"))
    _build_image(jm, tmp_path, "tpu_base").export_oci(str(tmp_path / "jax"))
    (pm_, pc), (jm_, jc) = _layout(tmp_path / "port"), _layout(tmp_path / "jax")

    assert pm_["layers"] == jm_["layers"]
    assert pc["rootfs"] == jc["rootfs"]
    for field in ("architecture", "os"):
        assert pc[field] == jc[field]
    for field in ("Env", "WorkingDir", "Entrypoint"):
        assert pc["config"][field] == jc["config"][field]

    differs = {k for k in ("architecture", "os", "rootfs") if pc[k] != jc[k]}
    differs |= {f"config.{k}" for k in pc["config"] if pc["config"][k] != jc["config"][k]}
    differs |= {"history"} if pc["history"] != jc["history"] else set()
    assert differs == {"config.Labels", "history"}
    assert pc["config"]["Labels"] != jc["config"]["Labels"]
    np_, nj = len(mtpu.Image.cuda_base().layers), len(jm.Image.tpu_base().layers)
    assert pc["history"][np_:] == jc["history"][nj:]  # every step after the base
    port_base = [h["created_by"] for h in pc["history"][:np_]]
    jax_base = [h["created_by"] for h in jc["history"][:nj]]
    assert port_base[0].startswith("BASE") and "cuda_base" in port_base[0] and "tpu_base" in jax_base[0]
    assert any("torch" in h for h in port_base) and not any("jax" in h for h in port_base)
    assert pm_["config"]["digest"] != jm_["config"]["digest"]
