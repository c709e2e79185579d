"""The port's kernel build names each library by a hash of what it compiles.

``_build.library_path(name)`` covers ``csrc/<name>.cu``, every shared header
``csrc/*.cuh`` and the flags, so an edited header rebuilds every kernel and an
edited source only its own. Checked on a temporary copy of ``csrc/`` (no
``nvcc`` needed: nothing is built).
"""

import shutil

import pytest

from modal_examples_tpu_torch.ops import _build
from test_torch_time_limit import share_cores

share_cores()

KERNELS = _build.kernel_names()


@pytest.fixture()
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def _paths():
    return {name: _build.library_path(name) for name in KERNELS}


def test_the_kernels_share_a_header():
    assert sorted(p.name for p in _build.CSRC.glob("*.cuh")) == [
        "flash_tf32.cuh", "hopper.cuh", "paged_decode.cuh"]
    including = [n for n in KERNELS if '#include "hopper.cuh"' in (_build.CSRC / f"{n}.cu").read_text()]
    assert {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "quantized_matmul"} <= set(including)
    including = [n for n in KERNELS if '#include "paged_decode.cuh"' in (_build.CSRC / f"{n}.cu").read_text()]
    assert including == ["paged_decode", "paged_decode_int8", "paged_decode_writeback", "paged_decode_writeback_int8"]
    # the three f32 instances, on the tensor cores by the 3xTF32 split, on
    # flash_tf32.cuh (which includes hopper.cuh); no SIMT f32 header is left
    including = [n for n in KERNELS if '#include "flash_tf32.cuh"' in (_build.CSRC / f"{n}.cu").read_text()]
    assert including == ["flash_bwd_dkv_f32", "flash_bwd_dq_f32", "flash_fwd_f32"]
    assert '#include "hopper.cuh"' in (_build.CSRC / "flash_tf32.cuh").read_text()


def test_an_unchanged_tree_keeps_its_paths(csrc):
    assert _paths() == _paths()
    assert all(p.parent == _build.BUILD_DIR for p in _paths().values())


def test_a_header_edit_changes_every_library_path(csrc):
    before = _paths()
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _paths()
    assert all(after[n] != before[n] for n in KERNELS)


def test_a_new_header_changes_every_library_path(csrc):
    before = _paths()
    (csrc / "extra.cuh").write_text("#pragma once\n")
    after = _paths()
    assert all(after[n] != before[n] for n in KERNELS)


@pytest.mark.parametrize("edited", KERNELS)
def test_a_source_edit_changes_only_its_own_path(csrc, edited):
    before = _paths()
    src = csrc / f"{edited}.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = _paths()
    assert [n for n in KERNELS if after[n] != before[n]] == [edited]
