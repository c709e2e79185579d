"""The port's ``Sandbox`` (``core/sandbox.py``) held against the JAX
package's: the cases of ``tests/test_sandbox_profiling.py::TestSandbox`` on
the port, the scrubbed environment of both packages' sandboxes for the same
image and secrets (the same keys and values but ``HOME``, each sandbox's
own directory), and the exec and sandbox deadlines.
"""

import json
import os
import sys
import time

import pytest

import modal_examples_tpu as jm
import modal_examples_tpu_torch as mtpu
from modal_examples_tpu_torch.core.sandbox import SandboxTimeoutError
from test_torch_time_limit import share_cores, time_limits

share_cores()

#: each test starts a few short processes
_limit_module, _limit_test = time_limits(test_s=60, module_s=120)


class TestSandbox:
    def test_exec_streams_and_exit_codes(self):
        sb = mtpu.Sandbox.create(timeout=60)
        try:
            p = sb.exec(sys.executable, "-c", "print('out'); import sys; print('err', file=sys.stderr)")
            assert p.wait() == 0
            assert p.stdout.read().strip() == "out"
            assert p.stderr.read().strip() == "err"
            bad = sb.exec(sys.executable, "-c", "raise SystemExit(3)")
            assert bad.wait() == 3
        finally:
            sb.cleanup()

    def test_env_scrubbed(self):
        os.environ["SUPER_SECRET_TEST_VAR"] = "leak-me"
        try:
            sb = mtpu.Sandbox.create(timeout=30)
            p = sb.exec(sys.executable, "-c", "import os; print('SUPER_SECRET_TEST_VAR' in os.environ)")
            p.wait()
            assert p.stdout.read().strip() == "False"
            sb.cleanup()
        finally:
            del os.environ["SUPER_SECRET_TEST_VAR"]

    def test_secrets_and_image_env_injected(self):
        img = mtpu.Image.debian_slim().env({"FROM_IMAGE": "yes"})
        sec = mtpu.Secret.from_dict({"FROM_SECRET": "yes"})
        sb = mtpu.Sandbox.create(image=img, secrets=[sec], timeout=30)
        p = sb.exec(sys.executable, "-c", "import os; print(os.environ['FROM_IMAGE'], os.environ['FROM_SECRET'])")
        p.wait()
        assert p.stdout.read().strip() == "yes yes"
        sb.cleanup()

    def test_open_confined_to_sandbox(self):
        sb = mtpu.Sandbox.create(timeout=30)
        with sb.open("notes/x.txt", "w") as f:
            f.write("hi")
        with sb.open("notes/x.txt") as f:
            assert f.read() == "hi"
        with pytest.raises(PermissionError):
            sb.open("../../etc/passwd")
        sb.cleanup()

    def test_volume_mount(self):
        vol = mtpu.Volume.from_name("sb-test-vol", create_if_missing=True)
        vol.write_file("data.txt", b"volume-data")
        sb = mtpu.Sandbox.create(volumes={"/data": vol}, timeout=30)
        p = sb.exec(sys.executable, "-c", "print(open('data/data.txt').read())")
        p.wait()
        assert p.stdout.read().strip() == "volume-data"
        sb.cleanup()

    def test_terminate_kills_processes(self):
        sb = mtpu.Sandbox.create(timeout=60)
        p = sb.exec(sys.executable, "-c", "import time; time.sleep(60)")
        assert sb.poll() is None
        sb.terminate()
        time.sleep(0.3)
        assert p.poll() is not None
        sb.cleanup()

    def test_from_id_and_list(self):
        sb = mtpu.Sandbox.create(timeout=30)
        assert mtpu.Sandbox.from_id(sb.object_id) is sb
        assert sb in mtpu.Sandbox.list()
        sb.cleanup()
        assert sb not in mtpu.Sandbox.list()

    def test_forward_tunnel(self):
        with mtpu.forward(8123) as tunnel:
            assert tunnel.url == "http://127.0.0.1:8123"


ENV_DUMP = "import json, os; print(json.dumps(dict(os.environ)))"


def _sandbox_env(pkg, **create) -> dict:
    sb = pkg.Sandbox.create(timeout=30, **create)
    try:
        p = sb.exec(sys.executable, "-c", ENV_DUMP)
        assert p.wait() == 0
        env = json.loads(p.stdout.read())
        assert env.pop("HOME") == str(sb._dir)
        return env
    finally:
        sb.cleanup()


@pytest.mark.parametrize("case", ["bare", "image_and_secrets"])
def test_environment_equals_the_references(case):
    """Only PATH, HOME and LANG, plus the image's and the secrets' variables,
    reach a sandbox's process, in both packages alike (so no CUDA or
    state-directory variable of the caller leaks in)."""
    create = {}
    if case == "image_and_secrets":
        create = {
            "image": ("env", {"MODEL": "llama", "CUDA_VISIBLE_DEVICES": "0"}),
            "secrets": {"HF_TOKEN": "tok", "MODEL": "from-secret"},
        }

    def build(pkg):
        if not create:
            return {}
        img = pkg.Image.debian_slim().env(create["image"][1])
        return {"image": img, "secrets": [pkg.Secret.from_dict(create["secrets"])]}

    port, ref = _sandbox_env(mtpu, **build(mtpu)), _sandbox_env(jm, **build(jm))
    assert port == ref
    want = {"PATH", "LANG"} | ({"MODEL", "HF_TOKEN", "CUDA_VISIBLE_DEVICES"} if create else set())
    assert set(port) == want
    if create:
        assert port["MODEL"] == "from-secret"  # secrets after the image, as in the reference


def test_exec_timeout_kills_the_process():
    sb = mtpu.Sandbox.create(timeout=60)
    try:
        t0 = time.monotonic()
        p = sb.exec(sys.executable, "-c", "import time; time.sleep(30)", timeout=0.5)
        assert p.wait(timeout=20) != 0
        assert time.monotonic() - t0 < 10
    finally:
        sb.cleanup()


def test_sandbox_deadline_raises_from_wait():
    sb = mtpu.Sandbox.create(timeout=1)
    try:
        p = sb.exec(sys.executable, "-c", "import time; time.sleep(30)")
        with pytest.raises(SandboxTimeoutError):
            p.wait(timeout=20)
        assert sb.wait() == -1 or sb.poll() is not None
    finally:
        sb.cleanup()
