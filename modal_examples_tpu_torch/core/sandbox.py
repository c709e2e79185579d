"""Copy of ``modal_examples_tpu/core/sandbox.py``: Sandbox, dynamically
created containers for untrusted code.

Reference spec (SURVEY.md §2.1): ``Sandbox.create(app=, image=, volumes=,
timeout=)`` (13_sandboxes/safe_code_execution.py:28), ``sandbox.exec(...)``
with streamed stdout/stderr and ``.wait()`` (:37-41), agent-driven use
(sandbox_agent.py:29-62), warm pools coordinated through Queues
(sandbox_pool.py:6-30), ``modal.forward`` tunnels
(11_notebooks/jupyter_inside_modal.py:9).

Local control plane: a sandbox is an isolated working directory + scrubbed
environment; ``exec`` spawns OS processes inside it with piped stdio, a
sandbox-wide deadline reaper, and volume mounts materialized as symlinks.
(The platform backend would run these under gvisor/runc — per-example
``runtimes`` frontmatter in the reference, internal/utils.py:133; the
process API is identical.)

The scrubbed environment passes no ``CUDA_VISIBLE_DEVICES``: a sandbox's
processes see every card of the host, as any process started with an empty
environment does. An image or secret that sets the variable narrows them
(``CUDA_VISIBLE_DEVICES=""`` hides every card), and ``Sandbox.create`` takes
no ``gpu=``, as the reference's takes no accelerator argument.
"""

from __future__ import annotations

import os
import shutil
import signal
import subprocess
import threading
import time
import uuid
from pathlib import Path

from .._internal import config as _config


class SandboxTimeoutError(TimeoutError):
    pass


class ContainerProcess:
    """Handle for one exec'd process: streamed stdio + wait/kill."""

    def __init__(self, proc: subprocess.Popen, sandbox: "Sandbox"):
        self._proc = proc
        self._sandbox = sandbox
        self.stdout = proc.stdout
        self.stderr = proc.stderr
        self.stdin = proc.stdin

    @property
    def returncode(self) -> int | None:
        return self._proc.returncode

    def poll(self) -> int | None:
        return self._proc.poll()

    def wait(self, timeout: float | None = None) -> int:
        remaining = self._sandbox._remaining()
        if timeout is None or (remaining is not None and remaining < timeout):
            timeout = remaining
        try:
            return self._proc.wait(timeout)
        except subprocess.TimeoutExpired:
            raise SandboxTimeoutError(
                f"process exceeded sandbox deadline in {self._sandbox.object_id}"
            ) from None

    def kill(self) -> None:
        try:
            self._proc.kill()
        except ProcessLookupError:
            pass


class Tunnel:
    """Forwarded-port handle (modal.forward analog). Locally ports are
    already reachable; the platform backend would allocate a public host."""

    def __init__(self, port: int):
        self.port = port
        self.url = f"http://127.0.0.1:{port}"
        self.tls_socket = ("127.0.0.1", port)


class Sandbox:
    def __init__(self, sandbox_dir: Path, env: dict[str, str], timeout: float):
        self.object_id = f"sb-{uuid.uuid4().hex[:12]}"
        self._dir = sandbox_dir
        self._env = env
        self._deadline = time.monotonic() + timeout if timeout else None
        self._procs: list[subprocess.Popen] = []
        self._lock = threading.Lock()
        self._terminated = False
        self._tags: dict[str, str] = {}
        _live_sandboxes[self.object_id] = self
        self._timeout_timer: threading.Timer | None = None
        if timeout:
            # daemon + cancelled on terminate: a live timer must not pin the
            # interpreter open for the full sandbox timeout after the user is
            # done with the sandbox
            self._timeout_timer = threading.Timer(timeout, self.terminate)
            self._timeout_timer.daemon = True
            self._timeout_timer.start()

    # -- creation -----------------------------------------------------------

    @classmethod
    def create(
        cls,
        *entrypoint_args: str,
        app=None,
        image=None,
        volumes: dict | None = None,
        secrets: list | None = None,
        timeout: float = 300,
        workdir: str | None = None,
        cpu: float | None = None,
        memory: int | None = None,
        unencrypted_ports: list[int] | None = None,
        encrypted_ports: list[int] | None = None,
    ) -> "Sandbox":
        root = _config.state_dir() / "sandboxes"
        root.mkdir(parents=True, exist_ok=True)
        sb_dir = root / f"sb-{uuid.uuid4().hex[:12]}"
        sb_dir.mkdir()
        # scrubbed environment: image/secrets env only + a minimal base —
        # untrusted code must not inherit the control plane's environment
        env = {
            "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
            "HOME": str(sb_dir),
            "LANG": os.environ.get("LANG", "C.UTF-8"),
        }
        if image is not None:
            env.update(image.env_vars())
        for s in secrets or []:
            env.update(s.env_vars())
        for mount_path, vol in (volumes or {}).items():
            target = sb_dir / mount_path.lstrip("/")
            target.parent.mkdir(parents=True, exist_ok=True)
            if not target.exists():
                target.symlink_to(vol.local_path)
        sb = cls(sb_dir, env, timeout)
        sb._volumes = dict(volumes or {})
        if workdir:
            (sb_dir / workdir.lstrip("/")).mkdir(parents=True, exist_ok=True)
            sb._workdir = str(sb_dir / workdir.lstrip("/"))
        else:
            sb._workdir = str(sb_dir)
        if entrypoint_args:
            sb.exec(*entrypoint_args)
        return sb

    @classmethod
    def from_id(cls, object_id: str) -> "Sandbox":
        try:
            return _live_sandboxes[object_id]
        except KeyError:
            raise KeyError(f"sandbox {object_id!r} not found in this process") from None

    @staticmethod
    def list() -> list["Sandbox"]:
        return [s for s in _live_sandboxes.values() if not s._terminated]

    # -- execution ----------------------------------------------------------

    def _remaining(self) -> float | None:
        if self._deadline is None:
            return None
        return max(0.0, self._deadline - time.monotonic())

    def exec(
        self,
        *cmd: str,
        workdir: str | None = None,
        timeout: float | None = None,
        text: bool = True,
        pty_info=None,
    ) -> ContainerProcess:
        if self._terminated:
            raise RuntimeError(f"sandbox {self.object_id} is terminated")
        proc = subprocess.Popen(
            list(cmd),
            cwd=workdir or self._workdir,
            env=self._env,
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=text,
            start_new_session=True,  # its own process group for clean kills
        )
        with self._lock:
            self._procs.append(proc)
        if timeout:
            t = threading.Timer(
                timeout, lambda: proc.poll() is None and proc.kill()
            )
            t.daemon = True
            t.start()
        return ContainerProcess(proc, self)

    # -- filesystem ---------------------------------------------------------

    def open(self, path: str, mode: str = "r"):
        p = (Path(self._workdir) / path.lstrip("/")).resolve()
        root = self._dir.resolve()
        # proper containment check (str.startswith lets /tmp/sb-abcd pass a
        # /tmp/sb-abc root); volume mounts resolve outside the sandbox dir
        # via symlinks and are legitimate targets
        allowed = [root] + [
            Path(v.local_path).resolve()
            for v in getattr(self, "_volumes", {}).values()
            if hasattr(v, "local_path")
        ]
        if not any(p == a or p.is_relative_to(a) for a in allowed):
            raise PermissionError(f"path escapes sandbox: {path}")
        p.parent.mkdir(parents=True, exist_ok=True)
        return open(p, mode)

    @property
    def workdir(self) -> str:
        return self._workdir

    # -- lifecycle ----------------------------------------------------------

    def poll(self) -> int | None:
        """None while any process runs; else last exit code."""
        with self._lock:
            procs = list(self._procs)
        codes = [p.poll() for p in procs]
        if any(c is None for c in codes):
            return None
        return codes[-1] if codes else 0

    def wait(self, raise_on_termination: bool = False) -> int:
        while True:
            code = self.poll()
            if code is not None:
                return code
            if self._remaining() == 0.0:
                self.terminate()
                if raise_on_termination:
                    raise SandboxTimeoutError(self.object_id)
                return -1
            time.sleep(0.05)

    def terminate(self) -> None:
        if self._timeout_timer is not None:
            self._timeout_timer.cancel()
        with self._lock:
            self._terminated = True
            procs = list(self._procs)
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(os.getpgid(p.pid), signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    p.kill()

    def cleanup(self, remove_dir: bool = True) -> None:
        self.terminate()
        _live_sandboxes.pop(self.object_id, None)
        if remove_dir:
            shutil.rmtree(self._dir, ignore_errors=True)

    def set_tags(self, tags: dict[str, str]) -> None:
        self._tags.update(tags)

    @property
    def tags(self) -> dict[str, str]:
        return dict(self._tags)

    def tunnels(self) -> dict[int, Tunnel]:
        return dict(self._tunnels) if hasattr(self, "_tunnels") else {}


_live_sandboxes: dict[str, Sandbox] = {}


class forward:
    """``with mtpu.forward(port) as tunnel: tunnel.url`` — port tunnel
    context (jupyter_inside_modal.py:9). Local backend: the port is already
    reachable on localhost."""

    def __init__(self, port: int, unencrypted: bool = False):
        self.port = port

    def __enter__(self) -> Tunnel:
        return Tunnel(self.port)

    def __exit__(self, *exc):
        return False
