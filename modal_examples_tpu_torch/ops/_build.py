"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles, with one
``nvcc`` process of its own, into ``build/kernels/lib<name>-<hash>.so`` at the
repository root (``build/`` is git-ignored). The hash covers the source, the
shared headers ``csrc/*.cuh`` and the flags, so an edited source or header
rebuilds and an unchanged one loads as it is.
:func:`build` starts every missing library's ``nvcc`` at once and waits for
all of them. A failed build raises; nothing falls back. Every lookup counts
in ``mtpu_compiles_total{program,cache}``, and every nvcc run appends a
``begin`` and an ``end`` record (its seconds) to the ``compiles`` journal
under the state directory: the port's compile ledger, which the CLI's
``profile`` reads.

Calling convention of every entry point: pointers and the CUDA stream are
``c_void_p`` (a Python int would be cut to 32 bits otherwise), and the entry
returns ``cudaGetLastError()`` after its launch, which :func:`check` turns
into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: the sources this process compiled (a container that finds its checkout's
#: libraries built compiles none)
compiled: list[str] = []


def kernel_names() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels build from csrc/ at first use"
        )
    return path


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of that source, every
    shared header ``csrc/*.cuh`` (any source may include one) and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: list[str] | None = None, *, verbose: bool = False) -> dict[str, str]:
    """Compile every library in ``names`` (default: all sources) that is not
    built yet, one ``nvcc`` per source, all started together. Returns the
    compiler output per newly built source (``-Xptxas -v`` register and
    shared-memory report when ``verbose``)."""
    names = kernel_names() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = [*NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ())]
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            out,
        )
    for name in names:
        if name not in procs:
            _ledger(name, "hit")
    started = time.monotonic()
    for name in procs:
        _ledger(name, "begin")
    logs, errors = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}.cu: nvcc exit {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
            logs[name] = log
            compiled.append(name)
            _ledger(name, "end", time.monotonic() - started)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return logs


def _ledger(name: str, event: str, seconds: float = 0.0) -> None:
    """One kernel-library lookup into the metrics and, for an nvcc run, its
    ``begin``/``end`` record into the compile ledger (best effort: a state
    directory that refuses writes costs the record, never the build)."""
    from ..observability import metrics as _obs
    from ..observability.journal import named_journal

    try:
        if event != "begin":
            _obs.record_compile(name, seconds, cache_hit=event == "hit")
        if event == "hit":
            return
        rec = {"at": time.time(), "event": event, "replica": f"pid-{os.getpid()}",
               "program": name, "shape_key": library_path(name).stem.rsplit("-", 1)[-1]}
        if event == "end":
            rec.update(seconds=round(float(seconds), 6), cache="miss")
        named_journal("compiles").record(rec)
    except Exception:
        pass


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            err_fn = getattr(lib, f"{name}_error_string")
            err_fn.argtypes = [ctypes.c_int]
            err_fn.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


_tickets: dict = {}


def ticket_buffer(owner: str, device, n: int):
    """Ticket scratch of ``owner``'s kernels (at least ``n`` int32) on the
    current stream: zeroed once per (owner, device, stream); every launch
    leaves it zero again (the last block of a group resets its ticket)."""
    import torch

    key = (owner, device, torch.cuda.current_stream(device).cuda_stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = _tickets[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return buf
