"""The port's configuration, after ``modal_examples_tpu/_internal/config.py``:
the state directory, the execution backend and the container's task id.

Request traces (``observability/trace.py``), the journals
(``observability/journal.py``), the deploy registry, volumes, secrets and
spawned-call results live under :func:`state_dir`: ``MTPU_STATE_DIR`` when
set, else ``~/.mtpu_torch``. The default is not the JAX package's ``~/.mtpu``,
so the two packages' registries and volumes never mix unless a caller points
both at one directory.
"""

from __future__ import annotations

import os
from pathlib import Path

#: Execution backend for ``.remote``-family calls.
#:   "process" — containers are supervised worker processes (default).
#:   "inline"  — run in the caller's process with a serialization round-trip
#:               (the caller keeps the card; also for debugging).
BACKEND_ENV = "MTPU_BACKEND"

#: root of the state directory
STATE_DIR_ENV = "MTPU_STATE_DIR"

#: Set inside containers so user code can detect remote execution
#: (reference analog: ``MODAL_TASK_ID``, simple_torch_cluster.py:111).
TASK_ID_ENV = "MTPU_TASK_ID"


def backend() -> str:
    return os.environ.get(BACKEND_ENV, "process")


def state_dir() -> Path:
    root = os.environ.get(STATE_DIR_ENV)
    p = Path(root) if root else Path.home() / ".mtpu_torch"
    p.mkdir(parents=True, exist_ok=True)
    return p


def in_container() -> bool:
    return TASK_ID_ENV in os.environ


def task_id() -> str | None:
    return os.environ.get(TASK_ID_ENV)
