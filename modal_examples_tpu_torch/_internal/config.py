"""The port's state directory, after ``modal_examples_tpu/_internal/config.py``.

Request traces (``observability/trace.py``) and the journals
(``observability/journal.py``) live under :func:`state_dir`:
``MTPU_STATE_DIR`` when set, else ``~/.mtpu_torch``. The default is not the
JAX package's ``~/.mtpu``, so the two packages' traces and journals never
land in one file unless a caller points both at one directory.
"""

from __future__ import annotations

import os
from pathlib import Path

#: root of the state directory (traces, journals)
STATE_DIR_ENV = "MTPU_STATE_DIR"


def state_dir() -> Path:
    root = os.environ.get(STATE_DIR_ENV)
    p = Path(root) if root else Path.home() / ".mtpu_torch"
    p.mkdir(parents=True, exist_ok=True)
    return p
