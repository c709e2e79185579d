"""Copy of ``modal_examples_tpu/utils/log.py``: structured logging for the platform layer.

Platform code under ``core/`` does not ``print()``: diagnostics go
through this logger, so they carry a level, a component name, and machine-readable fields —
and can be silenced or redirected without grepping stdout.

- ``MTPU_LOG_LEVEL`` sets the threshold (default ``INFO``).
- ``MTPU_LOG_JSON=1`` switches to one-JSON-object-per-line output
  (the greppable shape ``utils/tracking.RunLogger`` uses for run metrics).

Structured fields ride on the stdlib ``extra`` mechanism::

    log = get_logger("executor")
    event(log, logging.WARNING, "volume mount failed", path=p, err=str(e))
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

_ROOT_NAME = "mtpu"
_configured = False


class _Formatter(logging.Formatter):
    def __init__(self, json_mode: bool):
        super().__init__()
        self.json_mode = json_mode

    def format(self, record: logging.LogRecord) -> str:
        fields = getattr(record, "fields", None) or {}
        if self.json_mode:
            payload = {
                "ts": round(record.created, 3),
                "level": record.levelname,
                "logger": record.name,
                "msg": record.getMessage(),
                **fields,
            }
            if record.exc_info:
                payload["exc"] = self.formatException(record.exc_info)
            return json.dumps(payload, default=str)
        ts = time.strftime("%H:%M:%S", time.localtime(record.created))
        extras = "".join(f" {k}={v}" for k, v in fields.items())
        out = (
            f"[{ts} {record.levelname.lower()} {record.name}] "
            f"{record.getMessage()}{extras}"
        )
        if record.exc_info:
            out += "\n" + self.formatException(record.exc_info)
        return out


def _configure() -> None:
    global _configured
    if _configured:
        return
    _configured = True
    root = logging.getLogger(_ROOT_NAME)
    if root.handlers:
        return  # the embedding app already configured it; respect that
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        _Formatter(os.environ.get("MTPU_LOG_JSON", "") not in ("", "0"))
    )
    root.addHandler(handler)
    level = os.environ.get("MTPU_LOG_LEVEL", "INFO").upper()
    root.setLevel(getattr(logging, level, logging.INFO))
    root.propagate = False


def get_logger(name: str = "") -> logging.Logger:
    """Component logger under the ``mtpu`` hierarchy (``get_logger("executor")``
    -> ``mtpu.executor``)."""
    _configure()
    return logging.getLogger(f"{_ROOT_NAME}.{name}" if name else _ROOT_NAME)


def event(logger: logging.Logger, level: int, msg: str, **fields) -> None:
    """Log ``msg`` with structured ``fields`` (rendered as ``k=v`` pairs, or
    merged into the JSON object under ``MTPU_LOG_JSON=1``)."""
    logger.log(level, msg, extra={"fields": fields})
