"""Experiment tracking: local JSONL run logs + optional TensorBoard events.

A copy of ``modal_examples_tpu/utils/tracking.py`` (``RunLogger``, which
``training.Trainer.fit`` uses); it imports nothing of JAX.

The reference tracks runs with wandb (unsloth_finetune.py:294-300) and
TensorBoard over Volumes (hp_sweep_gpt.py:396-436, src/logs_manager.py).
Zero-egress equivalent: a run directory (put it on a Volume) holding
``metrics.jsonl`` (one JSON object per step — greppable, diffable) plus
TensorBoard event files when the tensorboard package is present, so a
hosted TB (wsgi pattern, §5.5) renders the same curves.
"""

from __future__ import annotations

import json
import time
from pathlib import Path


class RunLogger:
    def __init__(self, run_dir: str | Path, *, volume=None, tensorboard: bool = True):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.volume = volume
        self._jsonl = open(self.run_dir / "metrics.jsonl", "a")
        self._tb = None
        if tensorboard:
            try:
                from tensorboard.summary.writer.event_file_writer import (
                    EventFileWriter,
                )
                from tensorboard.compat.proto.summary_pb2 import Summary
                from tensorboard.compat.proto.event_pb2 import Event

                self._tb = EventFileWriter(str(self.run_dir))
                self._Summary = Summary
                self._Event = Event
            except Exception:
                self._tb = None

    def log(self, step: int, metrics: dict) -> None:
        record = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = str(v)
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            summary = self._Summary(
                value=[
                    self._Summary.Value(tag=k, simple_value=float(v))
                    for k, v in record.items()
                    if k not in ("step", "time") and isinstance(v, float)
                ]
            )
            self._tb.add_event(
                self._Event(step=step, wall_time=record["time"], summary=summary)
            )

    def history(self) -> list[dict]:
        path = self.run_dir / "metrics.jsonl"
        if not path.exists():
            return []
        return [json.loads(line) for line in path.read_text().splitlines() if line]

    def close(self) -> None:
        """Release the JSONL handle and TB writer, then commit the Volume.
        Idempotent: Trainer.fit and an outer ``with`` block may both close."""
        if getattr(self, "_closed", False):
            return
        self._closed = True
        self._jsonl.close()
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()
        if self.volume is not None:
            self.volume.commit()

    def __enter__(self) -> "RunLogger":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
