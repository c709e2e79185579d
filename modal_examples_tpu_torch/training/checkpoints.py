"""Checkpoint/resume: step-numbered pytree checkpoints on a Volume.

Counterpart of ``modal_examples_tpu/training/checkpoints.py``
(``CheckpointManager``) with ``torch.save``/``torch.load`` in place of
orbax (no byte compatibility with orbax checkpoints). The contract is kept:
directories named ``step_{step:08d}``, ``steps``/``latest_step`` scans,
keep-N pruning, ``volume.commit()`` after a save, and ``restore(target)``
returning ``target``'s structure with each tensor on ``target``'s device and
in its dtype.

A checkpoint holds the flat list of the state's leaves (tensors on the CPU,
ints, floats), so loading it unpickles no class (``weights_only``); the
structure comes from ``target``.
"""

from __future__ import annotations

import os
import re
import shutil
from pathlib import Path
from typing import Any

import torch

from ..utils import tree

_STEP_RE = re.compile(r"^step_(\d+)$")
_FILE = "state.pt"


class CheckpointManager:
    def __init__(
        self,
        directory: str | Path,
        *,
        keep_n: int = 3,
        volume=None,  # Volume-like: committed after save
    ):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n
        self.volume = volume

    def _step_dir(self, step: int) -> Path:
        return self.directory / f"step_{step:08d}"

    def steps(self) -> list[int]:
        out = []
        for p in self.directory.iterdir():
            m = _STEP_RE.match(p.name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> Path:
        """Write ``state`` as ``step_{step:08d}`` (written under a temporary
        name and renamed, so a scan never sees half a checkpoint)."""
        path = self._step_dir(step)
        tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        flat = [x.detach().cpu() if isinstance(x, torch.Tensor) else x for x in tree.leaves(state)]
        torch.save(flat, tmp / _FILE)
        if path.exists():
            shutil.rmtree(path)
        os.replace(tmp, path)
        self._prune()
        if self.volume is not None:
            self.volume.commit()
        return path

    def restore(self, target: Any, step: int | None = None) -> Any:
        """Restore into the structure, devices and dtypes of ``target``;
        defaults to the latest step."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        flat = torch.load(self._step_dir(step) / _FILE, map_location="cpu", weights_only=True)
        saved = tree.unflatten(target, flat)

        def place(t, s):
            if isinstance(t, torch.Tensor):
                if not isinstance(s, torch.Tensor) or s.shape != t.shape:
                    raise ValueError(f"checkpoint leaf {getattr(s, 'shape', s)} does not fit target {tuple(t.shape)}")
                return s.to(device=t.device, dtype=t.dtype)
            return s

        return tree.map(place, target, saved)

    def _prune(self) -> None:
        steps = self.steps()
        for old in steps[: -self.keep_n] if self.keep_n > 0 else []:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)
