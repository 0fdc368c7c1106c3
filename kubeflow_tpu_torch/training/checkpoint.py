"""Checkpoint and resume of a training state, on ``torch.save``.

Counterpart of ``kubeflow_tpu/training/checkpoint.py`` (orbax there).
Each save writes ``<dir>/ckpt-<step>.pt`` (the step, the model's
``state_dict`` and the optimizer's) to a temporary file and renames it
into place, so a crash mid-save never leaves a checkpoint that
``latest_step`` would pick.  The oldest files beyond ``max_to_keep`` are
deleted.  Saves are synchronous (``wait`` is accepted for the reference's
API).  Orbax checkpoints of the JAX package are not read.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import torch

_NAME = re.compile(r"^ckpt-(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = Path(directory).resolve()
        self._dir.mkdir(parents=True, exist_ok=True)
        self._keep = max_to_keep

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for p in self._dir.iterdir()
                      if (m := _NAME.match(p.name)))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, *, wait: bool = False) -> None:
        """Write ``state`` (a ``TrainState``) as step ``step``."""
        path = self._dir / f"ckpt-{step}.pt"
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        torch.save({"step": step, "model": state.model.state_dict(),
                    "optimizer": state.tx.state_dict()}, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self._keep]:
            (self._dir / f"ckpt-{old}.pt").unlink(missing_ok=True)

    def restore(self, state, step: int | None = None):
        """Load step ``step`` (default: the latest) into ``state``'s model
        and optimizer, on their device; returns the state at that step."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self._dir}")
        blob = torch.load(self._dir / f"ckpt-{step}.pt",
                          map_location=next(state.model.parameters()).device,
                          weights_only=True)
        state.model.load_state_dict(blob["model"])
        state.tx.load_state_dict(blob["optimizer"])
        state.step = int(blob["step"])
        return state

    def close(self) -> None:
        """Nothing is in flight: saves are synchronous."""
