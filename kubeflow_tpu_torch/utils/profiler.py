"""A bounded window of training steps traced with ``torch.profiler``.

Counterpart of ``kubeflow_tpu/utils/profiler.py::StepWindowTracer`` (over
``jax.profiler`` there).  The Trainer calls ``on_step(step)`` at the top
of each iteration and ``close()`` after the loop; the window covers
``num_steps`` steps from ``start_step`` and is written once, as a Chrome
trace (``trace.json``, readable by Perfetto or TensorBoard's profile
plugin), into ``directory``.  A replayed step after a resume never opens
a second window.
"""

from __future__ import annotations

import os

from kubeflow_tpu_torch.utils.logging import get_logger

log = get_logger("profiler")


class StepWindowTracer:
    def __init__(self, directory: str | None, start_step: int,
                 num_steps: int = 5):
        self.directory = directory
        self.start = start_step
        self.stop_at = start_step + num_steps
        self._prof = None
        self._active = False
        self._done = False

    def _profiler(self):
        if self._prof is None:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
        return self._prof

    def on_step(self, step: int) -> None:
        if not self.directory:
            return
        if step == self.start and not self._active and not self._done:
            os.makedirs(self.directory, exist_ok=True)
            self._profiler().start()
            self._active = True
            log.info("profiler window start", step=step,
                     directory=self.directory)
        elif step >= self.stop_at and self._active:
            self._write()

    def _write(self) -> None:
        prof = self._profiler()
        prof.stop()
        self._active = False
        self._done = True
        path = os.path.join(self.directory, "trace.json")
        prof.export_chrome_trace(path)
        log.info("profiler window written", path=path)

    def close(self) -> None:
        if self._active:
            self._write()
