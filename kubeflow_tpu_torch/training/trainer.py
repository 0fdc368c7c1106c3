"""The training loop: what a JAXJob worker process runs.

Counterpart of ``kubeflow_tpu/training/trainer.py``: registry model +
optimizer config + data + checkpoints, on one device.  ``TrainerConfig``
has the reference's fields and ``Trainer.run()`` returns its summary keys
(``final_loss``, ``steps``, ``start_step``, ``samples_per_sec``, and
``already_complete`` when a resumed run has nothing left to do).  The
loop reads the loss back only every ``log_every`` steps (the sync point),
keeps ``history``, saves and resumes checkpoints and honours
``fault_kill_at_step``.

Refused by name until the multi-device slice: ``fsdp``, ``tp`` or ``sp``
above 1 (and ``dp`` above 1), elastic membership (``membership_file``,
``worker_index``) and multi-process gangs (``parallel/distributed.py``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable

from kubeflow_tpu_torch.utils.logging import get_logger


@dataclasses.dataclass
class TrainerConfig:
    model: str = "mnist_mlp"                      # registry key
    model_config: dict = dataclasses.field(default_factory=dict)
    optimizer: dict = dataclasses.field(default_factory=dict)
    global_batch: int = 32
    steps: int = 100
    log_every: int = 10
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0                     # 0 = only at end
    resume: bool = True
    seed: int = 0
    # mesh axes (one device: dp -1 or 1, the rest 1)
    dp: int = -1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    grad_accum: int = 1
    data_path: str | None = None                  # .npz; else synthetic
    prefetch: int = 0                             # async input depth
    profile_dir: str | None = None                # torch.profiler window
    profile_steps: int = 5
    # a fresh (non-resumed) run hard-kills itself after this step, to
    # exercise gang restart and checkpoint resume
    fault_kill_at_step: int = 0
    membership_file: str | None = None            # elastic: not ported
    worker_index: int | None = None

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "TrainerConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def _refuse_unported(cfg: TrainerConfig) -> None:
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel.train_step import check_single_device

    check_single_device(dp=cfg.dp, fsdp=cfg.fsdp, tp=cfg.tp, sp=cfg.sp)
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        # each process would train its own copy with no gradient reduction
        raise NotImplementedError(
            f"a process group of {dist.get_world_size()}: multi-process "
            "training waits for the multi-device slice")
    for name in ("membership_file", "worker_index"):
        if getattr(cfg, name) is not None:
            raise NotImplementedError(
                f"{name}: elastic membership waits for the multi-device "
                "slice")
    if cfg.fault_kill_at_step and not (
            cfg.checkpoint_dir and cfg.checkpoint_every and cfg.resume
            and cfg.checkpoint_every <= cfg.fault_kill_at_step
            and cfg.fault_kill_at_step <= cfg.steps):
        # without a committed checkpoint before the kill step every
        # incarnation restarts from 0 and dies again
        raise ValueError(
            "fault_kill_at_step requires resume plus checkpointing "
            "with checkpoint_every <= fault_kill_at_step <= steps")


class Trainer:
    def __init__(self, cfg: TrainerConfig,
                 metrics_hook: Callable[[int, dict], None] | None = None,
                 *, device=None):
        self.cfg = cfg
        self.device = device
        self.log = get_logger("trainer", model=cfg.model)
        self._metrics_hook = metrics_hook
        self.history: list[dict] = []

    def run(self) -> dict:
        """Train to ``cfg.steps``; returns the summary."""
        from kubeflow_tpu_torch.device import resolve
        from kubeflow_tpu_torch.models import registry
        from kubeflow_tpu_torch.parallel import train_step as ts
        from kubeflow_tpu_torch.training.data import (
            DevicePrefetcher, NpzDataset, SyntheticDataset, to_device)
        from kubeflow_tpu_torch.training.optim import make_optimizer
        from kubeflow_tpu_torch.utils.profiler import StepWindowTracer

        cfg = self.cfg
        _refuse_unported(cfg)
        device = resolve(self.device)
        entry = registry.get(cfg.model)
        if entry.forward_loss is None:
            raise NotImplementedError(
                f"model {cfg.model!r} has no training loss in the port yet")
        module = entry.make_model(**cfg.model_config, device=device)
        module.init_weights(cfg.seed)
        tx = make_optimizer(cfg.optimizer)
        state = ts.init_train_state(module, tx)

        start_step = 0
        ckpt = None
        if cfg.checkpoint_dir:
            from kubeflow_tpu_torch.training.checkpoint import (
                CheckpointManager)

            ckpt = CheckpointManager(cfg.checkpoint_dir)
            if cfg.resume and ckpt.latest_step() is not None:
                state = ckpt.restore(state)
                start_step = state.step
                self.log.info("resumed", step=start_step)
                if start_step >= cfg.steps:
                    self.log.info("already complete", step=start_step)
                    ckpt.close()
                    return {"final_loss": None, "steps": cfg.steps,
                            "samples_per_sec": 0.0, "start_step": start_step,
                            "already_complete": True}

        def forward(model, batch):
            return entry.forward_loss(model, batch)

        step_fn = ts.build_train_step(forward, tx, grad_accum=cfg.grad_accum)
        if cfg.data_path:
            host = NpzDataset(cfg.data_path, cfg.global_batch,
                              seed=cfg.seed).iter_from(start_step)
        else:
            host = SyntheticDataset(cfg.model, module, cfg.global_batch,
                                    seed=cfg.seed).iter_from(start_step)

        def put(batch):
            return to_device(batch, device)

        batches = (DevicePrefetcher(host, put, depth=cfg.prefetch)
                   if cfg.prefetch > 0 else map(put, host))
        # a bounded trace window; step start+1 onward skips the warm-up
        tracer = StepWindowTracer(cfg.profile_dir, start_step=start_step + 1,
                                  num_steps=cfg.profile_steps)
        t0 = time.perf_counter()
        metrics: dict = {}
        try:
            for step in range(start_step, cfg.steps):
                tracer.on_step(step)
                state, metrics = step_fn(state, next(batches))
                if (step + 1) % cfg.log_every == 0 or step + 1 == cfg.steps:
                    loss = float(metrics["loss"])  # sync point
                    done = step + 1 - start_step
                    rec = {"step": step + 1, "loss": loss,
                           "samples_per_sec": cfg.global_batch * done
                           / (time.perf_counter() - t0)}
                    self.history.append(rec)
                    self.log.info("train", **rec)
                    if self._metrics_hook:
                        self._metrics_hook(step + 1, rec)
                if (ckpt and cfg.checkpoint_every
                        and (step + 1) % cfg.checkpoint_every == 0):
                    ckpt.save(step + 1, state)
                if (cfg.fault_kill_at_step and start_step == 0
                        and step + 1 == cfg.fault_kill_at_step):
                    # simulated preemption: die the way SIGKILL would (no
                    # cleanup, no final save)
                    self.log.info("fault injection: killing process",
                                  step=step + 1)
                    os._exit(17)
        finally:
            tracer.close()
            if isinstance(batches, DevicePrefetcher):
                batches.close()
        if ckpt:
            ckpt.save(cfg.steps, state, wait=True)
            ckpt.close()
        return {
            "final_loss": float(metrics["loss"]) if metrics else None,
            "steps": cfg.steps,
            "start_step": start_step,
            "samples_per_sec": (self.history[-1]["samples_per_sec"]
                                if self.history else 0.0),
        }

