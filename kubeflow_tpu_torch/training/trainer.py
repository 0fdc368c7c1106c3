"""The training loop: what a JAXJob worker process runs.

Counterpart of ``kubeflow_tpu/training/trainer.py``: registry model +
optimizer config + data + checkpoints, on one device per process.
``TrainerConfig`` has the reference's fields and ``Trainer.run()`` returns
its summary keys (``final_loss``, ``steps``, ``start_step``,
``samples_per_sec``; ``already_complete`` when a resumed run has nothing
left to do; ``resizes`` under a membership, and ``resigned`` for a worker
shrunk out of it).  The loop reads the loss back only every ``log_every``
steps (the sync point), keeps ``history``, saves and resumes checkpoints
and honours ``fault_kill_at_step``.

Rank and world come from the process group that
``parallel/distributed.initialize_from_env`` joined (a gang trains one
model data-parallel: every rank reads its rows of each global batch and
the step sums gradients over the gang), or from an elastic membership
(``membership_file`` / ``worker_index``, or a ``membership`` source).
Under a membership an epoch change at a step boundary runs the resize
barrier: the full state and a ``ResizeCheckpoint`` record are saved, the
data shard is re-keyed for the new world at that step, and a worker
shrunk out resigns.  The reference keeps one process world across a
resize and defines no re-formed group, so an epoch change inside a
process group of more than one rank is refused by name.

The mesh is built from ``dp``, ``fsdp``, ``tp`` and ``sp`` over the
gang (``parallel/mesh.make_mesh``).  With fsdp or tp above 1 the model
is split over it (``parallel/sharding.shard_model``) before the
optimizer's ``init``; the data axes (dp x fsdp) index the batch shards,
so the ranks of one tp or sp group read the same rows; checkpoints hold
whole tensors, whatever the layout.  With sp above 1 the step cuts each
row's sequence into the sp ranks' chunks and runs forward and backward
under ``ring_context`` (ring attention over the sp group: what the
reference's Trainer turns on for sp > 1), since only the step knows
where it cut.  A MoE registry model trains under every one of these
axes (the step routes with the global batch's capacity, positions and
aux, its experts' columns split over tp; the reference's Trainer has no
ep axis, and neither has this one), with every optimizer, lamb
included.  Refused by name: an elastic membership under fsdp, tp or sp
above 1 (a resize would re-shard the weights or the sequence; the
reference defines none).
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
    # mesh axes: dp is the gang's size (-1: every rank); the rest 1
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
    # elastic gangs: a JSON membership file ({"epoch": E, "members": [..]})
    # polled at every step boundary; worker_index is this worker's index
    # in it (default: the JAXJOB_MEMBER_INDEX env)
    membership_file: str | None = None
    worker_index: int | None = None

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "TrainerConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def _check_config(cfg: TrainerConfig, world: int, elastic: bool) -> None:
    from kubeflow_tpu_torch.parallel.train_step import check_mesh

    check_mesh(world=world, dp=cfg.dp, fsdp=cfg.fsdp, tp=cfg.tp, sp=cfg.sp)
    if elastic and (cfg.fsdp > 1 or cfg.tp > 1 or cfg.sp > 1):
        raise NotImplementedError(
            f"an elastic membership under fsdp={cfg.fsdp}, tp={cfg.tp}, "
            f"sp={cfg.sp}: a resize would re-shard the weights or the "
            "sequence, and the reference defines no resize of a sharded "
            "mesh")
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
                 membership=None, *, device=None):
        self.cfg = cfg
        self.device = device
        self.log = get_logger("trainer", model=cfg.model)
        self._metrics_hook = metrics_hook
        # membership source (``kubeflow_tpu_torch.elastic``): ``.index``
        # is this worker, ``.current(step)`` a Membership
        if membership is None and cfg.membership_file:
            from kubeflow_tpu_torch.elastic.runtime import FileMembership

            idx = cfg.worker_index
            if idx is None:
                idx = int(os.environ.get("JAXJOB_MEMBER_INDEX", "0"))
            membership = FileMembership(cfg.membership_file, idx)
        self._membership = membership
        self.history: list[dict] = []
        self.resizes: list[dict] = []

    def _rank_world(self, group, mesh) -> tuple[Any, int, int]:
        """(initial membership or None, data rank, data world) with the
        reference's checks: a rank's index on the mesh's data axes, or
        its membership rank."""
        from kubeflow_tpu_torch.parallel import distributed as pd

        cfg = self.cfg
        member = None
        rank, world = mesh.data_index()
        if self._membership is not None:
            # ragged worlds are admitted (shard_rows differ by one row)
            member = self._membership.current(0)
            rank = member.rank_of(self._membership.index)
            if rank is None:
                raise ValueError(
                    f"worker {self._membership.index} is not in the "
                    f"initial membership {member.members}")
            world = member.size
            if world > cfg.global_batch:
                raise ValueError(
                    f"world size {world} exceeds global_batch "
                    f"{cfg.global_batch}: some ranks would own no rows")
            if group is not None and (rank, world) != (
                    pd.rank_of(group), pd.world_size(group)):
                raise ValueError(
                    f"membership rank {rank} of {world} under a process "
                    f"group rank {pd.rank_of(group)} of "
                    f"{pd.world_size(group)}")
        if (member is None or group is not None) and cfg.global_batch % world:
            # a gang's data ranks hold equal shards of the global batch
            raise ValueError(
                f"global_batch {cfg.global_batch} must divide by process "
                f"count {world} (the ranks that hold distinct rows)")
        return member, rank, world

    def run(self) -> dict:
        """Train to ``cfg.steps``; returns the summary."""
        from kubeflow_tpu_torch.device import resolve
        from kubeflow_tpu_torch.elastic.protocol import shard_rows
        from kubeflow_tpu_torch.models import registry
        from kubeflow_tpu_torch.parallel import distributed as pd
        from kubeflow_tpu_torch.parallel import train_step as ts
        from kubeflow_tpu_torch.parallel.mesh import make_mesh
        from kubeflow_tpu_torch.parallel.sharding import shard_model
        from kubeflow_tpu_torch.training.data import (
            DevicePrefetcher, NpzDataset, SyntheticDataset, to_device)
        from kubeflow_tpu_torch.training.optim import make_optimizer
        from kubeflow_tpu_torch.utils.profiler import StepWindowTracer

        cfg = self.cfg
        group = pd.default_group()
        _check_config(cfg, pd.world_size(group),
                      self._membership is not None)
        device = resolve(self.device)
        mesh = make_mesh(pd.world_size(group), dp=cfg.dp, fsdp=cfg.fsdp,
                         tp=cfg.tp, sp=cfg.sp, device_type=device.type)
        member, rank, world = self._rank_world(group, mesh)
        entry = registry.get(cfg.model)
        if entry.forward_loss is None:
            raise NotImplementedError(
                f"model {cfg.model!r} has no training loss in the port yet")
        module = entry.make_model(**cfg.model_config, device=device)
        module.init_weights(cfg.seed)
        if mesh.axis_size("fsdp", "tp") > 1:
            shard_model(module, mesh)
        tx = make_optimizer(cfg.optimizer)
        state = ts.init_train_state(module, tx)

        start_step = 0
        ckpt = None
        if cfg.checkpoint_dir:
            from kubeflow_tpu_torch.training.checkpoint import (
                CheckpointManager)

            ckpt = CheckpointManager(cfg.checkpoint_dir, group=group)
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

        step_fn = ts.build_train_step(
            entry.forward_loss, tx, mesh, grad_accum=cfg.grad_accum,
            loss_weight=entry.loss_weight,
            sequence_keys=entry.sequence_keys)
        if cfg.data_path:
            dataset = NpzDataset(cfg.data_path, cfg.global_batch,
                                 seed=cfg.seed, process_index=rank,
                                 process_count=world)
        else:
            dataset = SyntheticDataset(
                cfg.model, module,
                len(shard_rows(cfg.global_batch, rank, world)),
                seed=cfg.seed, process_index=rank)

        def put(batch):
            return to_device(batch, device)

        def make_batches(step0: int, rank: int, world: int):
            """The input pipeline for (rank, world) from global step
            ``step0``: a resume continues the schedule, a resize
            re-partitions it, so no batch is replayed or skipped."""
            if isinstance(dataset, NpzDataset):
                it = dataset.iter_from(step0, rank=rank, world=world)
            else:
                it = dataset.iter_from(
                    step0, rank=rank,
                    rows=len(shard_rows(cfg.global_batch, rank, world)))
            if cfg.prefetch > 0:
                return DevicePrefetcher(it, put, depth=cfg.prefetch)
            return map(put, it)

        rckpt = None
        if self._membership is not None and cfg.checkpoint_dir:
            from kubeflow_tpu_torch.elastic import ResizeCheckpoint

            rckpt = ResizeCheckpoint(cfg.checkpoint_dir)

        # a bounded trace window; step start+1 onward skips the warm-up
        tracer = StepWindowTracer(cfg.profile_dir, start_step=start_step + 1,
                                  num_steps=cfg.profile_steps)
        batches = make_batches(start_step, rank, world)
        t0 = time.perf_counter()
        metrics: dict = {}
        try:
            for step in range(start_step, cfg.steps):
                if self._membership is not None:
                    latest = self._membership.current(step)
                    if latest.epoch != member.epoch:
                        if group is not None:
                            raise NotImplementedError(
                                f"membership epoch {member.epoch} -> "
                                f"{latest.epoch} inside a process group of "
                                f"{world} ranks: the reference defines no "
                                "re-formed group across a resize")
                        out = self._resize(latest, step, state, ckpt, rckpt)
                        if out is not None:
                            if ckpt is not None:
                                ckpt.close()
                            return out
                        member = latest
                        rank = member.rank_of(self._membership.index)
                        world = member.size
                        if isinstance(batches, DevicePrefetcher):
                            batches.close()
                        batches = make_batches(step, rank, world)
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
                    # cleanup, no final save); a gang's survivors raise in
                    # their next collective
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
        out = {
            "final_loss": float(metrics["loss"]) if metrics else None,
            "steps": cfg.steps,
            "start_step": start_step,
            "samples_per_sec": (self.history[-1]["samples_per_sec"]
                                if self.history else 0.0),
        }
        if self._membership is not None:
            out["resizes"] = len(self.resizes)
        return out

    def _resize(self, membership, step: int, state, ckpt, rckpt):
        """The resize barrier's commit half: save the full state and the
        protocol record at the step boundary, then decide this worker's
        fate under the new epoch.  Returns the summary of a worker shrunk
        out of the gang (it resigns cleanly), else None."""
        cfg = self.cfg
        if ckpt is not None and ckpt.latest_step() != step:
            # a joiner admitted at this boundary restores exactly this step
            ckpt.save(step, state, wait=True)
        if rckpt is not None:
            rckpt.save(step=step, epoch=membership.epoch,
                       members=membership.members)
        rank = membership.rank_of(self._membership.index)
        if rank is None:
            self.log.info("shrunk out of the gang; exiting cleanly",
                          step=step, epoch=membership.epoch)
            return {"resigned": True, "steps": cfg.steps,
                    "start_step": step, "final_loss": None,
                    "samples_per_sec": 0.0, "resizes": len(self.resizes)}
        if membership.size > cfg.global_batch:
            raise ValueError(
                f"resized world {membership.size} exceeds global_batch "
                f"{cfg.global_batch}")
        self.resizes.append({"step": step, "epoch": membership.epoch,
                             "world": membership.size, "rank": rank})
        self.log.info("resize", step=step, epoch=membership.epoch,
                      world=membership.size, rank=rank)
        return None
