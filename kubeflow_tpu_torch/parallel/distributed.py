"""Process rendezvous from the JAXJob controller's env, and the gang's
collectives.

Counterpart of ``kubeflow_tpu/parallel/distributed.py``.  The controller
injects three variables into every worker pod of a gang:

    JAXJOB_COORDINATOR    host:port of process 0
    JAXJOB_NUM_PROCESSES  total processes in the gang
    JAXJOB_PROCESS_ID     this process's rank

``initialize_from_env`` joins that gang with
``torch.distributed.init_process_group`` over ``tcp://<coordinator>``.
The backend follows from the devices, not from a setting: ``nccl`` when
every rank on this host has a CUDA device of its own, ``gloo`` when ranks
share a device (two ranks on one card) or run on the CPU.  Gloo (torch
2.11) takes CUDA tensors in ``all_reduce`` (float32 and bf16),
``broadcast``, ``barrier``, ``all_gather_into_tensor`` and
``reduce_scatter_tensor``: the collectives the port issues.  The group has a
timeout: a gang with a dead member raises instead of waiting in an
all-reduce.

Where the reference leaves gradient and statistics reduction to pjit,
the port issues it here: ``all_reduce_sum`` (gradients, flattened into a
few buckets), ``sum_over_group`` (differentiable, for BatchNorm's
global-batch statistics), ``data_parallel`` (binds the group that
``models/layers.py::BatchNorm`` reduces over while a train step runs,
and under sp the ``SequenceSplit`` the MoE block routes by),
and the sharded layers' differentiable collectives
(``parallel/sharding.py``): ``gather_cast`` (an fsdp block gathered
whole, its gradient reduce-scattered), ``copy_to_group`` and
``reduce_from_group`` (tensor parallelism's f and g, and the MoE
experts' input gradient and chosen outputs over tp and ep) and
``gather_from_group`` (a tp-split activation); and the neighbour
exchange of ring attention and the pipeline, ``ppermute`` (``jax.lax.ppermute`` with a cyclic
shift) and its differentiable form ``permute`` (``_Ppermute``); and
``broadcast_one_to_all`` (rank 0's fixed-shape buffer on every rank of a
group: the multi-host serving front door's prompts, and each serving
gang model's step records on a group of its own).
Gloo's point-to-point refuses a CUDA tensor (its TCP transport writes
from the device pointer: "writev ... Bad address", torch 2.11 on an
H100), so under gloo a CUDA exchange goes through pinned host buffers,
in ``ppermute`` alone; under NCCL the device tensors go as they are.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import os
from typing import Any

import torch

COORDINATOR_ENV = "JAXJOB_COORDINATOR"
NUM_PROCESSES_ENV = "JAXJOB_NUM_PROCESSES"
PROCESS_ID_ENV = "JAXJOB_PROCESS_ID"
# a collective that waits longer than this on a peer raises
GROUP_TIMEOUT_S = 300.0
# gradients are summed in flat buckets of at most this many bytes
BUCKET_BYTES = 128 << 20
_LOCAL_HOSTS = ("127.0.0.1", "localhost", "::1", "[::1]")


def rendezvous_env(coordinator: str, num_processes: int,
                   process_id: int) -> dict[str, str]:
    """The env block the JAXJob controller injects into pod
    ``process_id``."""
    return {
        COORDINATOR_ENV: coordinator,
        NUM_PROCESSES_ENV: str(num_processes),
        PROCESS_ID_ENV: str(process_id),
    }


def local_world(coordinator: str, num_processes: int) -> int:
    """Ranks on this host: every rank when the coordinator is this host
    (a local gang), else one (the JAXJob runs one process per host)."""
    host = coordinator.rsplit(":", 1)[0]
    return num_processes if host in _LOCAL_HOSTS else 1


def backend_for(device: torch.device, ranks_here: int) -> str:
    """``nccl`` when each of this host's ``ranks_here`` ranks has a CUDA
    device of its own, else ``gloo`` (ranks sharing a card, or the CPU)."""
    if device.type == "cuda" and torch.cuda.device_count() >= ranks_here:
        return "nccl"
    return "gloo"


def initialize_from_env(env: dict[str, str] | None = None, *,
                        device=None) -> dict:
    """Join the gang described by the env (a no-op for one process, and
    for a process that already joined it); returns the summary the worker
    logs: coordinator, num_processes, process_id, initialized,
    process_count, local_devices, global_devices and backend.

    ``device`` is the device the worker trains on (``None``: CUDA, which
    must exist); with CUDA it also sets this rank's current card."""
    env = os.environ if env is None else env
    coordinator = env.get(COORDINATOR_ENV)
    num_processes = int(env.get(NUM_PROCESSES_ENV, "1"))
    process_id = int(env.get(PROCESS_ID_ENV, "0"))
    if num_processes <= 1:
        return {"coordinator": None, "num_processes": 1, "process_id": 0,
                "initialized": False, "backend": None}
    if not coordinator:
        # num_processes independent copies would "succeed" with no
        # gradient reduction: refuse
        raise RuntimeError(
            f"{NUM_PROCESSES_ENV}={num_processes} but {COORDINATOR_ENV} "
            "is empty; refusing to train an uncoordinated gang")
    import torch.distributed as dist

    from kubeflow_tpu_torch.device import resolve

    dev = resolve(device)
    here = local_world(coordinator, num_processes)
    backend = backend_for(dev, here)
    if dev.type == "cuda":
        torch.cuda.set_device((process_id % here)
                              % torch.cuda.device_count())
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (num_processes,
                                                        process_id):
            raise RuntimeError(
                f"this process is rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, not {process_id} of "
                f"{num_processes}")
        backend = dist.get_backend()
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}", rank=process_id,
            world_size=num_processes,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return {"coordinator": coordinator, "num_processes": num_processes,
            "process_id": process_id, "initialized": True,
            "process_count": dist.get_world_size(), "local_devices": 1,
            "global_devices": dist.get_world_size(), "backend": backend}


def default_group():
    """The joined gang's group when it has more than one rank, else None
    (the train step then reduces nothing)."""
    import torch.distributed as dist

    if (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return dist.group.WORLD
    return None


def world_size(group) -> int:
    """Ranks in ``group``; 1 for None."""
    if group is None:
        return 1
    import torch.distributed as dist

    return dist.get_world_size(group)


def rank_of(group) -> int:
    """This process's rank in ``group``; 0 for None."""
    if group is None:
        return 0
    import torch.distributed as dist

    return dist.get_rank(group)


def all_reduce_sum(tensors: list[torch.Tensor], group) -> None:
    """Sum every tensor over ``group`` in place.  Consecutive tensors of
    one dtype and device are flattened into buckets of at most
    ``BUCKET_BYTES`` (a larger tensor is a bucket alone), one
    ``all_reduce`` per bucket."""
    import torch.distributed as dist

    buckets: list[list[torch.Tensor]] = []
    size = 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if (not buckets or size + nbytes > BUCKET_BYTES
                or (t.dtype, t.device) != (buckets[-1][0].dtype,
                                           buckets[-1][0].device)):
            buckets.append([])
            size = 0
        buckets[-1].append(t)
        size += nbytes
    for bucket in buckets:
        if len(bucket) == 1 and bucket[0].is_contiguous():
            dist.all_reduce(bucket[0], group=group)
            continue
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


class _SumOverGroup(torch.autograd.Function):
    """``y = sum over ranks of x``; the cotangent of every rank's ``x`` is
    the sum of every rank's cotangent of ``y`` (each rank's loss depends
    on the same ``y``)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def sum_over_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``'s ranks, differentiably."""
    return _SumOverGroup.apply(x, group)


def all_reduce_max(t: torch.Tensor, group) -> None:
    """Elementwise max of ``t`` over ``group``'s ranks, in place."""
    import torch.distributed as dist

    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)


def broadcast_one_to_all(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` as rank 0 of ``group`` (default: the gang) holds it, on every
    rank of it: one ``broadcast`` of a buffer of the same shape and dtype
    on each (the reference's ``multihost_utils.broadcast_one_to_all``);
    ``t`` itself without a gang.  Under NCCL a CPU buffer travels through
    the rank's card and comes back to the host."""
    import torch.distributed as dist

    if group is None:
        group = default_group()
    if group is None:
        return t
    buf = t
    if dist.get_backend(group) == "nccl" and not t.is_cuda:
        buf = t.to(torch.device("cuda", torch.cuda.current_device()))
    buf = buf.contiguous().clone()
    dist.broadcast(buf, group_src=0, group=group)
    return buf.to(t.device)


def all_gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along ``dim`` in
    rank order of ``group`` (one ``all_gather_into_tensor``)."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    flat = x.new_empty((n * x.shape[0],) + x.shape[1:])
    dist.all_gather_into_tensor(flat, x.contiguous(), group=group)
    return flat.view((n,) + x.shape).movedim(0, dim).reshape(
        x.shape[:dim] + (n * x.shape[dim],) + x.shape[dim + 1:])


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x`` summed over ``group``
    (one ``reduce_scatter_tensor``)."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    blocks = x.reshape(x.shape[:dim] + (n, x.shape[dim] // n)
                       + x.shape[dim + 1:]).movedim(dim, 0).contiguous()
    out = blocks.new_empty(blocks.shape[1:])
    dist.reduce_scatter_tensor(out, blocks.flatten(0, 1), group=group)
    return out


class _GatherCast(torch.autograd.Function):
    """``y`` = every rank's block of a parameter, cast to ``dtype`` and
    concatenated along ``dim``; the cotangent of this rank's block is its
    block of every rank's cotangent of ``y``, summed in float32 (the sum
    the unsharded model's gradient is, rounded as a data-parallel
    gang's)."""

    @staticmethod
    def forward(ctx, w, dtype, dim, group):
        ctx.dim, ctx.group, ctx.dtype = dim, group, w.dtype
        return all_gather_cat(w.to(dtype), dim, group)

    @staticmethod
    def backward(ctx, grad):
        g = reduce_scatter_dim(grad.float(), ctx.dim, ctx.group)
        return g.to(ctx.dtype), None, None, None


def gather_cast(w: torch.Tensor, dtype: torch.dtype, dim: int,
                group) -> torch.Tensor:
    """An fsdp-split parameter whole, in ``dtype``, differentiably."""
    return _GatherCast.apply(w, dtype, dim, group)


class _CopyToGroup(torch.autograd.Function):
    """Tensor parallelism's ``f``: the identity on a replicated input of
    rank-local work; its cotangent is summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromGroup(torch.autograd.Function):
    """Tensor parallelism's ``g``: rank-local partial sums summed over the
    group; the (replicated) cotangent passes through."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromGroup(torch.autograd.Function):
    """An activation split along ``dim`` made whole; the cotangent of this
    rank's block is its block of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, group, dim):
        import torch.distributed as dist

        dim %= x.dim()
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.index = dist.get_rank(group)
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group, dim: int = -1
                      ) -> torch.Tensor:
    return _GatherFromGroup.apply(x, group, dim)


def ppermute(tensors: list[torch.Tensor], group,
             shift: int = 1) -> list[torch.Tensor]:
    """Every tensor of ``tensors`` sent to rank ``(i + shift) % n`` of
    ``group`` and replaced by the one rank ``(i - shift) % n`` sent: new
    tensors of the same shapes, dtypes and device.  They travel as one
    flat byte buffer, one send and one receive paired in
    ``batch_isend_irecv`` so that no rank blocks; group ranks are mapped
    to global ranks here, and nowhere else.  Under gloo a CUDA buffer is
    staged through pinned host memory (module docstring)."""
    import torch.distributed as dist

    n, me = world_size(group), rank_of(group)
    if n == 1 or shift % n == 0:
        return [t.clone() for t in tensors]
    # each tensor's bytes start on a 16-byte boundary, so that every
    # received block can be viewed in its own dtype
    pieces = []
    for t in tensors:
        raw = t.reshape(-1).view(torch.uint8)
        pieces += [raw, raw.new_zeros(-raw.numel() % 16)]
    flat = torch.cat(pieces)
    staged = flat.is_cuda and dist.get_backend(group) == "gloo"
    send = flat
    if staged:
        send = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
        send.copy_(flat)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send,
                      dist.get_global_rank(group, (me + shift) % n), group),
           dist.P2POp(dist.irecv, recv,
                      dist.get_global_rank(group, (me - shift) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged:
        recv = recv.to(flat.device, non_blocking=True)
    out, offset = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        out.append(recv[offset:offset + nbytes].view(t.dtype).view(t.shape))
        offset += nbytes + (-nbytes % 16)
    return out


class _Ppermute(torch.autograd.Function):
    """``ppermute`` of one tensor; its cotangent goes back by the reverse
    shift (the transpose of a permutation, as JAX transposes
    ``ppermute``)."""

    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return ppermute([x], group, shift)[0]

    @staticmethod
    def backward(ctx, grad):
        return ppermute([grad], ctx.group, -ctx.shift)[0], None, None


def permute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """``ppermute`` of ``x``, differentiably."""
    return _Ppermute.apply(x, group, shift)


@dataclasses.dataclass(frozen=True)
class SequenceSplit:
    """How a train step cut each row's sequence over sp (bound beside the
    data group): this rank holds chunk ``index`` (its sp coordinate) of
    every one of its rows, ``group`` is its sp group and ``joint`` the
    group over the data axes and sp (``parallel/mesh.JOINT_AXES``)."""

    group: Any
    index: int
    joint: Any


_DATA_PARALLEL = contextvars.ContextVar("kf_data_parallel_group",
                                        default=(None, True, None))


@contextlib.contextmanager
def data_parallel(group, counted: bool = True,
                  sequence: SequenceSplit | None = None):
    """Bind ``group`` as the data-parallel group for the enclosed forward
    and backward (what a train step does under a gang).  ``counted``
    False: the rows are a stand-in that a rank runs only to issue the
    group's collectives (a micro-batch with no rows here), which a model
    must count as no rows (the MoE block's expert counts).  ``sequence``:
    the rows are this rank's chunks of a sequence split over sp (the MoE
    block orders its tokens' routing by it)."""
    token = _DATA_PARALLEL.set((group, counted, sequence))
    try:
        yield
    finally:
        _DATA_PARALLEL.reset(token)


def data_parallel_group():
    """The group bound by ``data_parallel``, or None."""
    return _DATA_PARALLEL.get()[0]


def rows_counted() -> bool:
    """False while ``data_parallel`` binds a stand-in's rows."""
    return _DATA_PARALLEL.get()[1]


def sequence_split() -> SequenceSplit | None:
    """The ``SequenceSplit`` bound by ``data_parallel``, or None."""
    return _DATA_PARALLEL.get()[2]


def data_parallel_state() -> tuple:
    """``(group, counted, sequence)`` as bound now, for re-entering the
    binding on another thread (``ops/attention.recompute_context``)."""
    return _DATA_PARALLEL.get()


def free_port() -> int:
    """A free localhost port for a local gang's coordinator."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# a coordinator port that ``free_port`` handed out can be taken by another
# process before rank 0 listens on it: the gang is spawned again on another
# port, at most this many times in all
_SPAWN_ATTEMPTS = 3


def spawn_local_gang(script: str, num_processes: int, *,
                     port: int | None = None, timeout: float = 180.0,
                     extra_env: dict[str, str] | None = None) -> list[dict]:
    """Run ``script`` (``python -c``) in ``num_processes`` OS processes
    joined by one localhost coordinator (the ``JAXJOB_*`` env of each
    rank).  Each worker prints a JSON object as its last stdout line; the
    parsed objects are returned in rank order.

    The first worker to exit nonzero, or the timeout, ends the gang: the
    survivors are killed before this raises (a half-dead gang would wait
    in its next collective).  Without a given ``port``, a gang whose
    coordinator could not listen on the port it was handed
    (``EADDRINUSE``) runs again on another one."""
    attempts = 1 if port is not None else _SPAWN_ATTEMPTS
    for attempt in range(attempts):
        try:
            return _spawn(script, num_processes,
                          free_port() if port is None else port, timeout,
                          extra_env)
        except RuntimeError as e:
            if "EADDRINUSE" not in str(e) or attempt == attempts - 1:
                raise


def _spawn(script: str, num_processes: int, port: int, timeout: float,
           extra_env: dict[str, str] | None) -> list[dict]:
    import json
    import subprocess
    import sys
    import tempfile
    import time

    procs: list[subprocess.Popen] = []
    files = []
    try:
        for pid in range(num_processes):
            env = dict(os.environ)
            env.update(rendezvous_env(f"127.0.0.1:{port}", num_processes,
                                      pid))
            env.update(extra_env or {})
            out, err = tempfile.TemporaryFile(), tempfile.TemporaryFile()
            files += [out, err]
            procs.append(subprocess.Popen(
                [sys.executable, "-c", script], env=env, stdout=out,
                stderr=err))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            for pid, code in enumerate(codes):
                if code not in (None, 0):
                    err = files[2 * pid + 1]
                    err.seek(0)
                    tail = err.read().decode(errors="replace")[-3000:]
                    raise RuntimeError(
                        f"gang worker {pid} exited {code}:\n{tail}")
            if all(code == 0 for code in codes):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"gang of {num_processes} did not "
                                   f"finish within {timeout}s")
            time.sleep(0.05)
        outs = []
        for pid in range(num_processes):
            out = files[2 * pid]
            out.seek(0)
            lines = out.read().decode().strip().splitlines()
            outs.append(json.loads(lines[-1]))
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
