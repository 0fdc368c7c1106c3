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
share a device (two ranks on one card) or run on the CPU.  Gloo takes
CUDA tensors for ``all_reduce``, ``broadcast`` and ``barrier`` only, so
those three are the only collectives the port issues.  The group has a
timeout: a gang with a dead member raises instead of waiting in an
all-reduce.

Where the reference leaves gradient and statistics reduction to pjit,
the port issues it here: ``all_reduce_sum`` (gradients, flattened into a
few buckets), ``sum_over_group`` (differentiable, for BatchNorm's
global-batch statistics) and ``data_parallel`` (binds the group that
``models/layers.py::BatchNorm`` reduces over while a train step runs).
"""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import os

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


_DATA_PARALLEL = contextvars.ContextVar("kf_data_parallel_group",
                                        default=None)


@contextlib.contextmanager
def data_parallel(group):
    """Bind ``group`` as the data-parallel group for the enclosed forward
    and backward (what a train step does under a gang)."""
    token = _DATA_PARALLEL.set(group)
    try:
        yield
    finally:
        _DATA_PARALLEL.reset(token)


def data_parallel_group():
    """The group bound by ``data_parallel``, or None."""
    return _DATA_PARALLEL.get()


def free_port() -> int:
    """A free localhost port for a local gang's coordinator."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_local_gang(script: str, num_processes: int, *,
                     port: int | None = None, timeout: float = 180.0,
                     extra_env: dict[str, str] | None = None) -> list[dict]:
    """Run ``script`` (``python -c``) in ``num_processes`` OS processes
    joined by one localhost coordinator (the ``JAXJOB_*`` env of each
    rank).  Each worker prints a JSON object as its last stdout line; the
    parsed objects are returned in rank order.

    The first worker to exit nonzero, or the timeout, ends the gang: the
    survivors are killed before this raises (a half-dead gang would wait
    in its next collective)."""
    import json
    import subprocess
    import sys
    import tempfile
    import time

    if port is None:
        port = free_port()
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
