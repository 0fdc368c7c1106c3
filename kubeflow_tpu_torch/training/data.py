"""Input pipelines: deterministic synthetic data and .npz array datasets.

Counterpart of ``kubeflow_tpu/training/data.py``.  Batches are host
tensors (the Trainer moves them to the device); each process loads only
its rows of the global batch (``elastic.protocol.shard_rows``).

- ``SyntheticDataset``: batch k is drawn from a ``torch.Generator`` keyed
  off (seed + k, rank), so a resumed run continues the schedule and ranks
  never collide.  The reference keys ``jax.random`` the same way; the two
  streams differ (see ``models/registry.py``).
- ``NpzDataset``: pure numpy, batch for batch identical to the
  reference's for the same file, seed, rank and world (numpy arrays);
  ``iter_from(step, rank=, world=)`` re-keys the shard at a resize.
- ``DevicePrefetcher``: a thread that assembles the next batches and
  copies them to the device from pinned memory while a step runs.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Any, Callable, Iterator

import numpy as np
import torch

from kubeflow_tpu_torch.elastic.protocol import shard_rows


def _step_seed(seed: int, step: int, rank: int) -> int:
    """A 63-bit generator seed from (seed + step, rank)."""
    state = np.random.SeedSequence([seed + step, rank]).generate_state(
        1, dtype=np.uint64)
    return int(state[0]) & (2**63 - 1)


class SyntheticDataset:
    """Infinite deterministic batches from a registry model's
    ``make_batch``; ``local_batch`` rows per process."""

    def __init__(self, model_name: str, module: Any, local_batch: int,
                 seed: int = 0, process_index: int = 0, **kw: Any):
        from kubeflow_tpu_torch.models import registry

        self._entry = registry.get(model_name)
        if self._entry.make_batch is None:
            raise NotImplementedError(
                f"model {model_name!r} has no synthetic batch in the port")
        self._module = module
        self._batch = local_batch
        self._seed = seed
        self._pi = process_index
        self._kw = kw

    def __iter__(self) -> Iterator[dict]:
        return self.iter_from(0)

    def iter_from(self, start_step: int, *, rank: int | None = None,
                  rows: int | None = None) -> Iterator[dict]:
        """Batch k derives from (seed + k, rank) wherever iteration
        starts; ``rank`` / ``rows`` re-key the shard (the reference's
        elastic resize contract)."""
        step = start_step
        pi = self._pi if rank is None else int(rank)
        n = self._batch if rows is None else int(rows)
        while True:
            gen = torch.Generator().manual_seed(_step_seed(self._seed, step,
                                                           pi))
            yield self._entry.make_batch(n, gen, self._module, **self._kw)
            step += 1


class NpzDataset:
    """Epochs over an .npz file of arrays sharing a leading example axis;
    each process yields its ``shard_rows`` of every global batch."""

    def __init__(self, path: str, global_batch: int, *, shuffle: bool = True,
                 seed: int = 0, process_index: int = 0,
                 process_count: int = 1):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        with np.load(path) as data:
            self._arrays = {k: data[k] for k in data.files}
        sizes = {k: v.shape[0] for k, v in self._arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"ragged dataset: {sizes}")
        self._n = next(iter(sizes.values()))
        self._batch = global_batch
        self._shuffle = shuffle
        self._seed = seed
        self._pi = process_index
        self._pc = process_count
        if self._pc > global_batch:
            raise ValueError(
                f"process count {self._pc} exceeds global batch "
                f"{global_batch}: some ranks would own no rows")
        if self._n < global_batch:
            raise ValueError(
                f"dataset {path} has {self._n} rows < global batch "
                f"{global_batch}")

    @property
    def batches_per_epoch(self) -> int:
        return self._n // self._batch

    def __iter__(self) -> Iterator[dict]:
        return self.iter_from(0)

    def iter_from(self, start_step: int, *, rank: int | None = None,
                  world: int | None = None) -> Iterator[dict]:
        """Global batch k is deterministic in (seed, k): a resumed run
        sees the rest of the schedule, not a replay."""
        pi = self._pi if rank is None else int(rank)
        pc = self._pc if world is None else int(world)
        bpe = self.batches_per_epoch
        epoch, offset = divmod(start_step, bpe)
        while True:
            order = np.arange(self._n)
            if self._shuffle:
                np.random.default_rng(self._seed + epoch).shuffle(order)
            for b in range(offset, bpe):
                idx = order[b * self._batch:(b + 1) * self._batch]
                idx = idx[list(shard_rows(len(idx), pi, pc))]
                yield {k: v[idx] for k, v in self._arrays.items()}
            offset = 0
            epoch += 1


def to_device(batch: dict, device: torch.device) -> dict:
    """Host batch (numpy arrays or CPU tensors) -> tensors on ``device``;
    to a card through pinned memory, without blocking the host."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


class DevicePrefetcher:
    """Async host-to-device input pipeline: a background thread pulls
    host batches from ``it``, moves them with ``put_fn``, and keeps up to
    ``depth`` batches in flight, so batch k+1's assembly and copy overlap
    step k.  Errors surface at the consumer's ``next()``."""

    _SENTINEL = object()

    def __init__(self, it: Iterator[Any], put_fn: Callable[[Any], Any],
                 depth: int = 2):
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1")
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._terminal = False
        self._thread = threading.Thread(
            target=self._fill, args=(it, put_fn), daemon=True,
            name="device-prefetch")
        self._thread.start()

    def _fill(self, it, put_fn) -> None:
        def offer(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            for batch in it:
                if self._stop.is_set() or not offer(("ok", put_fn(batch))):
                    return
            offer(("end", self._SENTINEL))
        except BaseException as e:  # surfaced at the consumer's next()
            offer(("err", e))

    def __iter__(self) -> "DevicePrefetcher":
        return self

    def __next__(self) -> Any:
        if self._terminal:
            raise StopIteration
        kind, val = self._q.get()
        if kind == "err":
            self._terminal = True
            raise val
        if kind == "end":
            self._terminal = True
            raise StopIteration
        return val

    def close(self) -> None:
        """Stop the producer and drop buffered batches."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
