"""Membership epochs and the exactly-once data contract of elastic gangs.

Counterpart of ``kubeflow_tpu/elastic/protocol.py``, framework-free and
copied rather than imported (the port imports nothing of the JAX
package).  A membership is a versioned set of worker indices; the epoch
is the fence: two observers that agree on it agree on the member set, the
coordinator (the lowest index) and every rank.

Global step ``k``'s batch is a fixed set of ``global_batch`` rows whatever
the gang's size; rank ``r`` of world ``w`` owns the strided rows
``range(r, global_batch, w)`` (``shard_rows``, the partition
``training/data.py`` applies), so across any resize the members consume
each step's batch exactly once.  ``BatchLedger`` audits that, and its
``digest`` folds a whole history into one hash.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json


@dataclasses.dataclass(frozen=True)
class Membership:
    """One epoch's gang: ``members`` are worker indices (sorted); rank is
    the position in that order; the coordinator is the lowest."""

    epoch: int
    members: tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "members",
                           tuple(sorted(int(m) for m in self.members)))

    @property
    def size(self) -> int:
        return len(self.members)

    @property
    def coordinator(self) -> int:
        return self.members[0]

    def rank_of(self, index: int) -> int | None:
        """This worker's rank under the epoch, or None when it was shrunk
        out of the gang (the worker then exits cleanly)."""
        try:
            return self.members.index(index)
        except ValueError:
            return None


def membership_from_status(job: dict) -> Membership | None:
    """The gang's membership from ``status.elastic`` (the controller's
    record), or None for a job that is not elastic or not stamped yet."""
    est = (job.get("status") or {}).get("elastic")
    if not est:
        return None
    return Membership(int(est.get("epoch", 0)),
                      tuple(est.get("members", ())))


def shard_rows(global_batch: int, rank: int, world: int) -> range:
    """Rank ``rank`` of ``world``'s rows of one global batch: the strided
    partition ``idx[rank::world]``.  Unions over ranks cover
    ``range(global_batch)`` exactly; shards differ by at most one row when
    ``world`` does not divide the batch."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside world {world}")
    return range(rank, global_batch, world)


def step_rows(global_batch: int,
              members: tuple[int, ...] | list[int]) -> dict[int, range]:
    """Worker index -> its rows of one global step's batch under the
    given membership: a disjoint cover of the batch for any member set."""
    ordered = sorted(members)
    world = len(ordered)
    return {m: shard_rows(global_batch, r, world)
            for r, m in enumerate(ordered)}


class BatchLedger:
    """Audit log of data consumption across resizes.

    ``record(step, member, rows)`` once per member per global step;
    ``verify`` raises ``AssertionError`` on a step or row consumed twice or
    never; ``digest`` hashes the whole ledger, equal for two runs that
    consumed the same batches under the same membership history."""

    def __init__(self) -> None:
        self._steps: dict[int, dict[int, tuple[int, ...]]] = {}

    def record(self, step: int, member: int, rows) -> None:
        per_member = self._steps.setdefault(int(step), {})
        if member in per_member:
            raise AssertionError(
                f"member {member} consumed step {step} twice")
        per_member[int(member)] = tuple(rows)

    def verify(self, *, steps: int, global_batch: int,
               start: int = 0) -> None:
        want = set(range(start, steps))
        got = set(self._steps)
        if got != want:
            missing = sorted(want - got)
            extra = sorted(got - want)
            raise AssertionError(
                f"steps skipped={missing[:5]} repeated/extra={extra[:5]}")
        full = set(range(global_batch))
        for step, per_member in self._steps.items():
            seen: set[int] = set()
            for member, rows in per_member.items():
                dup = seen.intersection(rows)
                if dup:
                    raise AssertionError(
                        f"step {step}: rows {sorted(dup)[:5]} delivered "
                        f"twice (member {member})")
                seen.update(rows)
            if seen != full:
                raise AssertionError(
                    f"step {step}: rows {sorted(full - seen)[:5]} skipped")

    def digest(self) -> str:
        canon = {str(s): {str(m): list(r) for m, r in sorted(pm.items())}
                 for s, pm in sorted(self._steps.items())}
        return hashlib.sha256(
            json.dumps(canon, sort_keys=True).encode()).hexdigest()

    def __len__(self) -> int:
        return len(self._steps)
