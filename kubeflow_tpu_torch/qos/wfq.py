"""Virtual-time weighted-fair queuing (start-time fair queuing).

The port's copy of ``kubeflow_tpu/qos/wfq.py``, whole.

Pure virtual time: the clock only advances when work is admitted, so
ordering is deterministic, sleep-free, and immune to wall-clock skew.
Each arrival gets a virtual FINISH tag

    start  = max(V, last_finish[tenant])
    finish = start + cost / share[tenant]

and admission always picks the queued request with the smallest tag
(FIFO within a tenant — tags are monotone per flow).  A tenant storming
at 10x its share only advances its OWN finish tags 10x faster; a
1x tenant's next tag stays near V, so its requests are admitted within
one fair round no matter how deep the storm's backlog is — the
starvation bound tests/test_qos.py pins down.

WFQ over strict priority: strict priority starves low classes outright
under sustained load; weighted fairness keeps every profile making
progress proportional to its share, which is the contract a multi-tenant
serving platform actually sells (DRF, Ghodsi NSDI'11).
"""

from __future__ import annotations

import math


class WeightedFairQueue:
    """Virtual-time tagger for one admission queue.

    Not thread-safe by itself — the ContinuousBatcher calls it under its
    own admission lock, which is the only place tags are minted or
    consumed."""

    def __init__(self, shares: dict[str, float] | None = None,
                 default_share: float = 1.0):
        self.shares = dict(shares or {})
        self.default_share = float(default_share)
        self.vtime = 0.0
        self._last_finish: dict[str, float] = {}

    def share_of(self, tenant: str) -> float:
        return max(1e-9, float(self.shares.get(tenant, self.default_share)))

    def tag(self, tenant: str, cost: float = 1.0) -> float:
        """Mint the virtual finish tag for a new arrival."""
        start = max(self.vtime, self._last_finish.get(tenant, 0.0))
        finish = start + float(cost) / self.share_of(tenant)
        self._last_finish[tenant] = finish
        return finish

    def advance(self, finish_tag: float) -> None:
        """Admitting the minimum-tag request moves virtual time to it."""
        if finish_tag > self.vtime:
            self.vtime = finish_tag

    def forget(self, tenant: str) -> None:
        """Drop an idle flow's state (its next arrival restarts at V)."""
        self._last_finish.pop(tenant, None)


def fair_quota(capacity: int, tenant: str,
               shares: dict[str, float] | None,
               default_share: float = 1.0) -> int:
    """The tenant's share of a bounded queue: ceil(capacity x w/W),
    never below 1.  With a single flow this is the full capacity, so the
    per-tenant shed check degenerates to the classic global one."""
    if capacity <= 0:
        return 0
    if not shares:
        return capacity
    weight = max(1e-9, float(shares.get(tenant, default_share)))
    total = sum(max(1e-9, float(w)) for w in shares.values())
    if tenant not in shares:
        total += weight
    return max(1, math.ceil(capacity * weight / total))
