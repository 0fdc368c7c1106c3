"""Membership sources for the Trainer's resize barrier.

Counterparts of ``FileMembership``, ``ScriptedMembership`` and
``write_membership_file`` in ``kubeflow_tpu/elastic/runtime.py``.  The
reference's ``GangSim`` (the chaos loadtest's logical-time gang) drives
the control plane's store and is not worker code; it stays there.
"""

from __future__ import annotations

import json
import os

from kubeflow_tpu_torch.elastic.protocol import Membership


class FileMembership:
    """Membership read from a JSON file (``{"epoch": E, "members": [..]}``)
    that an external agent rewrites.  A missing or malformed read returns
    the last good view: a torn rewrite must not look like a resize.

    Before the first record lands the view is this worker alone at epoch
    -1, below any epoch the controller stamps (it starts at 0), so the
    first real record, even epoch 0, reads as an epoch change and runs
    the barrier; a bootstrap at epoch 0 would train solo forever."""

    def __init__(self, path: str, index: int):
        self.path = path
        self.index = int(index)
        self._last = Membership(-1, (self.index,))

    def current(self, step: int) -> Membership:
        try:
            with open(self.path) as f:
                raw = json.load(f)
            self._last = Membership(int(raw["epoch"]),
                                    tuple(raw["members"]))
        except (OSError, ValueError, KeyError, TypeError):
            pass
        return self._last


class ScriptedMembership:
    """Test-side source: ``schedule`` maps a step threshold to the
    membership that takes effect at that step boundary."""

    def __init__(self, index: int, schedule: dict[int, Membership]):
        if 0 not in schedule:
            raise ValueError("schedule must define the step-0 membership")
        self.index = int(index)
        self._schedule = sorted(schedule.items())

    def current(self, step: int) -> Membership:
        live = self._schedule[0][1]
        for at, membership in self._schedule:
            if at <= step:
                live = membership
        return live


def write_membership_file(path: str, membership: Membership) -> None:
    """Publish a membership view for ``FileMembership`` readers
    atomically (a temporary file renamed into place)."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump({"epoch": membership.epoch,
                   "members": list(membership.members)}, f)
    os.replace(tmp, path)
