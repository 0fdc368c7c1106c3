"""Elastic gangs on the worker side: membership epochs, the exactly-once
data contract, the resize record and the membership sources.

Counterpart of ``kubeflow_tpu/elastic``, less its control-plane parts
(``ElasticDecider`` and the chaos runtime's ``GangSim``).  The Trainer
(``training/trainer.py``) reads a membership at every step boundary; on
an epoch change it saves its state and a ``ResizeCheckpoint`` record,
re-keys its data shard for the new world, and goes on with strictly
monotone steps, or resigns when it was shrunk out.
"""

from kubeflow_tpu_torch.elastic.checkpoint import ResizeCheckpoint
from kubeflow_tpu_torch.elastic.protocol import (
    BatchLedger,
    Membership,
    membership_from_status,
    shard_rows,
    step_rows,
)

__all__ = ["BatchLedger", "Membership", "ResizeCheckpoint",
           "membership_from_status", "shard_rows", "step_rows"]
