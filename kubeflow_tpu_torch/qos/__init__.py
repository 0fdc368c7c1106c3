"""Multi-tenant QoS for the serving engine: fair-share admission and
per-tenant accounting.

Counterpart of ``kubeflow_tpu/qos/``, trimmed to what serving uses (the
gateway's token buckets, tenant resolution from profiles and priority
tiers are control plane and stay out):

    tenants.clamp_tenant      a claimed tenant folded into the configured
                              share map, or the bounded ``"anonymous"``
    wfq.WeightedFairQueue     virtual-time weighted-fair ordering by
                              tenant share for ContinuousBatcher admission
    wfq.fair_quota            a tenant's share of the bounded queue
    accounting.Accountant     per-tenant usage meters (outcomes, admission
                              waits, decode tokens, slice-seconds)
"""

from __future__ import annotations

from kubeflow_tpu_torch.qos.accounting import (Accountant, get_accountant,
                                               set_accountant)
from kubeflow_tpu_torch.qos.tenants import (ANONYMOUS, DEFAULT_SHARE,
                                            clamp_tenant)
from kubeflow_tpu_torch.qos.wfq import WeightedFairQueue, fair_quota

__all__ = [
    "ANONYMOUS",
    "Accountant",
    "DEFAULT_SHARE",
    "WeightedFairQueue",
    "clamp_tenant",
    "fair_quota",
    "get_accountant",
    "set_accountant",
]
