"""Tenant identity as the serving engine sees it.

Counterpart of ``kubeflow_tpu/qos/tenants.py``'s ``ANONYMOUS``,
``DEFAULT_SHARE`` and ``clamp_tenant``.  A tenant is a profile name from
the engine's configured share map or the single bounded ``"anonymous"``
fallback, so per-tenant metric series and WFQ flows stay O(profiles),
never O(users).
"""

from __future__ import annotations

ANONYMOUS = "anonymous"
DEFAULT_SHARE = 1.0


def clamp_tenant(tenant: str | None, known) -> str:
    """Fold a claimed tenant into the known set (or anonymous).

    Engine-side guard for deployments where the predictor is reachable
    without the gateway: an arbitrary ``Kubeflow-Userid`` header must
    not mint new metric series or WFQ flows."""
    if tenant and known and tenant in known:
        return tenant
    return ANONYMOUS
