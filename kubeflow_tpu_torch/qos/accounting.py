"""Per-tenant usage meters: what each tenant actually consumed.

The port's copy of ``kubeflow_tpu/qos/accounting.py``, whole.  Exact
monotone counters owned by the component that did the work: the serving
engine meters outcomes, admission waits, decode tokens and slice-seconds
as it takes them.  One accountant per process, swappable for tests.
"""

from __future__ import annotations

import threading


def _empty_usage() -> dict:
    return {
        "requests": {},          # outcome -> count (ok/shed/error/...)
        "throttled": 0,          # gateway 429s from the token bucket
        "decode_tokens": 0,      # tokens actually emitted
        "slice_seconds": 0.0,    # decode wall time x slot share
        "admission_wait": {"count": 0, "sum_s": 0.0, "max_s": 0.0},
    }


class Accountant:
    """Thread-safe per-tenant usage aggregation."""

    def __init__(self):
        self._lock = threading.Lock()
        self._usage: dict[str, dict] = {}

    def _tenant(self, tenant: str) -> dict:
        u = self._usage.get(tenant)
        if u is None:
            u = self._usage[tenant] = _empty_usage()
        return u

    def record_outcome(self, tenant: str, outcome: str) -> None:
        with self._lock:
            reqs = self._tenant(tenant)["requests"]
            reqs[outcome] = reqs.get(outcome, 0) + 1

    def record_throttled(self, tenant: str) -> None:
        with self._lock:
            self._tenant(tenant)["throttled"] += 1

    def record_decode_tokens(self, tenant: str, tokens: int) -> None:
        if tokens <= 0:
            return
        with self._lock:
            self._tenant(tenant)["decode_tokens"] += int(tokens)

    def record_slice_seconds(self, tenant: str, seconds: float) -> None:
        if seconds <= 0:
            return
        with self._lock:
            self._tenant(tenant)["slice_seconds"] += float(seconds)

    def record_admission_wait(self, tenant: str, wait_s: float) -> None:
        wait_s = max(0.0, float(wait_s))
        with self._lock:
            w = self._tenant(tenant)["admission_wait"]
            w["count"] += 1
            w["sum_s"] += wait_s
            w["max_s"] = max(w["max_s"], wait_s)

    # -- reads -----------------------------------------------------------------
    def usage(self, tenant: str) -> dict:
        """Deep snapshot for one tenant (zeros when never seen)."""
        with self._lock:
            u = self._usage.get(tenant)
            if u is None:
                return _empty_usage()
            out = dict(u)
            out["requests"] = dict(u["requests"])
            out["admission_wait"] = dict(u["admission_wait"])
            return out

    def all_usage(self) -> dict[str, dict]:
        with self._lock:
            tenants = list(self._usage)
        return {t: self.usage(t) for t in tenants}

    def reset(self) -> None:
        with self._lock:
            self._usage.clear()


_accountant = Accountant()
_accountant_lock = threading.Lock()


def get_accountant() -> Accountant:
    return _accountant


def set_accountant(acct: Accountant) -> Accountant:
    """Swap the process accountant (tests); returns the previous one."""
    global _accountant
    with _accountant_lock:
        prev, _accountant = _accountant, acct
    return prev
