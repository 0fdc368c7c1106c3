"""Prometheus-style metrics registry (text exposition format).

The port's own copy of ``kubeflow_tpu/utils/metrics.py``, trimmed to what
the serving engine (its speculation counters
``serving_spec_tokens_proposed_total``, ``..._accepted_total`` and
``serving_spec_rounds_total`` included), the page pool, the prefix cache,
the weight-residency pool, the tracer and the predictor's ``/metrics``
use: labelled counters and gauges (readable with ``get``) and
cumulative-bucket histograms, labelled too (``serving_tenant_*`` by
tenant, ``serving_fleet_request_seconds`` by model; readable with
``count``).
"""

from __future__ import annotations

import threading
from typing import Iterable


class _Metric:
    def __init__(self, name: str, help_text: str,
                 label_names: Iterable[str] = ()):
        self.name = name
        self.help = help_text
        self.label_names = tuple(label_names)
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def labels(self, *label_values: str) -> "_MetricHandle":
        if len(label_values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected {len(self.label_names)} labels, "
                f"got {len(label_values)}")
        return _MetricHandle(self, tuple(str(v) for v in label_values))

    def _add(self, key: tuple, delta: float) -> None:
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + delta

    def _set(self, key: tuple, value: float) -> None:
        with self._lock:
            self._values[key] = value

    def get(self, *label_values: str) -> float:
        """The current value of one label set (0 before its first write)."""
        with self._lock:
            return self._values.get(tuple(str(v) for v in label_values),
                                    0.0)

    def expose(self, kind: str) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {kind}"]
        with self._lock:
            items = sorted(self._values.items())
        for key, value in items:
            if key:
                labels = ",".join(
                    f'{n}="{v}"' for n, v in zip(self.label_names, key))
                lines.append(f"{self.name}{{{labels}}} {value}")
            else:
                lines.append(f"{self.name} {value}")
        return "\n".join(lines)


class _MetricHandle:
    def __init__(self, metric: _Metric, key: tuple):
        self._metric = metric
        self._key = key

    def inc(self, delta: float = 1.0) -> None:
        self._metric._add(self._key, delta)


class Counter(_Metric):
    def inc(self, delta: float = 1.0) -> None:
        self._add((), delta)


class Gauge(_Metric):
    def set(self, value: float) -> None:
        self._set((), value)


class Histogram(_Metric):
    """Prometheus histogram: cumulative ``le`` buckets + _sum/_count, one
    row per label set (``labels(...)``; an unlabelled histogram has the
    one row ``()``)."""

    DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                       0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

    def __init__(self, name: str, help_text: str,
                 buckets: Iterable[float] | None = None,
                 label_names: Iterable[str] = ()):
        super().__init__(name, help_text, label_names)
        self.buckets = tuple(sorted(buckets or self.DEFAULT_BUCKETS))
        # label key -> [per-bucket counts..., +Inf count, sum]
        self._data: dict[tuple, list[float]] = {}
        if not self.label_names:
            self._data[()] = [0.0] * (len(self.buckets) + 2)

    def labels(self, *label_values: str) -> "_HistogramHandle":
        if len(label_values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected {len(self.label_names)} labels, "
                f"got {len(label_values)}")
        return _HistogramHandle(self, tuple(str(v) for v in label_values))

    def observe(self, value: float) -> None:
        self._observe((), value)

    def _observe(self, key: tuple, value: float) -> None:
        idx = next((i for i, b in enumerate(self.buckets) if value <= b),
                   len(self.buckets))
        with self._lock:
            row = self._data.get(key)
            if row is None:
                row = self._data[key] = [0.0] * (len(self.buckets) + 2)
            row[idx] += 1
            row[-1] += value

    def count(self, *label_values: str) -> float:
        """Observations of one label set (0 before the first)."""
        with self._lock:
            row = self._data.get(tuple(str(v) for v in label_values))
            return sum(row[:-1]) if row else 0.0

    def expose(self, kind: str) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {kind}"]
        with self._lock:
            items = sorted((k, list(v)) for k, v in self._data.items())
        for key, row in items:
            base = ",".join(f'{n}="{v}"'
                            for n, v in zip(self.label_names, key))
            sep = "," if base else ""
            cum = 0.0
            for bound, n in zip(self.buckets, row):
                cum += n
                lines.append(f'{self.name}_bucket{{{base}{sep}le="{bound}"}}'
                             f" {cum}")
            cum += row[len(self.buckets)]
            lines.append(f'{self.name}_bucket{{{base}{sep}le="+Inf"}} {cum}')
            suffix = f"{{{base}}}" if base else ""
            lines.append(f"{self.name}_sum{suffix} {row[-1]}")
            lines.append(f"{self.name}_count{suffix} {cum}")
        return "\n".join(lines)


class _HistogramHandle:
    def __init__(self, metric: Histogram, key: tuple):
        self._metric = metric
        self._key = key

    def observe(self, value: float) -> None:
        self._metric._observe(self._key, value)


class Registry:
    def __init__(self) -> None:
        self._metrics: dict[str, tuple[str, _Metric]] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_text: str = "",
                labels: Iterable[str] = ()) -> Counter:
        return self._register(name, "counter",
                              Counter(name, help_text, labels))

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._register(name, "gauge", Gauge(name, help_text))

    def histogram(self, name: str, help_text: str = "",
                  buckets: Iterable[float] | None = None,
                  labels: Iterable[str] = ()) -> Histogram:
        return self._register(name, "histogram",
                              Histogram(name, help_text, buckets, labels))

    def _register(self, name: str, kind: str, metric: _Metric):
        with self._lock:
            if name in self._metrics:
                existing_kind, existing = self._metrics[name]
                if existing_kind != kind:
                    raise ValueError(f"metric {name} already registered "
                                     f"as {existing_kind}")
                return existing
            self._metrics[name] = (kind, metric)
            return metric

    def get_metric(self, name: str) -> _Metric | None:
        """The registered metric of that name, or None."""
        with self._lock:
            entry = self._metrics.get(name)
        return entry[1] if entry else None

    def expose(self) -> str:
        with self._lock:
            items = sorted(self._metrics.items())
        return "\n".join(metric.expose(kind)
                         for _, (kind, metric) in items) + "\n"


REGISTRY = Registry()
