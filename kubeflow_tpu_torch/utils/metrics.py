"""Prometheus-style metrics registry (text exposition format).

The port's own copy of ``kubeflow_tpu/utils/metrics.py``, trimmed to what
the serving engine (its speculation counters
``serving_spec_tokens_proposed_total``, ``..._accepted_total`` and
``serving_spec_rounds_total`` included), the page pool, the prefix cache
and the predictor's ``/metrics`` use: labelled counters and gauges
(readable with ``get``) and cumulative-bucket histograms.
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
    """Prometheus histogram: cumulative ``le`` buckets + _sum/_count."""

    DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                       0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

    def __init__(self, name: str, help_text: str,
                 buckets: Iterable[float] | None = None):
        super().__init__(name, help_text)
        self.buckets = tuple(sorted(buckets or self.DEFAULT_BUCKETS))
        # per-bucket counts..., +Inf count, sum
        self._row = [0.0] * (len(self.buckets) + 2)

    def observe(self, value: float) -> None:
        idx = next((i for i, b in enumerate(self.buckets) if value <= b),
                   len(self.buckets))
        with self._lock:
            self._row[idx] += 1
            self._row[-1] += value

    def expose(self, kind: str) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {kind}"]
        with self._lock:
            row = list(self._row)
        cum = 0.0
        for bound, n in zip(self.buckets, row):
            cum += n
            lines.append(f'{self.name}_bucket{{le="{bound}"}} {cum}')
        cum += row[len(self.buckets)]
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{self.name}_sum {row[-1]}")
        lines.append(f"{self.name}_count {cum}")
        return "\n".join(lines)


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
                  buckets: Iterable[float] | None = None) -> Histogram:
        return self._register(name, "histogram",
                              Histogram(name, help_text, buckets))

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

    def expose(self) -> str:
        with self._lock:
            items = sorted(self._metrics.items())
        return "\n".join(metric.expose(kind)
                         for _, (kind, metric) in items) + "\n"


REGISTRY = Registry()
