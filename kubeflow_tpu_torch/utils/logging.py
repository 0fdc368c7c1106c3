"""Structured JSON logging with key/value context binding.

The port's own copy of ``kubeflow_tpu/utils/logging.py``, trimmed to what
the serving engine and predictor use.
"""

from __future__ import annotations

import json
import logging
import sys
from typing import Any

_CONFIGURED = False


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        entry: dict[str, Any] = {
            "ts": round(record.created, 3),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        extra = getattr(record, "kv", None)
        if extra:
            entry.update(extra)
        if record.exc_info and record.exc_info[0] is not None:
            entry["exc"] = self.formatException(record.exc_info)
        return json.dumps(entry, default=str)


class BoundLogger:
    """A logger with bound key/value context (zap-style)."""

    def __init__(self, logger: logging.Logger,
                 kv: dict[str, Any] | None = None):
        self._logger = logger
        self._kv = kv or {}

    def _log(self, level: int, msg: str, kv: dict[str, Any],
             exc_info=None) -> None:
        merged = dict(self._kv)
        merged.update(kv)
        self._logger.log(level, msg, extra={"kv": merged},
                         exc_info=exc_info)

    def info(self, msg: str, **kv: Any) -> None:
        self._log(logging.INFO, msg, kv)

    def warning(self, msg: str, exc_info=None, **kv: Any) -> None:
        self._log(logging.WARNING, msg, kv, exc_info=exc_info)

    def error(self, msg: str, exc_info=None, **kv: Any) -> None:
        self._log(logging.ERROR, msg, kv, exc_info=exc_info)


def configure(level: int = logging.INFO, stream=None) -> None:
    global _CONFIGURED
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(_JsonFormatter())
    root = logging.getLogger("kubeflow_tpu_torch")
    root.handlers[:] = [handler]
    root.setLevel(level)
    root.propagate = False
    _CONFIGURED = True


def get_logger(name: str, **kv: Any) -> BoundLogger:
    if not _CONFIGURED:
        configure()
    return BoundLogger(logging.getLogger(f"kubeflow_tpu_torch.{name}"), kv)
