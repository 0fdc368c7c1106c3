"""Model registry: name -> how to build it, for the serving runtime.

Counterpart of ``kubeflow_tpu/models/registry.py``; this slice registers
the ``llama`` entry only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    name: str
    make_model: Callable[..., Any]   # (size=, device=, param_dtype=, **cfg)
    generative: bool = False         # decoder LM: served by the engine


_REGISTRY: dict[str, ModelEntry] = {}


def register(entry: ModelEntry) -> None:
    _REGISTRY[entry.name] = entry


def get(name: str) -> ModelEntry:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def _make_llama(size: str = "tiny", *, device=None, param_dtype=None, **cfg):
    from kubeflow_tpu_torch.models import llama

    factory = {"tiny": llama.llama_tiny, "3b": llama.llama_3b,
               "7b": llama.llama2_7b, "13b": llama.llama2_13b}[size]
    config = factory(**cfg)
    return llama.LlamaModel(config, device=device,
                            param_dtype=param_dtype or config.torch_dtype)


register(ModelEntry("llama", _make_llama, generative=True))
