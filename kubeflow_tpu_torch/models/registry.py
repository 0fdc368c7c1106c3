"""Model registry: name -> how to build it, make a batch and take its loss.

Counterpart of ``kubeflow_tpu/models/registry.py``.  Registered: ``llama``
(serving; its training loss waits for a later slice) and ``bert``
(training).  ``make_batch(batch_size, gen, module)`` draws a synthetic
batch from a ``torch.Generator`` on the host; ``jax.random`` streams
cannot be reproduced bit for bit, so the port's synthetic batches have the
reference's shapes, ranges and masking rate, not its numbers (tests hand
both sides the same numpy batch).  ``forward_loss(module, batch)`` is the
reference's ``forward_loss(module, params, batch)`` with the parameters in
the module.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    name: str
    make_model: Callable[..., Any]   # (size=, device=, **cfg) -> nn.Module
    make_batch: Callable[..., dict] | None = None   # (b, gen, module)
    forward_loss: Callable[..., Any] | None = None  # (module, batch)
    generative: bool = False         # decoder LM: served by the engine


_REGISTRY: dict[str, ModelEntry] = {}


def register(entry: ModelEntry) -> None:
    _REGISTRY[entry.name] = entry


def get(name: str) -> ModelEntry:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


# --- BERT --------------------------------------------------------------------

def _make_bert(size: str = "base", *, device=None, **cfg):
    from kubeflow_tpu_torch.models import bert

    factory = {"tiny": bert.bert_tiny, "base": bert.bert_base,
               "large": bert.bert_large}[size]
    return bert.BertModel(factory(**cfg), device=device)


def _bert_batch(batch_size, gen, module, seq_len: int | None = None):
    import torch

    cfg = module.config
    s = seq_len or cfg.max_position
    shape = (batch_size, s)
    return {
        "input_ids": torch.randint(0, cfg.vocab_size, shape, generator=gen),
        "labels": torch.randint(0, cfg.vocab_size, shape, generator=gen),
        # standard BERT masks 15% of positions
        "weights": (torch.rand(shape, generator=gen) < 0.15).float(),
    }


def _bert_loss(module, batch):
    from kubeflow_tpu_torch.models.bert import mlm_loss

    out = module(batch["input_ids"])
    return mlm_loss(out, batch["labels"], batch["weights"])


register(ModelEntry("bert", _make_bert, make_batch=_bert_batch,
                    forward_loss=_bert_loss))


# --- Llama -------------------------------------------------------------------

def _make_llama(size: str = "tiny", *, device=None, param_dtype=None, **cfg):
    from kubeflow_tpu_torch.models import llama

    factory = {"tiny": llama.llama_tiny, "3b": llama.llama_3b,
               "7b": llama.llama2_7b, "13b": llama.llama2_13b}[size]
    config = factory(**cfg)
    return llama.LlamaModel(config, device=device,
                            param_dtype=param_dtype or config.torch_dtype)


register(ModelEntry("llama", _make_llama, generative=True))
