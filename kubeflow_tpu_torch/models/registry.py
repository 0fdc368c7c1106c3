"""Model registry: name -> how to build it, make a batch and take its loss.

Counterpart of ``kubeflow_tpu/models/registry.py``, with its five models:
``mnist_mlp``, ``cifar_convnet``, ``resnet50``, ``bert`` (training) and
``llama`` (training and serving).  ``make_model`` builds float32 master
parameters, as flax's ``init`` gives; the predictor asks for Llama's in the
compute dtype (``param_dtype="compute"``), which is what the reference
casts them to at every use.  ``make_batch(batch_size, gen, module)`` draws a synthetic
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

import torch


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


def _image_batch(batch_size, gen, shape, num_classes):
    return {"image": torch.randn((batch_size, *shape), generator=gen),
            "label": torch.randint(0, num_classes, (batch_size,),
                                   generator=gen)}


# --- MNIST MLP ---------------------------------------------------------------

def _make_mlp(*, device=None, **cfg):
    from kubeflow_tpu_torch.models.mlp import MLP, MLPConfig

    if "hidden_dims" in cfg:
        cfg["hidden_dims"] = tuple(cfg["hidden_dims"])
    return MLP(MLPConfig(**cfg), device=device)


def _mlp_loss(module, batch):
    from kubeflow_tpu_torch.models.mlp import softmax_cross_entropy

    return softmax_cross_entropy(module(batch["image"]), batch["label"])


register(ModelEntry(
    "mnist_mlp", _make_mlp,
    make_batch=lambda b, gen, m: _image_batch(b, gen, (28, 28, 1), 10),
    forward_loss=_mlp_loss))


# --- CIFAR ConvNet -----------------------------------------------------------

def _make_convnet(*, device=None, **cfg):
    from kubeflow_tpu_torch.models.convnet import ConvNet, ConvNetConfig

    fields = {f.name for f in dataclasses.fields(ConvNetConfig)}
    cfg = {k: v for k, v in cfg.items() if k in fields}
    if "channels" in cfg:
        cfg["channels"] = tuple(cfg["channels"])
    return ConvNet(ConvNetConfig(**cfg), device=device)


def _convnet_loss(module, batch):
    from kubeflow_tpu_torch.models.mlp import softmax_cross_entropy

    # the reference's loss runs the model in eval mode (no dropout)
    return softmax_cross_entropy(module(batch["image"], train=False),
                                 batch["label"])


register(ModelEntry(
    "cifar_convnet", _make_convnet,
    make_batch=lambda b, gen, m: _image_batch(b, gen, (32, 32, 3), 10),
    forward_loss=_convnet_loss))


# --- ResNet-50 ---------------------------------------------------------------

def _make_resnet(*, device=None, **cfg):
    from kubeflow_tpu_torch.models.resnet import ResNet, ResNetConfig

    if "stage_sizes" in cfg:
        cfg["stage_sizes"] = tuple(cfg["stage_sizes"])
    return ResNet(ResNetConfig(**cfg), device=device)


def _resnet_loss(module, batch):
    from kubeflow_tpu_torch.models.mlp import softmax_cross_entropy

    # BatchNorm on batch statistics (train mode); the reference discards
    # the running-average update, and the port never makes it
    return softmax_cross_entropy(module(batch["image"], train=True),
                                 batch["label"])


register(ModelEntry(
    "resnet50", _make_resnet,
    make_batch=lambda b, gen, m: _image_batch(
        b, gen, (224, 224, 3), m.config.num_classes),
    forward_loss=_resnet_loss))


# --- BERT --------------------------------------------------------------------

def _make_bert(size: str = "base", *, device=None, **cfg):
    from kubeflow_tpu_torch.models import bert

    factory = {"tiny": bert.bert_tiny, "base": bert.bert_base,
               "large": bert.bert_large}[size]
    return bert.BertModel(factory(**cfg), device=device)


def _bert_batch(batch_size, gen, module, seq_len: int | None = None):
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

def _make_llama(size: str = "tiny", *, device=None,
                param_dtype: torch.dtype | str = torch.float32, **cfg):
    """``param_dtype="compute"`` holds the parameters in the compute dtype
    (serving); the default is float32 masters (training)."""
    from kubeflow_tpu_torch.models import llama

    factory = {"tiny": llama.llama_tiny, "3b": llama.llama_3b,
               "7b": llama.llama2_7b, "13b": llama.llama2_13b}[size]
    config = factory(**cfg)
    if param_dtype == "compute":
        param_dtype = config.torch_dtype
    return llama.LlamaModel(config, device=device, param_dtype=param_dtype)


def _llama_batch(batch_size, gen, module, seq_len: int | None = None):
    cfg = module.config
    s = seq_len or min(cfg.max_seq_len, 512)
    ids = torch.randint(0, cfg.vocab_size, (batch_size, s + 1), generator=gen)
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


def _llama_loss(module, batch):
    from kubeflow_tpu_torch.models.mlp import softmax_cross_entropy

    if module.config.moe_experts > 0:   # the load-balance term's layers
        raise NotImplementedError("MoE llama layers are not yet ported")
    out = module(batch["input_ids"])
    return softmax_cross_entropy(out["logits"], batch["labels"])


register(ModelEntry("llama", _make_llama, make_batch=_llama_batch,
                    forward_loss=_llama_loss, generative=True))
