"""Weight bridge: a flax params tree (as numpy) onto the port's modules.

The port's modules keep the flax leaf names and layouts, so the mapping is
by path alone: ``layer_3/attention/q/kernel`` becomes
``layers.3.attention.q.kernel`` (Llama; an MoE block's
``layer_2/moe/router/kernel``, ``.../router/bias``, ``moe/w_in`` and
``moe/w_out`` likewise), ``layer_3/attention/query/kernel``
becomes ``layers.3.attention.query.kernel`` (BERT), and
``stage1_block0/conv2/kernel`` becomes ``stage1_block0.conv2.kernel``
(ResNet; MLP and ConvNet likewise).  ResNet's ``batch_stats`` tree maps
onto its BatchNorm buffers (``stage1_block0.bn2.mean``).  The input is a nested
dict of numpy arrays (what ``jax.tree.map(np.asarray, params)`` gives), so
the port never imports JAX to read it.  bfloat16 arrays (numpy's
``bfloat16`` from ml_dtypes) are taken bit for bit.  The same mapping
carries any tree of that shape, gradients included.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from kubeflow_tpu_torch.models.bert import BertConfig
from kubeflow_tpu_torch.models.convnet import ConvNet, ConvNetConfig
from kubeflow_tpu_torch.models.llama import LlamaConfig, moe_layers
from kubeflow_tpu_torch.models.mlp import MLP, MLPConfig
from kubeflow_tpu_torch.models.resnet import ResNet, ResNetConfig

# the vision models' expected leaves are read off a model built on the CPU
_VISION = {MLPConfig: MLP, ConvNetConfig: ConvNet, ResNetConfig: ResNet}


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr).copy())


def from_jax_params(tree: dict, cfg, *, batch_stats: dict | None = None
                    ) -> dict[str, torch.Tensor]:
    """Map a flax params tree of any registry model (``cfg`` is its port
    config) onto the port module's state dict (CPU tensors;
    ``load_state_dict`` copies them to the model's device).  For ResNet,
    ``batch_stats`` (flax's running averages) adds the BatchNorm buffers.
    Raises on a missing, unexpected or misshapen leaf."""
    state = _named(tree)
    expected, buffers = _expected(cfg)
    _check_leaves(state, expected, cfg)
    if batch_stats is not None:
        stats = _named(batch_stats)
        _check_leaves(stats, buffers, cfg)
        state.update(stats)
    return state


def _named(tree: dict) -> dict[str, torch.Tensor]:
    return {re.sub(r"^layer_(\d+)/", r"layers.\1/", path).replace("/", "."):
            _to_tensor(arr) for path, arr in _flatten(tree).items()}


def _check_leaves(state: dict, expected: dict, cfg) -> None:
    missing = sorted(set(expected) - set(state))
    extra = sorted(set(state) - set(expected))
    if missing or extra:
        raise ValueError(f"params tree does not match {cfg}: missing "
                         f"{missing[:4]}, unexpected {extra[:4]}")
    for name, shape in expected.items():
        if tuple(state[name].shape) != shape:
            raise ValueError(f"{name}: shape {tuple(state[name].shape)}, "
                             f"expected {shape}")


def _expected(cfg) -> tuple[dict[str, tuple], dict[str, tuple]]:
    """(parameter shapes, buffer shapes) by state-dict name."""
    if isinstance(cfg, BertConfig):
        return _bert_expected_shapes(cfg), {}
    if isinstance(cfg, LlamaConfig):
        return _expected_shapes(cfg), {}
    if type(cfg) not in _VISION:
        raise TypeError(f"no weight mapping for {type(cfg).__name__}")
    model = _VISION[type(cfg)](cfg, device="cpu")
    return ({n: tuple(p.shape) for n, p in model.named_parameters()},
            {n: tuple(b.shape) for n, b in model.named_buffers()})


def _expected_shapes(cfg: LlamaConfig) -> dict[str, tuple]:
    h, hd, f = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    e = cfg.moe_experts
    shapes = {"tok_embeddings.embedding": (cfg.vocab_size, h),
              "final_norm.scale": (h,)}
    moe = moe_layers(cfg)
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        shapes.update({
            p + "attention_norm.scale": (h,),
            p + "ffn_norm.scale": (h,),
            p + "attention.q.kernel": (h, cfg.num_heads, hd),
            p + "attention.k.kernel": (h, cfg.num_kv_heads, hd),
            p + "attention.v.kernel": (h, cfg.num_kv_heads, hd),
            p + "attention.o.kernel": (cfg.num_heads * hd, h),
        })
        if i in moe:   # an MoE block has no gate/up/down
            shapes.update({p + "moe.router.kernel": (h, e),
                           p + "moe.router.bias": (e,),
                           p + "moe.w_in": (e, h, f),
                           p + "moe.w_out": (e, f, h)})
        else:
            shapes.update({p + "gate.kernel": (h, f), p + "up.kernel": (h, f),
                           p + "down.kernel": (f, h)})
    return shapes


def _bert_expected_shapes(cfg: BertConfig) -> dict[str, tuple]:
    h, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    heads = (cfg.num_heads, cfg.head_dim)

    def dense(name, n_in, out):
        out = (out,) if isinstance(out, int) else out
        return {f"{name}.kernel": (n_in, *out), f"{name}.bias": out}

    def norm(name):
        return {f"{name}.scale": (h,), f"{name}.bias": (h,)}

    shapes = {"word_embeddings.embedding": (v, h),
              "position_embeddings": (cfg.max_position, h),
              "mlm_bias": (v,),
              **norm("embeddings_ln"), **norm("mlm_ln"),
              **dense("pooler", h, h), **dense("mlm_transform", h, h),
              **dense("nsp", h, 2)}
    if cfg.type_vocab_size:
        shapes["token_type_embeddings"] = (cfg.type_vocab_size, h)
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        for name in ("query", "key", "value"):
            shapes.update(dense(p + "attention." + name, h, heads))
        shapes.update(dense(p + "attention.out", h, h))
        shapes.update(dense(p + "intermediate", h, f))
        shapes.update(dense(p + "output", f, h))
        shapes.update(norm(p + "attention_ln"))
        shapes.update(norm(p + "output_ln"))
    return shapes
