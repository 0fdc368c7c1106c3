"""BERT encoder (base / large): the platform's flagship pretraining model.

Counterpart of ``kubeflow_tpu/models/bert.py``: bf16 activations and
products, float32 parameters, softmax and LayerNorm statistics; an
encoder of post-LN layers with tanh-approximate GELU; a tied MLM decoder
plus ``mlm_bias``, and the pooler and NSP heads.  Parameter names and
layouts follow the flax tree (``layers.3.attention.query.kernel`` is
``layer_3/attention/query/kernel``; ``models/convert.py``).

``remat`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``, non-reentrant), as the reference's
``nn.remat``, so a layer's forward runs twice per training step.  The
reference's sharding hints (``shard_activation``, ``replicate``) drop out
on one device.  Unmasked self-attention with ``use_flash`` runs the flash
kernels (``ops/flash_attention.py``) forward and backward.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch.device import dtype_of, resolve
from kubeflow_tpu_torch.models import layers as kl
from kubeflow_tpu_torch.models.mlp import label_log_probs
from kubeflow_tpu_torch.ops.attention import (
    dot_product_attention, recompute_context, sequence_offset)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: str = "bfloat16"
    remat: bool = True
    use_flash: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return dtype_of(self.dtype)


def bert_base(**kw) -> BertConfig:
    return BertConfig(**kw)


def bert_large(**kw) -> BertConfig:
    return BertConfig(hidden_size=1024, num_layers=24, num_heads=16,
                      intermediate_size=4096, **kw)


def bert_tiny(**kw) -> BertConfig:
    """For tests and CPU dry runs."""
    kw.setdefault("use_flash", False)
    return BertConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                      num_heads=4, intermediate_size=128, max_position=128,
                      **kw)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, *, device):
        super().__init__()
        self.cfg = cfg
        kw = dict(use_bias=True, dtype=cfg.torch_dtype, device=device)
        heads = (cfg.num_heads, cfg.head_dim)
        names = ("embed", "heads", "kv")
        self.query = kl.DenseGeneral(cfg.hidden_size, heads,
                                     axis_names=names, **kw)
        self.key = kl.DenseGeneral(cfg.hidden_size, heads, axis_names=names,
                                   **kw)
        self.value = kl.DenseGeneral(cfg.hidden_size, heads,
                                     axis_names=names, **kw)
        self.out = kl.DenseGeneral(cfg.hidden_size, cfg.hidden_size,
                                   axis_names=("heads", "embed"), **kw)

    def forward(self, x, mask):
        cfg = self.cfg
        q, k, v = self.query(x), self.key(x), self.value(x)
        out = dot_product_attention(q, k, v, mask=mask,
                                    use_flash=cfg.use_flash and mask is None)
        # this rank's heads under tensor parallelism (all of them without)
        return self.out(out.reshape(out.shape[:-2] + (-1,)))


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, *, device):
        super().__init__()
        kw = dict(use_bias=True, dtype=cfg.torch_dtype, device=device)
        eps = cfg.layer_norm_eps
        self.attention = BertSelfAttention(cfg, device=device)
        self.attention_ln = kl.LayerNorm(cfg.hidden_size, eps, device=device)
        self.intermediate = kl.DenseGeneral(cfg.hidden_size,
                                            cfg.intermediate_size,
                                            axis_names=("embed", "mlp"), **kw)
        self.output = kl.DenseGeneral(cfg.intermediate_size,
                                      cfg.hidden_size,
                                      axis_names=("mlp", "embed"), **kw)
        self.output_ln = kl.LayerNorm(cfg.hidden_size, eps, device=device)

    def forward(self, x, mask):
        x = self.attention_ln(x + self.attention(x, mask))
        h = F.gelu(self.intermediate(x), approximate="tanh")
        return self.output_ln(x + self.output(h))


class BertModel(nn.Module):
    """Encoder + tied MLM head + NSP head.

    ``model(input_ids, token_type_ids, attention_mask, masked_positions)``
    -> {"logits": [B, S|P, V] float32, "pooled": [B, H],
        "nsp_logits": [B, 2] float32}
    """

    def __init__(self, config: BertConfig, *, device=None):
        super().__init__()
        self.config = cfg = config
        device = resolve(device)
        dt, h, eps = cfg.torch_dtype, cfg.hidden_size, cfg.layer_norm_eps
        kw = dict(use_bias=True, dtype=dt, device=device)
        self.word_embeddings = kl.Embed(cfg.vocab_size, h, dtype=dt,
                                        device=device)
        self.position_embeddings = kl.param((cfg.max_position, h),
                                            torch.float32, device,
                                            (None, "embed"))
        self.token_type_embeddings = (
            kl.param((cfg.type_vocab_size, h), torch.float32, device,
                     (None, "embed"))
            if cfg.type_vocab_size else None)
        self.embeddings_ln = kl.LayerNorm(h, eps, device=device)
        self.layers = nn.ModuleList(BertLayer(cfg, device=device)
                                    for _ in range(cfg.num_layers))
        head = ("embed", None)
        self.pooler = kl.DenseGeneral(h, h, axis_names=head, **kw)
        self.mlm_transform = kl.DenseGeneral(h, h, axis_names=head, **kw)
        self.mlm_ln = kl.LayerNorm(h, eps, device=device)
        self.mlm_bias = kl.param((cfg.vocab_size,), torch.float32, device,
                                 ("vocab",))
        self.nsp = kl.DenseGeneral(h, 2, axis_names=head, **kw)

    @property
    def device(self) -> torch.device:
        return self.mlm_bias.device

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "BertModel":
        """Seeded random init on the model's device (flax's initializers:
        lecun-normal kernels, normal(0.02) embedding tables, zero biases,
        unit LayerNorm scales)."""
        gen = kl.init_submodules(self, seed)
        kl.embed_normal_(self.position_embeddings, gen)
        if self.token_type_embeddings is not None:
            kl.embed_normal_(self.token_type_embeddings, gen)
        nn.init.zeros_(self.mlm_bias)
        return self

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_positions=None) -> dict:
        """``masked_positions``: optional [B, P] indices; the MLM head then
        runs only on those positions (logits [B, P, V])."""
        cfg = self.config
        dt = cfg.torch_dtype
        s = input_ids.shape[1]
        x = self.word_embeddings(input_ids)
        # under sequence parallelism this rank's chunk holds positions
        # [off, off + s) of the sequence
        off = sequence_offset(s)
        x = x + kl.weight(self.position_embeddings, dt)[off:off + s][None]
        if self.token_type_embeddings is not None:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            x = x + kl.weight(self.token_type_embeddings, dt)[token_type_ids]
        x = self.embeddings_ln(x)

        mask = None
        if attention_mask is not None:   # [B, S] -> [B, 1, 1, S] boolean
            mask = attention_mask[:, None, None, :].bool()
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in self.layers:
            x = (checkpoint(layer, x, mask, use_reentrant=False,
                            context_fn=recompute_context) if remat
                 else layer(x, mask))

        # x[:, 0] is the CLS token only on sp rank 0; elsewhere the pooler
        # reads another token, which the MLM loss never reaches (its
        # gradient is 0 there, as in the reference)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        h = x
        if masked_positions is not None:
            h = h.gather(1, masked_positions[..., None].expand(
                -1, -1, h.shape[-1]))
        h = F.gelu(self.mlm_transform(h), approximate="tanh")
        h = self.mlm_ln(h)
        logits = self.word_embeddings.attend(h) + self.mlm_bias
        return {"logits": logits, "pooled": pooled,
                "nsp_logits": self.nsp(pooled).float()}


def mlm_loss(outputs: dict, labels: torch.Tensor,
             label_weights: torch.Tensor, vocab=None) -> torch.Tensor:
    """Masked-LM cross entropy; labels -100 or weight 0 positions
    ignored (labels are clipped into the vocabulary, as the reference).
    ``vocab``: the logits' tensor-parallel vocabulary split
    (``mlp.label_log_probs``)."""
    logits = outputs["logits"]
    n = logits.shape[-1]
    if vocab is not None:
        labels_safe = labels.long().clamp(0, n * vocab.size - 1)
        nll = -label_log_probs(logits, labels_safe, vocab).reshape(-1)
    else:
        labels_safe = labels.long().clamp(0, n - 1)
        nll = F.cross_entropy(logits.reshape(-1, n).float(),
                              labels_safe.reshape(-1), reduction="none")
    weights = label_weights.float().reshape(-1)
    return (nll * weights).sum() / weights.sum().clamp_min(1.0)
