"""Llama-2 style decoder: the text-generation serving model.

Counterpart of ``kubeflow_tpu/models/llama.py`` (Llama-2-7B is
BASELINE.json configs[4]): RoPE, GQA, SwiGLU, RMSNorm, a tied LM head,
and a contiguous KV cache.  Three attention branches:

- no cache: causal self-attention, through the flash kernel when
  ``use_flash``;
- cache with a scalar ``index`` (the serving engine's batch-1 prefill from
  position ``start``): the new K/V are written at ``[start, start+s)`` and
  the queries attend to ``cache[:, :start+s]`` causally, which is the flash
  kernel's contract (offset ``sk - sq = start``).  Padded tail queries sit
  after every real one, so causality hides them from the real rows;
- cache with a ``[B]`` index (decode, ragged rows): each row writes at its
  own position and attends through a position mask (plain attention).

The cache is updated IN PLACE (the reference's functional update returns
a new array; here the returned cache holds the same tensors), which keeps
the serving engine's KV view and prefill scratch from being copied per
step.  The paged branch and MoE layers are not yet ported and raise.

Training (no cache, grad enabled) runs each block under
``torch.utils.checkpoint`` (non-reentrant) when ``remat`` is on, as the
reference's ``nn.remat``: a block's forward, the flash kernel's included,
runs again in the backward pass.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch.device import dtype_of, resolve
from kubeflow_tpu_torch.models import layers as kl
from kubeflow_tpu_torch.ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    intermediate_size: int = 11008
    max_seq_len: int = 4096
    rope_base: float = 10000.0
    rms_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: bool = True
    use_flash: bool = True
    moe_experts: int = 0    # MoE layers: not yet ported (raises)
    moe_every: int = 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return dtype_of(self.dtype)


def llama2_7b(**kw) -> LlamaConfig:
    return LlamaConfig(**kw)


def llama2_13b(**kw) -> LlamaConfig:
    return LlamaConfig(hidden_size=5120, num_layers=40, num_heads=40,
                       num_kv_heads=40, intermediate_size=13824, **kw)


def llama_3b(**kw) -> LlamaConfig:
    """OpenLLaMA-3B shape (head_dim 100: the flash kernel is not built for
    it, so its prefill raises on CUDA until a kernel instantiation lands)."""
    return LlamaConfig(hidden_size=3200, num_layers=26, num_heads=32,
                       num_kv_heads=32, intermediate_size=8640, **kw)


def llama_tiny(**kw) -> LlamaConfig:
    kw.setdefault("use_flash", False)
    return LlamaConfig(vocab_size=512, hidden_size=64, num_layers=2,
                       num_heads=4, num_kv_heads=2, intermediate_size=128,
                       max_seq_len=128, **kw)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, param_dtype, device):
        super().__init__()
        self.cfg = cfg
        dt = cfg.torch_dtype
        kw = dict(dtype=dt, param_dtype=param_dtype, device=device)
        hd = cfg.head_dim
        self.q = kl.DenseGeneral(cfg.hidden_size, (cfg.num_heads, hd), **kw)
        self.k = kl.DenseGeneral(cfg.hidden_size, (cfg.num_kv_heads, hd),
                                 **kw)
        self.v = kl.DenseGeneral(cfg.hidden_size, (cfg.num_kv_heads, hd),
                                 **kw)
        self.o = kl.DenseGeneral(cfg.num_heads * hd, cfg.hidden_size, **kw)

    def forward(self, x, positions, cache=None, attn_mask=None):
        cfg = self.cfg
        q = kl.rotary_embedding(self.q(x), positions, cfg.rope_base)
        k = kl.rotary_embedding(self.k(x), positions, cfg.rope_base)
        v = self.v(x)
        if cache is not None and "pages" in cache:
            raise NotImplementedError(
                "the paged KV cache branch is not yet ported")
        if cache is not None:
            ck, cv, idx = cache["k"], cache["v"], cache["index"]
            s = x.shape[1]
            k = k.to(ck.dtype)
            v = v.to(cv.dtype)
            if isinstance(idx, int):
                if idx < 0 or idx + s > ck.shape[1]:
                    raise ValueError(f"cache write [{idx}, {idx + s}) is "
                                     f"outside [0, {ck.shape[1]})")
                ck[:, idx:idx + s] = k
                cv[:, idx:idx + s] = v
                # the batch-1 scratch slice stays contiguous: no copy
                out = dot_product_attention(
                    q, ck[:, :idx + s], cv[:, :idx + s], causal=True,
                    use_flash=cfg.use_flash)
            else:
                rows = torch.arange(x.shape[0], device=x.device)
                if s == 1:
                    # clamped so frozen/finished rows never write out of
                    # bounds
                    write = idx.clamp(0, ck.shape[1] - 1)
                    ck[rows, write] = k[:, 0]
                    cv[rows, write] = v[:, 0]
                else:
                    # ragged multi-token write: row b's block at its own
                    # index (start clamped like dynamic_update_slice)
                    starts = idx.clamp(0, ck.shape[1] - s).tolist()
                    for b, st in enumerate(starts):
                        ck[b, st:st + s] = k[b]
                        cv[b, st:st + s] = v[b]
                # key slot j is visible to the query at absolute position
                # p iff j <= p (also hides never-written slots)
                pos_k = torch.arange(ck.shape[1], device=x.device)
                valid = pos_k[None, None, None, :] <= positions[:, None, :,
                                                               None]
                out = dot_product_attention(q, ck, cv, mask=valid)
            cache = {"k": ck, "v": cv, "index": idx + s}
        else:
            out = dot_product_attention(q, k, v, causal=True, mask=attn_mask,
                                        use_flash=cfg.use_flash)
        out = out.reshape(out.shape[:-2] + (cfg.num_heads * cfg.head_dim,))
        return self.o(out), cache


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, param_dtype, device):
        super().__init__()
        dt = cfg.torch_dtype
        kw = dict(dtype=dt, param_dtype=param_dtype, device=device)
        nkw = dict(param_dtype=param_dtype, device=device)
        self.attention_norm = kl.RMSNorm(cfg.hidden_size, cfg.rms_eps, **nkw)
        self.attention = LlamaAttention(cfg, param_dtype=param_dtype,
                                        device=device)
        self.ffn_norm = kl.RMSNorm(cfg.hidden_size, cfg.rms_eps, **nkw)
        self.gate = kl.DenseGeneral(cfg.hidden_size, cfg.intermediate_size,
                                    **kw)
        self.up = kl.DenseGeneral(cfg.hidden_size, cfg.intermediate_size,
                                  **kw)
        self.down = kl.DenseGeneral(cfg.intermediate_size, cfg.hidden_size,
                                    **kw)

    def forward(self, x, positions, cache=None, attn_mask=None):
        h, cache = self.attention(self.attention_norm(x), positions, cache,
                                  attn_mask)
        x = x + h
        y = self.ffn_norm(x)
        y = self.down(F.silu(self.gate(y)) * self.up(y))
        return x + y, cache


class LlamaModel(nn.Module):
    """Decoder-only LM.

    Prefill: ``model(ids)`` -> {"logits": [B, S, V]} (float32).
    With a cache (``init_cache``): {"logits", "cache"}.
    """

    def __init__(self, config: LlamaConfig, *, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        if config.moe_experts > 0:
            raise NotImplementedError("MoE llama layers are not yet ported")
        self.config = config
        device = resolve(device)
        self.tok_embeddings = kl.Embed(config.vocab_size, config.hidden_size,
                                       dtype=config.torch_dtype,
                                       param_dtype=param_dtype, device=device)
        self.layers = nn.ModuleList(
            LlamaBlock(config, param_dtype=param_dtype, device=device)
            for _ in range(config.num_layers))
        self.final_norm = kl.RMSNorm(config.hidden_size, config.rms_eps,
                                     param_dtype=param_dtype, device=device)

    @property
    def device(self) -> torch.device:
        return self.tok_embeddings.embedding.device

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "LlamaModel":
        """Seeded random init on the model's device (flax's initializers:
        lecun-normal kernels, normal(0.02) embedding, unit norm scales)."""
        kl.init_submodules(self, seed)
        return self

    def forward(self, input_ids, positions=None, cache=None, attn_mask=None):
        b, s = input_ids.shape
        if positions is None:
            start = 0 if cache is None else cache["layers"][0]["index"]
            steps = torch.arange(s, device=input_ids.device)
            if isinstance(start, int):
                positions = (start + steps)[None, :].expand(b, s)
            else:  # [B] per-sequence positions
                positions = start[:, None] + steps[None, :]
        x = self.tok_embeddings(input_ids)
        remat = (self.config.remat and cache is None
                 and torch.is_grad_enabled())
        new_cache = []
        for i, block in enumerate(self.layers):
            layer_cache = None if cache is None else cache["layers"][i]
            if remat:
                x, layer_cache = checkpoint(block, x, positions, None,
                                            attn_mask, use_reentrant=False)
            else:
                x, layer_cache = block(x, positions, layer_cache, attn_mask)
            new_cache.append(layer_cache)
        x = self.final_norm(x)
        out = {"logits": self.tok_embeddings.attend(x)}
        if cache is not None:
            out["cache"] = {"layers": new_cache}
        return out


def init_cache(cfg: LlamaConfig, batch: int, max_len: int | None = None,
               per_sequence: bool = False, *, device=None):
    """Contiguous KV cache ``[B, max_len, Hkv, D]`` per layer.  The index is
    a Python int (equal-length rows) or, with ``per_sequence``, a ``[B]``
    int64 tensor so each row sits at its own length."""
    device = resolve(device)
    max_len = max_len or cfg.max_seq_len
    dtype = cfg.torch_dtype
    index = (torch.zeros((batch,), dtype=torch.int64, device=device)
             if per_sequence else 0)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"layers": [
        {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device),
         "index": index}
        for _ in range(cfg.num_layers)]}
