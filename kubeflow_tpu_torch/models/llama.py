"""Llama-2 style decoder: the text-generation serving model.

Counterpart of ``kubeflow_tpu/models/llama.py`` (Llama-2-7B is
BASELINE.json configs[4]): RoPE, GQA, SwiGLU, RMSNorm, a tied LM head,
a contiguous KV cache and a paged one.  Four attention branches:

- no cache: causal self-attention, through the flash kernel when
  ``use_flash``;
- cache with a scalar ``index`` (a prefill from position ``start``: the
  serving engine's batch-1 chunks, and ``serving/multihost.py``'s padded
  rows from 0): the new K/V are written at ``[start, start+s)`` and the
  queries attend to ``cache[:, :start+s]`` causally, which is the flash
  kernel's contract (offset ``sk - sq = start``).  Padded tail queries sit
  after every real one, so causality hides them from the real rows;
- cache with a ``[B]`` index (decode, ragged rows): each row writes at its
  own position and attends through a position mask (plain attention);
- paged cache (``pool_k``/``pool_v`` ``[N, page, Hkv, D]`` per layer from
  ``init_kv_pool``, a ``[B, P]`` page table ``pages`` and a ``[B]``
  ``index``): each token's k/v is scattered into (page, offset) of its
  absolute position clamped to the table's span, and the queries attend
  over the logical ``[B, P * page]`` view gathered through the table,
  under a position mask (plain attention).  Pages shared between rows are
  read in place.

Every cache is updated IN PLACE (the reference's functional update
returns a new array; here the returned cache holds the same tensors),
which keeps the serving engine's KV view, prefill scratch and page pool
from being copied per step.

With ``moe_experts`` > 0, every ``moe_every``-th block (``i % moe_every ==
0``) replaces its SwiGLU FFN with a top-2 ``MoEBlock``
(``models/moe.py``): dropless when a cache is present (serving), the
capacity formulation otherwise (training).  The output gains
``moe_aux``, the blocks' load-balance losses averaged over the MoE
layers.

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
from kubeflow_tpu_torch.models.moe import MoEBlock, MoEConfig
from kubeflow_tpu_torch.ops.attention import (
    dot_product_attention, recompute_context, sequence_offset)


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
    moe_experts: int = 0    # > 0: every moe_every-th block is an MoE block
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
    it, so the attention dispatcher runs its prefill and training on the
    plain route)."""
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
        heads = ("embed", "heads", "kv")
        self.q = kl.DenseGeneral(cfg.hidden_size, (cfg.num_heads, hd),
                                 axis_names=heads, **kw)
        self.k = kl.DenseGeneral(cfg.hidden_size, (cfg.num_kv_heads, hd),
                                 axis_names=heads, **kw)
        self.v = kl.DenseGeneral(cfg.hidden_size, (cfg.num_kv_heads, hd),
                                 axis_names=heads, **kw)
        self.o = kl.DenseGeneral(cfg.num_heads * hd, cfg.hidden_size,
                                 axis_names=("heads", "embed"), **kw)

    def forward(self, x, positions, cache=None, attn_mask=None):
        cfg = self.cfg
        q = kl.rotary_embedding(self.q(x), positions, cfg.rope_base)
        k = kl.rotary_embedding(self.k(x), positions, cfg.rope_base)
        v = self.v(x)
        if cache is not None and "pages" in cache:
            out, cache = self._paged(q, k, v, positions, cache)
        elif cache is not None:
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
                    # index (start clamped like dynamic_update_slice), one
                    # scatter for every row
                    start = idx.clamp(0, ck.shape[1] - s)
                    cols = start[:, None] + torch.arange(s, device=x.device)
                    ck[rows[:, None], cols] = k
                    cv[rows[:, None], cols] = v
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
        # this rank's heads under tensor parallelism (all of them without)
        out = out.reshape(out.shape[:-2] + (-1,))
        return self.o(out), cache

    @staticmethod
    def _paged(q, k, v, positions, cache):
        """The paged branch: writes this step's k/v into the pool IN PLACE
        and attends over the page table's logical view."""
        pool_k, pool_v = cache["pool_k"], cache["pool_v"]
        pages, idx = cache["pages"], cache["index"]
        page = pool_k.shape[1]
        b, s = q.shape[0], q.shape[1]
        span = pages.shape[1] * page
        # absolute positions, clamped so frozen or overshooting rows stay
        # in their table; such writes are re-written before any query
        # attends to them
        pos = (idx[:, None] + torch.arange(s, device=q.device)[None, :]
               ).clamp(0, span - 1)
        pg = torch.gather(pages, 1, pos // page)
        off = pos % page
        pool_k[pg, off] = k.to(pool_k.dtype)
        pool_v[pg, off] = v.to(pool_v.dtype)
        ck = pool_k[pages].reshape(b, span, *pool_k.shape[2:])
        cv = pool_v[pages].reshape(b, span, *pool_v.shape[2:])
        pos_k = torch.arange(span, device=q.device)
        valid = pos_k[None, None, None, :] <= positions[:, None, :, None]
        out = dot_product_attention(q, ck, cv, mask=valid)
        return out, {"pool_k": pool_k, "pool_v": pool_v, "pages": pages,
                     "index": idx + s}


class LlamaBlock(nn.Module):
    """Attention and FFN with pre-norms; ``use_moe`` swaps the SwiGLU FFN
    for a top-2 ``MoEBlock``.  Returns ``(x, cache, aux)``: ``aux`` is the
    MoE block's load-balance loss, None for a dense block."""

    def __init__(self, cfg: LlamaConfig, *, use_moe: bool = False,
                 param_dtype, device):
        super().__init__()
        dt = cfg.torch_dtype
        kw = dict(dtype=dt, param_dtype=param_dtype, device=device)
        nkw = dict(param_dtype=param_dtype, device=device)
        self.use_moe = use_moe
        self.attention_norm = kl.RMSNorm(cfg.hidden_size, cfg.rms_eps, **nkw)
        self.attention = LlamaAttention(cfg, param_dtype=param_dtype,
                                        device=device)
        self.ffn_norm = kl.RMSNorm(cfg.hidden_size, cfg.rms_eps, **nkw)
        if use_moe:
            self.moe = MoEBlock(MoEConfig(
                hidden_size=cfg.hidden_size, ffn_size=cfg.intermediate_size,
                num_experts=cfg.moe_experts, dtype=cfg.dtype),
                param_dtype=param_dtype, device=device)
        else:
            mlp = ("embed", "mlp")
            self.gate = kl.DenseGeneral(cfg.hidden_size,
                                        cfg.intermediate_size,
                                        axis_names=mlp, **kw)
            self.up = kl.DenseGeneral(cfg.hidden_size, cfg.intermediate_size,
                                      axis_names=mlp, **kw)
            self.down = kl.DenseGeneral(cfg.intermediate_size,
                                        cfg.hidden_size,
                                        axis_names=("mlp", "embed"), **kw)

    def forward(self, x, positions, cache=None, attn_mask=None):
        h, cache = self.attention(self.attention_norm(x), positions, cache,
                                  attn_mask)
        x = x + h
        y = self.ffn_norm(x)
        if self.use_moe:
            # serving (a cache) routes dropless, so a request's logits do
            # not depend on padding or co-batched rows; training keeps the
            # capacity formulation
            y, aux = self.moe(y, dropless=cache is not None)
            return x + y, cache, aux
        y = self.down(F.silu(self.gate(y)) * self.up(y))
        return x + y, cache, None


class LlamaModel(nn.Module):
    """Decoder-only LM.

    Prefill: ``model(ids)`` -> {"logits": [B, S, V]} (float32).
    With a cache (``init_cache``): {"logits", "cache"}.
    """

    def __init__(self, config: LlamaConfig, *, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        self.config = config
        # "meta": the structure without storage, which the predictor's
        # loader fills one tensor at a time; every other device resolves
        if device is None or torch.device(device).type != "meta":
            device = resolve(device)
        self.tok_embeddings = kl.Embed(config.vocab_size, config.hidden_size,
                                       dtype=config.torch_dtype,
                                       param_dtype=param_dtype, device=device)
        self.layers = nn.ModuleList(
            LlamaBlock(config, use_moe=i in moe_layers(config),
                       param_dtype=param_dtype, device=device)
            for i in range(config.num_layers))
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
            # under sequence parallelism this rank's chunk starts at its
            # global position, so RoPE sees global positions
            start = (sequence_offset(s) if cache is None
                     else cache["layers"][0]["index"])
            steps = torch.arange(s, device=input_ids.device)
            if isinstance(start, int):
                positions = (start + steps)[None, :].expand(b, s)
            else:  # [B] per-sequence positions
                positions = start[:, None] + steps[None, :]
        x = self.tok_embeddings(input_ids)
        remat = (self.config.remat and cache is None
                 and torch.is_grad_enabled())
        new_cache, auxes = [], []
        for i, block in enumerate(self.layers):
            layer_cache = None if cache is None else cache["layers"][i]
            if remat:
                # the recomputed forward routes exactly as the first did
                x, layer_cache, aux = checkpoint(
                    block, x, positions, None, attn_mask, use_reentrant=False,
                    context_fn=recompute_context)
            else:
                x, layer_cache, aux = block(x, positions, layer_cache,
                                            attn_mask)
            new_cache.append(layer_cache)
            if aux is not None:
                auxes.append(aux)
        x = self.final_norm(x)
        out = {"logits": self.tok_embeddings.attend(x)}
        if self.config.moe_experts > 0:
            # depth-normalised, so the loss coefficient does not depend on
            # how many layers are MoE
            out["moe_aux"] = sum(auxes) / len(auxes)
        if cache is not None:
            out["cache"] = {"layers": new_cache}
        return out


def moe_layers(cfg: LlamaConfig) -> set[int]:
    """Indices of the MoE blocks: every ``moe_every``-th from layer 0."""
    if cfg.moe_experts <= 0:
        return set()
    every = max(cfg.moe_every, 1)
    return {i for i in range(cfg.num_layers) if i % every == 0}


def init_kv_pool(cfg: LlamaConfig, num_pages: int, page_size: int, *,
                 device=None, quantized: bool = False):
    """Per-layer paged KV pool: ``[num_pages, page_size, Hkv, D]`` k and v
    tensors in the model dtype, addressed through page tables (page 0 is
    the null page).  Callers attach ``pages``/``index`` per layer at
    dispatch time, as ``init_cache`` callers attach ``index``.

    ``quantized``: the store of int8 pages (``serving/quant.py``), four
    tensors per layer under the reference's page-tree keys: ``k``/``v``
    int8 ``[num_pages, page_size, Hkv, D]`` and ``ks``/``vs`` float32
    ``[num_pages, 1, Hkv, 1]``, one scale per (page, kv head).  Only the
    engine's commit and seed read it; the paged attention branch takes
    the model-dtype store."""
    device = resolve(device)
    shape = (num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    if quantized:
        scale = (num_pages, 1, cfg.num_kv_heads, 1)
        return {"layers": [
            {"k": torch.zeros(shape, dtype=torch.int8, device=device),
             "ks": torch.ones(scale, dtype=torch.float32, device=device),
             "v": torch.zeros(shape, dtype=torch.int8, device=device),
             "vs": torch.ones(scale, dtype=torch.float32, device=device)}
            for _ in range(cfg.num_layers)]}
    dt = cfg.torch_dtype
    return {"layers": [
        {"k": torch.zeros(shape, dtype=dt, device=device),
         "v": torch.zeros(shape, dtype=dt, device=device)}
        for _ in range(cfg.num_layers)]}


def kv_page_nbytes(cfg: LlamaConfig, page_size: int) -> int:
    """Device bytes one page id covers across every layer (k and v)."""
    itemsize = torch.empty((), dtype=cfg.torch_dtype).element_size()
    return (2 * cfg.num_layers * page_size * cfg.num_kv_heads
            * cfg.head_dim * itemsize)


def init_cache(cfg: LlamaConfig, batch: int, max_len: int | None = None,
               per_sequence: bool = False, *, device=None, tp: int = 1):
    """Contiguous KV cache ``[B, max_len, Hkv / tp, D]`` per layer: with
    ``tp`` > 1, a tensor-parallel rank's KV heads.  The index is a Python
    int (equal-length rows) or, with ``per_sequence``, a ``[B]`` int64
    tensor so each row sits at its own length."""
    if cfg.num_kv_heads % tp:
        raise ValueError(
            f"num_kv_heads={cfg.num_kv_heads} not divisible by tp={tp}")
    device = resolve(device)
    max_len = max_len or cfg.max_seq_len
    dtype = cfg.torch_dtype
    index = (torch.zeros((batch,), dtype=torch.int64, device=device)
             if per_sequence else 0)
    shape = (batch, max_len, cfg.num_kv_heads // tp, cfg.head_dim)
    return {"layers": [
        {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device),
         "index": index}
        for _ in range(cfg.num_layers)]}
