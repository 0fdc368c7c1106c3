"""Draft-model speculation: a truncated target model as the drafter.

Counterpart of ``kubeflow_tpu/serving/draft_model.py``.  The n-gram
drafter (``serving/speculative.py``) is free but fires only on text that
repeats itself; this drafter is the target's first ``num_layers`` decoder
blocks with the target's own embedding (tied head) and final norm, the
self-speculative observation of Zhang et al. (2023), "Draft & Verify".
``truncate`` builds it from the SAME modules, so it holds the target's
``nn.Parameter``s and adds no weight memory (a copy of four 7B layers and
the embedding would be ~2 GB; of the whole target, 13.5 GB).

The drafter is greedy and autoregressive over its own batch-1 contiguous
KV cache.  The engine re-drafts each round with the previous round's
tokens as a prefix (generated text is append-only), so the cache is kept
incrementally: an LRU map (``max_entries``) from consumed-token prefixes
to caches, so a round pays one bucketed suffix prefill
(``EXTEND_BUCKETS``) plus one token-at-a-time scan.  Caches are updated in
place; an extension moves its ancestor's cache to the longer key, and
positions past a key's length (pad, or the last scan's drafts) are
rewritten by the next extension before any query reads them.

Cost model: the engine's speculation arbiter charges ``cost_per_token``
scan-step units per planned draft token before drafting; the default is
``0.5 * num_layers / target_layers``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from kubeflow_tpu_torch.models.llama import LlamaModel, init_cache

# suffix prefill buckets, sized for per-round extensions (a round extends
# by accepted + 1 tokens; the first call pays the prompt)
EXTEND_BUCKETS = (8, 16, 32, 64, 128, 256, 512)


def truncate(model: LlamaModel, num_layers: int) -> LlamaModel:
    """A ``num_layers``-deep ``LlamaModel`` over the target's first
    ``num_layers`` blocks, its embedding and its final norm: the same
    modules, hence the same parameters, never a copy.  A depth outside
    ``(0, target depth]`` raises ``ValueError``."""
    target = model.config
    if not 0 < num_layers <= target.num_layers:
        raise ValueError(f"draft depth {num_layers} outside target depth "
                         f"{target.num_layers}")
    draft = LlamaModel.__new__(LlamaModel)
    nn.Module.__init__(draft)
    draft.config = dataclasses.replace(target, num_layers=num_layers,
                                       remat=False)
    draft.tok_embeddings = model.tok_embeddings
    draft.layers = nn.ModuleList(list(model.layers[:num_layers]))
    draft.final_norm = model.final_norm
    return draft


class DraftModel:
    """Callable drafter over a truncated target: the engine's
    ``draft_fn(tokens, max_tokens) -> list[int]``, plus the
    ``cost_per_token`` the arbiter's pre-gate reads."""

    def __init__(self, model: LlamaModel, num_layers: int = 1,
                 max_entries: int = 8, cost_per_token: float | None = None):
        self.model = truncate(model, num_layers)
        self.cfg = self.model.config
        self.device = model.device
        self.seq_cap = int(model.config.max_seq_len)
        self.max_entries = max(1, int(max_entries))
        self.cost_per_token = (
            0.5 * num_layers / max(1, model.config.num_layers)
            if cost_per_token is None else float(cost_per_token))
        # consumed-token prefix -> (cache, next greedy token); insertion
        # order doubles as LRU order (re-stores move to the back)
        self._ctx: dict[tuple, tuple] = {}

    # -- forwards --------------------------------------------------------------
    def _extend(self, cache: dict, suffix: tuple, s_pad: int, start: int,
                true_len: int) -> tuple[dict, int]:
        """Run the right-padded suffix through the cache from ``start``;
        return the cache at index ``true_len`` and the greedy token after
        position ``true_len - 1``."""
        ids = torch.tensor([list(suffix) + [0] * (s_pad - len(suffix))],
                           dtype=torch.int64, device=self.device)
        out = self.model(ids, cache={"layers": [
            dict(l, index=start) for l in cache["layers"]]})
        tok = int(out["logits"][0, true_len - 1 - start].argmax())
        return {"layers": [dict(l, index=true_len)
                           for l in cache["layers"]]}, tok

    def _scan(self, cache: dict, tok: int, pos: int, n: int) -> list[int]:
        """``n`` greedy decode steps from ``tok`` (the first draft token,
        at position ``pos``), returning the follow-on tokens (one host
        sync)."""
        cur = torch.tensor([[tok]], dtype=torch.int64, device=self.device)
        toks = []
        for i in range(n):
            out = self.model(cur, cache={"layers": [
                dict(l, index=pos + i) for l in cache["layers"]]})
            cur = out["logits"][:, -1].argmax(dim=-1, keepdim=True)
            toks.append(cur)
        return torch.cat(toks).flatten().tolist()

    # -- incremental context ---------------------------------------------------
    def _lookup(self, toks: tuple):
        """Longest stored prefix of ``toks`` (possibly ``toks`` itself)."""
        best, best_len = None, -1
        for key in self._ctx:
            n = len(key)
            if best_len < n <= len(toks) and toks[:n] == key:
                best, best_len = key, n
        return best

    def _store(self, toks: tuple, cache, tok, drop: tuple | None) -> None:
        if drop is not None:
            # the ancestor's cache now belongs to ``toks``
            self._ctx.pop(drop, None)
        self._ctx.pop(toks, None)
        self._ctx[toks] = (cache, tok)
        while len(self._ctx) > self.max_entries:
            self._ctx.pop(next(iter(self._ctx)))

    def reset(self) -> None:
        self._ctx.clear()

    # -- drafting --------------------------------------------------------------
    def __call__(self, tokens, max_tokens: int) -> list[int]:
        return self.draft(tokens, max_tokens)

    @torch.no_grad()
    def draft(self, tokens, max_tokens: int) -> list[int]:
        toks = tuple(int(t) for t in tokens)
        limit = min(int(max_tokens), self.seq_cap - len(toks))
        if not toks or limit <= 0:
            return []
        key = self._lookup(toks)
        if key is not None and len(key) == len(toks):
            cache, tok = self._ctx[key]
        else:
            if key is None:
                cache = init_cache(self.cfg, 1, self.seq_cap,
                                   device=self.device)
                start = 0
            else:
                cache, _ = self._ctx[key]
                start = len(key)
            suffix = toks[start:]
            # a bucket qualifies only if the padded write still fits the
            # cache; otherwise the suffix runs at its exact length
            fit = self.seq_cap - start
            s_pad = next((b for b in EXTEND_BUCKETS
                          if len(suffix) <= b <= fit), len(suffix))
            cache, tok = self._extend(cache, suffix, s_pad, start, len(toks))
            self._store(toks, cache, tok, drop=key)
        out = [tok]
        if limit > 1:
            out.extend(self._scan(cache, tok, len(toks), limit - 1))
        return out[:limit]
