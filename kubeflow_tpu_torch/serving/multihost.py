"""Multi-host sharded serving: a gang decodes in lockstep.

Counterpart of ``kubeflow_tpu/serving/multihost.py``.  A predictor for a
model bigger than one card shards its weights and KV cache over a global
dp x tp mesh of the gang's ranks (one rank per card): tp minor, so a tp
group's ranks are contiguous (same host, its all-reduces on the fast
links), dp major (weight replicas, independent request rows).

Process model: every rank of the serving gang joins the same rendezvous
a training gang would (``parallel/distributed.py::initialize_from_env``,
the JAXJob controller's env), builds the same mesh, keeps its block of
the same weights (one seed, or one host state dict) and runs the same
decode in lockstep.  This is the synchronous batch API: every rank
presents the same prompts to each ``generate`` call, which a rank-0 front
door gets there with ``broadcast_prompts`` (one collective per batch).
The continuous batcher's gang is ``GenerativePredictor(tp=, ep=)``: rank
0's engine takes the requests and broadcasts a record per step that the
others replay (``serving/lockstep.py``).

A ``generate`` prefills each rank's ``[B / dp, pad_len]`` rows at scalar
cache index 0: every row starts at position 0, so the reference's "key j
visible iff j <= p" is causal attention, which the Llama's scalar-index
branch runs through the flash kernel (K1) at the rank's ``Hq / tp`` and
``Hkv / tp`` heads.  Padded tail positions sit after a row's real ones;
decode overwrites them before any query sees them.  The cache index then
becomes the per-row ``last_pos + 1`` and greedy decode runs the ``[B]``
index branch (plain masked attention).  Each step's logits are gathered
over tp at the positions read (``Embed.whole_vocab``) before ``argmax``,
and the rows' tokens are gathered over dp at the end.  Everything is
deterministic across ranks by construction: weights from one seed or
state, greedy decode, no data-dependent control flow.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from kubeflow_tpu_torch.device import resolve
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.parallel.mesh import Mesh, make_mesh
from kubeflow_tpu_torch.serving import sharded
from kubeflow_tpu_torch.serving.quant import quantize_param
from kubeflow_tpu_torch.utils.logging import get_logger

log = get_logger("serving.multihost")

# decode-batch rows ride dp (one replica per host group); KV heads ride tp,
# as every serving cache's do (``sharded.CACHE_SPEC``)
CACHE_SPEC = ("dp",) + sharded.CACHE_SPEC[1:]


def _world() -> int:
    return pd.world_size(pd.default_group())


def global_serving_mesh(tp: int, dp: int = 1, ep: int = 1, *,
                        device_type: str = "cuda") -> Mesh:
    """A dp x tp (x ep) mesh over the gang's ranks, tp minor (a tp
    group's ranks are contiguous); a gang with fewer ranks is refused
    with the reference's message."""
    n = tp * dp * ep
    have = _world()
    if have < n:
        raise ValueError(f"dp={dp} x tp={tp} x ep={ep} needs {n} devices,"
                         f" have {have} globally")
    return make_mesh(n, dp=dp, fsdp=1, tp=tp, sp=1, ep=ep,
                     device_type=device_type)


def place_global(model: nn.Module, state: dict, mesh: Mesh, *,
                 device: torch.device, quantize: bool = False) -> None:
    """Fill the storage-less ``model`` from a host-replicated ``state``
    (every rank holds the same values: one checkpoint, or
    ``models/convert.py::from_jax_params``) one weight at a time: the
    whole value to ``device`` in the model's dtype, int8-quantized whole
    from it when ``quantize`` asks, and this rank's block kept through
    ``sharded.place_params``'s one rule.  No rank holds more than one
    whole weight at a time."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(state))
    extra = sorted(set(state) - set(params))
    if missing or extra:
        raise ValueError(f"state does not match the model: missing "
                         f"{missing[:4]}, unexpected {extra[:4]}")
    for name, p in params.items():
        prefix, _, leaf = name.rpartition(".")
        owner = model.get_submodule(prefix)
        full = state[name].to(device)
        new = nn.Parameter(full.to(p.dtype), requires_grad=False)
        new.logical_axes = getattr(p, "logical_axes", None)
        owner._parameters[leaf] = new
        if quantize:
            quantize_param(model, name, full)
        sharded.place_params(owner, mesh, names={leaf})


def constrain_cache(cache: dict, mesh: Mesh, *, batch: int,
                    num_kv_heads: int) -> dict:
    """Check that every 4-d leaf of ``cache`` is this rank's
    ``[batch / dp, S, num_kv_heads / tp, D]`` block (``CACHE_SPEC``: rows
    over dp, KV heads over tp); raises ``ValueError`` naming the first
    leaf that is not.  Index tensors and scalars pass.  Returns the
    cache."""
    for i, layer in enumerate(cache["layers"]):
        for key, x in layer.items():
            if getattr(x, "ndim", 0) != 4:
                continue
            block = sharded.cache_block(
                (batch, x.shape[1], num_kv_heads, x.shape[3]), mesh,
                CACHE_SPEC)
            rows, heads = block[0], block[2]
            if (x.shape[0], x.shape[2]) != (rows, heads):
                raise ValueError(
                    f"layers.{i}.{key} is {tuple(x.shape)}, not this "
                    f"rank's [{rows}, S, {heads}, D] block of rows over "
                    f"dp={mesh.shape['dp']} and KV heads over "
                    f"tp={mesh.shape['tp']}")
    return cache


def broadcast_prompts(prompts: list[list[int]] | None,
                      max_items: int = 64,
                      max_len: int = 4096) -> list[list[int]]:
    """Get rank 0's prompts to every rank (the front door's fan-out):
    ranks other than 0 pass None.  Encodes to a fixed-size int32 buffer
    (each row its length, then its tokens) so the collective's shape is
    the same on every rank."""
    buf = torch.full((max_items, max_len + 1), -1, dtype=torch.int32)
    if pd.rank_of(pd.default_group()) == 0:
        if prompts is None:
            raise ValueError("rank 0 must supply prompts")
        if len(prompts) > max_items:
            raise ValueError(f"{len(prompts)} prompts > {max_items}")
        for i, p in enumerate(prompts):
            if len(p) > max_len:
                raise ValueError(f"prompt {i} longer than {max_len}")
            buf[i, 0] = len(p)
            buf[i, 1:1 + len(p)] = torch.tensor(p, dtype=torch.int32)
    out = pd.broadcast_one_to_all(buf).tolist()
    got: list[list[int]] = []
    for row in out:
        n = row[0]
        if n < 0:
            break
        got.append(row[1:1 + n])
    return got


class MultiHostPredictor:
    """Synchronous sharded text generation over a global dp x tp (x ep)
    mesh: a MoE model's experts split over ep, its dropless layers
    summing their partial outputs over tp x ep (``models/moe.py``).

    In one process this is plain decode (the CI reference path); in a
    gang every rank constructs it with the same arguments and calls
    ``generate`` with the same prompts (``broadcast_prompts``).  Weights
    come from ``state`` (a full host state dict, e.g.
    ``models/convert.py::from_jax_params``: each rank keeps its blocks)
    or from a seeded init, identical on every rank and in one process;
    the init makes one weight at a time on the device and keeps only the
    rank's block, so no rank ever holds the whole model.  ``quantize``
    swaps every eligible matmul weight for int8, quantized whole and then
    split (``serving/sharded.py``).  Runs on ``device`` (None: CUDA).

    ``prefill_logits`` holds the last ``generate``'s first-token logits of
    this rank's rows (``rows``), over the whole vocabulary."""

    def __init__(self, model_name: str = "llama", size: str = "tiny",
                 tp: int = 1, dp: int = 1, ep: int = 1,
                 max_seq: int = 128, seed: int = 0,
                 quantize: bool = False,
                 model_config: dict | None = None, *,
                 state: dict[str, torch.Tensor] | None = None,
                 device: str | torch.device | None = None):
        from kubeflow_tpu_torch.models import registry

        self.device = resolve(device)
        entry = registry.get(model_name)
        # the structure without storage; the loader fills it
        self.module = entry.make_model(size=size, device="meta",
                                       param_dtype="compute",
                                       **(model_config or {}))
        self.module.eval()
        self.cfg = self.module.config
        sharded.check_experts(self.cfg, ep)
        self.max_seq = min(max_seq, self.cfg.max_seq_len)
        self.mesh = global_serving_mesh(tp, dp=dp, ep=ep,
                                        device_type=self.device.type)
        self.dp, self.tp = dp, tp
        if self.cfg.num_kv_heads % tp != 0:
            raise ValueError(f"num_kv_heads={self.cfg.num_kv_heads} "
                             f"not divisible by tp={tp}")
        if self.mesh.size != _world():
            raise ValueError(
                f"dp={dp} x tp={tp} x ep={ep} is {self.mesh.size} ranks "
                f"and the gang has {_world()}: every rank serves one "
                "position of the mesh")
        with torch.no_grad():
            if state is not None:
                place_global(self.module, state, self.mesh,
                             device=self.device, quantize=quantize)
            else:
                self._init_weights(seed, quantize)
        self._gen_cache: dict = {}
        self.prefill_logits: torch.Tensor | None = None
        self.rows = slice(0, 0)
        log.info("multi-host predictor ready", processes=_world(),
                 devices=self.mesh.size, dp=dp, tp=tp, ep=ep)

    def _init_weights(self, seed: int, quantize: bool) -> None:
        """flax's initializers from one generator in module order (as
        ``init_weights(seed)``); each submodule is made, quantized when
        asked, and cut to this rank's blocks before the next is made."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for prefix, m in self.module.named_modules():
            if m is self.module or not hasattr(m, "init_weights"):
                continue
            axes = {leaf: getattr(p, "logical_axes", None)
                    for leaf, p in m._parameters.items() if p is not None}
            m.to_empty(device=self.device, recurse=False)
            for leaf, names in axes.items():   # to_empty makes new ones
                m._parameters[leaf].logical_axes = names
            m.init_weights(gen)
            if quantize:
                for leaf in axes:
                    quantize_param(self.module, f"{prefix}.{leaf}")
            sharded.place_params(m, self.mesh, names=set(axes))

    # -- lockstep decode ------------------------------------------------------
    def _bucket_cache(self, batch: int, pad_len: int, max_new: int) -> dict:
        """The rank's preallocated KV cache of bucket ``(batch, pad_len,
        max_new)``: its ``batch / dp`` rows and ``Hkv / tp`` heads, made
        at the bucket's first use and reused by every request it
        serves."""
        key = (batch, pad_len, max_new)
        if key in self._gen_cache:
            return self._gen_cache[key]
        from kubeflow_tpu_torch.models import llama as llama_mod

        max_len = min(self.max_seq, pad_len + max_new)
        cache = llama_mod.init_cache(self.cfg, batch // self.dp,
                                     max_len=max_len, device=self.device,
                                     tp=self.tp)
        self._gen_cache[key] = constrain_cache(
            cache, self.mesh, batch=batch, num_kv_heads=self.cfg.num_kv_heads)
        return self._gen_cache[key]

    @torch.no_grad()
    def _decode(self, cache: dict, ids: np.ndarray, last: np.ndarray,
                max_new: int) -> np.ndarray:
        """Prefill this rank's rows of ``ids`` and decode ``max_new``
        greedy tokens; every row's tokens ``[B, max_new]`` on every
        rank."""
        rows = ids.shape[0] // self.dp
        start = self.mesh.coordinate("dp") * rows
        self.rows = slice(start, start + rows)
        dev = self.device
        mine = torch.as_tensor(ids[self.rows], dtype=torch.long, device=dev)
        pos = torch.as_tensor(last[self.rows], dtype=torch.long, device=dev)
        for layer in cache["layers"]:
            layer["index"] = 0          # every row from position 0: causal
        out = self.module(mine, cache=cache)
        # argmax over the whole vocabulary (a tp rank's own slice would
        # not break ties at the lowest index as the reference does)
        vocab = self.module.tok_embeddings.whole_vocab
        at = out["logits"][torch.arange(rows, device=dev), pos]
        self.prefill_logits = vocab(at)
        tok = self.prefill_logits.argmax(dim=-1)
        del out, at
        index = pos + 1
        toks = [tok]
        for _ in range(max_new - 1):
            for layer in cache["layers"]:
                layer["index"] = index
            step = self.module(tok[:, None], cache=cache)
            tok = vocab(step["logits"][:, 0]).argmax(dim=-1)
            index = index + 1
            toks.append(tok)
        got = torch.stack(toks, dim=1)
        if self.dp > 1:
            got = pd.all_gather_cat(got, 0, self.mesh.group("dp"))
        return got.cpu().numpy()

    def generate(self, prompts: list[list[int]],
                 max_new_tokens: int = 16) -> list[list[int]]:
        """Greedy decode; every rank must pass identical prompts.  Rows
        pad up to a dp multiple (pad rows are dropped from the result);
        rank ``(dp = i)`` takes contiguous row block ``i``."""
        if not prompts:
            return []
        if any(not p for p in prompts):
            raise ValueError("empty prompt")
        batch = len(prompts)
        pad_len = max(len(p) for p in prompts)
        if pad_len + max_new_tokens > self.max_seq:
            # the engine's contract: refusing beats clamped cache writes
            # silently corrupting the decode
            raise ValueError(
                f"prompt+new ({pad_len + max_new_tokens}) > max_seq "
                f"{self.max_seq}")

        # shape bucketing, as the reference's (its compiled programs; here
        # each bucket's preallocated KV cache): pow2 buckets cap them at a
        # handful
        def _pow2(n: int) -> int:
            return 1 << max(0, (n - 1).bit_length())

        requested_new = max_new_tokens
        true_pad = pad_len
        # bucket the per-replica row count, then multiply by dp: the batch
        # stays dp-divisible (dp need not be a power of two)
        padded_b = _pow2(-(-batch // self.dp)) * self.dp
        # bucket max_new first, shrinking it (never below the request)
        # until it fits beside the real prompt, then bucket pad_len into
        # the room that remains
        new_b = _pow2(max(8, requested_new))
        while new_b // 2 >= requested_new and \
                pad_len + new_b > self.max_seq:
            new_b //= 2
        if pad_len + new_b > self.max_seq:
            new_b = requested_new  # no pow2 bucket fits: exact tail
        max_new_tokens = new_b
        pad_len = min(_pow2(max(8, pad_len)),
                      self.max_seq - max_new_tokens)
        # reuse across the bucket ladder: any bucket already made whose
        # shapes dominate this request serves it (rows and prompts pad
        # up, the decode tail is sliced back)
        best = None
        for (b, p, n) in self._gen_cache:
            if (b >= batch and p >= true_pad and n >= requested_new
                    and (best is None
                         or b * (p + n) < best[0] * (best[1] + best[2]))):
                best = (b, p, n)
        if best is not None:
            padded_b, pad_len, max_new_tokens = best
        ids = np.zeros((padded_b, pad_len), np.int64)
        last = np.zeros((padded_b,), np.int64)
        for i, p in enumerate(prompts):
            ids[i, :len(p)] = p
            last[i] = len(p) - 1
        cache = self._bucket_cache(padded_b, pad_len, max_new_tokens)
        toks = self._decode(cache, ids, last, max_new_tokens)
        # bucketed decode may overshoot; return exactly what was asked
        toks = toks[:, :requested_new]
        return [list(prompts[i]) + [int(t) for t in toks[i]]
                for i in range(batch)]
