"""Pipeline parallelism over the ``pp`` mesh axis (the GPipe schedule).

Counterpart of ``kubeflow_tpu/parallel/pipeline.py``.  Layers are
stacked on a leading axis (``stack_layer_params``; logical axis "stage",
split over pp: ``stage_spec``), each pp rank holds its stage's layers
(``stage_slice``), and ``pipeline_forward`` runs the reference's
schedule of M + P - 1 ticks: stage 0 feeds microbatch t, every stage
runs its layers on what it holds while ``p <= t < p + M`` (an inactive
stage computes nothing: its output is zero, as the reference's masked
one), the last stage banks microbatch ``t - (P - 1)``, and after each
tick but the last every stage hands its output to stage ``p + 1``
(``distributed.ppermute``; the wrap from the last stage to stage 0
carries zeros, which stage 0 ignores).  The banked outputs are summed
over pp with ``reduce_from_group``'s contract (sum forward, identity
backward), so every stage returns the real outputs and each rank's copy
of a loss counts once, as the reference's one global loss does.

    out = pipeline_forward(block_fn, stage_slice(stacked, mesh), x,
                           mesh=mesh, num_microbatches=M)

``block_fn(layer_params, h) -> h`` applies ONE layer; the stacked
parameters' leaves have a leading dim L (total layers, L % pp == 0).

The reference differentiates its ``lax.scan`` of ticks.  Here the whole
schedule is one ``torch.autograd.Function`` whose backward walks the
ticks in reverse, one reverse exchange per forward one: each rank then
issues its point-to-point calls in the same order, which autograd's own
ordering of a graph that differs from stage to stage would not promise.
Each active tick keeps its graph from the forward (GPipe without
recomputation), and its backward is a ``torch.autograd.grad`` of that
tick's output.
"""

from __future__ import annotations

import torch

from kubeflow_tpu_torch.parallel import distributed as pd


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def _rebuild(tree, leaves):
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


def stack_layer_params(per_layer: list):
    """[L parameter trees (dicts of tensors)] -> one tree whose leaves have
    a leading layer axis."""
    first = per_layer[0]
    if isinstance(first, dict):
        return {k: stack_layer_params([p[k] for p in per_layer])
                for k in first}
    return torch.stack(per_layer)


def stage_spec() -> tuple:
    """The spec of stacked layer params: the leading "stage" axis over pp
    (the reference's ``P("pp")``)."""
    return ("pp",)


def stage_slice(stacked, mesh, axis_name: str = "pp"):
    """This rank's stage of ``stacked``: layers ``[p L / P, (p + 1) L / P)``
    of every leaf, for pp coordinate p of P."""
    n, p = mesh.shape[axis_name], mesh.coordinate(axis_name)
    layers = _leaves(stacked)[0].shape[0]
    if layers % n:
        raise ValueError(f"{layers} layers do not split into "
                         f"{axis_name}={n} stages")
    per = layers // n
    return _tree_map(lambda t: t[p * per:(p + 1) * per], stacked)


class _Schedule(torch.autograd.Function):
    """The GPipe ticks of one stage; returns the banked outputs ``[M, ...]``
    (zeros but on the last stage).  Inputs: the stage's parameter leaves
    after ``xs``."""

    @staticmethod
    def forward(ctx, run, group, stage, stages, xs, *params):
        m = xs.shape[0]
        leaves = [p.detach().requires_grad_(p.requires_grad)
                  for p in params]
        bank = torch.zeros_like(xs)
        ticks = []      # per tick: (input leaf, output) of an active one
        h_in = torch.zeros_like(xs[0])
        for t in range(m + stages - 1):
            active = stage <= t < stage + m
            h_out = torch.zeros_like(xs[0])
            record = None
            if active:
                fed = xs[t - stage] if stage == 0 else h_in
                x_leaf = fed.detach().requires_grad_()
                with torch.enable_grad():
                    h_out = run(leaves, x_leaf)
                record = (x_leaf, h_out)
                h_out = h_out.detach()
            ticks.append(record)
            if stage == stages - 1 and t >= stages - 1:
                bank[t - (stages - 1)] = h_out
            if t + 1 < m + stages - 1:
                send = (torch.zeros_like(h_out) if stage == stages - 1
                        else h_out)
                h_in = pd.ppermute([send], group)[0]
        ctx.ticks, ctx.leaves = ticks, leaves
        ctx.group, ctx.stage, ctx.stages = group, stage, stages
        ctx.xs_shape = xs.shape
        return bank

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_bank):
        group, stage, stages = ctx.group, ctx.stage, ctx.stages
        leaves = ctx.leaves
        grads = [None] * len(leaves)
        g_xs = torch.zeros(ctx.xs_shape, dtype=g_bank.dtype,
                           device=g_bank.device)
        g_in = None   # this stage's gradient of what it received last tick
        ticks = ctx.ticks
        for t in reversed(range(len(ticks))):
            g_out = (g_bank[t - (stages - 1)].clone()
                     if stage == stages - 1 and t >= stages - 1
                     else torch.zeros_like(g_bank[0]))
            if t + 1 < len(ticks):
                # stage p + 1's gradient of what this stage sent after
                # tick t; stage 0 ignored what the last stage sent
                back = (torch.zeros_like(g_bank[0])
                        if stage == 0 or g_in is None else g_in)
                got = pd.ppermute([back], group, -1)[0]
                if stage != stages - 1:
                    g_out = g_out + got
            g_in = None
            record = ticks[t]
            if record is not None:
                x_leaf, h_out = record
                wrt = [x_leaf] + [p for p in leaves if p.requires_grad]
                got = torch.autograd.grad(h_out, wrt, g_out,
                                          allow_unused=True)
                g_in = got[0]
                rest = iter(got[1:])
                for i, p in enumerate(leaves):
                    if not p.requires_grad:
                        continue
                    g = next(rest)
                    if g is not None:
                        grads[i] = g if grads[i] is None else grads[i] + g
                if stage == 0 and g_in is not None:
                    g_xs[t] += g_in
        ctx.ticks = None
        return (None, None, None, None, g_xs, *grads)


def pipeline_forward(block_fn, stage_params, x: torch.Tensor, *,
                     mesh, num_microbatches: int,
                     axis_name: str = "pp") -> torch.Tensor:
    """Run x [B, ...] through every stacked layer, pipelined over the
    ``axis_name`` mesh axis with ``num_microbatches`` GPipe microbatches.
    ``stage_params``: this rank's stage (``stage_slice``).  Returns the
    output [B, ...] on every stage, differentiable in the stage's
    parameters (each stage gets its own layers' gradients of the last
    stage's copy of the loss) and, on stage 0, in x."""
    stages = mesh.shape[axis_name]
    m = num_microbatches
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} must divide into {m} microbatches")
    group = mesh.group(axis_name)
    stage = mesh.coordinate(axis_name)
    xs = x.reshape((m, b // m) + x.shape[1:])
    layers = _leaves(stage_params)[0].shape[0]

    def run(leaves, h):
        tree = _rebuild(stage_params, leaves)
        for i in range(layers):
            h = block_fn(_tree_map(lambda t: t[i], tree), h)
        return h

    bank = _Schedule.apply(run, group, stage, stages, xs,
                           *_leaves(stage_params))
    if group is not None:
        bank = pd.reduce_from_group(bank, group)
    return bank.reshape((b,) + bank.shape[2:])
