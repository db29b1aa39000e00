"""Pipeline parallelism over a mesh axis (GPipe schedule, point-to-point
rotation).

Counterpart of ``repro/distributed/pipeline.py``.  Intended use at fleet
scale: stage the layer stack over the ``pod`` axis so only activations
(MBs) cross the DCN boundary instead of gradient all-reduces (GBs) — the
multi-pod alternative to pod-level DP.

Mechanics (the reference's collective pipeline, on the ranks of the axis):
  * each pipeline rank holds ``layers_per_stage`` consecutive layers (its
    slice of the stacked-layer axis);
  * the schedule runs ``num_microbatches + num_stages - 1`` ticks; at each
    tick every rank applies its stage to its current activation, then the
    activations rotate one rank forward by ``isend`` / ``irecv`` (rank 0
    receives zeros, as under ``ppermute``);
  * rank 0 injects a fresh microbatch each tick (while any remain), rank
    P-1 emits a finished microbatch per tick after the fill phase;
  * the last rank's outputs are replicated by a masked all-reduce sum;
  * bubble fraction = (P-1)/(M+P-1), the usual GPipe cost.

``pipeline_apply`` is differentiable: the rotation's backward is the
reverse rotation, the masked sum's backward hands each rank the gradient
of the replicated output, and each rank's stage slice gives its gradient
back to the whole stacked leaf through an all-reduce sum, so every rank
ends with the full parameter gradient, as the reference's ``jax.grad``
does.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import axis_size
from repro_torch.training.tree import leaves, unflatten


def _peer(group, rank: int) -> int:
    return dist.get_global_rank(group, rank)


def _rotate(x, group, rank: int, n: int, forward: bool):
    """Rank r's ``x`` moves to rank r+1 (``forward``) or r-1; the rank at
    the open end receives zeros."""
    dst, src = (rank + 1, rank - 1) if forward else (rank - 1, rank + 1)
    out = torch.zeros_like(x)
    ops = []
    if 0 <= dst < n:
        ops.append(dist.P2POp(dist.isend, x.contiguous(), _peer(group, dst),
                              group))
    if 0 <= src < n:
        ops.append(dist.P2POp(dist.irecv, out, _peer(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Rotate(torch.autograd.Function):
    """ppermute one rank forward; the backward rotates one rank back."""

    @staticmethod
    def forward(ctx, x, group, rank, n):
        ctx.group, ctx.rank, ctx.n = group, rank, n
        return _rotate(x, group, rank, n, forward=True)

    @staticmethod
    def backward(ctx, g):
        return _rotate(g, ctx.group, ctx.rank, ctx.n, forward=False), None, None, None


class _SumToReplicated(torch.autograd.Function):
    """All-reduce sum whose result is one replicated value: the backward
    hands each rank the (replicated) output gradient."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _StageSlice(torch.autograd.Function):
    """a[rank] of a stacked leaf; the backward places the slice's gradient
    at ``rank`` and sums over the ranks, so each rank holds the whole
    leaf's gradient."""

    @staticmethod
    def forward(ctx, a, rank, group):
        ctx.rank, ctx.group, ctx.shape = rank, group, a.shape
        return a[rank]

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full[ctx.rank] = g
        dist.all_reduce(full, group=ctx.group)
        return full, None, None


def pipeline_apply(stage_fn, params, x_mb, *, mesh, axis: str, out_like=None):
    """Run a GPipe pipeline over mesh axis ``axis``.

    stage_fn(stage_params, x) -> y  applies ONE stage (its slice of
    layers).  ``params`` leaves must be stacked with a leading
    ``num_stages`` axis; every rank passes the whole stack and applies its
    own stage's slice.  ``x_mb`` is (num_microbatches, mb_size, ...), the
    same on every rank, and the result has the same shape, replicated.
    """
    n_stages = axis_size(mesh, axis)
    group = mesh.get_group(axis)
    rank = dist.get_rank(group)
    n_mb = x_mb.shape[0]
    ticks = n_mb + n_stages - 1

    flat = leaves(params)
    sparams = unflatten(params, [_StageSlice.apply(a, rank, group)
                                 for a in flat])
    state = torch.zeros_like(x_mb[0])
    emitted = []
    for t in range(ticks):
        if rank == 0 and t < n_mb:
            # inject at stage 0: rank 0 received zeros, and adding keeps
            # the rotation in the graph, so every rank runs every
            # rotation's backward exchange in the same order
            state = state + x_mb[t]
        out = stage_fn(sparams, state)
        emitted.append(out)  # meaningful on the last rank only
        if t < ticks - 1:  # the last tick's rotation would feed nothing
            state = _Rotate.apply(out, group, rank, n_stages)
    # finished microbatch m leaves the last rank at tick m + P - 1
    outs = torch.stack(emitted[n_stages - 1:])
    mask = 1.0 if rank == n_stages - 1 else 0.0
    return _SumToReplicated.apply(outs * mask, group)


def stack_stages(layer_params, n_stages: int):
    """(L, ...) stacked layer params -> (n_stages, L/n_stages, ...)."""

    def f(a):
        l = a.shape[0]
        assert l % n_stages == 0, (l, n_stages)
        return a.reshape(n_stages, l // n_stages, *a.shape[1:])

    return unflatten(layer_params, (f(a) for a in leaves(layer_params)))


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
