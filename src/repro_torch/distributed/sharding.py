"""Sharding rules: logical activation/parameter shardings for the production
mesh, applied via a thread-local context so model code stays mesh-agnostic
(no-ops when no rules are set, as on the serving path).

Counterpart of ``repro/distributed/sharding.py``.  ``ShardingRules``, the
thread-local ``set_rules`` / ``current_rules`` / ``use_rules`` and the
parameter rules (``_PARAM_RULES``, ``_spec_for``, ``param_specs``) keep
the reference's fields, defaults, regexes and divisibility guard.  The
JAX types map as follows:

  * ``PartitionSpec`` -> :class:`PartitionSpec`, a tuple of mesh-axis
    names (or tuples of them, or None) per tensor dim;
  * ``Mesh`` -> ``torch.distributed.device_mesh.DeviceMesh`` (or a
    shape-only stand-in whose ``shape`` is a dict, for spec checks);
  * ``NamedSharding`` -> :class:`NamedSharding`, a mesh and its DTensor
    placements (:func:`placements`: ``Shard(d)`` per mesh axis naming
    tensor dim ``d``, else ``Replicate()``);
  * ``with_sharding_constraint`` -> ``DTensor.redistribute`` on a DTensor
    (identity on a plain tensor);
  * ``shard_map`` -> ``torch.distributed.tensor.experimental.local_map``.

Mesh axes (launch/mesh.py):
  single-pod : (data=16, model=16)
  multi-pod  : (pod=2, data=16, model=16)   # pod extends the data dimension

Parallelism mapping:
  * batch            -> ('pod','data')  (DP; pod axis is DP across DCN)
  * sequence (long)  -> 'model'         (SP for prefill/decode caches)
  * attention heads / FFN columns / experts / vocab -> 'model'   (TP/EP)
  * parameters       -> TP axis over 'model'; optionally FSDP over 'data'

A tuple of axes on one tensor dim (``('pod', 'data')``) shards it
major-to-minor in the tuple's order under JAX; a DTensor splits a dim in
mesh-dim order, so :func:`placements` takes a tuple only in the mesh's
own axis order (which every rule of the repo uses) and refuses another.
"""

from __future__ import annotations

import math
import re
import threading
from dataclasses import dataclass
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

# the reference's shard_map, under its name
shard_map = local_map

_CTX = threading.local()


class PartitionSpec(tuple):
    """Mesh-axis names per tensor dim: a name, a tuple of names, or None
    (replicated)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def axis_size(mesh, name) -> int:
    """The size of mesh axis ``name`` (a product over a tuple of names; 1
    for None), on a ``DeviceMesh`` or a stand-in with a dict ``shape``."""
    if name is None:
        return 1
    if isinstance(name, (tuple, list)):
        return math.prod(axis_size(mesh, n) for n in name)
    if isinstance(mesh.shape, dict):
        return mesh.shape[name]
    return mesh.shape[mesh.mesh_dim_names.index(name)]


@dataclass
class ShardingRules:
    mesh: Any = None
    batch_axes: tuple[str, ...] = ("data",)  # ('pod','data') multi-pod
    model_axis: str = "model"
    fsdp: bool = True  # shard the non-TP param axis over 'data'
    shard_seq: bool = False  # sequence-parallel activations/caches
    # decode long-context: shard cache sequence over (data+model)
    seq_axes: tuple[str, ...] = ("model",)
    # serving/§Perf: shard expert FFN width over the DP axes so MoE decode
    # gathers tokens instead of expert weights (models/moe._moe_decode_tpdata)
    expert_ff_fsdp: bool = False
    # serving/§Perf: 2D tensor parallelism for decode — weights stay fully
    # sharded over (data x model), activations are replicated over the batch
    # axes (psum-combined), the KV cache shards its sequence over both axes.
    # Removes the per-layer FSDP weight all-gathers that dominate decode.
    shard_batch: bool = True

    def batch(self) -> Any:
        if not self.shard_batch:
            return None
        return tuple(self.batch_axes) if len(self.batch_axes) > 1 else self.batch_axes[0]

    def fsdp_axis(self):
        return "data" if self.fsdp else None


def set_rules(rules: ShardingRules | None) -> None:
    _CTX.rules = rules


def current_rules() -> ShardingRules | None:
    return getattr(_CTX, "rules", None)


class use_rules:
    """Context manager: ``with use_rules(rules): ...``"""

    def __init__(self, rules: ShardingRules | None):
        self.rules = rules

    def __enter__(self):
        self.prev = current_rules()
        set_rules(self.rules)
        return self.rules

    def __exit__(self, *exc):
        set_rules(self.prev)


# -- specs -> DTensor placements ----------------------------------------------


def placements(spec, mesh) -> list:
    """A :class:`PartitionSpec` -> one placement per mesh dim: ``Shard(d)``
    where the mesh axis names tensor dim ``d``, else ``Replicate()``."""
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(
                f"{spec}: axes {axes} on dim {d} are not in the mesh's order "
                f"{tuple(names)}, which a DTensor's layout follows")
        for m in dims:
            out[m] = Shard(d)
    return out


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the DTensor layout ``placements`` over ``mesh``."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)


def named(params_specs, rules: ShardingRules):
    """PartitionSpec tree -> NamedSharding tree over ``rules.mesh``."""
    return _map_specs(lambda s: NamedSharding(rules.mesh, s), params_specs)


def _map_specs(fn, tree):
    if isinstance(tree, PartitionSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_specs(fn, v) for v in tree)
    return tree


def as_dtensor(t, mesh):
    """A DTensor as it is; a plain tensor (the same on every rank) as a
    replicated DTensor over ``mesh``."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def mesh_of(*xs):
    """The mesh of the first DTensor among ``xs``, else None."""
    return next((x.device_mesh for x in xs if isinstance(x, DTensor)), None)


def whole_rows(x):
    """``x`` with its last dim gathered whole on every rank (a DTensor),
    else ``x``: the layout of a row-wise op that DTensor cannot run on a
    split row (the cross-entropy's gather on vocab-sharded logits)."""
    if not isinstance(x, DTensor):
        return x
    want = row_placements(x)
    return x if list(x.placements) == want else x.redistribute(placements=want)


def _constrain(x, spec: P):
    """``x`` laid out by ``spec``, leaving unsharded a dim that its axes
    do not divide (a batch of 1 over the data axis), as the parameter
    rules do: ``local_map`` takes every shard to be of one size."""
    rules = current_rules()
    if rules is None or rules.mesh is None or not isinstance(x, DTensor):
        return x
    spec = P(*(a if x.shape[d] % axis_size(rules.mesh, a) == 0 else None
               for d, a in enumerate(spec)))
    want = placements(spec, rules.mesh)
    if list(x.placements) == want:
        return x
    return x.redistribute(rules.mesh, want)


def _whole_partials(y):
    pls = list(y.placements)
    want = [Replicate() if isinstance(p, Partial)
            and y.shape[0] % y.device_mesh.size(i) else p
            for i, p in enumerate(pls)]
    return y if want == pls else y.redistribute(placements=want)


class _PartialRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return _whole_partials(y)

    @staticmethod
    def backward(ctx, g):
        return _whole_partials(g) if isinstance(g, DTensor) else g


def reduce_partial_rows(y):
    """``y`` (a DTensor; else as it is), and its gradient, with each
    ``Partial()`` placement reduced to ``Replicate()`` on a mesh dim that
    does not divide the rows (dim 0).  A product against a weight sharded
    over the batch axes (FSDP) on rows left whole is partial over those
    axes, and so is the gradient that such a product sends back; the
    pointwise op that meets either next would reduce-scatter it over the
    rows however few they are: an uneven shard, which DTensor's views and
    ``local_map`` refuse.  Where the rows divide, DTensor's own choice
    stands."""
    if not isinstance(y, DTensor):
        return y
    if torch.is_grad_enabled() and y.requires_grad:
        return _PartialRows.apply(y)
    return _whole_partials(y)


def dense(x, w):
    """``x @ w`` for activations ``x`` (..., d) and a weight ``w`` (d, f).
    On DTensors under grad (a train step), a split of ``w``'s contraction
    dim over a mesh dim on which ``x`` is whole -- FSDP's storage split
    over batch axes that leave the rows unsharded -- is gathered first, as
    FSDP gathers a weight for its products: the product then sums as the
    unsharded step does.  Without grad the split stays (the serving
    layouts keep weights sharded and combine the partial sums), and
    :func:`reduce_partial_rows` settles what it leaves."""
    mesh = mesh_of(x, w)
    if mesh is not None and isinstance(w, DTensor) and torch.is_grad_enabled():
        xp = as_dtensor(x, mesh).placements
        want = [Replicate() if isinstance(p, Shard) and p.dim == 0
                and isinstance(xp[i], Replicate) else p
                for i, p in enumerate(w.placements)]
        if want != list(w.placements):
            w = w.redistribute(placements=want)
    return reduce_partial_rows(torch.matmul(x, w))


def _unstrided(x):
    """``x`` (a DTensor; else as it is) with no ``_StridedShard``.  Such a
    placement ``(d, split_factor=sf)`` is what a view leaves when it merges
    a dim split over one mesh dim into a dim before it: dim ``d`` viewed
    back as ``(sf, size / sf)`` makes it a plain shard of the inner dim,
    which is gathered before the two are merged again.  (Redistributing
    the strided layout directly can fail inside DTensor.)"""
    if not isinstance(x, DTensor):
        return x
    strided = [p for p in x.placements if hasattr(p, "split_factor")]
    if not strided:
        return x
    d, sf = strided[0].dim, strided[0].split_factor
    shape = list(x.shape)
    y = x.view(*shape[:d], sf, shape[d] // sf, *shape[d + 1:])
    y = y.redistribute(placements=[
        Replicate() if getattr(p, "dim", None) == d + 1 else p
        for p in y.placements])
    return _unstrided(y.flatten(d, d + 1))


def local_call(fn, args, arg_placements, out_placements, grad_placements=None):
    """``fn(*args)`` on the local shards of DTensor ``args`` (each
    redistributed to its entry of ``arg_placements``; None for a
    non-tensor), wrapped back as DTensors with ``out_placements``.
    ``grad_placements`` (optional, per arg) are the placements of each
    argument's gradient, e.g. ``Partial()`` for a replicated weight that
    meets batch-sharded rows.  The kernel wrappers run their launches
    through this, so a launch only ever sees local tensors.  An argument
    split by a ``_StridedShard`` (a view that merged a dim split over one
    mesh axis into one split over another) has that tensor dim gathered
    first: ``local_map``'s own redistribute may fail on it."""
    args = [_unstrided(a) for a in args]
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(arg_placements),
                     in_grad_placements=(None if grad_placements is None
                                         else tuple(grad_placements)),
                     redistribute_inputs=True)(*args)


def kernel_plan(mesh, anchor, heads=(), *, batch: bool = True) -> list:
    """Per mesh dim, how a kernel run on local shards splits its work:
    "batch" where the DTensor ``anchor``'s rows (dim 0) are sharded (and
    ``batch``), else "heads" while every count in ``heads`` divides by the
    mesh dim's size (the splits already taken out), else None (that mesh
    dim's shards are gathered).  The mesh dims that already shard one of
    the anchor's other dims (its heads, as the cache rules lay a state
    out) take the heads first, so the anchor keeps its layout where it
    can; the rest follow in mesh order."""
    pls = anchor.placements if isinstance(anchor, DTensor) else \
        [Replicate()] * mesh.ndim
    plan: list = ["batch" if batch and isinstance(p, Shard) and p.dim == 0
                  else None for p in pls]
    counts = list(heads)
    held = [i for i, p in enumerate(pls) if isinstance(p, Shard) and p.dim]
    for i in held + [i for i in range(mesh.ndim) if i not in held]:
        n = mesh.size(i)
        if plan[i] is None and counts and all(c % n == 0 for c in counts):
            plan[i] = "heads"
            counts = [c // n for c in counts]
    return plan


def plan_placements(plan, *, batch=None, heads=None) -> list:
    """One tensor's placements under a :func:`kernel_plan`: ``batch`` and
    ``heads`` (placements, None for replicated) on those mesh dims,
    ``Replicate()`` on the others."""
    return [{"batch": batch, "heads": heads}.get(k) or Replicate()
            for k in plan]


def local_offsets(x) -> tuple[int, ...]:
    """The global index of the first element of this rank's shard of the
    DTensor ``x``, per dim."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    _, off = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return tuple(off)


def assign(dst, src) -> None:
    """``dst.copy_(src)`` in place; a DTensor ``src`` is first laid out as
    the DTensor ``dst`` is, so each rank copies its own shard."""
    if isinstance(dst, DTensor):
        src = as_dtensor(src, dst.device_mesh)
        if list(src.placements) != list(dst.placements):
            src = src.redistribute(dst.device_mesh, dst.placements)
        dst.to_local().copy_(src.to_local())
        return
    dst.copy_(src)


def whole_heads(x, n: int, dim: int = -1):
    """``x`` ready to have dim ``dim`` viewed as (n, size / n): a
    DTensor's shard of that dim is gathered unless it splits into whole
    heads (``n`` divides by the ranks it is split over)."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    dims = [i for i, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim == dim]
    if not dims or n % math.prod(x.device_mesh.size(i) for i in dims) == 0:
        return x
    return x.redistribute(placements=[Replicate() if i in dims else p
                                      for i, p in enumerate(x.placements)])


class _MergeHeads(torch.autograd.Function):
    """Dims (dim, dim + 1) of x viewed as one; the gradient is laid out
    by :func:`whole_heads` before it is viewed back."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.shape, ctx.dim = x.shape, dim
        return x.flatten(dim, dim + 1)

    @staticmethod
    def backward(ctx, g):
        g = whole_heads(g, ctx.shape[ctx.dim], ctx.dim)
        return g.reshape(ctx.shape), None


def merge_heads(x, dim: int):
    """Dims (dim, dim + 1) of ``x`` -- heads and their width -- as one.  A
    DTensor under grad goes through :class:`_MergeHeads`: DTensor may
    shard the merged gradient over more ranks than the heads split over,
    and cannot view that back."""
    if isinstance(x, DTensor) and torch.is_grad_enabled() and x.requires_grad:
        return _MergeHeads.apply(x, dim)
    return x.flatten(dim, dim + 1)


def row_placements(x) -> list:
    """``x``'s placements with any shard of its last dim replicated: the
    layout of a row-wise op (a norm, a softmax over the vocab) whose rows
    are the leading dims."""
    return [p if isinstance(p, Shard) and p.dim < x.ndim - 1 else Replicate()
            for p in x.placements]


def partial_where_sharded(pls) -> list:
    """The gradient placements of a replicated weight used against rows
    laid out as ``pls``: ``Partial()`` on each mesh dim that shards the
    rows (each rank holds the sum over its rows only), ``Replicate()``
    elsewhere."""
    return [Partial() if isinstance(p, Shard) else Replicate() for p in pls]


# -- activation shardings ----------------------------------------------------


def shard_tokens(x):
    """(B, S) int tokens."""
    r = current_rules()
    if r is None:
        return x
    seq = r.model_axis if r.shard_seq else None
    return _constrain(x, P(r.batch(), seq))


def shard_hidden(x):
    """(B, S, D) activations: batch over DP; seq over model when SP is on."""
    r = current_rules()
    if r is None:
        return x
    seq = r.model_axis if r.shard_seq else None
    return _constrain(x, P(r.batch(), seq, None))


def shard_heads(x):
    """(B, S, N, H) per-head activations: heads over the model axis."""
    r = current_rules()
    if r is None:
        return x
    return _constrain(x, P(r.batch(), None, r.model_axis, None))


def shard_logits(x):
    """(B, S, V) logits: vocab over the model axis."""
    r = current_rules()
    if r is None:
        return x
    return _constrain(x, P(r.batch(), None, r.model_axis))


def shard_ffn(x):
    """(B, S, F) FFN activations: columns over the model axis."""
    r = current_rules()
    if r is None:
        return x
    return _constrain(x, P(r.batch(), None, r.model_axis))


def shard_cache_seq(x, *, batch_axis: int, seq_axis: int):
    """KV/conv caches: shard batch over DP and the sequence axis over the
    model axis (sequence parallelism for long contexts).  When batch is 1
    (long_500k), the sequence is spread over every mesh axis instead."""
    r = current_rules()
    if r is None or r.mesh is None:
        return x
    spec = [None] * x.ndim
    if x.shape[batch_axis] == 1:
        spec[seq_axis] = (*r.batch_axes, r.model_axis)
    else:
        spec[batch_axis] = r.batch()
        spec[seq_axis] = r.seq_axes if len(r.seq_axes) > 1 else r.seq_axes[0]
    return _constrain(x, P(*spec))


# -- parameter shardings -----------------------------------------------------

# leaf-name-pattern -> spec builder; {tp} is the model axis, {fsdp} the
# optional data axis.  Layer-stacked leaves get a leading None inserted by
# param_specs().  Patterns are matched against the '/'-joined tree path.
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed$", ("tp", "fsdp")),             # (V, D): vocab over TP
    (r"pos_embed$", (None, None)),
    (r"lm_head$", ("fsdp", "tp")),           # (D, V)
    (r"w_dkv$", ("fsdp", None)),             # (D, R+Pr): replicated latent
    (r"(wq|wq_a|wq_b)$", ("fsdp", "tp", None)),  # (D, N, H)
    (r"(wk|wv)$", ("fsdp", "tp", None)),
    (r"wo$", ("tp", None, "fsdp")),          # (N, H, D)
    (r"(w_uk|w_uv)$", (None, "tp", None)),   # (R, N, H): heads over TP
    (r"w_krope$", ("fsdp", None)),
    (r"experts/(w_gate|w_up)$", ("tp", "fsdp", None)),  # (E, D, F): EP
    (r"experts/w_down$", ("tp", None, "fsdp")),         # (E, F, D)
    (r"(w_gate|w_up)$", ("fsdp", "tp")),     # (D, F)
    (r"w_down$", ("tp", "fsdp")),            # (F, D)
    (r"router$", ("fsdp", None)),            # (D, E)
    (r"in_proj$", ("fsdp", "tp")),           # SSM in projection (D, inner)
    (r"(z_proj|xbc_proj|dt_proj)$", ("fsdp", "tp")),  # split SSM projections
    (r"out_proj$", ("tp", "fsdp")),          # SSM out projection (inner, D)
    (r"conv_w$", (None, "tp")),              # (width, conv_dim)
    (r"(A_log|dt_bias|ssm_D)$", ("tp",)),    # per-head SSM params
    (r"(norm|scale|bias|b)$", (None,)),      # norms & small vectors
]


def _spec_for(path: str, shape: tuple[int, ...], rules: ShardingRules) -> P:
    tp = rules.model_axis
    fsdp = rules.fsdp_axis()
    if rules.expert_ff_fsdp and re.search(r"experts/", path):
        # serving layout: experts over TP, FFN width over the DP axes
        dp = rules.batch_axes if len(rules.batch_axes) > 1 else rules.batch_axes[0]
        pad = [None] * (len(shape) - 3)
        if re.search(r"experts/(w_gate|w_up)$", path):  # (E, D, F)
            return P(*pad, tp, None, dp)
        if re.search(r"experts/w_down$", path):  # (E, F, D)
            return P(*pad, tp, dp, None)
    for pat, proto in _PARAM_RULES:
        if re.search(pat, path):
            if len(proto) > len(shape):
                proto = proto[-len(shape):]
            axes = []
            for i, a in enumerate(proto):
                name = {"tp": tp, "fsdp": fsdp}.get(a, a) if isinstance(a, str) else a
                # never shard an axis that isn't divisible by the mesh axis
                if name is not None and rules.mesh is not None:
                    size = axis_size(rules.mesh, name) if not isinstance(name, tuple) else 1
                    if shape[i + (len(shape) - len(proto))] % max(size, 1) != 0:
                        name = None
                axes.append(name)
            pad = [None] * (len(shape) - len(proto))
            return P(*pad, *axes)
    return P(*([None] * len(shape)))


def param_specs(params_shape, rules: ShardingRules, *, stacked_prefix: int = 0):
    """Build a PartitionSpec tree matching ``params_shape`` (a tree of
    dicts, lists and tuples whose leaves have a ``shape``: tensors, meta
    tensors).  Paths join dict keys and sequence indices with '/', as the
    reference's tree paths do."""

    def build(node, path):
        if isinstance(node, dict):
            return {k: build(v, (*path, str(k))) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, (*path, str(i)))
                              for i, v in enumerate(node))
        if node is None:
            return None
        return _spec_for("/".join(path), tuple(node.shape), rules)

    return build(params_shape, ())


def distribute(tree, specs, rules: ShardingRules):
    """Each tensor leaf of ``tree`` laid out over ``rules.mesh`` by its
    spec in ``specs`` (a tree of the same structure), as a DTensor: a plain
    tensor is distributed (every rank passes the whole tensor and keeps
    its own shard), a DTensor redistributed when its layout differs.  A
    dict entry without a spec, and a leaf that is not a tensor, are kept
    as they are."""
    from torch.distributed.tensor import distribute_tensor

    def go(node, spec):
        if isinstance(node, dict):
            return {k: go(v, spec[k]) if k in spec else v
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(go(v, s) for v, s in zip(node, spec))
        if not isinstance(node, torch.Tensor):
            return node
        want = placements(spec, rules.mesh)
        if not isinstance(node, DTensor):
            return distribute_tensor(node.detach(), rules.mesh, want)
        return (node if list(node.placements) == want
                else node.redistribute(rules.mesh, want))

    return go(tree, specs)


def to_full(x) -> torch.Tensor:
    """A DTensor's whole value as a plain tensor on every rank (a plain
    tensor as it is)."""
    return x.full_tensor() if isinstance(x, DTensor) else x
