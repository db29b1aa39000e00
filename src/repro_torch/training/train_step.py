"""Train-step assembly: loss + remat + AdamW, on one device or sharded
over a device mesh.

Counterpart of ``repro/training/train_step.py``.  ``build_train_step``
returns a function

    (params, opt_state, batch) -> (params, opt_state, metrics)

that runs forward and backward (``torch.autograd.grad`` over the params'
leaves) and the AdamW update, which writes params and state in place.
PyTorch runs eagerly: there is no jit to build, and nothing to donate
(the update is in place already).

With rules that hold a mesh (a ``DeviceMesh``), the step is the
reference's sharded one: params and AdamW state are DTensors laid out by
``named(param_specs(...))`` and ``_opt_specs`` (plain trees passed in are
distributed on entry, as the reference's ``in_shardings`` place them),
the batch by :func:`batch_specs`, and the step runs under ``use_rules``,
so the models' shard points redistribute the activations and the kernel
wrappers run on local shards.  Plain tensors the step makes (positions,
masks, scalars) join DTensor ops as replicated
(``implicit_replication``).  Metrics come back as plain replicated
scalars.  Where DTensor has no sharding rule for an op, that op takes a
gathered layout (see ``distributed.sharding``: ``whole_rows`` at the
cross-entropy's gold gather, the whole table under the bf16 logits GEMM).
The reference's ``compress_dp_grads`` setting is not read by its step
either; ``training.grad_compress`` is the DP reduction it names.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import math

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.distributed import sharding as shd
from repro_torch.models import model as M
from repro_torch.models.transformer import REMAT_POLICIES  # noqa: F401
from repro_torch.training import optimizer as opt
from repro_torch.training.tree import leaves, unflatten


@dataclass(frozen=True)
class TrainSettings:
    adamw: opt.AdamWConfig = field(default_factory=opt.AdamWConfig)
    remat: bool = True
    remat_policy: str = "dots_no_batch"  # a name of REMAT_POLICIES
    grad_accum: int = 1  # microbatch accumulation steps
    aux_weight: float = 0.01


def make_loss(cfg, settings: TrainSettings):
    if settings.remat_policy not in REMAT_POLICIES:
        raise KeyError(f"unknown remat policy {settings.remat_policy!r}; "
                       f"known: {sorted(REMAT_POLICIES)}")

    def loss(params, batch):
        return M.loss_fn(cfg, params, batch, remat=settings.remat,
                         remat_policy=settings.remat_policy,
                         aux_weight=settings.aux_weight)

    return loss


def _split_microbatches(batch, n: int):
    # mrope positions have batch on axis 1: handle dict-wise
    out = {}
    for k, v in batch.items():
        if k == "mrope_positions":
            out[k] = v.reshape(v.shape[0], n, v.shape[1] // n, *v.shape[2:]).swapaxes(0, 1)
        elif hasattr(v, "ndim"):
            out[k] = v.reshape(n, v.shape[0] // n, *v.shape[1:])
        else:
            out[k] = v
    return out


def value_and_grad(loss_fn, params, batch):
    """((loss, metrics), grads) of ``loss_fn(params, batch)``, grads a tree
    like ``params`` (zeros for a leaf the loss does not reach)."""
    flat = leaves(params)
    with torch.enable_grad():
        xs = [p.detach().requires_grad_(True) for p in flat]
        loss, metrics = loss_fn(unflatten(params, xs), batch)
        grads = torch.autograd.grad(loss, xs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(xs, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), unflatten(params, grads)


def accumulated_value_and_grad(loss_fn, params, batch, n: int):
    """((loss, {}), grads) over ``n`` microbatches of ``batch``: the
    microbatches' gradients summed in fp32 and their losses summed, each
    divided by ``n`` (the reference's ``grad_accum`` scan)."""
    micro = _split_microbatches(batch, n)
    gsum = [torch.zeros_like(p, dtype=torch.float32) for p in leaves(params)]
    lsum = 0.0
    for i in range(n):
        mb = {k: v[i] if hasattr(v, "ndim") else v for k, v in micro.items()}
        (l, _), g = value_and_grad(loss_fn, params, mb)
        for acc, gi in zip(gsum, leaves(g)):
            acc.add_(gi)
        lsum = lsum + l
    return (lsum / n, {}), unflatten(params, (g / n for g in gsum))


def train_step_fn(cfg, settings: TrainSettings):
    loss_fn = make_loss(cfg, settings)

    def step(params, opt_state, batch):
        if settings.grad_accum > 1:
            (loss, metrics), grads = accumulated_value_and_grad(
                loss_fn, params, batch, settings.grad_accum)
        else:
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch)

        params, opt_state, opt_metrics = opt.update(
            grads, opt_state, params, settings.adamw)
        metrics = {**metrics, **opt_metrics, "loss": loss}
        return params, opt_state, metrics

    return step


def batch_specs(cfg, batch_shapes, rules: shd.ShardingRules):
    """PartitionSpec tree for a train/serve batch: batch dim over DP axes
    (left unsharded when the batch doesn't divide them, e.g. long_500k's
    global_batch=1)."""
    n_dp = math.prod(shd.axis_size(rules.mesh, a) for a in rules.batch_axes) \
        if rules.mesh is not None else 1

    def b_for(size: int):
        return rules.batch() if size % max(n_dp, 1) == 0 else None

    def spec(name, leaf):
        if name == "mrope_positions":  # (3, B, S)
            return shd.P(None, b_for(leaf.shape[1]), None)
        if name in ("frames", "embeds"):  # (B, T, D)
            return shd.P(b_for(leaf.shape[0]), None, None)
        if leaf.ndim >= 1:
            return shd.P(b_for(leaf.shape[0]), *([None] * (leaf.ndim - 1)))
        return shd.P()

    return {k: spec(k, v) for k, v in batch_shapes.items()
            if hasattr(v, "ndim")}


def build_train_step(cfg, settings: TrainSettings, rules=None,
                     batch_shapes=None):
    """The step on one device, or with ``rules.mesh`` the sharded step
    (``batch_shapes`` is accepted for the reference's signature: the
    batch's specs come from each batch itself)."""
    step = train_step_fn(cfg, settings)
    if rules is None or getattr(rules, "mesh", None) is None:
        return step

    mesh = rules.mesh

    def place(tree, specs):
        """Plain leaves distributed by their specs; DTensors as they are."""
        flat = leaves(tree)
        if all(isinstance(t, DTensor) for t in flat):
            return tree
        return shd.distribute(tree, specs, rules)

    def wrapped(params, opt_state, batch):
        pspecs = shd.param_specs(params, rules)
        params = place(params, pspecs)
        opt_state = place(opt_state, _opt_specs(opt_state, pspecs))
        bspecs = batch_specs(cfg, batch, rules)
        batch = {k: (shd.distribute(v, bspecs[k], rules) if k in bspecs
                     and not isinstance(v, DTensor) else v)
                 for k, v in batch.items()}
        with shd.use_rules(rules), implicit_replication():
            params, opt_state, metrics = step(params, opt_state, batch)
        # replicated scalars, as the reference's out sharding None
        metrics = {k: shd.to_full(v) for k, v in metrics.items()}
        return params, opt_state, metrics

    return wrapped


def _opt_specs(opt_shape, pspecs):
    """Optimizer-state specs mirror the param specs leaf-for-leaf."""
    out = {}
    for k, sub in opt_shape.items():
        if k == "step":
            out[k] = shd.P()
        else:
            out[k] = pspecs
    return out
