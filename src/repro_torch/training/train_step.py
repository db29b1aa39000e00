"""Train-step assembly: loss + remat + AdamW, on one device.

Counterpart of ``repro/training/train_step.py``.  ``build_train_step``
returns a function

    (params, opt_state, batch) -> (params, opt_state, metrics)

that runs forward and backward (``torch.autograd.grad`` over the params'
leaves) and the AdamW update, which writes params and state in place.
PyTorch runs eagerly: there is no jit to build and nothing to donate.
Sharded steps over a device mesh wait for the distributed slice of the
port (ROADMAP A11.5): ``build_train_step`` refuses a mesh, and the
reference's ``batch_specs`` and ``_opt_specs`` come with it, and so
does its ``compress_dp_grads`` setting (``grad_compress``, ROADMAP
A11.2b), which its step does not read either.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

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
    gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in leaves(params)]
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


def build_train_step(cfg, settings: TrainSettings, rules=None):
    """The step on one device.  ``rules`` with a mesh (the reference's
    sharded, donating jit) raises ``NotImplementedError``."""
    if rules is not None and getattr(rules, "mesh", None) is not None:
        raise NotImplementedError(
            "sharded train steps over a device mesh are not ported yet "
            "(ROADMAP A11.5)")
    return train_step_fn(cfg, settings)
