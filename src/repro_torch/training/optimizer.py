"""AdamW with dtype-configurable state, on trees of tensors.

Counterpart of ``repro/training/optimizer.py``.  State mirrors the
parameter tree leaf for leaf, plus a scalar step counter:
  * ``moment_dtype='bfloat16'`` keeps m and v in bf16;
  * ``master_dtype='float32'`` keeps a full-precision master copy when the
    params are bf16 (None updates the params directly).
With bf16 params + bf16 moments + fp32 master: 2+2+2+4 = 10 bytes/param.

Where the reference returns new trees, :func:`update` writes the new
params and state into the given ones in place, under ``torch.no_grad()``
(the memory of a second copy of the state is what a step would otherwise
cost), and returns them.  The arithmetic keeps the reference's order of
operations and dtypes, so fp32 agrees to rounding.  Every value stays on
the params' device: no host sync.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.training.tree import leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "bfloat16"
    master_dtype: str | None = "float32"


def schedule(cfg: AdamWConfig, step):
    """Linear warmup + cosine decay to min_lr_ratio; ``step`` a tensor."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params, cfg: AdamWConfig):
    mdt = getattr(torch, cfg.moment_dtype)
    first = leaves(params)[0]
    state = {
        "mu": tree_map(lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device), params),
        "nu": tree_map(lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }
    if cfg.master_dtype is not None:
        mst = getattr(torch, cfg.master_dtype)
        state["master"] = tree_map(lambda p: p.detach().to(mst, copy=True), params)
    return state


def global_norm(tree):
    sums = [torch.sum(torch.square(l.to(torch.float32))) for l in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def update(grads, state, params, cfg: AdamWConfig):
    """Returns (params, state, metrics), params and state updated in
    place."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
             if cfg.grad_clip else 1.0)
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)
    mdt = getattr(torch, cfg.moment_dtype)
    masters = state.get("master", params)

    for g, m, v, p, master in zip(leaves(grads), leaves(state["mu"]),
                                  leaves(state["nu"]), leaves(params),
                                  leaves(masters)):
        g = g.to(torch.float32) * scale
        m32 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * torch.square(g)
        upd = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
        new_master = master.to(torch.float32) * (1 - lr * cfg.weight_decay) - lr * upd
        m.copy_(m32.to(mdt))
        v.copy_(v32.to(mdt))
        if cfg.master_dtype is not None:
            master.copy_(new_master.to(master.dtype))
        p.copy_(new_master.to(p.dtype))
    state["step"].copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
