"""Weights from the seed, in the port's parameter layout.

The layout (tree, shapes, dtypes) comes from the port's initialiser run
on the meta device, which allocates nothing; the numbers are drawn here,
on the run's device, one draw per leaf (a leaf of the layer stack holds
every layer), in the dtype served, from one generator seeded by the run's
seed, with the port's scales: 1/sqrt(fan-in) for products, 0.02 for the
embedding and the router, ones for norm scales.  Both the program and the
plain reference read these tensors; neither derives them.

Mamba-2's own leaves (``models/ssm.py::init_mamba2``) are drawn as
``mamba_ssm``'s ``Mamba2`` initialises them: ``A_log`` = log of uniform
[1, 16]; ``dt_bias`` = the inverse softplus of dt, dt = exp of uniform
[log 1e-3, log 1e-1] floored at 1e-4; ``ssm_D`` and ``gate_norm`` ones.
The general rule would put A near -1 and dt near 0.7, so that each step
halves the state, and the gated norm's scale near 1/sqrt(d_inner): the
state would not carry from one chunk of the SSD scan into the next.  The
mixer's other leaves (``in_proj``, ``conv_w``, ``conv_b``, ``out_proj``)
keep the general rule, and a tree without those four names (the dense
and MLA families) is drawn by it alone.

The fan-in rule strips the leading axis of a stacked leaf only under the
top-level key ``layers``: a family whose stacks sit elsewhere (zamba2's
``groups``, shaped (G, PG, ...)) would get the wrong fan-in, and needs
its key named in ``_std`` first.
"""

from __future__ import annotations

import math

import torch


def layout(cfg):
    from repro_torch.models import model as M

    return M.init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="meta")


# Mamba2 (mamba_ssm): A_init_range, dt_min, dt_max, dt_init_floor
A_RANGE = (1.0, 16.0)
DT_RANGE = (1e-3, 1e-1)
DT_FLOOR = 1e-4
ONES = ("scale", "ssm_D", "gate_norm")


def _a_log(u):
    """log A, A uniform in ``A_RANGE``, from ``u`` uniform in [0, 1)."""
    lo, hi = A_RANGE
    return torch.log(lo + (hi - lo) * u)


def _dt_bias(u):
    """softplus^-1(dt), log dt uniform in log ``DT_RANGE``, dt floored at
    ``DT_FLOOR``, from ``u`` uniform in [0, 1)."""
    lo, hi = (math.log(x) for x in DT_RANGE)
    dt = torch.exp(lo + (hi - lo) * u).clamp(min=DT_FLOOR)
    return dt + torch.log(-torch.expm1(-dt))


UNIFORM = {"A_log": _a_log, "dt_bias": _dt_bias}


def _std(path: tuple, shape: tuple) -> float | None:
    """The draw's scale for the normal leaf at ``path`` (None: ones)."""
    key = path[-1]
    if key in ONES:
        return None
    if key in ("embed", "router"):
        return 0.02
    if path[0] == "layers":  # stacked: the leading axis counts layers
        shape = shape[1:]
    if key == "wo":  # (n, hv, d)
        return 1.0 / math.sqrt(shape[0] * shape[1])
    if "experts" in path:  # (E, in, out)
        return 1.0 / math.sqrt(shape[1])
    return 1.0 / math.sqrt(shape[0])


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*path, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, (*path, i))
    else:
        yield path, tree


def _map(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, (*path, k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, (*path, i)) for i, v in enumerate(tree))
    return fn(path, tree)


def fill(params, seed: int) -> None:
    """Draw every leaf of ``params`` in place from ``seed``."""
    gen = None
    for path, t in _leaves(params):
        if gen is None:
            gen = torch.Generator(device=t.device).manual_seed(seed % 2**63)
        if path[-1] in UNIFORM:
            u = torch.rand(t.shape, generator=gen, dtype=torch.float32,
                           device=t.device)
            t.copy_(UNIFORM[path[-1]](u))
        elif (std := _std(path, tuple(t.shape))) is None:
            t.fill_(1.0)
        else:
            t.normal_(0.0, std, generator=gen)


def allocate(tree, device):
    """Uninitialised tensors on ``device`` shaped as the meta ``tree``."""
    return _map(tree, lambda _p, m: torch.empty(m.shape, dtype=m.dtype,
                                                device=device))


def make(cfg, seed: int, device):
    """The served weights of ``cfg`` drawn from ``seed`` on ``device``."""
    params = allocate(layout(cfg), device)
    fill(params, seed)
    return params


def param_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for _, t in _leaves(params))
