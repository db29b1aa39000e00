"""Weights from the seed, in the port's parameter layout.

The layout (tree, shapes, dtypes) comes from the port's initialiser run
on the meta device, which allocates nothing; the numbers are drawn here,
on the run's device, one ``torch.randn`` per leaf (a leaf of the layer
stack holds every layer), in the dtype served, with the port's scales:
1/sqrt(fan-in) for products, 0.02 for the embedding and the router, ones
for norm scales.  Both the program and the plain reference read these
tensors; neither derives them.
"""

from __future__ import annotations

import math

import torch


def layout(cfg):
    from repro_torch.models import model as M

    return M.init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="meta")


def _std(path: tuple, shape: tuple) -> float | None:
    """The draw's scale for the leaf at ``path`` (None: ones)."""
    key = path[-1]
    if key == "scale":
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
        std = _std(path, tuple(t.shape))
        if std is None:
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
