"""Weights for the port: the bridge from the reference's parameters and
AdamW state, and native random init.

``params_from_numpy`` takes the reference pytree already converted to
numpy (``jax.tree.map(np.asarray, params)``) and returns the same tree of
tensors in the same layouts (stacked ``layers`` leaves keep their leading L
axis; ``wq`` stays (d, nq, hd), ``wo`` (nq, hd, d)), so both packages run
on identical weights.  ``init_params`` draws the reference's distributions
from a ``torch.Generator`` (not its numbers).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.model import init_params  # noqa: F401


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: jax arrays are read-only
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, from jax arrays
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


# leaves the reference keeps fp32 whatever the config's dtype
# (repro/models/ssm.py, init_mamba2; repro/models/moe.py, init_moe)
FP32_LEAVES = frozenset({"A_log", "dt_bias", "ssm_D", "router"})


def params_from_numpy(tree, *, device=None, dtype: torch.dtype | None = None):
    """Same tree (dicts, lists, tuples) with every numpy leaf a tensor on
    ``device``, cast to ``dtype`` when given -- except the leaves named in
    ``FP32_LEAVES``, which stay fp32."""
    device = resolve_device(device)

    def conv(node, key=None):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v, key) for v in node)
        t = _tensor(np.asarray(node)).to(device)
        if dtype is None:
            return t
        return t.to(torch.float32 if key in FP32_LEAVES else dtype)

    return conv(tree)


def opt_state_from_numpy(state, *, device=None, dtype: torch.dtype | None = None):
    """The reference's AdamW state (``repro.training.optimizer.init`` or
    ``update``: ``mu``, ``nu``, optional ``master``, ``step``) already
    converted to numpy, as the port's state of tensors on ``device``:
    every leaf keeps its dtype (bf16 moments stay bf16, the fp32 master
    fp32, ``step`` a 0-d int32), except that ``dtype``, when given, casts
    the moments ``mu`` and ``nu``."""
    device = resolve_device(device)

    def conv(node, cast=None):
        if isinstance(node, dict):
            return {k: conv(v, cast) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v, cast) for v in node)
        t = _tensor(np.asarray(node)).to(device)
        return t if cast is None else t.to(cast)

    return {k: conv(v, dtype if k in ("mu", "nu") else None)
            for k, v in state.items()}
