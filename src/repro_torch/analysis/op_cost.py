"""Static (flops, hbm_bytes) of one call of an eager PyTorch function.

Counterpart, for eager PyTorch, of ``analysis/hlo_cost.py``: the port has
no HLO to walk, so it counts the aten ops one call dispatches, by the same
rules, so that the two packages price the same things:

  * flops     -- matrix products and convolutions only (``hlo_cost`` counts
                 only ``dot`` and ``convolution``): 2*m*n*k per product, by
                 ``torch.utils.flop_counter``'s formulas;
  * hbm_bytes -- every op reads its inputs and writes its outputs, except
                 (as ``hlo_cost._instr_bytes`` charges them):
                   views and reshapes, allocations and ``arange`` are free
                   (``_SKIP_BYTES``: bitcast, reshape, parameter, iota), and
                   so is a ``to`` that returns its input;
                   a gather (``index``, ``index_select``, ``embedding``,
                   ``gather``) costs 2 x its output + its indices, never
                   its whole source;
                   a scatter (``index_put_``, ``index_copy_``, ``scatter``,
                   ``index_add_``) costs 3 x its update;
                   ``copy_`` into a slice costs the update read plus the
                   slice written (2 x the update).

A tensor's bytes are its distinct elements (axes of stride 0, as
``expand`` makes them, count once) times its element size.  XLA fuses
elementwise chains into one pass and this count does not, so an
elementwise-heavy function prices above its ``hlo_cost`` twin.

Meta tensors hold no values, so pricing a model on the ``meta`` device
(every kernel wrapper takes its plain version there) costs no device
memory and launches nothing; CPU tensors give the same counts.
"""

from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# ops that move no bytes: allocations without a fill, iota, aliasing
_FREE = {"_unsafe_view", "empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "arange", "lift_fresh", "lift_fresh_copy",
         "detach", "alias", "_reshape_alias"}
# metadata queries, which FlopCounterMode passes on too
_QUERIES = {"is_contiguous", "sym_is_contiguous", "is_strides_like_format",
            "is_non_overlapping_and_dense", "size", "sym_size", "stride",
            "sym_stride", "storage_offset", "sym_storage_offset", "numel",
            "sym_numel", "dim"}
# op -> name of its index argument(s)
_GATHERS = {"index": "indices", "index_select": "index",
            "embedding": "indices", "gather": "index"}
# op -> name of its update argument
_SCATTERS = {"index_put": "values", "index_put_": "values",
             "_index_put_impl_": "values", "index_copy": "source",
             "index_copy_": "source", "scatter": "src", "scatter_": "src",
             "scatter_add": "src", "scatter_add_": "src",
             "scatter_reduce": "src", "scatter_reduce_": "src",
             "index_add": "source", "index_add_": "source"}


def tensor_bytes(t: torch.Tensor) -> int:
    """Distinct elements of ``t`` times its element size."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride != 0:
            n *= size
    return n * t.element_size()


def _bytes_of(x) -> int:
    """Bytes of every tensor in ``x`` (a tensor, or sequences and dicts of
    them; anything else counts 0)."""
    if isinstance(x, torch.Tensor):
        return tensor_bytes(x)
    if isinstance(x, (list, tuple)):
        return sum(_bytes_of(v) for v in x)
    if isinstance(x, dict):
        return sum(_bytes_of(v) for v in x.values())
    return 0


@functools.cache
def _is_view(func) -> bool:
    """Whether the op returns an alias of an input it does not write."""
    return any(a.alias_info is not None and not a.alias_info.is_write
               for a in func._schema.arguments)


def op_bytes(func, args, kwargs, out) -> int:
    """HBM bytes of one aten op call (the rules in the module docstring)."""
    name = func.overloadpacket.__name__
    if name == "to":  # a view when it returns its input, else a copy
        return 0 if out is args[0] else tensor_bytes(args[0]) + _bytes_of(out)
    if name in _FREE or _is_view(func):
        return 0
    if name in _GATHERS or name in _SCATTERS or name == "copy_":
        named = dict(zip((a.name for a in func._schema.arguments), args))
        named.update(kwargs)
        if name in _GATHERS:
            return 2 * _bytes_of(out) + _bytes_of(named.get(_GATHERS[name]))
        if name == "copy_":
            return tensor_bytes(named["src"]) + tensor_bytes(named["self"])
        upd = named.get(_SCATTERS[name])
        if isinstance(upd, torch.Tensor):
            return 3 * tensor_bytes(upd)
        idx = named.get("index")  # a scalar update: one per index
        return 3 * (idx.numel() * named["self"].element_size()
                    if isinstance(idx, torch.Tensor) else 0)
    return _bytes_of(args) + _bytes_of(kwargs) + _bytes_of(out)


class CostMode(TorchDispatchMode):
    """Sums, over the aten ops dispatched inside it, the flops of
    ``torch.utils.flop_counter``'s formulas (matrix products, convolutions,
    attention) and :func:`op_bytes`.  A composite op (matmul, einsum, linear) with no formula of its own
    is counted as the ops it decomposes into, as ``FlopCounterMode`` counts
    it, whether or not autograd is on."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet.__name__ in _QUERIES:
            return NotImplemented
        formula = flop_registry.get(packet)
        if formula is None:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        self.bytes += op_bytes(func, args, kwargs, out)
        return out


def cost_of(fn, *args, **kwargs) -> tuple[float, float]:
    """(flops, hbm_bytes) of one call ``fn(*args, **kwargs)``, run under
    inference mode."""
    mode = CostMode()
    with torch.inference_mode(), mode:
        fn(*args, **kwargs)
    return (float(mode.flops), float(mode.bytes))
