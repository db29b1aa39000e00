"""Gradient compression for data-parallel reduction (distributed-optimization
trick): 8-bit quantization with error feedback.

Counterpart of ``repro/training/grad_compress.py``, with its scheme (per
leaf, across the ranks of the mesh axes ``axes``):
  1. shared scale: all-reduce max of the local absmax (tiny scalar
     collective), scale = absmax / 127;
  2. q = round((g + err)/scale), clipped to [-127, 127] — int8 payload,
     carried wider on the wire so the summation cannot overflow
     (|sum| <= n*127, safe for n <= 257 shards);
  3. mean = sum(q) * scale / n;
  4. err' = (g + err) - q*scale  (error feedback: quantization error is
     re-injected next step — the Seide/Karimireddy condition that keeps
     compressed SGD convergent).

The wire: the reference carries the sum as int16, 2 bytes/element vs 4
for fp32.  Neither NCCL nor gloo reduces int16 (NCCL has no 16-bit
integer type; gloo refuses it), so the port carries the sum as int32
(:data:`WIRE_DTYPE`): 4 bytes/element, the same as fp32, and exact as the
reference's is.  The port keeps the scheme's values, not its wire saving.
Over several axes the max and the sum run axis by axis, which gives the
same values: a max of maxes, and an integer sum.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import axis_size
from repro_torch.training.tree import leaves, tree_map, unflatten


def _div(x, c):
    """``x / c`` for a Python number ``c``, as a true division on every
    device: CUDA divides by a host scalar as a product with its
    reciprocal, which can be an ulp off the reference's quotient."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def quantize_int8(x):
    """x fp -> (q int8, scale fp32).  Symmetric per-tensor scaling."""
    x = x.to(torch.float32)
    scale = _div(torch.clamp(torch.max(torch.abs(x)), min=1e-12), 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def init_error_state(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


# the integer type the quantized sum travels in (the reference's int16 is
# reduced by neither NCCL nor gloo)
WIRE_DTYPE = torch.int32


def _psum_compressed_leaf(g, e, groups, n: int):
    corrected = g.to(torch.float32) + e
    absmax = torch.max(torch.abs(corrected))
    for grp in groups:
        dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=grp)
    scale = _div(torch.clamp(absmax, min=1e-12), 127.0)
    q = torch.clamp(torch.round(corrected / scale), -127, 127)
    total = q.to(WIRE_DTYPE)
    for grp in groups:
        dist.all_reduce(total, group=grp)
    mean = _div(total.to(torch.float32) * scale, n)
    new_err = corrected - q * scale
    return mean.to(g.dtype), new_err


def compressed_psum_mean(grads, err, mesh, axes: tuple[str, ...]):
    """All-reduce-mean grads over the ranks of ``axes`` of ``mesh`` (a
    ``DeviceMesh``) with int8 compression + error feedback.  Each rank
    passes its own grads (plain tensors) and error state.

    Returns (mean_grads, new_err)."""
    n = math.prod(axis_size(mesh, a) for a in axes)
    if n > 257:
        raise ValueError(f"int16 wire overflows beyond 257 shards, got {n}")
    groups = [mesh.get_group(a) for a in axes]
    pairs = [_psum_compressed_leaf(g, e, groups, n)
             for g, e in zip(leaves(grads), leaves(err))]
    return (unflatten(grads, (p[0] for p in pairs)),
            unflatten(grads, (p[1] for p in pairs)))
