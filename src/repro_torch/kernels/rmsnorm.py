"""RMSNorm: CUDA kernel (``csrc/rmsnorm.cu``), plain version and wrapper.

Counterpart of ``repro/kernels/rmsnorm.py``.  Rounding follows the model
path (``repro/models/layers.py::rms_norm``): normalize in fp32, cast to x's
dtype, then multiply by the scale.

The kernel runs one warp per row by one of three routes, picked by
:func:`rmsnorm_route` from the row width and alignment before any launch:
the row held in registers for the widths in :data:`ROW_WIDTHS` up to
:data:`ROW_BYTES` a row, a loop of 16-byte vectors for any other width
that is a whole number of them, and an element loop for any other width.

The backward (``csrc/rmsnorm.cu``; the reference has no kernel for it: XLA
differentiates the jnp path) takes the same three routes by
:func:`rmsnorm_bwd_route`.  On the register route (every width of
:data:`ROW_WIDTHS`, both dtypes) blocks of :data:`BWD_WARPS` warps,
:data:`BWD_BLOCKS_PER_SM` per SM, deal the rows out to groups of
:func:`bwd_row_split` warps, each lane keeping its columns' dw sums in
registers across its rows; the loop routes take a row per warp.  Each
block writes one fp32 row of dw partial sums, and a second kernel reduces
them in a fixed order (no float atomics: every run gives the same bits).
:class:`RMSNormFunction` binds the two for autograd;
:func:`rmsnorm` goes through it only when grad is enabled and an input
requires grad, so a call under ``no_grad`` or ``inference_mode`` (the
serving path, its CUDA graphs) is the forward launch alone.  DTensor
inputs (a sharded train step) run under ``local_map`` on the local rows,
w replicated, its gradient a partial sum over the rows' shards.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import Replicate

from repro_torch.distributed import sharding as shd
from repro_torch.kernels import _build

# row widths the register-resident route is instantiated for
# (csrc/rmsnorm.cu): the repo's configs' norms -- MLA's kv_lora 512,
# whisper 1024, mamba2 / qwen2-vl 1536, internlm2 / deepseek 2048, mamba2's
# gated norm 3072, zamba2 3584 and its gated norm 7168
ROW_WIDTHS = frozenset({512, 1024, 1536, 2048, 3072, 3584, 7168})
# the widest row the forward holds in one warp's registers: 28 16-byte
# vectors a lane (bf16 at 7168, fp32 at 3584; fp32 at 7168 would take 56)
ROW_BYTES = 32 * 28 * 16

# route codes of csrc/rmsnorm.cu
ROUTES = {"scalar": 0, "vectors": 1, "registers": 2}

# the backward's register route: blocks of 8 warps, two per SM; a lane
# holds BWD_LANE_BYTES of a row's x (and of its dy) where the row splits
# so, wider rows being shared by 2, 4 or 8 warps (bwd_row_split)
BWD_WARPS = 8
BWD_BLOCKS_PER_SM = 2
BWD_LANE_BYTES = 64
# its loop routes: blocks of 4 warps, a row per warp, two blocks per SM;
# each warp sums its dw terms in a row of fp32 shared memory
BWD_LOOP_WARPS = 4
BWD_MAX_WIDTH = 14336  # 4 * D floats within the 227 KB a block may take


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32, or float64 for float64 inputs (the CPU gradient checks)."""
    return torch.promote_types(dtype, torch.float32)


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x (..., D); w (D,) -> same shape and dtype as x."""
    dt = x.dtype
    xf = x.to(_acc_dtype(dt))
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * w


def rmsnorm_bwd_plain(x, w, dy, eps: float):
    """The gradient of :func:`rmsnorm_plain` as an explicit formula, with
    r = rsqrt(mean(x^2) + eps) and n = cast(x * r) in fp32: dw = sum over
    rows of dy * n; dx = r * (g - x * r^2 * mean(g * x)), g = dy * w.
    Returns (dx in x's dtype, dw in w's dtype)."""
    acc = _acc_dtype(x.dtype)
    xf, dyf = x.to(acc), dy.to(acc)
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    n = (xf * r).to(x.dtype).to(acc)
    dw = (dyf * n).reshape(-1, x.shape[-1]).sum(dim=0).to(w.dtype)
    g = dyf * w.to(acc)
    dx = r * (g - xf * r.square() * (g * xf).mean(dim=-1, keepdim=True))
    return dx.to(x.dtype), dw


def _route(x: torch.Tensor, *others: torch.Tensor) -> str:
    d = x.shape[-1]
    if (d % (16 // x.element_size())
            or any(t.data_ptr() % 16 for t in (x, *others))):
        return "scalar"
    return "registers" if d in ROW_WIDTHS else "vectors"


def rmsnorm_route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The forward's kernel route for contiguous x (..., D) and w (D,):
    "registers" for D in :data:`ROW_WIDTHS` whose row takes at most
    :data:`ROW_BYTES` (decided by bytes a lane, not by width alone: fp32 at
    7168 takes the vectors), "vectors" for another D that is a whole number
    of 16-byte vectors, both only with 16-byte aligned x and w; "scalar"
    otherwise."""
    route = _route(x, w)
    if route == "registers" and x.shape[-1] * x.element_size() > ROW_BYTES:
        return "vectors"
    return route


def rmsnorm_bwd_route(x: torch.Tensor, w: torch.Tensor,
                      dy: torch.Tensor) -> str:
    """The backward's kernel route: "registers" for D in
    :data:`ROW_WIDTHS` in either dtype (a row shared by
    :func:`bwd_row_split` warps), "vectors" for another D that is a whole
    number of 16-byte vectors, both only with 16-byte aligned x, w and dy;
    "scalar" otherwise."""
    return _route(x, w, dy)


def bwd_row_split(d: int, element_size: int) -> int:
    """Warps that share one row on the backward's register route, a power
    of two up to :data:`BWD_WARPS`: the fewest that keep a lane's share of
    the row within :data:`BWD_LANE_BYTES`, or, where the row splits no
    further into whole warp-wide 16-byte vectors, the most it splits into
    (bf16 3584 and 7168, fp32 3584: 112 bytes a lane;
    ``csrc/rmsnorm.cu``'s ``row_split``)."""
    vec = 16 // element_size
    k = 1
    while (k < BWD_WARPS and d * element_size > 32 * BWD_LANE_BYTES * k
           and d % (2 * k * 32 * vec) == 0):
        k *= 2
    return k


def bwd_blocks(rows: int, d: int, element_size: int, route: str,
               sms: int) -> int:
    """The backward's grid for ``rows`` rows on a card of ``sms`` SMs:
    :data:`BWD_BLOCKS_PER_SM` blocks of :data:`BWD_WARPS` per SM on the
    register route, two of :data:`BWD_LOOP_WARPS` on the loop routes, and
    no more blocks than the rows fill (each block takes as many rows at
    once as it has row groups)."""
    if route == "registers":
        per_block = BWD_WARPS // bwd_row_split(d, element_size)
        per_sm = BWD_BLOCKS_PER_SM
    else:
        per_block, per_sm = BWD_LOOP_WARPS, 2
    return max(1, min(-(-rows // per_block), per_sm * sms))


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x (..., D); w (D,) -> same shape and dtype as x.  CPU tensors take
    the plain version; CUDA tensors launch the kernel.  With grad enabled
    and an input that requires grad, the call goes through
    :class:`RMSNormFunction`."""
    mesh = shd.mesh_of(x, w)
    if mesh is not None:
        x = shd.as_dtensor(x, mesh)
        pl = shd.row_placements(x)
        return shd.local_call(
            lambda x, w: rmsnorm(x.contiguous(), w, eps),
            (x, shd.as_dtensor(w, mesh)), (pl, [Replicate()] * mesh.ndim),
            pl, (pl, shd.partial_where_sharded(pl)))
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return RMSNormFunction.apply(x, w, eps)
    return _rmsnorm(x, w, eps)


def _check(x: torch.Tensor, w: torch.Tensor, name: str) -> None:
    d = x.shape[-1]
    if tuple(w.shape) != (d,) or not x.is_contiguous() or not w.is_contiguous():
        raise ValueError(f"{name} takes contiguous x (..., {d}) and w ({d},); "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")


def _rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    if _build.on_cpu(x, w):
        return rmsnorm_plain(x, w, eps)
    dtype = _build.kernel_dtype(x, w)
    d = x.shape[-1]
    _check(x, w, "rmsnorm")
    route = ROUTES[rmsnorm_route(x, w)]
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    rows = x.numel() // d if d else 0
    if rows:
        _build.launch("rmsnorm", "rmsnorm_launch", x.data_ptr(), w.data_ptr(),
                      out.data_ptr(), rows, d, float(eps), dtype, route,
                      _build.stream_of(x))
    return out


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                eps: float):
    """(dx, dw) of :func:`rmsnorm` at x (..., D), w (D,) for the output
    gradient dy (x's shape).  CPU tensors take the plain version; CUDA
    tensors launch the backward kernel, which raises ``ValueError`` for a
    row wider than :data:`BWD_MAX_WIDTH`."""
    if _build.on_cpu(x, w, dy):
        return rmsnorm_bwd_plain(x, w, dy, eps)
    dtype = _build.kernel_dtype(x, w, dy)
    d = x.shape[-1]
    _check(x, w, "rmsnorm_bwd")
    if tuple(dy.shape) != tuple(x.shape) or not dy.is_contiguous():
        raise ValueError(f"rmsnorm_bwd takes a contiguous dy of x's shape "
                         f"{tuple(x.shape)}; got {tuple(dy.shape)}")
    if d > BWD_MAX_WIDTH:
        raise ValueError(f"rmsnorm_bwd: rows of {d} exceed the kernel's "
                         f"{BWD_MAX_WIDTH} (its dw sums in shared memory)")
    route = rmsnorm_bwd_route(x, w, dy)
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    rows = x.numel() // d if d else 0
    if not rows:
        return dx, torch.zeros_like(w)
    dw = torch.empty_like(w)
    blocks = bwd_blocks(rows, d, x.element_size(), route,
                        _build.sm_count(x.device))
    partial = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    _build.launch("rmsnorm_bwd", "rmsnorm_bwd_launch", x.data_ptr(),
                  w.data_ptr(), dy.data_ptr(), dx.data_ptr(), dw.data_ptr(),
                  partial.data_ptr(), rows, d, blocks, float(eps), dtype,
                  ROUTES[route], _build.stream_of(x))
    return dx, dw


class RMSNormFunction(torch.autograd.Function):
    """rmsnorm with its backward kernel: saves x and w, and gives dx and
    dw from :func:`rmsnorm_bwd`."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rmsnorm(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, dy.contiguous(), ctx.eps)
        return dx, dw, None
