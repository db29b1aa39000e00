"""RMSNorm: CUDA kernel (``csrc/rmsnorm.cu``), plain version and wrapper.

Counterpart of ``repro/kernels/rmsnorm.py``.  Rounding follows the model
path (``repro/models/layers.py::rms_norm``): normalize in fp32, cast to x's
dtype, then multiply by the scale.

The kernel runs one warp per row by one of three routes, picked by
:func:`rmsnorm_route` from the row width and alignment before any launch:
the row held in registers for the widths in :data:`ROW_WIDTHS`, a loop of
16-byte vectors for any other width that is a whole number of them, and an
element loop for any other width.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

# row widths the register-resident route is instantiated for
# (csrc/rmsnorm.cu): the repo's configs' norms -- MLA's kv_lora 512,
# whisper 1024, mamba2 / qwen2-vl 1536, internlm2 / deepseek 2048, mamba2's
# gated norm 3072, zamba2 3584
ROW_WIDTHS = frozenset({512, 1024, 1536, 2048, 3072, 3584})

# route codes of csrc/rmsnorm.cu
ROUTES = {"scalar": 0, "vectors": 1, "registers": 2}


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x (..., D); w (D,) -> same shape and dtype as x."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * w


def rmsnorm_route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel route for contiguous x (..., D) and w (D,): "registers"
    for D in :data:`ROW_WIDTHS`, "vectors" for another D that is a whole
    number of 16-byte vectors, both only with 16-byte aligned x and w;
    "scalar" otherwise."""
    d = x.shape[-1]
    if d % (16 // x.element_size()) or x.data_ptr() % 16 or w.data_ptr() % 16:
        return "scalar"
    return "registers" if d in ROW_WIDTHS else "vectors"


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x (..., D); w (D,) -> same shape and dtype as x.  CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    if _build.on_cpu(x, w):
        return rmsnorm_plain(x, w, eps)
    dtype = _build.kernel_dtype(x, w)
    d = x.shape[-1]
    if tuple(w.shape) != (d,) or not x.is_contiguous() or not w.is_contiguous():
        raise ValueError(f"rmsnorm takes contiguous x (..., {d}) and w ({d},); "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    route = ROUTES[rmsnorm_route(x, w)]
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    rows = x.numel() // d if d else 0
    if rows:
        _build.launch("rmsnorm", "rmsnorm_launch", x.data_ptr(), w.data_ptr(),
                      out.data_ptr(), rows, d, float(eps), dtype, route,
                      _build.stream_of(x))
    return out
