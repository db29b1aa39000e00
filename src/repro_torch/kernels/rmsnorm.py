"""RMSNorm: CUDA kernel (``csrc/rmsnorm.cu``), plain version and wrapper.

Counterpart of ``repro/kernels/rmsnorm.py``.  Rounding follows the model
path (``repro/models/layers.py::rms_norm``): normalize in fp32, cast to x's
dtype, then multiply by the scale.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x (..., D); w (D,) -> same shape and dtype as x."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * w


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
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows:
        _build.launch("rmsnorm", "rmsnorm_launch", x.data_ptr(), w.data_ptr(),
                      out.data_ptr(), rows, d, float(eps), dtype,
                      _build.stream_of(x))
    return out
