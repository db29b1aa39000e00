"""PyTorch/CUDA port of the ``repro`` package.

The JAX package ``repro`` stays the reference; this package mirrors its
module layout (``repro_torch/models/layers.py`` <-> ``repro/models/
layers.py``) and imports nothing of it.  Device work runs on an NVIDIA
Hopper card through hand-written CUDA kernels (``repro_torch/csrc``, bound
with ctypes in ``repro_torch/kernels``); each kernel keeps a plain PyTorch
version beside it that serves CPU tensors, which is how the CPU tests run.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA and no explicit device they raise.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    CUDA card.  Never falls back to the CPU quietly."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
