"""Causal or full GQA prefill attention: CUDA kernel
(``csrc/flash_attention.cu``), plain version and wrapper.

Counterpart of ``repro/kernels/flash_attention.py``, in the model's
(B, S, N, H) layout (the kernel reads it through strides; nothing is
transposed).  The value width may differ from the query/key width: MLA
prefill attends with H = qk_nope + qk_rope and Hv = v_head_dim.  Full
(``causal=False``) attention may take a key/value length Sk of its own:
enc-dec cross-attention attends from the decoder's S tokens to the
encoder's Sk frames.  The plain version is the model's ``_sdpa``
(``repro/models/layers.py:118``): it rounds the normalised softmax
probabilities to the value dtype before the PV product.  The kernel has
two versions, chosen by dtype: fp32 runs on the CUDA cores and keeps the
probabilities in fp32 (agreeing with the plain version to 1e-5); bf16 runs
on the tensor cores and rounds the unnormalised probabilities to bf16
(agreeing to the bf16 tolerance), for the head widths in
:data:`TENSOR_CORE_WIDTHS` only and with 16-byte aligned operands.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

# (H, Hv) pairs the bf16 tensor-core kernel is instantiated for
# (csrc/flash_attention.cu): the repo's attention configs' head widths --
# internlm2, llama3, granite, qwen (128), whisper (64), zamba2 (112) and
# MLA prefill (192 / 128)
TENSOR_CORE_WIDTHS = frozenset({(64, 64), (112, 112), (128, 128),
                                (192, 128)})


def sdpa(q, k, v, *, mask, scale: float):
    """q (B,Sq,Nq,H); k/v (B,Sk,Nkv,H); grouped heads; fp32 softmax.
    ``mask`` broadcasts against (B, Nkv, g, Sq, Sk)."""
    b, sq, nq, h = q.shape
    nkv = k.shape[2]
    hv = v.shape[-1]
    g = nq // nkv
    qg = q.reshape(b, sq, nkv, g, h)
    logits = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, sq, nq, hv).to(v.dtype)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          scale: float | None = None):
    """q (B,S,Nq,H); k (B,Sk,Nkv,H); v (B,Sk,Nkv,Hv) -> (B,S,Nq,Hv); Sk = S
    when ``causal``."""
    s = q.shape[1]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    mask = None
    if causal:
        idx = torch.arange(s, device=q.device)
        mask = (idx[None, :] <= idx[:, None])[None, None, None]
    return sdpa(q, k, v, mask=mask, scale=scale)


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None):
    """q (B,S,Nq,H); k (B,Sk,Nkv,H); v (B,Sk,Nkv,Hv) -> (B,S,Nq,Hv) in q's
    dtype, Sk = S when ``causal``.  CPU tensors take the plain version;
    CUDA tensors launch the kernel, which in bf16 raises ``ValueError`` for
    an (H, Hv) outside :data:`TENSOR_CORE_WIDTHS` or an operand whose base
    or strides are not 16-byte aligned."""
    if _build.on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    dtype = _build.kernel_dtype(q, k, v)
    b, s, nq, h = q.shape
    sk, nkv, hv = k.shape[1], k.shape[2], v.shape[-1]
    if (tuple(k.shape) != (b, sk, nkv, h)
            or tuple(v.shape) != (b, sk, nkv, hv) or nq % nkv or sk < 1
            or (causal and sk != s)):
        raise ValueError(
            f"flash_attention: q (B,S,Nq,H), k (B,Sk,Nkv,H), v (B,Sk,Nkv,Hv), "
            f"Sk >= 1 and Sk = S when causal; got q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, causal={causal}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_unit_stride(f"flash_attention {name}", t)
        if q.dtype == torch.bfloat16:
            _build.check_aligned(f"flash_attention {name}", t)
    if q.dtype == torch.bfloat16 and (h, hv) not in TENSOR_CORE_WIDTHS:
        raise ValueError(
            f"flash_attention: no bf16 kernel for head widths (H, Hv) = "
            f"({h}, {hv}); instantiated: {sorted(TENSOR_CORE_WIDTHS)}")
    out = torch.empty((b, s, nq, hv), dtype=q.dtype, device=q.device)
    if b and s:
        _build.launch(
            "flash_attention", "flash_attention_launch", q.data_ptr(),
            k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, sk, nq, nkv, h,
            hv, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], int(causal),
            float(scale if scale is not None else h ** -0.5), dtype,
            _build.stream_of(q))
    return out
