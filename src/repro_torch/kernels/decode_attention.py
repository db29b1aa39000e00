"""Dense decode attention: CUDA kernel (``csrc/decode_attention.cu``), plain
version and wrapper.

Counterpart of ``repro/kernels/decode_attention.py``, in the model's cache
layout: q (B, Nq, H) against k/v caches (B, Smax, Nkv, H) with per-row
``lengths`` (positions >= lengths[b] are masked; the model passes
``pos + 1`` because it writes the new token before attending).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
# KV tile of the kernel: the serving engine's default kv_block_size, so the
# dense and paged decode kernels do the same arithmetic per row
DEFAULT_BLOCK_K = 16


def masked_softmax_pv(scores: torch.Tensor, valid: torch.Tensor,
                      v: torch.Tensor, equation: str) -> torch.Tensor:
    """The online-softmax recurrence's result in one pass: softmax over the
    last axis of fp32 ``scores`` restricted to ``valid``, times ``v`` (by
    ``equation``), divided by max(l, 1e-30) -- so a row with no valid
    position gives 0, as the kernels' finalize does, not NaN."""
    s = torch.where(valid, scores, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum(equation, p / denom, v.float())


def decode_attention_plain(q, k, v, lengths, *, scale: float | None = None):
    """q (B,Nq,H); k/v (B,Smax,Nkv,H); lengths (B,) -> (B,Nq,H)."""
    b, nq, h = q.shape
    smax, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    scale = scale if scale is not None else h ** -0.5
    qg = q.float().reshape(b, nkv, g, h)
    scores = torch.einsum("bkgh,btkh->bkgt", qg, k.float()) * scale
    pos = torch.arange(smax, device=q.device)
    valid = (pos[None, :] < lengths.long()[:, None])[:, None, None, :]
    out = masked_softmax_pv(scores, valid, v, "bkgt,btkh->bkgh")
    return out.reshape(b, nq, h).to(q.dtype)


def decode_attention(q, k, v, lengths, *, scale: float | None = None,
                     block_k: int = DEFAULT_BLOCK_K):
    """q (B,Nq,H); k/v (B,Smax,Nkv,H); lengths (B,) int32 -> (B,Nq,H).
    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which sweeps KV tiles of ``block_k`` positions."""
    if _build.on_cpu(q, k, v, lengths):
        return decode_attention_plain(q, k, v, lengths, scale=scale)
    dtype = _build.kernel_dtype(q, k, v)
    b, nq, h = q.shape
    _, smax, nkv, hk = k.shape
    if (tuple(v.shape) != tuple(k.shape) or k.shape[0] != b or hk != h
            or nq % nkv or k.stride() != v.stride() or not q.is_contiguous()
            or block_k < 1):
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)} (contiguous), k/v "
            f"(B,Smax,Nkv,H) with equal strides, block_k >= 1; got k "
            f"{tuple(k.shape)} {k.stride()}, v {tuple(v.shape)} {v.stride()}")
    _build.check_unit_stride("decode_attention k", k)
    _build.check_index("decode_attention lengths", lengths, (b,))
    out = torch.empty_like(q)
    if b:
        sb, ss, sn, _ = k.stride()
        _build.launch(
            "decode_attention", "decode_attention_launch", q.data_ptr(),
            k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            b, nq, nkv, h, smax, sb, ss, sn, block_k,
            float(scale if scale is not None else h ** -0.5), dtype,
            _build.stream_of(q))
    return out
