"""Paged decode attention: CUDA kernel (``csrc/paged_decode_attention.cu``),
plain version and wrapper.

Counterpart of ``repro/kernels/paged_decode_attention.py::
paged_decode_attention``: one query token per row against a KV block pool
(NB, BS, Nkv, H) addressed through ``block_tables`` (B, W); block j of row
b holds cache positions [j*BS, (j+1)*BS).  Table entries past a row's live
blocks may point anywhere (the scratch block): they are never read.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import decode_attention_plain


def paged_decode_attention_plain(q, k_pool, v_pool, block_tables, lengths, *,
                                 scale: float | None = None):
    """q (B,Nq,H); pools (NB,BS,Nkv,H); block_tables (B,W); lengths (B,)
    -> (B,Nq,H): dense decode over each row's gathered blocks."""
    b, w = block_tables.shape
    bs = k_pool.shape[1]
    idx = block_tables.long()

    def gather(pool):
        return pool[idx].reshape(b, w * bs, *pool.shape[2:])

    return decode_attention_plain(q, gather(k_pool), gather(v_pool), lengths,
                                  scale=scale)


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           scale: float | None = None):
    """q (B,Nq,H); pools (NB,BS,Nkv,H); block_tables (B,W) int32; lengths
    (B,) int32 -> (B,Nq,H).  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if _build.on_cpu(q, k_pool, v_pool, block_tables, lengths):
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                            lengths, scale=scale)
    dtype = _build.kernel_dtype(q, k_pool, v_pool)
    b, nq, h = q.shape
    _, bs, nkv, hk = k_pool.shape
    w = block_tables.shape[1] if block_tables.dim() == 2 else -1
    if (tuple(v_pool.shape) != tuple(k_pool.shape) or hk != h or nq % nkv
            or k_pool.stride() != v_pool.stride() or not q.is_contiguous()):
        raise ValueError(
            f"paged_decode_attention: q {tuple(q.shape)} (contiguous), pools "
            f"(NB,BS,Nkv,H) with equal strides; got k {tuple(k_pool.shape)} "
            f"{k_pool.stride()}, v {tuple(v_pool.shape)} {v_pool.stride()}")
    _build.check_unit_stride("paged_decode_attention pools", k_pool)
    _build.check_index("paged_decode_attention block_tables", block_tables,
                       (b, w))
    _build.check_index("paged_decode_attention lengths", lengths, (b,))
    out = torch.empty_like(q)
    if b:  # a table of width 0 leaves every row at length 0: output 0
        pb, pt, pn, _ = k_pool.stride()
        _build.launch(
            "paged_decode_attention", "paged_decode_attention_launch",
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            b, nq, nkv, h, bs, w, pb, pt, pn,
            float(scale if scale is not None else h ** -0.5), dtype,
            _build.stream_of(q))
    return out
