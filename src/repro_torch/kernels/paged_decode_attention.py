"""Paged decode attention, GQA and absorbed MLA: CUDA kernels
(``csrc/paged_decode_attention.cu`` on the KV split it shares with the dense
kernel, ``csrc/paged_mla_decode_attention.cu``), plain versions and
wrappers.

Counterpart of ``repro/kernels/paged_decode_attention.py``: one query token
per row against a block pool addressed through ``block_tables`` (B, W);
block j of row b holds cache positions [j*BS, (j+1)*BS).  Table entries
past a row's live blocks may point anywhere (the scratch block): they are
never read.  ``paged_decode_attention`` reads KV pools (NB, BS, Nkv, H);
``paged_mla_decode_attention`` reads MLA's latent pools (NB, BS, R) and
(NB, BS, PR), which have no head axis.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (DECODE_TILES_PER_SPLIT,
                                                  check_tensor_cores,
                                                  decode_attention_plain,
                                                  masked_softmax_pv,
                                                  split_scratch)


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
    tensors launch the kernel: the dense kernel's KV split over pool blocks
    (one thread block per (split of ``DECODE_TILES_PER_SPLIT`` blocks, up to
    16 query heads of one kv head, row), then a merge in split order), so a
    row gives the bits of dense decode with ``block_k`` = BS.  bf16 runs on
    the tensor cores (``check_tensor_cores`` says what it takes); fp32 on the
    CUDA cores at any widths."""
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
    if q.dtype == torch.bfloat16:
        check_tensor_cores("paged_decode_attention", bs, q, k_pool, v_pool)
    _build.check_index("paged_decode_attention block_tables", block_tables,
                       (b, w))
    _build.check_index("paged_decode_attention lengths", lengths, (b,))
    out = torch.empty_like(q)
    if b and nq:  # a table of width 0 leaves every row at length 0: output 0
        scratch = split_scratch(q, w)
        pb, pt, pn, _ = k_pool.stride()
        _build.launch(
            "paged_decode_attention", "paged_decode_attention_launch",
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), b, nq, nkv, h, bs, w, DECODE_TILES_PER_SPLIT,
            pb, pt, pn, float(scale if scale is not None else h ** -0.5),
            dtype, _build.stream_of(q))
    return out


def paged_mla_decode_attention_plain(q_lat, q_rope, ckv_pool, krope_pool,
                                     block_tables, lengths, *,
                                     scale: float | None = None):
    """q_lat (B,Nq,R); q_rope (B,Nq,PR); pools (NB,BS,R) / (NB,BS,PR);
    block_tables (B,W); lengths (B,) -> o_lat (B,Nq,R): the absorbed
    softmax over each row's gathered latent blocks, key concat(c_kv,
    k_rope), value c_kv."""
    b, w = block_tables.shape
    bs = ckv_pool.shape[1]
    r, pr = q_lat.shape[-1], q_rope.shape[-1]
    scale = scale if scale is not None else (r + pr) ** -0.5
    idx = block_tables.long()
    ckv = ckv_pool[idx].reshape(b, w * bs, r)
    krope = krope_pool[idx].reshape(b, w * bs, pr)
    scores = (torch.einsum("bnr,btr->bnt", q_lat.float(), ckv.float())
              + torch.einsum("bnp,btp->bnt", q_rope.float(), krope.float())
              ) * scale
    pos = torch.arange(w * bs, device=q_lat.device)
    valid = (pos[None, :] < lengths.long()[:, None])[:, None, :]
    return masked_softmax_pv(scores, valid, ckv,
                             "bnt,btr->bnr").to(q_lat.dtype)


# KV split of paged_mla_decode_attention: split s of a row walks the row's
# blocks [s*T, (s+1)*T), T = MLA_TILES_PER_SPLIT, in one thread block.  A
# fixed T keeps every split's positions a function of block indices alone
# (never of the table width, the batch or the grid), so a row gives the same
# bits through any table that holds its blocks.
MLA_TILES_PER_SPLIT = 2
# (R, PR, BS) of the bf16 tensor-core kernel (deepseek-v2's latent 512,
# rope 64, blocks of 16 positions); fp32 takes any widths
MLA_TENSOR_CORE_WIDTHS = (512, 64, 16)


def mla_splits(width: int) -> int:
    """Splits per row of a launch over a block table of ``width`` blocks:
    the grid is sized from the width alone, so no length is read on the
    host; splits past a row's live blocks exit at once."""
    return -(-width // MLA_TILES_PER_SPLIT)


def mla_scratch_shapes(b: int, nq: int, r: int, width: int):
    """Shapes of a launch's fp32 scratch: the splits' unnormalised
    accumulators (B, NS, Nq, R) and their (max, denominator) pairs
    (B, NS, Nq, 2), NS = :func:`mla_splits`."""
    ns = mla_splits(width)
    return (b, ns, nq, r), (b, ns, nq, 2)


def paged_mla_decode_attention(q_lat, q_rope, ckv_pool, krope_pool,
                               block_tables, lengths, *,
                               scale: float | None = None):
    """q_lat (B,Nq,R); q_rope (B,Nq,PR); pools ckv (NB,BS,R) / k_rope
    (NB,BS,PR); block_tables (B,W) int32; lengths (B,) int32 -> o_lat
    (B,Nq,R).  ``scale`` defaults to (R+PR)^-0.5 as in the reference; the
    model passes 1/sqrt(qk_nope + qk_rope).  CPU tensors take the plain
    version; CUDA tensors launch the kernel: one thread block per (KV split,
    16 heads, row) reads each latent tile of its split once for its heads,
    and a merge pass combines each row's splits in split order.  bf16 runs
    on the tensor cores at (R, PR, BS) = :data:`MLA_TENSOR_CORE_WIDTHS` with
    16-byte aligned pools, and raises ``ValueError`` elsewhere; fp32 runs on
    the CUDA cores at any widths.  The scratch is allocated per call on the
    caller's stream, so concurrent calls on two streams share nothing."""
    if _build.on_cpu(q_lat, q_rope, ckv_pool, krope_pool, block_tables,
                     lengths):
        return paged_mla_decode_attention_plain(
            q_lat, q_rope, ckv_pool, krope_pool, block_tables, lengths,
            scale=scale)
    dtype = _build.kernel_dtype(q_lat, q_rope, ckv_pool, krope_pool)
    b, nq, r = q_lat.shape
    nb, bs, pr = krope_pool.shape
    w = block_tables.shape[1] if block_tables.dim() == 2 else -1
    if (tuple(q_rope.shape) != (b, nq, pr)
            or tuple(ckv_pool.shape) != (nb, bs, r)
            or not q_lat.is_contiguous() or not q_rope.is_contiguous()):
        raise ValueError(
            f"paged_mla_decode_attention: q_lat (B,Nq,R) and q_rope "
            f"(B,Nq,PR) contiguous, pools (NB,BS,R) / (NB,BS,PR); got q_lat "
            f"{tuple(q_lat.shape)}, q_rope {tuple(q_rope.shape)}, pools "
            f"{tuple(ckv_pool.shape)} / {tuple(krope_pool.shape)}")
    _build.check_unit_stride("paged_mla_decode_attention ckv_pool", ckv_pool)
    _build.check_unit_stride("paged_mla_decode_attention krope_pool",
                             krope_pool)
    if q_lat.dtype == torch.bfloat16:
        if (r, pr, bs) != MLA_TENSOR_CORE_WIDTHS:
            raise ValueError(
                f"paged_mla_decode_attention: no bf16 kernel for (R, PR, BS) "
                f"= {(r, pr, bs)}; instantiated: {MLA_TENSOR_CORE_WIDTHS}")
        for name, t in (("q_lat", q_lat), ("q_rope", q_rope),
                        ("ckv_pool", ckv_pool), ("krope_pool", krope_pool)):
            _build.check_aligned(f"paged_mla_decode_attention {name}", t)
    _build.check_index("paged_mla_decode_attention block_tables",
                       block_tables, (b, w))
    _build.check_index("paged_mla_decode_attention lengths", lengths, (b,))
    out = torch.empty_like(q_lat)
    if b and nq:
        acc_shape, stats_shape = mla_scratch_shapes(b, nq, r, w)
        acc = torch.empty(acc_shape, dtype=torch.float32, device=q_lat.device)
        stats = torch.empty(stats_shape, dtype=torch.float32,
                            device=q_lat.device)
        _build.launch(
            "paged_mla_decode_attention", "paged_mla_decode_attention_launch",
            q_lat.data_ptr(), q_rope.data_ptr(), ckv_pool.data_ptr(),
            krope_pool.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), acc.data_ptr(), stats.data_ptr(), b, nq, r, pr,
            bs, w, MLA_TILES_PER_SPLIT, *ckv_pool.stride()[:2],
            *krope_pool.stride()[:2],
            float(scale if scale is not None else (r + pr) ** -0.5), dtype,
            _build.stream_of(q_lat))
    return out
