"""Paged decode attention, GQA and absorbed MLA: CUDA kernels
(``csrc/paged_decode_attention.cu``, ``csrc/paged_mla_decode_attention.cu``),
plain versions and wrappers.

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
from repro_torch.kernels.decode_attention import (decode_attention_plain,
                                                  masked_softmax_pv)


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


def paged_mla_decode_attention(q_lat, q_rope, ckv_pool, krope_pool,
                               block_tables, lengths, *,
                               scale: float | None = None,
                               heads_per_block: int | None = None):
    """q_lat (B,Nq,R); q_rope (B,Nq,PR); pools ckv (NB,BS,R) / k_rope
    (NB,BS,PR); block_tables (B,W) int32; lengths (B,) int32 -> o_lat
    (B,Nq,R).  ``scale`` defaults to (R+PR)^-0.5 as in the reference; the
    model passes 1/sqrt(qk_nope + qk_rope).  CPU tensors take the plain
    version; CUDA tensors launch the kernel, one thread block per
    ``heads_per_block`` heads of a row (default: all Nq), which reads each
    latent tile once for its heads."""
    if _build.on_cpu(q_lat, q_rope, ckv_pool, krope_pool, block_tables,
                     lengths):
        return paged_mla_decode_attention_plain(
            q_lat, q_rope, ckv_pool, krope_pool, block_tables, lengths,
            scale=scale)
    dtype = _build.kernel_dtype(q_lat, q_rope, ckv_pool, krope_pool)
    b, nq, r = q_lat.shape
    nb, bs, pr = krope_pool.shape
    g = nq if heads_per_block is None else heads_per_block
    w = block_tables.shape[1] if block_tables.dim() == 2 else -1
    if (tuple(q_rope.shape) != (b, nq, pr)
            or tuple(ckv_pool.shape) != (nb, bs, r) or g < 1 or nq % g
            or not q_lat.is_contiguous() or not q_rope.is_contiguous()):
        raise ValueError(
            f"paged_mla_decode_attention: q_lat (B,Nq,R) and q_rope "
            f"(B,Nq,PR) contiguous, pools (NB,BS,R) / (NB,BS,PR), heads per "
            f"block dividing Nq; got q_lat {tuple(q_lat.shape)}, q_rope "
            f"{tuple(q_rope.shape)}, pools {tuple(ckv_pool.shape)} / "
            f"{tuple(krope_pool.shape)}, {g} heads per block")
    _build.check_unit_stride("paged_mla_decode_attention ckv_pool", ckv_pool)
    _build.check_unit_stride("paged_mla_decode_attention krope_pool",
                             krope_pool)
    _build.check_index("paged_mla_decode_attention block_tables",
                       block_tables, (b, w))
    _build.check_index("paged_mla_decode_attention lengths", lengths, (b,))
    out = torch.empty_like(q_lat)
    if b:  # a table of width 0 leaves every row at length 0: output 0
        _build.launch(
            "paged_mla_decode_attention", "paged_mla_decode_attention_launch",
            q_lat.data_ptr(), q_rope.data_ptr(), ckv_pool.data_ptr(),
            krope_pool.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), b, nq, g, r, pr, bs, w, *ckv_pool.stride()[:2],
            *krope_pool.stride()[:2],
            float(scale if scale is not None else (r + pr) ** -0.5), dtype,
            _build.stream_of(q_lat))
    return out
