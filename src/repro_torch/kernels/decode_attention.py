"""Dense decode attention: CUDA kernel (``csrc/decode_attention.cu``), plain
version and wrapper, and the KV split that it shares with the paged kernel
(``csrc/decode_split.cuh``).

Counterpart of ``repro/kernels/decode_attention.py``, in the model's cache
layout: q (B, Nq, H) against k/v caches (B, Smax, Nkv, H) with per-row
``lengths`` (positions >= lengths[b] are masked; the model passes
``pos + 1`` because it writes the new token before attending).  With
``row_ids`` (B,), row b reads row ``row_ids[b]`` of a (R, Smax, Nkv, H)
cache instead: the enc-dec decoder's shared cross-attention segments,
addressed by each stream's segment id without a gathered copy.

DTensor inputs (a sharded decode step) run under ``local_map``: the
cache's batch shards stay, head shards where both head counts divide,
every other shard (a sharded sequence) is gathered, and the wrapper sees
the local tensors only.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import Shard

from repro_torch.distributed import sharding as shd
from repro_torch.kernels import _build

NEG_INF = -1e30
# KV tile of the kernel: the serving engine's default kv_block_size, so the
# dense and paged decode kernels do the same arithmetic per row
DEFAULT_BLOCK_K = 16
# KV split of the decode pair: split s of a row walks the row's tiles
# [s*T, (s+1)*T), T = DECODE_TILES_PER_SPLIT, in one thread block (a tile is
# a pool block, or block_k positions of the dense cache).  A fixed T keeps
# every split's positions a function of tile indices alone (never of the
# table width, the batch or the grid), so a row gives the same bits through
# any table that holds its blocks and through the dense cache.
DECODE_TILES_PER_SPLIT = 2
# head widths of the bf16 tensor-core kernel: every GQA config's head_dim
# (internlm2, llama3, granite, qwen 128; zamba2 112; whisper 64) and the
# reduced configs' 16 (the serving launcher's); fp32 runs on the CUDA cores
# at any width
DECODE_TENSOR_CORE_WIDTHS = (16, 64, 112, 128)


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


def decode_attention_plain(q, k, v, lengths, *, scale: float | None = None,
                           row_ids=None):
    """q (B,Nq,H); k/v (B,Smax,Nkv,H), or (R,Smax,Nkv,H) with ``row_ids``
    (B,) picking each row's; lengths (B,) -> (B,Nq,H)."""
    if row_ids is not None:
        k, v = k[row_ids.long()], v[row_ids.long()]
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


def decode_splits(width: int) -> int:
    """Splits per row of a launch over ``width`` tiles (a block table's
    width, or ceil(Smax / block_k)): the grid is sized from the width alone,
    so no length is read on the host; splits past a row's live tiles exit
    at once."""
    return -(-width // DECODE_TILES_PER_SPLIT)


def decode_scratch_shapes(b: int, nq: int, h: int, width: int):
    """Shapes of a launch's fp32 scratch, one tensor carved in two: the
    splits' unnormalised accumulators (B, NS, Nq, H), then their (max,
    denominator) pairs (B, NS, Nq, 2), NS = :func:`decode_splits`."""
    ns = decode_splits(width)
    return (b, ns, nq, h), (b, ns, nq, 2)


def split_scratch(q: torch.Tensor, width: int) -> torch.Tensor:
    """A launch's scratch, fresh on the caller's stream (so two calls in
    flight on two streams share nothing): B * NS * Nq * (H + 2) floats."""
    acc, stats = decode_scratch_shapes(*q.shape, width)
    return torch.empty(math.prod(acc) + math.prod(stats),
                       dtype=torch.float32, device=q.device)


def check_tensor_cores(name: str, tile: int, *tensors: torch.Tensor) -> None:
    """bf16 runs on the tensor cores: a head width of
    :data:`DECODE_TENSOR_CORE_WIDTHS`, tiles of a multiple of 16 positions
    and 16-byte aligned operands, else ``ValueError`` before any launch."""
    h = tensors[0].shape[-1]
    if h not in DECODE_TENSOR_CORE_WIDTHS or tile % 16:
        raise ValueError(
            f"{name}: no bf16 kernel for head width {h} with tiles of {tile} "
            f"positions; instantiated: H in {DECODE_TENSOR_CORE_WIDTHS}, "
            "tiles a multiple of 16")
    for t in tensors:
        _build.check_aligned(name, t)


def _decode_sharded(mesh, q, k, v, lengths, scale, block_k, row_ids):
    """:func:`decode_attention` on DTensors, per mesh dim: the rows where
    the cache's batch is sharded (not with ``row_ids``, which index the
    whole cache), else the heads where Nq and Nkv divide, else gathered."""
    plan = shd.kernel_plan(mesh, k, (q.shape[1], k.shape[2]),
                           batch=row_ids is None)
    qp = shd.plan_placements(plan, batch=Shard(0), heads=Shard(1))
    kp = shd.plan_placements(plan, batch=Shard(0), heads=Shard(2))
    rp = shd.plan_placements(plan, batch=Shard(0))
    args = [q, k, v, lengths] + ([] if row_ids is None else [row_ids])
    pls = [qp, kp, kp, rp] + ([] if row_ids is None else [rp])

    def local(q, k, v, lengths, row_ids=None):
        return decode_attention(q, k, v, lengths, scale=scale,
                                block_k=block_k, row_ids=row_ids)

    return shd.local_call(local, [shd.as_dtensor(t, mesh) for t in args],
                          pls, qp)


def decode_attention(q, k, v, lengths, *, scale: float | None = None,
                     block_k: int = DEFAULT_BLOCK_K, row_ids=None):
    """q (B,Nq,H); k/v (B,Smax,Nkv,H); lengths (B,) int32 -> (B,Nq,H).
    With ``row_ids`` (B,) int32 in [0, R), k/v are (R,Smax,Nkv,H) and row b
    attends to row ``row_ids[b]`` (read in place: the kernel's address map,
    not a gather; ids are not range-checked, as block tables are not).
    CPU tensors take the plain version; CUDA tensors launch the kernel: one
    thread block per (KV split of :data:`DECODE_TILES_PER_SPLIT` tiles of
    ``block_k`` positions, up to 16 query heads of one kv head, row), then a
    merge of each row's splits in split order.  bf16 runs on the tensor
    cores (see :func:`check_tensor_cores` for what it takes); fp32 on the
    CUDA cores at any widths."""
    ids = () if row_ids is None else (row_ids,)
    mesh = shd.mesh_of(q, k, v, lengths, *ids)
    if mesh is not None:
        return _decode_sharded(mesh, q, k, v, lengths, scale, block_k, row_ids)
    if _build.on_cpu(q, k, v, lengths, *ids):
        return decode_attention_plain(q, k, v, lengths, scale=scale,
                                      row_ids=row_ids)
    dtype = _build.kernel_dtype(q, k, v)
    b, nq, h = q.shape
    _, smax, nkv, hk = k.shape
    if row_ids is not None:
        _build.check_index("decode_attention row_ids", row_ids, (b,))
    elif k.shape[0] != b:
        raise ValueError(f"decode_attention: k/v hold {k.shape[0]} rows for "
                         f"{b} queries and no row_ids")
    if (tuple(v.shape) != tuple(k.shape) or hk != h
            or nq % nkv or k.stride() != v.stride() or not q.is_contiguous()
            or block_k < 1):
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)} (contiguous), k/v "
            f"(R,Smax,Nkv,H) with equal strides, block_k >= 1; got k "
            f"{tuple(k.shape)} {k.stride()}, v {tuple(v.shape)} {v.stride()}")
    _build.check_unit_stride("decode_attention k", k)
    if q.dtype == torch.bfloat16:
        check_tensor_cores("decode_attention", block_k, q, k, v)
    _build.check_index("decode_attention lengths", lengths, (b,))
    out = torch.empty_like(q)
    if b and nq:
        width = -(-smax // block_k)
        scratch = split_scratch(q, width)
        sb, ss, sn, _ = k.stride()
        _build.launch(
            "decode_attention", "decode_attention_launch", q.data_ptr(),
            k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            None if row_ids is None else row_ids.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), b, nq, nkv, h, smax, sb, ss, sn, block_k,
            DECODE_TILES_PER_SPLIT,
            float(scale if scale is not None else h ** -0.5), dtype,
            _build.stream_of(q))
    return out
