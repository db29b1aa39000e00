"""The KV split of the GQA decode pair (``csrc/decode_split.cuh``), on the CPU.

The CUDA kernels of ``decode_attention`` and ``paged_decode_attention`` walk
each row's KV tiles in splits of ``DECODE_TILES_PER_SPLIT`` tiles, one
thread block per (split, group of up to 16 query heads of one kv head,
row), and merge each row's splits in split order.  Here the host side of
that plan (split counts, scratch shapes, the tensor-core widths) is checked,
and the split-and-merge arithmetic, emulated in torch in fp32, is held
against the plain versions, the Pallas kernels in interpret mode and the
``repro.kernels.ref`` oracles (1e-5, atol and rtol), at lengths on both
sides of the split boundaries and at every GQA group size of the repo's
configs.  Inputs are made with numpy from a seed.  The CUDA kernels
themselves run only on a card: test_torch_cuda.py holds each against its
plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.paged_decode_attention import (
    paged_decode_attention as jax_paged)
from repro_torch.kernels.decode_attention import (
    DECODE_TENSOR_CORE_WIDTHS, DECODE_TILES_PER_SPLIT, DEFAULT_BLOCK_K,
    decode_attention_plain, decode_scratch_shapes, decode_splits,
    split_scratch)
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention, paged_decode_attention_plain)

T = DECODE_TILES_PER_SPLIT
BS = 16
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _split_merge(q, tile, width, bs, lengths, scale):
    """The CUDA kernels' algorithm in torch, fp32.  ``tile(row, j)`` gives
    tile j of a row as (k, v), each (bs, Nkv, H).  Split s of a row walks
    its tiles [s*T, (s+1)*T) with its own softmax state per query head (max
    m, denominator l, unnormalised accumulator), and the merge combines the
    row's live splits in split order; a row with none gives 0."""
    b, nq, h = q.shape
    out = torch.zeros((b, nq, h), dtype=torch.float32)
    for row in range(b):
        n = max(0, min(int(lengths[row]), width * bs))
        ntiles = -(-n // bs)
        parts = []
        for s in range(decode_splits(width)):
            t0 = s * T
            if t0 >= ntiles:
                break
            ks, vs = zip(*(tile(row, j)
                           for j in range(t0, min(t0 + T, ntiles))))
            k, v = torch.cat(ks).float(), torch.cat(vs).float()
            nkv = k.shape[1]
            qg = q[row].float().reshape(nkv, nq // nkv, h)
            pos = torch.arange(t0 * bs, t0 * bs + k.shape[0])
            sc = torch.einsum("kgh,tkh->kgt", qg, k) * scale
            sc = torch.where(pos < n, sc, torch.tensor(-1e30))
            m = sc.amax(-1)
            p = torch.exp(sc - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("kgt,tkh->kgh", p, v)))
        if parts:
            mx = torch.stack([m for m, _, _ in parts]).amax(0)
            acc = torch.zeros_like(parts[0][2])
            den = torch.zeros_like(mx)
            for m, l, a in parts:
                wt = torch.exp(m - mx)
                den = den + l * wt
                acc = acc + a * wt[..., None]
            out[row] = (acc / den.clamp_min(1e-30)[..., None]).reshape(nq, h)
    return out


def _paged_tiles(k_pool, v_pool, tables):
    return lambda row, j: (k_pool[int(tables[row, j])],
                           v_pool[int(tables[row, j])])


def _dense_tiles(k, v, bk):
    return lambda row, j: (k[row, j * bk:(j + 1) * bk],
                           v[row, j * bk:(j + 1) * bk])


def _paged_inputs(seed, b, nq, nkv, h, w, lengths):
    """q, pools of b * w + 1 blocks (block 0 the scratch block, full of
    1e4), tables with each row's live blocks drawn without replacement
    and lanes past them on block 0 -- as (jax, torch) pairs."""
    rng = np.random.default_rng(seed)
    nb = b * w + 1
    q = rng.standard_normal((b, nq, h), dtype=np.float32)
    kp = rng.standard_normal((nb, BS, nkv, h), dtype=np.float32)
    vp = rng.standard_normal((nb, BS, nkv, h), dtype=np.float32)
    kp[0] = vp[0] = 1e4
    perm = rng.permutation(nb - 1) + 1
    tables = np.zeros((b, w), np.int32)
    used = 0
    for i, n in enumerate(lengths):
        need = -(-n // BS)
        tables[i, :need] = perm[used:used + need]
        used += need
    lens = np.asarray(lengths, np.int32)
    return ([jnp.asarray(a) for a in (q, kp, vp, tables, lens)],
            [torch.from_numpy(a) for a in (q, kp, vp, tables, lens)])


class TestSplitPlan:
    """The host side of the kernels' split KV sweep."""

    @pytest.mark.parametrize("width,splits", [
        (0, 0), (1, 1), (T, 1), (T + 1, 2), (16, -(-16 // T)),
        (32, -(-32 // T)),
    ])
    def test_splits_follow_the_width_alone(self, width, splits):
        assert decode_splits(width) == splits

    def test_scratch_shapes(self):
        ns = decode_splits(16)
        assert decode_scratch_shapes(4, 16, 128, 16) == ((4, ns, 16, 128),
                                                         (4, ns, 16, 2))
        assert decode_scratch_shapes(2, 4, 64, 0) == ((2, 0, 4, 64),
                                                      (2, 0, 4, 2))
        # one tensor carved in two: the accumulators, then the (m, l) pairs
        q = torch.zeros((4, 16, 128), dtype=torch.bfloat16)
        acc, stats = decode_scratch_shapes(4, 16, 128, 16)
        scratch = split_scratch(q, 16)
        assert scratch.dtype == torch.float32
        assert scratch.numel() == np.prod(acc) + np.prod(stats)

    def test_tensor_core_widths_cover_every_gqa_config(self):
        """Every GQA config's head width has a bf16 kernel, and the engine's
        block size and the dense tile are whole 16-position mma tiles."""
        import inspect

        from repro_torch.configs.registry import get_config, list_configs
        from repro_torch.serving.engine import ServeEngine

        for name in list_configs():
            cfg = get_config(name)
            if cfg.num_heads and cfg.attn_type != "mla":
                assert cfg.head_dim in DECODE_TENSOR_CORE_WIDTHS, name
                assert cfg.num_heads % cfg.num_kv_heads == 0, name
        block = inspect.signature(ServeEngine).parameters["kv_block_size"]
        assert block.default % 16 == 0 and DEFAULT_BLOCK_K % 16 == 0


class TestSplitMerge:
    """The split-and-merge arithmetic against the plain versions, Pallas
    (interpret mode) and ``ref``, and its independence of the width."""

    @pytest.mark.parametrize("h", [64, 112, 128])
    @pytest.mark.parametrize("g,nkv", [(1, 2), (2, 2), (6, 2), (16, 1),
                                       (48, 1)])
    def test_matches_plain_pallas_and_ref(self, g, nkv, h):
        """Lengths 16T - 1, 16T, 16T + 1 and 32T + 1: the last position of
        a split, the first of the next, one past, and the first of a third
        split; lanes past them point at a scratch block of 1e4."""
        lengths = [BS * T - 1, BS * T, BS * T + 1, 2 * BS * T + 1]
        b, nq, w = len(lengths), g * nkv, -(-max(lengths) // BS) + 1
        (qj, kj, vj, tj, lj), (q, kp, vp, tables, lens) = _paged_inputs(
            60 + g + h, b, nq, nkv, h, w, lengths)
        scale = h ** -0.5
        got = _split_merge(q, _paged_tiles(kp, vp, tables), w, BS, lens,
                           scale)
        _close(got, paged_decode_attention(q, kp, vp, tables, lens))
        _close(got, jax_paged(qj, kj, vj, tj, lj, interpret=True))
        _close(got, ref.paged_decode_attention_ref(qj, kj, vj, tj, lj))
        # the same rows as a dense (B, W*BS, Nkv, H) cache
        kd, vd = kp[tables.long()].flatten(1, 2), vp[tables.long()].flatten(1, 2)
        dense = _split_merge(q, _dense_tiles(kd, vd, BS), w, BS, lens, scale)
        assert torch.equal(dense, got)
        _close(got, decode_attention_plain(q, kd, vd, lens))
        kdj, vdj = (jnp.swapaxes(jnp.asarray(t.numpy()), 1, 2)
                    for t in (kd, vd))
        _close(got, jax_decode(qj, kdj, vdj, lj, block_k=BS, interpret=True))
        _close(got, ref.decode_attention_ref(qj, kdj, vdj, lj))

    def test_same_bits_through_any_width_and_the_dense_view(self):
        """Batched decode's width-16 table, a width-32 table (the unbatched
        cache's 512 positions) and the dense cache with block_k = BS give
        the same bits: a wider table only adds splits that exit at once.
        A row of length 0 merges nothing and gives exactly 0."""
        lengths = [0, BS * T + 1, 255, 256]
        (_, _, _, _, _), (q, kp, vp, tables, lens) = _paged_inputs(
            70, 4, 4, 2, 64, 16, lengths)
        scale = 0.125
        narrow = _split_merge(q, _paged_tiles(kp, vp, tables), 16, BS, lens,
                              scale)
        lanes = torch.zeros((4, 32), dtype=torch.int32)
        lanes[:, :16] = tables  # past them: the scratch block
        wide = _split_merge(q, _paged_tiles(kp, vp, lanes), 32, BS, lens,
                            scale)
        kd, vd = kp[lanes.long()].flatten(1, 2), vp[lanes.long()].flatten(1, 2)
        dense = _split_merge(q, _dense_tiles(kd, vd, BS), 32, BS, lens, scale)
        assert decode_splits(32) > decode_splits(16)
        assert torch.equal(narrow, wide) and torch.equal(narrow, dense)
        assert torch.equal(narrow[0], torch.zeros_like(narrow[0]))
        _close(narrow, paged_decode_attention_plain(q, kp, vp, tables, lens,
                                                    scale=scale))
