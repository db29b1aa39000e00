"""The port's MLA kernels against the reference package: the plain version
of ``paged_mla_decode_attention`` against the Pallas kernel (interpret
mode) and the ``repro.kernels.ref`` oracle, mirroring
test_kernels.py::TestPagedMLADecodeAttention, and the plain flash
attention with a value width different from the key width (MLA prefill:
qk_nope + qk_rope vs v_head_dim) against the model's ``_sdpa``.

Tolerances are test_kernels.py's (fp32 1e-5, bf16 2e-2, atol and rtol).
Inputs are made with numpy from a seed and rounded to the working dtype
once, so both sides see identical values.  The CUDA kernels themselves run
only on a card: test_torch_cuda.py holds each against its plain version
there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.paged_decode_attention import (
    paged_mla_decode_attention as jax_paged_mla)
from repro.models.layers import _sdpa as jax_sdpa
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.paged_decode_attention import (
    MLA_TILES_PER_SPLIT, mla_scratch_shapes, mla_splits,
    paged_mla_decode_attention, paged_mla_decode_attention_plain)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _inputs(seed, dtype, *shapes):
    """Normal inputs as (jax array, torch tensor) pairs of equal values."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    out = []
    for shape in shapes:
        a = jnp.asarray(rng.standard_normal(shape, dtype=np.float32)).astype(jdt)
        out.append((a, torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)))
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def _make(seed, b, nq, r, pr, nb, bs, w, dtype):
    """q_lat, q_rope, latent pools, and tables of w distinct pool blocks
    per row, deliberately out of order."""
    pairs = _inputs(seed, dtype, (b, nq, r), (b, nq, pr), (nb, bs, r),
                    (nb, bs, pr))
    perm = np.random.default_rng(seed + 1).permutation(nb)[: b * w]
    return pairs, perm.reshape(b, w).astype(np.int32)


def _both(pairs, tables, lengths, **kw):
    """The port's wrapper (plain version on the CPU) and the Pallas kernel
    in interpret mode, on the same inputs."""
    (ql, qlt), (qr, qrt), (ck, ckt), (kr, krt) = pairs
    got = paged_mla_decode_attention(qlt, qrt, ckt, krt,
                                     torch.from_numpy(tables),
                                     torch.from_numpy(lengths), **kw)
    args = (ql, qr, ck, kr, jnp.asarray(tables), jnp.asarray(lengths))
    return got, args


class TestPagedMLADecodeAttention:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("b,nq,r,pr,nb,bs,w", [
        (2, 4, 32, 8, 16, 16, 4),
        (1, 8, 64, 16, 12, 32, 3),
    ])
    def test_plain_matches_pallas_and_ref(self, b, nq, r, pr, nb, bs, w,
                                          dtype):
        pairs, tables = _make(40, b, nq, r, pr, nb, bs, w, dtype)
        lengths = np.random.default_rng(41).integers(1, w * bs + 1, b,
                                                     np.int32)
        got, args = _both(pairs, tables, lengths)
        _close(got, jax_paged_mla(*args, interpret=True), dtype)
        _close(got, ref.paged_mla_decode_attention_ref(*args), dtype)

    def test_short_lengths_skip_blocks(self):
        """Lanes past a row's live blocks are never read: pointing them at
        a scratch block full of 1e4 leaves the rows unchanged."""
        b, nq, r, pr, nb, bs, w = 3, 2, 32, 8, 12, 16, 4
        pairs, tables = _make(42, b, nq, r, pr, nb, bs, w, "float32")
        lengths = np.array([1, 16, 17], np.int32)
        got, args = _both(pairs, tables, lengths)
        _close(got, jax_paged_mla(*args, interpret=True), "float32")
        _close(got, ref.paged_mla_decode_attention_ref(*args), "float32")
        scratch = int(tables[2, 3])  # a block no live lane of rows 0-1 uses
        lanes = tables.copy()
        lanes[:2, 1:] = scratch
        dirty = list(pairs)
        for i in (2, 3):
            pool = pairs[i][1].clone()
            pool[scratch] = 1e4
            dirty[i] = (pairs[i][0], pool)
        got2, _ = _both(dirty, lanes, lengths)
        assert torch.equal(got[:2], got2[:2])

    def test_custom_scale(self):
        """MLA scales by the QK head dim (here nope 16 + rope 8), not the
        kernel's (R + PR)^-0.5 default (R 32 + PR 8)."""
        b, nq, r, pr, nb, bs, w = 1, 2, 32, 8, 8, 16, 2
        pairs, tables = _make(43, b, nq, r, pr, nb, bs, w, "float32")
        lengths = np.array([20], np.int32)
        got, args = _both(pairs, tables, lengths, scale=24 ** -0.5)
        _close(got, jax_paged_mla(*args, scale=24 ** -0.5, interpret=True),
               "float32")
        _close(got, ref.paged_mla_decode_attention_ref(*args,
                                                       scale=24 ** -0.5),
               "float32")
        default, _ = _both(pairs, tables, lengths)
        assert not torch.allclose(got, default)

    def test_length_zero_gives_zero(self):
        """No valid position: 0 (the kernels' finalize divides by max(l,
        1e-30)); the -inf oracle gives NaN there."""
        pairs, tables = _make(44, 2, 4, 32, 8, 8, 16, 2, "float32")
        got, _ = _both(pairs, tables, np.array([0, 9], np.int32))
        assert torch.equal(got[0], torch.zeros_like(got[0]))
        assert torch.isfinite(got).all() and got[1].abs().sum() > 0

    def test_identity_table_view_equals_paged(self):
        """A dense (B, Smax, R) cache viewed as a block pool with the
        identity table gives what the same positions give when paged."""
        b, nq, r, pr, bs, w = 2, 4, 32, 8, 16, 3
        pairs, _ = _make(45, b, nq, r, pr, b * w, bs, w, "float32")
        (_, qlt), (_, qrt), (_, ckt), (_, krt) = pairs
        ident = (torch.arange(b)[:, None] * w
                 + torch.arange(w)[None, :]).to(torch.int32)
        perm = torch.randperm(b * w, generator=torch.Generator().manual_seed(0))
        tables = perm[ident.long()].to(torch.int32)
        lengths = torch.tensor([w * bs, 21], dtype=torch.int32)
        dense = paged_mla_decode_attention(qlt, qrt, ckt, krt, ident, lengths)
        inv = torch.argsort(perm)
        paged = paged_mla_decode_attention(qlt, qrt, ckt[inv], krt[inv],
                                           tables, lengths)
        assert torch.equal(dense, paged)

    def test_cpu_takes_the_plain_version_and_counts_nothing(self):
        pairs, tables = _make(46, 1, 2, 16, 8, 4, 16, 2, "float32")
        _build.reset_launches()
        got, _ = _both(pairs, tables, np.array([17], np.int32))
        want = paged_mla_decode_attention_plain(
            *(t for _, t in pairs), torch.from_numpy(tables),
            torch.tensor([17], dtype=torch.int32))
        assert torch.equal(got, want)
        assert sum(_build.launches.values()) == 0


def _split_merge(q_lat, q_rope, ckv_pool, krope_pool, tables, lengths,
                 scale):
    """The CUDA kernel's algorithm in torch, fp32: split s of a row walks
    the row's blocks [s*T, (s+1)*T) with its own softmax state (max m,
    denominator l, unnormalised accumulator), and the merge combines the
    live splits of the row in split order."""
    b, w = tables.shape
    bs, r = ckv_pool.shape[1], ckv_pool.shape[2]
    out = torch.zeros(q_lat.shape, dtype=torch.float32)
    for row in range(b):
        n = min(int(lengths[row]), w * bs)
        ntiles = -(-n // bs)
        parts = []
        for s in range(mla_splits(w)):
            t0 = s * MLA_TILES_PER_SPLIT
            if t0 >= ntiles:
                break
            blocks = tables[row, t0:min(t0 + MLA_TILES_PER_SPLIT, ntiles)]
            ckv = ckv_pool[blocks.long()].reshape(-1, r).float()
            kr = krope_pool[blocks.long()].reshape(ckv.shape[0], -1).float()
            pos = torch.arange(t0 * bs, t0 * bs + ckv.shape[0])
            sc = (q_lat[row].float() @ ckv.T + q_rope[row].float() @ kr.T
                  ) * scale
            sc = torch.where(pos[None] < n, sc, torch.tensor(-1e30))
            m = sc.max(-1).values
            p = torch.exp(sc - m[:, None])
            parts.append((m, p.sum(-1), p @ ckv))
        if parts:
            mx = torch.stack([m for m, _, _ in parts]).max(0).values
            acc = torch.zeros_like(parts[0][2])
            den = torch.zeros_like(mx)
            for m, l, a in parts:
                wt = torch.exp(m - mx)
                den = den + l * wt
                acc = acc + a * wt[:, None]
            out[row] = acc / den.clamp_min(1e-30)[:, None]
    return out


class TestMLASplitPlan:
    """The host side of the kernel's split KV sweep: the grid's split count
    and scratch shapes, and the split-and-merge arithmetic (emulated in
    torch) against the plain version and the reference oracle."""

    @pytest.mark.parametrize("width,splits", [
        (0, 0), (1, 1), (MLA_TILES_PER_SPLIT, 1), (MLA_TILES_PER_SPLIT + 1, 2),
        (16, -(-16 // MLA_TILES_PER_SPLIT)), (32, -(-32 // MLA_TILES_PER_SPLIT)),
    ])
    def test_splits_follow_the_width_alone(self, width, splits):
        assert mla_splits(width) == splits

    def test_scratch_shapes(self):
        ns = mla_splits(16)
        assert mla_scratch_shapes(4, 16, 512, 16) == ((4, ns, 16, 512),
                                                      (4, ns, 16, 2))
        assert mla_scratch_shapes(2, 4, 32, 0) == ((2, 0, 4, 32),
                                                   (2, 0, 4, 2))

    @pytest.mark.parametrize("lengths", [
        [1, 15, 16, 17],
        [16 * MLA_TILES_PER_SPLIT - 1, 16 * MLA_TILES_PER_SPLIT,
         16 * MLA_TILES_PER_SPLIT + 1, 16 * 2 * MLA_TILES_PER_SPLIT + 1],
        [63, 64, 65, 16 * 8],
    ])
    def test_split_merge_matches_plain_and_ref(self, lengths):
        b, nq, r, pr, bs, w = 4, 4, 32, 8, 16, 8
        pairs, tables = _make(48, b, nq, r, pr, b * w, bs, w, "float32")
        lens = np.array(lengths, np.int32)
        got, args = _both(pairs, tables, lens, scale=24 ** -0.5)
        ts = [t for _, t in pairs]
        emulated = _split_merge(*ts, torch.from_numpy(tables),
                                torch.from_numpy(lens), 24 ** -0.5)
        _close(emulated, got, "float32")
        _close(emulated, ref.paged_mla_decode_attention_ref(
            *args, scale=24 ** -0.5), "float32")

    def test_split_merge_ignores_the_table_width(self):
        """A wider table (the unbatched dense cache's) adds splits that
        exit at once: each row's splits and merge are the same, bit for
        bit; a row of length 0 merges nothing and gives 0."""
        b, nq, r, pr, bs, w = 3, 2, 32, 8, 16, 4
        pairs, tables = _make(49, b, nq, r, pr, 4 * w, bs, w, "float32")
        ts = [t for _, t in pairs]
        wide = np.concatenate([tables, np.zeros_like(tables)], axis=1)
        lens = torch.tensor([0, 33, w * bs], dtype=torch.int32)
        narrow_out = _split_merge(*ts, torch.from_numpy(tables), lens, 0.2)
        wide_out = _split_merge(*ts, torch.from_numpy(wide), lens, 0.2)
        assert mla_splits(2 * w) > mla_splits(w)
        assert torch.equal(narrow_out, wide_out)
        assert torch.equal(narrow_out[0], torch.zeros_like(narrow_out[0]))


class TestFlashValueWidth:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("b,s,n,h,hv", [
        (2, 8, 4, 24, 16),     # deepseek-v2-lite reduced: nope 16 + rope 8
        (1, 40, 2, 192, 128),  # full-width MLA head dims, ragged S
    ])
    def test_plain_matches_model_sdpa(self, b, s, n, h, hv, dtype):
        (qj, qt), (kj, kt), (vj, vt) = _inputs(47, dtype, (b, s, n, h),
                                               (b, s, n, h), (b, s, n, hv))
        scale = h ** -0.5
        got = flash_attention(qt, kt, vt, causal=True, scale=scale)
        assert tuple(got.shape) == (b, s, n, hv)
        idx = jnp.arange(s)
        mask = (idx[None, :] <= idx[:, None])[None, None, None]
        _close(got, jax_sdpa(qj, kj, vj, mask=mask, scale=scale), dtype)
        _close(got, flash_attention_plain(qt, kt, vt, scale=scale), dtype)
