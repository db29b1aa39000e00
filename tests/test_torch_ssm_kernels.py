"""The port's SSD kernels (repro_torch.kernels.ssd_scan) against the
reference package.

On the CPU each wrapper runs its plain version; here each plain version is
held against the JAX Pallas kernel (interpret mode) and the
``repro.kernels.ref`` oracle over the shape sweeps of test_kernels.py (plus
a chunk length that is not a power of two), at fp32 1e-5 and bf16 2e-2.
Inputs are made with numpy from a seed and rounded to the working dtype
once, so both sides see identical values.

``ssd_intra`` returns y in fp32 (the model path adds the inter-chunk term
before it casts); the Pallas kernel casts y to x's dtype.  In fp32 the two
differ by summation order only; in bf16 the Pallas kernel's rounding of y
is up to 2e-2, the bf16 tolerance.

The sweep draws dA on a grid of 2**-10, so every partial sum of
cumsum(dA) is exact in fp32 and both sides see the same decay exponents:
XLA's cumsum sums in another order than a sequential one, and
exp(seg_i - seg_j) turns its ~4e-6 differences at |seg| ~ 13 into y
differences of up to 2e-4 at Q = 256 (pinned by
``test_cumsum_order_moves_y_within_bound``).

The CUDA kernels themselves run only on a card: test_torch_cuda.py holds
each against its plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.ssd_scan import ssd_intra as jax_ssd_intra
from repro.kernels.ssd_scan import ssd_slab_decode as jax_slab_decode
from repro.models.ssm import ssd_decode_step as jax_decode_step
from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import (ssd_intra, ssd_intra_plain,
                                          ssd_slab_decode)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _pair(rng, shape, dtype, transform=None):
    """A (jax array, torch tensor) pair of equal values in ``dtype``."""
    a = rng.standard_normal(shape, dtype=np.float32)
    if transform is not None:
        a = transform(a)
    jdt, tdt = DTYPES[dtype]
    j = jnp.asarray(a).astype(jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _softplus(a):
    return np.logaddexp(a, 0.0).astype(np.float32)


def _decay(a):
    """Negative dA on a grid of 2**-10: cumsum is exact in any order."""
    return -np.round(np.abs(a) * 0.1 * 1024) / 1024


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


class TestSSDIntra:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("m,h,q,p,n", [
        (2, 2, 64, 32, 32),
        (1, 4, 128, 64, 128),
        (3, 1, 256, 64, 64),
        (2, 3, 40, 16, 16),   # a chunk length that is not a power of two
    ])
    def test_plain_matches_pallas_and_ref(self, m, h, q, p, n, dtype):
        rng = np.random.default_rng(5)
        xj, xt = _pair(rng, (m, h, q, p), dtype)
        dtj, dtt = _pair(rng, (m, h, q), "float32", _softplus)
        daj, dat = _pair(rng, (m, h, q), "float32", _decay)
        bj, bt = _pair(rng, (m, q, n), dtype)
        cj, ct = _pair(rng, (m, q, n), dtype)
        y, s = ssd_intra(xt, dtt, dat, bt, ct)
        assert y.dtype == s.dtype == torch.float32
        assert tuple(y.shape) == (m, h, q, p) and tuple(s.shape) == (m, h, n, p)
        pallas_y, pallas_s = jax_ssd_intra(xj, dtj, daj, bj, cj, interpret=True)
        ref_y, ref_s = ref.ssd_intra_ref(xj, dtj, daj, bj, cj)
        for want_y, want_s in ((pallas_y, pallas_s), (ref_y, ref_s)):
            _close(y, want_y, dtype)
            _close(s, want_s, dtype)

    def test_cumsum_order_moves_y_within_bound(self):
        """With dA off the exact grid, XLA's cumsum and the sequential one
        differ in the last bits, and exp(seg_i - seg_j) amplifies that:
        y still agrees to 5e-4 (the disagreement in ROADMAP C)."""
        rng = np.random.default_rng(5)
        m, h, q, p, n = 3, 1, 256, 64, 64
        xj, xt = _pair(rng, (m, h, q, p), "float32")
        dtj, dtt = _pair(rng, (m, h, q), "float32", _softplus)
        daj, dat = _pair(rng, (m, h, q), "float32", lambda a: -np.abs(a) * 0.1)
        bj, bt = _pair(rng, (m, q, n), "float32")
        cj, ct = _pair(rng, (m, q, n), "float32")
        y, s = ssd_intra(xt, dtt, dat, bt, ct)
        want_y, want_s = ref.ssd_intra_ref(xj, dtj, daj, bj, cj)
        np.testing.assert_allclose(_np(y), _np(want_y), rtol=5e-4, atol=5e-4)
        _close(s, want_s, "float32")

    def test_cumsum_order_float64_arbiter(self, monkeypatch):
        """Which side of that disagreement is off: ``ref.ssd_intra_ref``
        evaluated in float64 (its fp32 casts widened) on the same inputs.
        The port's sequential cumsum lands no further from it than XLA's,
        in the reference and in the Pallas kernel alike (y: 1.13e-4 against
        1.25e-4), so the 2.1e-4 between them is two fp32 summation orders,
        not a fault of either (ROADMAP C)."""
        rng = np.random.default_rng(5)
        m, h, q, p, n = 3, 1, 256, 64, 64
        xj, xt = _pair(rng, (m, h, q, p), "float32")
        dtj, dtt = _pair(rng, (m, h, q), "float32", _softplus)
        daj, dat = _pair(rng, (m, h, q), "float32", lambda a: -np.abs(a) * 0.1)
        bj, bt = _pair(rng, (m, q, n), "float32")
        cj, ct = _pair(rng, (m, q, n), "float32")
        port = ssd_intra_plain(xt, dtt, dat, bt, ct)
        jax_fp32 = ref.ssd_intra_ref(xj, dtj, daj, bj, cj)
        pallas = jax_ssd_intra(xj, dtj, daj, bj, cj, interpret=True)

        class Float64Numpy:  # jax.numpy whose float32 is float64
            float32 = jnp.float64

            def __getattr__(self, name):
                return getattr(jnp, name)

        monkeypatch.setattr(ref, "jnp", Float64Numpy())
        with jax.enable_x64(True):
            wide = [jnp.asarray(np.asarray(a, np.float64))
                    for a in (xj, dtj, daj, bj, cj)]
            exact = [np.asarray(a) for a in ref.ssd_intra_ref(*wide)]
        assert all(a.dtype == np.float64 for a in exact)

        def err(got):
            return [float(np.abs(np.asarray(g, np.float64) - e).max())
                    for g, e in zip(got, exact)]

        port_y = err(port)[0]
        assert port_y <= min(err(jax_fp32)[0], err(pallas)[0])
        # both states hold the fp32 tolerance against float64
        for got in (port[1], jax_fp32[1]):
            np.testing.assert_allclose(np.asarray(got, np.float64), exact[1],
                                       rtol=1e-5, atol=1e-5)

    def test_strided_views_match_contiguous(self):
        """The model passes permuted views of its (B,S,H,P) activations and
        slices of xBC: the result equals that of contiguous copies."""
        rng = np.random.default_rng(6)
        m, q, h, p, n = 2, 24, 3, 8, 8
        xbc = torch.from_numpy(rng.standard_normal((m, q, h * p + 2 * n),
                                                   dtype=np.float32))
        dt = torch.from_numpy(_softplus(rng.standard_normal((m, q, h),
                                                            dtype=np.float32)))
        x = xbc[..., : h * p].view(m, q, h, p).permute(0, 2, 1, 3)
        b, c = xbc[..., h * p: h * p + n], xbc[..., h * p + n:]
        da = (dt * -0.3).permute(0, 2, 1)
        got = ssd_intra(x, dt.permute(0, 2, 1), da, b, c)
        want = ssd_intra_plain(x.contiguous(), dt.permute(0, 2, 1).contiguous(),
                               da.contiguous(), b.contiguous(), c.contiguous())
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)

    def test_padding_past_length_changes_no_state(self):
        """dt = 0 (so dA = 0) past a row's length: the chunk state and the
        rows before the length equal those of the exact-length chunk."""
        rng = np.random.default_rng(7)
        _, x = _pair(rng, (1, 2, 16, 8), "float32")
        _, dt = _pair(rng, (1, 2, 16), "float32", _softplus)
        _, b = _pair(rng, (1, 16, 8), "float32")
        _, c = _pair(rng, (1, 16, 8), "float32")
        dt[..., 11:] = 0.0
        da = dt * -0.5
        y_pad, s_pad = ssd_intra(x, dt, da, b, c)
        y, s = ssd_intra(x[:, :, :11], dt[..., :11], da[..., :11],
                         b[:, :11], c[:, :11])
        torch.testing.assert_close(y_pad[:, :, :11], y, **TOL["float32"])
        torch.testing.assert_close(s_pad, s, **TOL["float32"])


class TestSSDSlabDecode:
    @staticmethod
    def _make(seed, b, h, p, n, g, ns, dtype):
        rng = np.random.default_rng(seed)
        pool = _pair(rng, (ns, h, p, n), "float32")
        x = _pair(rng, (b, h, p), dtype)
        dt = _pair(rng, (b, h), "float32", _softplus)
        a = _pair(rng, (h,), "float32", lambda v: -np.abs(v) * 0.5)
        bb = _pair(rng, (b, g, n), dtype)
        cc = _pair(rng, (b, g, n), dtype)
        slabs = rng.permutation(ns)[:b].astype(np.int32)
        return pool, slabs, x, dt, a, bb, cc

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("b,h,p,n,g,ns", [
        (2, 4, 16, 24, 1, 8),
        (3, 4, 32, 16, 2, 6),
    ])
    def test_plain_matches_pallas_and_ref(self, b, h, p, n, g, ns, dtype):
        pool, slabs, *rest = self._make(31, b, h, p, n, g, ns, dtype)
        jargs = [pool[0], jnp.asarray(slabs), *(j for j, _ in rest)]
        targs = [pool[1], torch.from_numpy(slabs), *(t for _, t in rest)]
        y, states = ssd_slab_decode(*targs)
        assert y.dtype == targs[2].dtype and states.dtype == torch.float32
        for want_y, want_s in (jax_slab_decode(*jargs, interpret=True),
                               ref.ssd_slab_decode_ref(*jargs)):
            _close(y, want_y, dtype)
            _close(states, want_s, "float32")

    def test_scatter_roundtrip_matches_model_step(self):
        """index_copy_ of the gathered states into the pool equals the
        reference's decode step on the gathered slabs; untouched slabs stay
        bit-identical."""
        pool, _, x, dt, a, bb, cc = self._make(32, 2, 2, 8, 12, 1, 5,
                                               "float32")
        slabs = np.array([3, 1], np.int32)
        y, states = ssd_slab_decode(pool[1], torch.from_numpy(slabs), x[1],
                                    dt[1], a[1], bb[1], cc[1])
        new_pool = pool[1].clone()
        new_pool.index_copy_(0, torch.from_numpy(slabs).long(), states)
        y2, s2 = jax_decode_step(pool[0][slabs], x[0], dt[0], a[0], bb[0],
                                 cc[0])
        _close(y, y2, "float32")
        _close(new_pool[slabs], s2, "float32")
        rest = np.setdiff1d(np.arange(5), slabs)
        assert torch.equal(new_pool[rest], pool[1][rest])

    def test_duplicate_slab_id_scatters_like_one_row(self):
        """Padding rows repeat row 0 (and warm-up rows the scratch slab):
        a repeated id gives the pool that the single row gives."""
        pool, _, x, dt, a, bb, cc = self._make(33, 3, 2, 8, 12, 1, 6,
                                               "float32")
        one = torch.tensor([4], dtype=torch.int32)
        dup = torch.tensor([4, 4, 4], dtype=torch.int32)
        rep = lambda t: t[1][:1].expand(3, *t[1].shape[1:])
        _, s1 = ssd_slab_decode(pool[1], one, x[1][:1], dt[1][:1], a[1],
                                bb[1][:1], cc[1][:1])
        y3, s3 = ssd_slab_decode(pool[1], dup, rep(x), rep(dt), a[1], rep(bb),
                                 rep(cc))
        p1, p3 = pool[1].clone(), pool[1].clone()
        p1.index_copy_(0, one.long(), s1)
        p3.index_copy_(0, dup.long(), s3)
        assert torch.equal(p1, p3)
        assert torch.equal(y3[0], y3[2])


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    rng = np.random.default_rng(34)
    _, x = _pair(rng, (1, 2, 8, 4), "float32")
    _, dt = _pair(rng, (1, 2, 8), "float32", _softplus)
    _, b = _pair(rng, (1, 8, 4), "float32")
    _build.reset_launches()
    y, s = ssd_intra(x, dt, -dt, b, b)
    ssd_slab_decode(s, torch.zeros(1, dtype=torch.int32), x[:, :, 0],
                    dt[:, :, 0], -dt[0, :, 0], b[:, :1], b[:, :1])
    meta = torch.empty((1, 2, 8, 4), device="meta")
    ym, sm = ssd_intra(meta, dt.to("meta"), dt.to("meta"), b.to("meta"),
                       b.to("meta"))
    assert (ym.device.type, ym.shape) == ("meta", y.shape)
    assert (sm.device.type, sm.shape) == ("meta", s.shape)
    assert sum(_build.launches.values()) == 0
