"""The port's kernels (repro_torch.kernels) against the reference package.

On the CPU every wrapper runs its plain PyTorch version; here each plain
version is held against the JAX Pallas kernel (interpret mode) and the
``repro.kernels.ref`` oracle over the shape sweeps of test_kernels.py, at
fp32 1e-5 and bf16 2e-2.  Inputs are made with numpy from a seed and
rounded to the working dtype once, so both sides see identical values.

The CUDA kernels themselves run only on a card: test_torch_cuda.py holds
each against its plain version there.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.paged_decode_attention import (
    paged_decode_attention as jax_paged)
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro.models.layers import rms_norm as jax_rms_norm
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention, paged_decode_attention_plain)
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

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
        t = torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
        out.append((a, t))
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


class TestFlashAttention:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("b,nq,nkv,s,h", [
        (1, 4, 4, 128, 64),    # MHA
        (2, 4, 2, 128, 64),    # GQA
        (1, 4, 1, 256, 128),   # MQA, two kv blocks per q row
        (1, 2, 2, 512, 64),    # multiple q and kv blocks
    ])
    def test_plain_matches_pallas_and_ref(self, b, nq, nkv, s, h, dtype):
        # the plain version rounds probabilities to the value dtype (the
        # model's _sdpa) while Pallas and ref keep them fp32: in bf16 they
        # agree to bf16 tolerance only
        (qj, qt), (kj, kt), (vj, vt) = _inputs(0, dtype, (b, s, nq, h),
                                               (b, s, nkv, h), (b, s, nkv, h))
        got = flash_attention(qt, kt, vt, causal=True)
        heads = lambda a: jnp.swapaxes(a, 1, 2)  # (B,S,N,H) -> (B,N,S,H)
        pallas = jax_flash(heads(qj), heads(kj), heads(vj), causal=True,
                           block_q=128, block_k=128, interpret=True)
        want = ref.flash_attention_ref(heads(qj), heads(kj), heads(vj))
        _close(got, heads(pallas), dtype)
        _close(got, heads(want), dtype)

    def test_non_causal_and_scale(self):
        (qj, qt), (kj, kt), (vj, vt) = _inputs(1, "float32", (1, 64, 2, 32),
                                               (1, 64, 2, 32), (1, 64, 2, 32))
        heads = lambda a: jnp.swapaxes(a, 1, 2)
        for causal, scale in ((False, None), (True, 0.5)):
            got = flash_attention(qt, kt, vt, causal=causal, scale=scale)
            want = ref.flash_attention_ref(heads(qj), heads(kj), heads(vj),
                                           causal=causal, scale=scale)
            _close(got, heads(want), "float32")

    @pytest.mark.parametrize("s", [1, 8, 40])
    def test_any_length(self, s):
        """Prefill buckets need not divide a tile: short and ragged S."""
        (qj, qt), (kj, kt), (vj, vt) = _inputs(2, "float32", (2, s, 4, 16),
                                               (2, s, 2, 16), (2, s, 2, 16))
        heads = lambda a: jnp.swapaxes(a, 1, 2)
        want = ref.flash_attention_ref(heads(qj), heads(kj), heads(vj))
        _close(flash_attention(qt, kt, vt), heads(want), "float32")


class TestDecodeAttention:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("b,nq,nkv,smax,h", [
        (2, 4, 4, 256, 64),
        (2, 8, 2, 512, 64),
        (1, 4, 1, 1024, 128),
    ])
    def test_plain_matches_pallas_and_ref(self, b, nq, nkv, smax, h, dtype):
        (qj, qt), (kj, kt), (vj, vt) = _inputs(3, dtype, (b, nq, h),
                                               (b, smax, nkv, h),
                                               (b, smax, nkv, h))
        lengths = np.random.default_rng(4).integers(1, smax + 1, b, np.int32)
        got = decode_attention(qt, kt, vt, torch.from_numpy(lengths))
        heads = lambda a: jnp.swapaxes(a, 1, 2)  # model -> kernel layout
        lj = jnp.asarray(lengths)
        pallas = jax_decode(qj, heads(kj), heads(vj), lj, block_k=128,
                            interpret=True)
        _close(got, pallas, dtype)
        _close(got, ref.decode_attention_ref(qj, heads(kj), heads(vj), lj),
               dtype)

    def test_ragged_lengths(self):
        """Tiny lengths: only the masked prefix participates."""
        (qj, qt), (kj, kt), (vj, vt) = _inputs(5, "float32", (3, 2, 64),
                                               (3, 512, 2, 64),
                                               (3, 512, 2, 64))
        lengths = np.array([1, 7, 130], np.int32)
        got = decode_attention(qt, kt, vt, torch.from_numpy(lengths))
        want = ref.decode_attention_ref(qj, jnp.swapaxes(kj, 1, 2),
                                        jnp.swapaxes(vj, 1, 2),
                                        jnp.asarray(lengths))
        _close(got, want, "float32")

    def test_length_zero_gives_zero(self):
        """No valid position: the kernels' finalize divides by max(l,
        1e-30), so the row is 0 (the -inf oracles give NaN there)."""
        (_, qt), (_, kt), (_, vt) = _inputs(6, "float32", (2, 4, 16),
                                            (2, 32, 2, 16), (2, 32, 2, 16))
        out = decode_attention(qt, kt, vt, torch.tensor([0, 3], dtype=torch.int32))
        assert torch.equal(out[0], torch.zeros_like(out[0]))
        assert torch.isfinite(out).all() and out[1].abs().sum() > 0


class TestPagedDecodeAttention:
    @staticmethod
    def _make(seed, b, nq, nkv, h, nb, bs, w, dtype):
        (qj, qt), (kj, kt), (vj, vt) = _inputs(seed, dtype, (b, nq, h),
                                               (nb, bs, nkv, h),
                                               (nb, bs, nkv, h))
        # each row gets w distinct pool blocks, deliberately out of order
        perm = np.random.default_rng(seed + 1).permutation(nb)[: b * w]
        tables = perm.reshape(b, w).astype(np.int32)
        return (qj, qt), (kj, kt), (vj, vt), tables

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("b,nq,nkv,h,nb,bs,w", [
        (2, 4, 4, 64, 16, 16, 4),    # MHA
        (2, 8, 2, 64, 32, 32, 6),    # GQA
        (1, 4, 1, 128, 8, 64, 3),    # MQA
    ])
    def test_plain_matches_pallas_and_ref(self, b, nq, nkv, h, nb, bs, w,
                                          dtype):
        (qj, qt), (kj, kt), (vj, vt), tables = self._make(11, b, nq, nkv, h,
                                                          nb, bs, w, dtype)
        lengths = np.random.default_rng(12).integers(1, w * bs + 1, b,
                                                     np.int32)
        got = paged_decode_attention(qt, kt, vt, torch.from_numpy(tables),
                                     torch.from_numpy(lengths))
        args = (qj, kj, vj, jnp.asarray(tables), jnp.asarray(lengths))
        _close(got, jax_paged(*args, interpret=True), dtype)
        _close(got, ref.paged_decode_attention_ref(*args), dtype)

    def test_scratch_lanes_are_never_read(self):
        """Lanes past a row's live blocks point at the scratch block: its
        content, however large, must not change the output."""
        b, nq, nkv, h, nb, bs, w = 3, 2, 2, 64, 12, 16, 4
        (qj, qt), (kj, kt), (vj, vt), tables = self._make(13, b, nq, nkv, h,
                                                          nb, bs, w, "float32")
        lengths = np.array([1, 16, 17], np.int32)
        scratch = int(tables[2, 3])  # a block no live lane of rows 0-1 uses
        lanes = tables.copy()
        lanes[0, 1:] = scratch
        lanes[1, 1:] = scratch
        k_dirty, v_dirty = kt.clone(), vt.clone()
        k_dirty[scratch], v_dirty[scratch] = 1e4, -1e4
        clean = paged_decode_attention(qt, kt, vt, torch.from_numpy(tables),
                                       torch.from_numpy(lengths))
        dirty = paged_decode_attention(qt, k_dirty, v_dirty,
                                       torch.from_numpy(lanes),
                                       torch.from_numpy(lengths))
        assert torch.equal(clean[:2], dirty[:2])
        want = ref.paged_decode_attention_ref(qj, kj, vj, jnp.asarray(tables),
                                              jnp.asarray(lengths))
        _close(clean, want, "float32")

    def test_equals_dense_decode_when_tile_is_block(self):
        """Paged and dense decode share one online-softmax core: on the
        same logical cache, with the dense tile equal to the block size,
        they agree -- in the port and against the dense Pallas kernel."""
        b, nq, nkv, h, bs, w = 2, 4, 2, 64, 32, 4
        smax = bs * w
        (qj, qt), (kj, kt), (vj, vt) = _inputs(14, "float32", (b, nq, h),
                                               (b, smax, nkv, h),
                                               (b, smax, nkv, h))
        lengths = torch.tensor([smax, 37], dtype=torch.int32)
        tables = (torch.arange(b)[:, None] * w + torch.arange(w)[None, :]
                  ).to(torch.int32)  # identity paging
        kp = kt.reshape(b * w, bs, nkv, h)
        vp = vt.reshape(b * w, bs, nkv, h)
        paged = paged_decode_attention(qt, kp, vp, tables, lengths)
        dense = decode_attention(qt, kt, vt, lengths, block_k=bs)
        np.testing.assert_allclose(paged.numpy(), dense.numpy(), rtol=1e-6,
                                   atol=1e-6)
        pallas = jax_decode(qj, jnp.swapaxes(kj, 1, 2), jnp.swapaxes(vj, 1, 2),
                            jnp.asarray(lengths.numpy()), block_k=bs,
                            interpret=True)
        _close(paged, pallas, "float32")

    def test_length_zero_gives_zero(self):
        (_, qt), (_, kt), (_, vt), tables = self._make(15, 2, 2, 1, 16, 6, 8,
                                                       2, "float32")
        out = paged_decode_attention(qt, kt, vt, torch.from_numpy(tables),
                                     torch.tensor([0, 9], dtype=torch.int32))
        assert torch.equal(out[0], torch.zeros_like(out[0]))


class TestRMSNorm:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", [(4, 16, 64), (2, 128), (1, 3, 7, 256)])
    def test_plain_matches_model_path_and_pallas(self, shape, dtype):
        (xj, xt), (wj, wt) = _inputs(7, dtype, shape, shape[-1:])
        wj, wt = wj * 0.1 + 1.0, (wt.float() * 0.1 + 1.0).to(wt.dtype)
        got = rmsnorm(xt, wt, 1e-5)
        # the model path's rounding (cast, then scale) is the plain
        # version's own, so it matches exactly up to fp32 summation order
        _close(got, jax_rms_norm(xj, wj, 1e-5), dtype)
        _close(got, jax_rmsnorm(xj, wj, eps=1e-5, block_rows=2,
                                interpret=True), dtype)


class TestWrappers:
    def test_cpu_tensors_take_the_plain_version_and_count_nothing(self):
        (_, xt), (_, wt) = _inputs(8, "float32", (2, 8), (8,))
        _build.reset_launches()
        torch.testing.assert_close(rmsnorm(xt, wt, 1e-5),
                                   rmsnorm_plain(xt, wt, 1e-5))
        assert sum(_build.launches.values()) == 0

    def test_no_fallback_for_other_devices(self):
        """A wrapper serves CPU tensors with its plain version and launches
        its kernel for CUDA tensors; meta tensors, which hold no values,
        take the plain version too (static pricing runs there); anything
        else raises."""
        x = torch.empty((2, 8), device="meta")
        w = torch.empty((8,), device="meta")
        _build.reset_launches()
        y = rmsnorm(x, w, 1e-5)
        assert y.device.type == "meta" and y.shape == x.shape
        assert sum(_build.launches.values()) == 0
        other = types.SimpleNamespace(device=torch.device("xpu"))
        with pytest.raises(ValueError, match="no kernel for device"):
            _build.on_cpu(other, other)
        with pytest.raises(ValueError, match="several devices"):
            rmsnorm(torch.zeros(2, 8), w, 1e-5)


class TestTensorCoreContracts:
    """Host-side contracts of the bf16 tensor-core kernels, on the CPU:
    which head widths have a flash instantiation, and which operands the
    16-byte copies accept."""

    def test_flash_widths_cover_every_attention_config(self):
        from repro_torch.configs.registry import get_config, list_configs
        from repro_torch.kernels.flash_attention import TENSOR_CORE_WIDTHS

        for name in list_configs():
            cfg = get_config(name)
            if cfg.attn_type == "mla":
                widths = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim,
                          cfg.v_head_dim)
            elif cfg.num_heads:
                widths = (cfg.head_dim, cfg.head_dim)
            else:
                continue
            assert widths in TENSOR_CORE_WIDTHS, name

    def test_aligned_views_pass(self):
        wide = torch.zeros((2, 40, 8, 256), dtype=torch.bfloat16)
        _build.check_aligned("wide", wide)
        _build.check_aligned("v", wide[..., 64:192])  # 128-byte offset
        # an axis of size 1 is never stepped: its stride is free
        _build.check_aligned("b1", wide[:1].as_strided((1, 40, 8, 128),
                                                       (3, 2048, 256, 1)))

    @pytest.mark.parametrize("start", [1, 4])  # 2- and 8-byte offsets
    def test_misaligned_base_raises(self, start):
        wide = torch.zeros((2, 40, 8, 256), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="16-byte"):
            _build.check_aligned("v", wide[..., start:start + 128])

    def test_misaligned_stride_raises(self):
        odd = torch.zeros((40, 8, 132), dtype=torch.bfloat16)[..., :128]
        with pytest.raises(ValueError, match="16-byte"):
            _build.check_aligned("v", odd)

