"""Which kernel the ssd_intra and rmsnorm wrappers launch, and what they
refuse -- decided on the host from dtype, shape and alignment before any
launch, so it is checked here on the CPU with the launch itself replaced
by a recorder.  Likewise what the attention wrappers pass for the enc-dec
shapes: flash attention's key length Sk of its own (full attention only),
and decode attention's row ids.

Also the arithmetic behind the bf16 tensor-core ssd_intra: its decayed
scores W and scaled inputs enter the products as a pair of bf16 values
(hi + lo), because one rounding of these unnormalised values moves y and
the chunk state past the bf16 tolerance (emulated here in torch at
mamba2-780m widths).
"""

import pytest
import torch

from repro_torch.configs.registry import get_config, list_configs
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as D
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import rmsnorm as R
from repro_torch.kernels import ssd_scan as S


@pytest.fixture
def launches(monkeypatch):
    """CPU tensors take the kernel path; launches are recorded, not run."""
    calls = []
    monkeypatch.setattr(_build, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "sm_count", lambda dev: 132)  # an H100's
    monkeypatch.setattr(_build, "launch",
                        lambda name, entry, *args: calls.append((name, args)))
    return calls


def _ssd(m, h, q, p, n, dtype=torch.bfloat16, pad=0):
    """The model's views: x and B/C cut from one (m, q, h*p + 2n + pad)
    activation, dt/dA (m, h, q) fp32."""
    xbc = torch.zeros((m, q, pad + h * p + 2 * n), dtype=dtype)[..., pad:]
    x = xbc[..., :h * p].view(m, q, h, p).permute(0, 2, 1, 3)
    b, c = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dt = torch.zeros((m, h, q))
    return x, dt, dt.clone(), b, c


class TestSSDIntraRoute:
    def test_widths_cover_the_ssm_configs(self):
        for name in ("mamba2_780m", "zamba2_7b"):
            cfg = get_config(name)
            assert (cfg.ssm_head_dim, cfg.ssm_state_dim) in \
                S.SSD_TENSOR_CORE_WIDTHS, name

    @pytest.mark.parametrize("p,n,dtype,pad,want", [
        (64, 128, torch.bfloat16, 0, "tensor_cores"),
        (64, 64, torch.bfloat16, 0, "tensor_cores"),
        (64, 128, torch.float32, 0, "cuda_cores"),    # fp32 holds 1e-5
        (16, 16, torch.bfloat16, 0, "cuda_cores"),    # not instantiated
        (64, 128, torch.bfloat16, 1, "cuda_cores"),   # 2-byte misaligned
    ])
    def test_route(self, p, n, dtype, pad, want):
        x, _, _, b, c = _ssd(2, 3, 40, p, n, dtype, pad)
        assert S.ssd_intra_route(x, b, c) == want

    @pytest.mark.parametrize("p,n,dtype,tensor_cores", [
        (64, 128, torch.bfloat16, 1), (64, 64, torch.bfloat16, 1),
        (64, 128, torch.float32, 0), (16, 16, torch.bfloat16, 0)])
    def test_wrapper_passes_the_route(self, launches, p, n, dtype,
                                      tensor_cores):
        args = _ssd(2, 3, 40, p, n, dtype)
        y, s = S.ssd_intra(*args)
        assert y.shape == (2, 3, 40, p) and s.shape == (2, 3, n, p)
        ((name, a),) = launches
        assert name == "ssd_intra"
        cb, flag = a[7], a[-2]
        assert flag == tensor_cores
        assert (cb is None) == bool(tensor_cores)  # no (M,Q,Q) scratch

    @pytest.mark.parametrize("change,error", [
        (lambda a: (a[0], a[1][..., :-1], *a[2:]), ValueError),   # dt
        (lambda a: (*a[:3], a[3][:, :-1], a[4]), ValueError),     # B
        (lambda a: (*a[:3], a[3].float(), a[4]), TypeError),      # dtype
        (lambda a: (a[0], a[1].bfloat16(), *a[2:]), TypeError),   # dt fp32
        (lambda a: (a[0].transpose(-1, -2), *a[1:]), ValueError),  # stride
    ])
    def test_refusals_come_before_any_launch(self, launches, change, error):
        with pytest.raises(error):
            S.ssd_intra(*change(_ssd(1, 2, 64, 64, 128)))
        assert launches == []

    def test_longest_chunk_and_widest_head(self, launches):
        for m, h, q, p, n in ((1, 1, S.MAX_CHUNK + 1, 64, 64),
                              (1, 1, 8, S.MAX_HEAD_DIM + 16, 64)):
            with pytest.raises(ValueError):
                S.ssd_intra(*_ssd(m, h, q, p, n))
        assert launches == []


class TestRMSNormRoute:
    def test_row_widths_are_norm_widths_of_the_configs(self):
        widths = set()
        for name in list_configs():
            cfg = get_config(name)
            widths.add(cfg.d_model)
            widths.add(getattr(cfg, "kv_lora_rank", 0))
            if cfg.ssm_nheads:
                widths.add(cfg.ssm_nheads * cfg.ssm_head_dim)  # gated norm
        assert R.ROW_WIDTHS <= widths
        for d in R.ROW_WIDTHS:  # whole warp-wide 16-byte vectors
            assert d % (32 * 8) == 0

    @pytest.mark.parametrize("d,dtype,offset,want", [
        (2048, torch.bfloat16, 0, "registers"),
        (3072, torch.float32, 0, "registers"),
        (1024, torch.float32, 0, "registers"),  # whisper's d_model
        (1000, torch.bfloat16, 0, "vectors"),
        (100, torch.float32, 0, "vectors"),
        (100, torch.bfloat16, 0, "scalar"),   # not whole 16-byte vectors
        (37, torch.float32, 0, "scalar"),
        (2048, torch.bfloat16, 1, "scalar"),  # misaligned base
        (7168, torch.bfloat16, 0, "registers"),  # zamba2's gated norm
        (3584, torch.float32, 0, "registers"),  # 28 vectors a lane
        (7168, torch.float32, 0, "vectors"),  # 56 vectors a lane: too many
        (7168, torch.bfloat16, 4, "scalar"),  # an 8-byte offset
    ])
    def test_route(self, d, dtype, offset, want):
        x = torch.zeros(4 * d + offset, dtype=dtype)[offset:].view(4, d)
        w = torch.ones(d, dtype=dtype)
        assert R.rmsnorm_route(x, w) == want

    @pytest.mark.parametrize("d,route", [(512, 2), (1024, 2), (1536, 2),
                                         (2048, 2), (3072, 2), (3584, 2),
                                         (1280, 1), (12, 0), (7168, 2)])
    def test_wrapper_passes_the_route(self, launches, d, route):
        x = torch.zeros((4, 1, d), dtype=torch.bfloat16)
        out = R.rmsnorm(x, torch.ones(d, dtype=torch.bfloat16), 1e-6)
        assert out.shape == x.shape and out.dtype == x.dtype
        ((name, a),) = launches
        assert name == "rmsnorm" and a[3:5] == (4, d) and a[-2] == route

    def test_refusals_come_before_any_launch(self, launches):
        x = torch.zeros((4, 256), dtype=torch.bfloat16)
        for bad in ((x, torch.ones(128, dtype=torch.bfloat16)),
                    (x.t(), torch.ones(4, dtype=torch.bfloat16))):
            with pytest.raises(ValueError):
                R.rmsnorm(*bad, 1e-6)
        with pytest.raises(TypeError):
            R.rmsnorm(x, torch.ones(256), 1e-6)
        assert launches == []


class TestEncDecAttentionArgs:
    """The cross-attention's kernel shapes reach the C entry points: flash
    with S query rows against Sk keys, decode with a row id per query
    row; what a kernel cannot take is refused before any launch."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_flash_passes_sk(self, launches, dtype):
        q = torch.zeros((2, 8, 16, 64), dtype=dtype)
        kv = torch.zeros((2, 1500, 16, 64), dtype=dtype)
        out = FA.flash_attention(q, kv, kv, causal=False)
        assert tuple(out.shape) == (2, 8, 16, 64)
        ((name, a),) = launches
        assert name == "flash_attention"
        assert a[4] is None  # no lse: the forward alone
        assert a[5:12] == (2, 8, 1500, 16, 16, 64, 64)  # b, S, Sk, ...
        assert a[12:15] == q.stride()[:3] and a[15:18] == kv.stride()[:3]
        assert a[-4] == 0  # not causal

    def test_flash_refuses_sk_when_causal(self, launches):
        q = torch.zeros((1, 8, 4, 64))
        kv = torch.zeros((1, 20, 4, 64))
        with pytest.raises(ValueError, match="Sk = S when causal"):
            FA.flash_attention(q, kv, kv, causal=True)
        with pytest.raises(ValueError):
            FA.flash_attention(q, kv[:, :0], kv[:, :0], causal=False)
        assert launches == []

    def test_decode_passes_row_ids(self, launches):
        q = torch.zeros((4, 16, 64), dtype=torch.bfloat16)
        pool = torch.zeros((6, 1500, 16, 64), dtype=torch.bfloat16)
        lengths = torch.full((4,), 1500, dtype=torch.int32)
        ids = torch.tensor([3, 3, 1, 0], dtype=torch.int32)
        D.decode_attention(q, pool, pool, lengths, row_ids=ids)
        D.decode_attention(q, pool[:4], pool[:4], lengths)
        (name, rows), (_, dense) = launches
        assert name == "decode_attention"
        assert rows[4] == ids.data_ptr() and dense[4] is None
        # b, Nq, Nkv, H, Smax: 94 tiles of 16, the last ragged
        assert rows[7:12] == dense[7:12] == (4, 16, 16, 64, 1500)
        assert rows[12:15] == pool.stride()[:3]

    def test_decode_refuses_bad_row_ids(self, launches):
        q = torch.zeros((4, 16, 64))
        pool = torch.zeros((6, 20, 16, 64))
        lengths = torch.full((4,), 20, dtype=torch.int32)
        for ids in (torch.zeros(3, dtype=torch.int32),
                    torch.zeros(4, dtype=torch.int64)):
            with pytest.raises(ValueError, match="row_ids"):
                D.decode_attention(q, pool, pool, lengths, row_ids=ids)
        with pytest.raises(ValueError, match="no row_ids"):
            D.decode_attention(q, pool, pool, lengths)
        assert launches == []


def _pair_rounded(t, pair):
    hi = t.to(torch.bfloat16).float()
    return [hi, (t - hi).to(torch.bfloat16).float()] if pair else [hi]


def _tensor_core_arithmetic(x, dt, dA, B, C, pair):
    """ssd_intra as the bf16 tensor-core kernel computes it: S = C B^T and
    the decay in fp32, W = S exp(seg_i - seg_j) dt_j and the scaled B
    rounded to bf16 (once, or as the pair hi + lo), products summed in
    fp32."""
    seg = torch.cumsum(dA, -1)
    q = x.shape[2]
    idx = torch.arange(q)
    causal = idx[:, None] >= idx[None, :]
    decay = torch.exp(torch.where(causal, seg[..., :, None] - seg[..., None, :],
                                  -1e30))
    w = torch.einsum("min,mjn->mij", C.float(), B.float())[:, None] * decay \
        * dt[..., None, :]
    y = sum(torch.einsum("mhij,mhjp->mhip", part, x.float())
            for part in _pair_rounded(w, pair))
    bd = B.float()[:, None] * (torch.exp(seg[..., -1:] - seg) * dt)[..., None]
    s = sum(torch.einsum("mhqn,mhqp->mhnp", part, x.float())
            for part in _pair_rounded(bd, pair))
    return y, s


@pytest.mark.parametrize("pair", [False, True], ids=["one_rounding",
                                                     "bf16_pair"])
def test_bf16_pair_is_what_holds_the_tolerance(pair):
    """At mamba2-780m widths (P 64, N 128), Q 256 and slow decay: one bf16
    rounding of W and of the scaled B puts elements of y and of s out of
    the bf16 tolerance (2e-2, atol and rtol) against the plain version; the
    pair holds it with room to spare."""
    gen = torch.Generator().manual_seed(0)
    m, h, q, p, n = 1, 4, 256, 64, 128
    x = torch.randn((m, h, q, p), generator=gen).bfloat16()
    b = torch.randn((m, q, n), generator=gen).bfloat16()
    c = torch.randn((m, q, n), generator=gen).bfloat16()
    dt = torch.nn.functional.softplus(torch.randn((m, h, q), generator=gen))
    da = torch.round(dt * -0.05 * 1024) / 1024
    got = _tensor_core_arithmetic(x, dt, da, b, c, pair)
    want = S.ssd_intra_plain(x, dt, da, b, c)
    for g, w in zip(got, want):
        over = ((g - w).abs() > 2e-2 + 2e-2 * w.abs()).float().mean().item()
        if pair:
            assert over == 0.0
            assert (g - w).abs().max().item() < 5e-3
        else:
            assert over > 0  # elements out of tolerance in y and in s


class TestBackwardArgs:
    """What the backward wrappers pass to their C entry points, and what
    they refuse before any launch: the flash backward's (H, Hv) pairs by
    dtype (bf16 at 64, 112, 128 and 192 / 128 with aligned operands, fp32
    at those and 16, 24 / 16 and 32), causal or full with a key length of
    its own; the rmsnorm backward's route and block count; the ssd_intra
    backward's arguments and limits (Q <= 256, P <= 128, N <= 128, fp32
    dt, dA and cotangents)."""

    # (dtype, H, Hv, base offset in elements, refusal message or None).
    # The first nine cases keep the names they had when the kernel took
    # H = Hv = 128 alone in bf16 (and 16, 32, 128 in fp32), so a run's
    # record of them carries on; a name's last part is what the case
    # expected then ("A13": refused as unported).  What each case expects
    # now is its refusal column: bf16 64 and 112 and fp32 64 launch, bf16
    # 16 is refused as a width with no instantiation.
    @pytest.mark.parametrize("dtype,h,hv,offset,refused", [
        pytest.param(torch.bfloat16, 128, 128, 0, None, id="dtype0-128-0-None"),
        pytest.param(torch.bfloat16, 64, 64, 0, None, id="dtype1-64-0-A13"),
        pytest.param(torch.bfloat16, 112, 112, 0, None, id="dtype2-112-0-A13"),
        pytest.param(torch.bfloat16, 16, 16, 0, "backward kernel takes",
                     id="dtype3-16-0-A13"),
        pytest.param(torch.float32, 128, 128, 0, None, id="dtype4-128-0-None"),
        pytest.param(torch.float32, 16, 16, 0, None, id="dtype5-16-0-None"),
        pytest.param(torch.float32, 32, 32, 0, None, id="dtype6-32-0-None"),
        pytest.param(torch.float32, 64, 64, 0, None, id="dtype7-64-0-A13"),
        pytest.param(torch.bfloat16, 128, 128, 1, "aligned",
                     id="dtype8-128-1-aligned"),
        pytest.param(torch.bfloat16, 192, 128, 0, None, id="bf16-mla-192-128"),
        pytest.param(torch.float32, 192, 128, 0, None, id="fp32-mla-192-128"),
        pytest.param(torch.float32, 24, 16, 0, None, id="fp32-reduced-mla"),
        pytest.param(torch.float32, 112, 112, 0, None, id="fp32-112"),
        pytest.param(torch.bfloat16, 48, 48, 0, "backward kernel takes",
                     id="bf16-48-not-instantiated"),
        pytest.param(torch.float32, 48, 48, 0, "backward kernel takes",
                     id="fp32-48-not-instantiated"),
        pytest.param(torch.bfloat16, 128, 64, 0, "backward kernel takes",
                     id="bf16-128-64-not-instantiated"),
        pytest.param(torch.bfloat16, 64, 64, 4, "aligned",
                     id="bf16-64-misaligned")])
    def test_flash_bwd_route(self, launches, dtype, h, hv, offset, refused):
        b, s, nq, nkv = 2, 40, 4, 2
        q = torch.zeros(b * s * nq * h + offset, dtype=dtype)[offset:].view(
            b, s, nq, h)
        k = torch.zeros((b, s, nkv, h), dtype=dtype)
        v = torch.zeros((b, s, nkv, hv), dtype=dtype)
        o = torch.zeros((b, s, nq, hv), dtype=dtype)
        lse = torch.zeros((b, nq, s))
        if refused:
            with pytest.raises(ValueError, match=refused):
                FA.flash_attention_bwd(q, k, v, o, lse, o)
            assert launches == []
            return
        dq, dk, dv = FA.flash_attention_bwd(q, k, v, o, lse, o)
        assert dq.shape == q.shape and dk.shape == k.shape
        assert dv.shape == v.shape
        ((name, a),) = launches
        assert name == "flash_attention_bwd"
        # b, S, Sk, Nq, Nkv, H, Hv, causal
        assert a[10:18] == (b, s, s, nq, nkv, h, hv, 1)
        assert a[-2] == _build.DTYPE_CODES[dtype]  # the dtype picks the route

    @pytest.mark.parametrize("s,sk", [(1500, 1500), (1, 1500), (40, 1500),
                                      (448, 1500), (7, 3)])
    def test_flash_bwd_full_attention_takes_its_own_key_length(
            self, launches, s, sk):
        """Whisper's encoder (S = Sk = 1500) and cross-attention (S against
        Sk 1500): non-causal, Sk passed beside S, dk/dv of length Sk."""
        q = torch.zeros((1, s, 16, 64), dtype=torch.bfloat16)
        kv = torch.zeros((1, sk, 16, 64), dtype=torch.bfloat16)
        lse = torch.zeros((1, 16, s))
        dq, dk, dv = FA.flash_attention_bwd(q, kv, kv, q, lse, q,
                                            causal=False)
        assert dq.shape == q.shape and dk.shape == dv.shape == kv.shape
        ((_, a),) = launches
        assert a[10:18] == (1, s, sk, 16, 16, 64, 64, 0)

    def test_flash_bwd_refusals_come_before_any_launch(self, launches):
        q = torch.zeros((1, 8, 4, 128))
        lse = torch.zeros((1, 4, 8))
        kv = torch.zeros((1, 5, 4, 128))
        with pytest.raises(ValueError, match="Sk = S when causal"):
            FA.flash_attention_bwd(q, kv, kv, q, lse, q)  # causal, Sk != S
        with pytest.raises(ValueError, match="backward kernel takes"):
            # Hv = 32 beside H = 128: no instantiation
            FA.flash_attention_bwd(q, q, q[..., :32], q[..., :32], lse,
                                   q[..., :32])
        with pytest.raises(ValueError, match="backward kernel takes"):
            FA.flash_attention_bwd(q[..., :48], q[..., :48], q[..., :48],
                                   q[..., :48], lse, q[..., :48])
        with pytest.raises(ValueError, match="lse"):  # lse of the wrong shape
            FA.flash_attention_bwd(q, q, q, q, lse[:, :2], q)
        with pytest.raises(ValueError, match="lse"):  # lse not fp32
            FA.flash_attention_bwd(q, q, q, q, lse.double(), q)
        with pytest.raises(ValueError, match="o/do"):  # o, do not of width Hv
            FA.flash_attention_bwd(q, q, q, q[..., :64], lse, q[..., :64])
        assert launches == []

    def test_flash_function_refuses_before_the_forward(self, launches):
        """FlashAttentionFunction checks the backward's widths before it
        launches the forward: an un-instantiated width under grad raises
        with nothing launched."""
        q = torch.zeros((1, 8, 4, 48), requires_grad=True)
        with pytest.raises(ValueError, match="backward kernel takes"):
            FA.flash_attention(q, q, q)
        assert launches == []

    # (rows, D, route, blocks) on a card of 132 SMs: the register route
    # takes two blocks of 8 warps per SM, 8 / bwd_row_split rows at once
    # (bf16: 1 warp a row at 512 and 1024, 2 at 1536, 2048 and 3584, 4 at
    # 3072 and 7168; fp32: 1 at 512, 2 at 1024, 4 at 1536, 2048 and 3584,
    # 8 at 3072 and 7168); the loops two blocks of 4 warps per SM, a row
    # per warp.  The first four ids are the names these cases had when the
    # grid was ceil(rows / 4) blocks up to 256; their blocks column is the
    # present rule's.
    @pytest.mark.parametrize("dtype,rows,d,route,blocks", [
        pytest.param(torch.bfloat16, 4096, 2048, 2, 264, id="4096-2048-2-256"),
        pytest.param(torch.bfloat16, 5, 2048, 2, 2, id="5-2048-2-2"),
        pytest.param(torch.bfloat16, 256, 1032, 1, 64, id="256-1032-1-64"),
        pytest.param(torch.bfloat16, 3, 37, 0, 1, id="3-37-0-1"),
        pytest.param(torch.bfloat16, 4096, 7168, 2, 264, id="bf16-4096-7168"),
        pytest.param(torch.bfloat16, 5, 7168, 2, 3, id="bf16-5-7168"),
        pytest.param(torch.bfloat16, 6000, 1024, 2, 264, id="bf16-6000-1024"),
        pytest.param(torch.bfloat16, 9, 3584, 2, 3, id="bf16-9-3584"),
        pytest.param(torch.bfloat16, 1, 512, 2, 1, id="bf16-1-512"),
        pytest.param(torch.float32, 5, 7168, 2, 5, id="fp32-5-7168"),
        pytest.param(torch.float32, 6000, 3072, 2, 264, id="fp32-6000-3072"),
        pytest.param(torch.float32, 5, 1536, 2, 3, id="fp32-5-1536"),
        pytest.param(torch.bfloat16, 6000, 1032, 1, 264, id="bf16-6000-1032"),
        pytest.param(torch.float32, 5, 37, 0, 2, id="fp32-5-37")])
    def test_rmsnorm_bwd_args(self, launches, dtype, rows, d, route, blocks):
        x = torch.zeros((rows, d), dtype=dtype)
        w = torch.ones(d, dtype=dtype)
        dx, dw = R.rmsnorm_bwd(x, w, x, 1e-5)
        assert dx.shape == x.shape and dw.shape == w.shape
        ((name, a),) = launches
        assert name == "rmsnorm_bwd"
        assert a[6:9] == (rows, d, blocks) and a[-2] == route
        assert a[-3] == _build.DTYPE_CODES[dtype]

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_rmsnorm_bwd_row_split_fits_the_kernel(self, dtype):
        """Every register-route width splits into whole warp-wide vectors
        over at most a block's warps, by the fewest warps that keep a
        lane's share within BWD_LANE_BYTES, or else the most the row splits
        into (the rule of csrc/rmsnorm.cu's row_split)."""
        el = torch.tensor([], dtype=dtype).element_size()
        vec = 16 // el
        for d in R.ROW_WIDTHS:
            k = R.bwd_row_split(d, el)
            assert k in (1, 2, 4, 8) and k <= R.BWD_WARPS
            assert d % (32 * k * vec) == 0
            assert k == 1 or d * el > 32 * R.BWD_LANE_BYTES * (k // 2)
            if d * el > 32 * R.BWD_LANE_BYTES * k:  # split no further
                assert k == R.BWD_WARPS or d % (2 * 32 * k * vec)
            assert d * el <= 32 * 112 * k  # at most 7 vectors a lane
        assert R.bwd_row_split(2048, 2) == 2 and R.bwd_row_split(7168, 2) == 4
        assert R.bwd_row_split(3584, 2) == 2 and R.bwd_row_split(7168, 4) == 8

    def test_rmsnorm_bwd_refusals_come_before_any_launch(self, launches):
        x = torch.zeros((4, 256), dtype=torch.bfloat16)
        w = torch.ones(256, dtype=torch.bfloat16)
        with pytest.raises(ValueError):
            R.rmsnorm_bwd(x, w, x[:2], 1e-5)
        wide = torch.zeros((2, R.BWD_MAX_WIDTH + 8), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="exceed"):
            R.rmsnorm_bwd(wide, torch.ones(wide.shape[1], dtype=torch.bfloat16),
                          wide, 1e-5)
        assert launches == []

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_rmsnorm_bwd_split_route_refusals(self, launches, dtype):
        """The rows shared by several warps (7168) take what the other
        routes take and refuse the rest before any launch: dy of another
        dtype, shape or layout, w of another width, float64."""
        x = torch.zeros((5, 7168), dtype=dtype)
        w = torch.ones(7168, dtype=dtype)
        other = torch.bfloat16 if dtype == torch.float32 else torch.float32
        with pytest.raises(TypeError):
            R.rmsnorm_bwd(x, w, x.to(other), 1e-5)
        with pytest.raises(TypeError):
            R.rmsnorm_bwd(x.double(), w.double(), x.double(), 1e-5)
        with pytest.raises(ValueError):
            R.rmsnorm_bwd(x, w[:3584], x, 1e-5)
        with pytest.raises(ValueError):
            R.rmsnorm_bwd(x, w, x[:4], 1e-5)
        with pytest.raises(ValueError):  # a non-contiguous dy
            R.rmsnorm_bwd(x, w, torch.zeros((7168, 5), dtype=dtype).t(), 1e-5)
        assert launches == []

    @pytest.mark.parametrize("m,h,q,p,n,dtype", [
        (16, 48, 256, 64, 128, torch.bfloat16),   # mamba2-780m's training
        (4, 112, 256, 64, 64, torch.bfloat16),    # zamba2-7b
        (3, 4, 5, 16, 16, torch.float32),         # reduced, a ragged chunk
        (2, 2, 1, 128, 128, torch.float32)])      # the widest it takes
    def test_ssd_intra_bwd_args(self, launches, m, h, q, p, n, dtype):
        """The model's strided views reach the entry point as they are:
        x, B and C cut from one activation, dy a (M,H,Q,P) view of the
        forward's (M,Q,H,P) buffer; dx comes back in that layout too."""
        x, dt, da, b, c = _ssd(m, h, q, p, n, dtype)
        dy = torch.zeros((m, q, h, p)).permute(0, 2, 1, 3)
        ds = torch.zeros((m, h, n, p))
        dx, ddt, dda, db, dc = S.ssd_intra_bwd(x, dt, da, b, c, dy, ds)
        assert dx.shape == x.shape and dx.dtype == dtype
        assert dx.stride() == (q * h * p, p, h * p, 1)
        assert ddt.shape == dda.shape == dt.shape
        assert ddt.dtype == dda.dtype == torch.float32
        assert db.shape == dc.shape == b.shape and db.dtype == dtype
        ((name, a),) = launches
        assert name == "ssd_intra_bwd"
        assert a[13:18] == (m, h, q, p, n)
        assert list(a[18]) == [*x.stride()[:3], *dt.stride(), *da.stride(),
                               *b.stride()[:2], *c.stride()[:2],
                               *dy.stride()[:3], *dx.stride()[:3]]
        assert a[-2] == _build.DTYPE_CODES[dtype]

    @pytest.mark.parametrize("q,p,n,bad,error", [
        (257, 16, 16, None, ValueError),           # Q > 256
        (8, 129, 16, None, ValueError),            # P > 128
        (8, 16, 129, None, ValueError),            # N > 128
        (8, 16, 16, "dt", TypeError),              # dt not fp32
        (8, 16, 16, "dy", TypeError),              # dy not fp32
        (8, 16, 16, "ds_shape", ValueError)])      # ds not (M,H,N,P)
    def test_ssd_intra_bwd_refusals_come_before_any_launch(
            self, launches, q, p, n, bad, error):
        x, dt, da, b, c = _ssd(2, 3, q, p, n, torch.float32)
        dy = torch.zeros(x.shape)
        ds = torch.zeros((2, 3, n, p))
        if bad == "dt":
            dt = dt.bfloat16()
        elif bad == "dy":
            dy = dy.bfloat16()
        elif bad == "ds_shape":
            ds = ds[:, :, :-1]
        with pytest.raises(error):
            S.ssd_intra_bwd(x, dt, da, b, c, dy, ds)
        assert launches == []

    def test_ssd_intra_takes_the_function_only_under_grad(self, launches):
        """On the card, a call under grad goes through SSDIntraFunction
        (its output has a grad_fn) and launches the forward alone; under
        no_grad or inference_mode it is the plain forward launch with no
        grad_fn."""
        x, dt, da, b, c = _ssd(2, 3, 8, 16, 16, torch.float32)
        x.requires_grad_(True)
        y, s = S.ssd_intra(x, dt, da, b, c)
        assert type(y.grad_fn).__name__ == "SSDIntraFunctionBackward"
        for ctx in (torch.no_grad, torch.inference_mode):
            with ctx():
                y, s = S.ssd_intra(x, dt, da, b, c)
            assert y.grad_fn is None
        assert [n for n, _ in launches] == ["ssd_intra"] * 3
