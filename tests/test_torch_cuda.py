"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and the CUDA toolkit (the kernels build
at first use): each is marked ``cuda`` and skips elsewhere.  The file
imports neither JAX nor the reference package, so it runs on the machine
with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Shapes are the main paths' widths (internlm2-1.8b: Nq=16, Nkv=8, H=128,
D=2048, block 16; mamba2-780m: 48 SSM heads of P=64, N=128, conv_dim
3328; deepseek-v2-lite-16b: 16 heads, latent R=512, rope PR=64, QK width
192, V width 128; whisper-medium: 16/16 heads of 64, 1500 encoder frames);
tolerances those of test_kernels.py (fp32 1e-5, bf16 2e-2, atol and rtol).
The engines (and ``TestCudaGraphCells``, every warm cell a CUDA graph)
run at reduced size in fp32, where replays must match eager runs bit for
bit.
"""

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (DECODE_TENSOR_CORE_WIDTHS,
                                                  DECODE_TILES_PER_SPLIT,
                                                  decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (TENSOR_CORE_WIDTHS,
                                                 flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.paged_decode_attention import (
    MLA_TILES_PER_SPLIT, paged_decode_attention, paged_decode_attention_plain,
    paged_mla_decode_attention, paged_mla_decode_attention_plain)
from repro_torch.kernels.rmsnorm import ROW_WIDTHS, rmsnorm, rmsnorm_plain
from repro_torch.kernels.ssd_scan import (SSD_TENSOR_CORE_WIDTHS, ssd_intra,
                                          ssd_intra_plain, ssd_intra_route,
                                          ssd_slab_decode,
                                          ssd_slab_decode_plain)
from repro_torch.training.tree import leaves as tree_leaves
from repro_torch.training.tree import unflatten

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda():
    """The card; skips without one (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, dtype, *shapes, device):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen).to(getattr(torch, dtype)).to(device)
            for s in shapes]


def _close(got, want, dtype):
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(),
                               **TOL[dtype])


@pytest.mark.cuda
class TestCudaKernels:
    """Each CUDA kernel against its plain version on the card, at the
    main path's widths (Nq=16, Nkv=8, H=128, D=2048, block 16)."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_rmsnorm(self, cuda, dtype):
        x, w = _inputs(20, dtype, (4, 5, 2048), (2048,), device=cuda)
        _close(rmsnorm(x, w, 1e-5), rmsnorm_plain(x, w, 1e-5), dtype)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("rows", [1, 4, 256])
    @pytest.mark.parametrize("d", sorted(ROW_WIDTHS))
    def test_rmsnorm_row_in_registers(self, cuda, dtype, rows, d):
        x, w = _inputs(21, dtype, (rows, d), (d,), device=cuda)
        x = x * 3.0
        _close(rmsnorm(x, w, 1e-6), rmsnorm_plain(x, w, 1e-6), dtype)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("d", [1032, 100, 37])  # vectors / scalar routes
    def test_rmsnorm_other_widths(self, cuda, dtype, d):
        x, w = _inputs(22, dtype, (5, d), (d,), device=cuda)
        _close(rmsnorm(x, w, 1e-6), rmsnorm_plain(x, w, 1e-6), dtype)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("b", [1, 4])
    @pytest.mark.parametrize("s", [8, 40, 64, 100, 256])
    def test_flash_attention(self, cuda, dtype, b, s):
        """GQA g = 2; S at the prefill buckets, a ragged 40 and 100, and
        one whole 64-row tile (the bf16 kernel's tile)."""
        q, k, v = _inputs(21, dtype, (b, s, 16, 128), (b, s, 8, 128),
                          (b, s, 8, 128), device=cuda)
        _close(flash_attention(q, k, v), flash_attention_plain(q, k, v),
               dtype)

    @pytest.mark.parametrize("b", [2, 8])
    def test_flash_non_causal(self, cuda, b):
        q, k, v = _inputs(25, "bfloat16", (b, 100, 16, 128), (b, 100, 8, 128),
                          (b, 100, 8, 128), device=cuda)
        _close(flash_attention(q, k, v, causal=False, scale=0.1),
               flash_attention_plain(q, k, v, causal=False, scale=0.1),
               "bfloat16")

    @pytest.mark.parametrize("widths", sorted(TENSOR_CORE_WIDTHS))
    @pytest.mark.parametrize("b,s", [(1, 200), (4, 256)])
    def test_flash_every_instantiated_width(self, cuda, widths, b, s):
        """Each (H, Hv) of the bf16 kernel, at one prefill row (a grid that
        leaves SMs idle: 8 warps, key halves) and at the batched bucket
        (4 warps)."""
        h, hv = widths
        q, k, v = _inputs(28, "bfloat16", (b, s, 16, h), (b, s, 8, h),
                          (b, s, 8, hv), device=cuda)
        _close(flash_attention(q, k, v), flash_attention_plain(q, k, v),
               "bfloat16")

    def test_flash_refuses_what_the_tensor_cores_cannot_take(self, cuda):
        """bf16 needs 16-byte aligned operands and an instantiated (H, Hv);
        fp32 (the CUDA-core kernel) takes both."""
        q, k, wide = _inputs(26, "bfloat16", (1, 40, 16, 128),
                             (1, 40, 8, 128), (1, 40, 8, 256), device=cuda)
        _build.reset_launches()
        with pytest.raises(ValueError, match="16-byte"):
            flash_attention(q, k, wide[..., 4:132])  # base 8 bytes off
        q96, k96, v96 = _inputs(27, "bfloat16", (1, 40, 4, 96),
                                (1, 40, 4, 96), (1, 40, 4, 96), device=cuda)
        with pytest.raises(ValueError, match="no bf16 kernel"):
            flash_attention(q96, k96, v96)
        assert _build.launches["flash_attention"] == 0
        q32, k32, v32 = (t.float() for t in (q96, k96, v96))
        _close(flash_attention(q32, k32, v32),
               flash_attention_plain(q32, k32, v32), "float32")

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_decode_attention(self, cuda, dtype):
        q, k, v = _inputs(22, dtype, (4, 16, 128), (4, 512, 8, 128),
                          (4, 512, 8, 128), device=cuda)
        lengths = torch.tensor([0, 1, 41, 233], dtype=torch.int32, device=cuda)
        got = decode_attention(q, k, v, lengths)
        _close(got, decode_attention_plain(q, k, v, lengths), dtype)
        assert torch.equal(got[0], torch.zeros_like(got[0]))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_paged_decode_attention(self, cuda, dtype):
        q, kp, vp = _inputs(23, dtype, (4, 16, 128), (65, 16, 8, 128),
                            (65, 16, 8, 128), device=cuda)
        tables = torch.zeros((4, 16), dtype=torch.int32)  # lanes -> scratch 0
        perm = torch.randperm(64, generator=torch.Generator().manual_seed(0)) + 1
        lengths = [0, 1, 41, 233]
        used = 0
        for i, n in enumerate(lengths):
            tables[i, : -(-n // 16)] = perm[used: used + -(-n // 16)]
            used += -(-n // 16)
        tables = tables.to(cuda)
        lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
        got = paged_decode_attention(q, kp, vp, tables, lens)
        want = paged_decode_attention_plain(q, kp, vp, tables, lens)
        _close(got, want, dtype)
        kd = kp[tables.long()].reshape(4, -1, 8, 128)
        vd = vp[tables.long()].reshape(4, -1, 8, 128)
        torch.testing.assert_close(got, decode_attention(q, kd, vd, lens,
                                                         block_k=16))

    def test_launches_are_counted(self, cuda):
        x, w = _inputs(24, "float32", (2, 64), (64,), device=cuda)
        _build.reset_launches()
        rmsnorm(x, w, 1e-5)
        assert _build.launches["rmsnorm"] == 1


def _gqa_inputs(seed, dtype, lengths, nq, nkv, h, device, w=16):
    """q, pools of 1 + the rows' live blocks (block 0 the scratch block, full
    of 1e4), tables (B, w) whose live blocks are drawn without replacement
    and whose lanes past them point at block 0, lengths."""
    nb = 1 + sum(-(-n // 16) for n in lengths)
    q, kp, vp = _inputs(seed, dtype, (len(lengths), nq, h), (nb, 16, nkv, h),
                        (nb, 16, nkv, h), device=device)
    kp[0], vp[0] = 1e4, 1e4
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(seed)) + 1
    tables = torch.zeros((len(lengths), w), dtype=torch.int32)
    used = 0
    for i, n in enumerate(lengths):
        tables[i, : -(-n // 16)] = perm[used: used + -(-n // 16)]
        used += -(-n // 16)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    return q, kp, vp, tables.to(device), lens


def _dense_view(kp, vp, tables):
    """The rows' blocks as a dense (B, W * 16, Nkv, H) cache."""
    return (kp[tables.long()].flatten(1, 2), vp[tables.long()].flatten(1, 2))


# lengths 0, 1, one block +- 1, every split boundary of a W-16 table +- 1
# (splits of DECODE_TILES_PER_SPLIT blocks) and W * 16
_EDGE = 16 * DECODE_TILES_PER_SPLIT
SPLIT_EDGES = sorted({0, 1, 15, 16, 17, 256} | {
    n for j in range(1, 16 // DECODE_TILES_PER_SPLIT)
    for n in (j * _EDGE - 1, j * _EDGE, j * _EDGE + 1)})


@pytest.mark.cuda
class TestCudaDecodeSplit:
    """The GQA decode pair's split KV sweep (bf16 on the tensor cores, fp32
    on the CUDA cores) at every GQA group size and head width of the
    repo's configs."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("h", sorted(DECODE_TENSOR_CORE_WIDTHS))
    @pytest.mark.parametrize("g,nkv", [(1, 4), (2, 8), (6, 2), (16, 2),
                                       (48, 1)])
    def test_both_kernels_match_plain_across_split_edges(self, cuda, dtype,
                                                         h, g, nkv):
        q, kp, vp, tables, lens = _gqa_inputs(30 + g + h, dtype, SPLIT_EDGES,
                                              g * nkv, nkv, h, cuda)
        paged = paged_decode_attention(q, kp, vp, tables, lens)
        _close(paged[1:], paged_decode_attention_plain(q, kp, vp, tables,
                                                       lens)[1:], dtype)
        assert torch.equal(paged[0], torch.zeros_like(paged[0]))
        kd, vd = _dense_view(kp, vp, tables)
        dense = decode_attention(q, kd, vd, lens)
        _close(dense[1:], decode_attention_plain(q, kd, vd, lens)[1:], dtype)
        assert torch.equal(dense, paged)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("w", [16, 32])
    def test_paged_equals_dense_at_any_width(self, cuda, dtype, w):
        """Batched decode's width-16 table against a width-w table and the
        unbatched dense cache (B, w * 16, Nkv, H) of the same rows: the same
        bits, since splits follow block indices, never the width."""
        q, kp, vp, tables, lens = _gqa_inputs(36, dtype, [38, 101, 233, 17],
                                              16, 8, 128, cuda)
        paged = paged_decode_attention(q, kp, vp, tables, lens)
        lanes = torch.zeros((4, w), dtype=torch.int32, device=cuda)
        lanes[:, :16] = tables  # past them: the scratch block
        assert torch.equal(paged_decode_attention(q, kp, vp, lanes, lens),
                           paged)
        kd, vd = _dense_view(kp, vp, lanes)
        assert torch.equal(decode_attention(q, kd, vd, lens, block_k=16),
                           paged)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_scratch_lanes_are_never_read(self, cuda, dtype):
        q, kp, vp, tables, lens = _gqa_inputs(37, dtype, [1, 16, 33, 200],
                                              16, 8, 128, cuda)
        dirty = paged_decode_attention(q, kp, vp, tables, lens)
        kp[0], vp[0] = 0.0, 0.0
        assert torch.equal(paged_decode_attention(q, kp, vp, tables, lens),
                           dirty)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_two_streams_at_once_equal_one_after_the_other(self, cuda,
                                                           dtype):
        """Each call takes its scratch on the caller's stream: two calls in
        flight on two streams give the bits of the same calls in turn."""
        one = _gqa_inputs(38, dtype, [233, 38, 101, 64], 16, 8, 128, cuda)
        two = _gqa_inputs(39, dtype, [17, 200, 0, 129], 16, 8, 128, cuda)
        dense = [(a[0], *_dense_view(*a[1:4]), a[4]) for a in (one, two)]
        want = [paged_decode_attention(*a) for a in (one, two)]
        want_dense = [decode_attention(*a) for a in dense]
        torch.cuda.synchronize()
        streams = [torch.cuda.Stream(), torch.cuda.Stream()]
        got, got_dense = [], []
        for _ in range(3):
            for stream, args, dargs in zip(streams, (one, two), dense):
                with torch.cuda.stream(stream):
                    got.append(paged_decode_attention(*args))
                    got_dense.append(decode_attention(*dargs))
        torch.cuda.synchronize()
        for i, (out, dout) in enumerate(zip(got, got_dense)):
            assert torch.equal(out, want[i % 2])
            assert torch.equal(dout, want_dense[i % 2])

    def test_refuses_what_the_tensor_cores_cannot_take(self, cuda):
        """bf16 needs an instantiated head width, tiles of a multiple of 16
        positions and 16-byte aligned operands, and raises before any
        launch; fp32 (the CUDA cores) takes all three."""
        q, kp, vp, tables, lens = _gqa_inputs(40, "bfloat16", [20, 40], 4, 2,
                                              96, cuda)
        kd, vd = _dense_view(kp, vp, tables)
        _build.reset_launches()
        with pytest.raises(ValueError, match="no bf16 kernel"):
            paged_decode_attention(q, kp, vp, tables, lens)
        with pytest.raises(ValueError, match="no bf16 kernel"):
            decode_attention(q, kd, vd, lens)
        q, kp, vp, tables, lens = _gqa_inputs(41, "bfloat16", [20, 40], 4, 2,
                                              128, cuda)
        kd, vd = _dense_view(kp, vp, tables)
        with pytest.raises(ValueError, match="no bf16 kernel"):
            decode_attention(q, kd, vd, lens, block_k=8)
        wide = torch.zeros((kp.shape[0], 16, 2, 136), dtype=torch.bfloat16,
                           device=cuda)
        odd = wide[..., 4:132]  # base 8 bytes off, rows 272 bytes apart
        odd.copy_(kp)
        with pytest.raises(ValueError, match="16-byte"):
            paged_decode_attention(q, odd, odd, tables, lens)
        assert _build.launches["paged_decode_attention"] == 0
        assert _build.launches["decode_attention"] == 0
        args = [t.float() for t in (q, odd, odd)]
        _close(paged_decode_attention(*args, tables, lens),
               paged_decode_attention_plain(*args, tables, lens), "float32")
        assert _build.launches["paged_decode_attention"] == 1

    def test_cuda_tensors_launch_or_raise(self, cuda, monkeypatch):
        from repro_torch.kernels import decode_attention as da
        from repro_torch.kernels import paged_decode_attention as pda

        def refuse(*args, **kwargs):
            raise AssertionError("plain decode version called on the card")

        monkeypatch.setattr(pda, "paged_decode_attention_plain", refuse)
        monkeypatch.setattr(da, "decode_attention_plain", refuse)
        q, kp, vp, tables, lens = _gqa_inputs(42, "bfloat16", [3, 20], 16, 8,
                                              128, cuda)
        _build.reset_launches()
        pda.paged_decode_attention(q, kp, vp, tables, lens)
        da.decode_attention(q, *_dense_view(kp, vp, tables), lens)
        torch.cuda.synchronize()
        assert _build.launches["paged_decode_attention"] == 1
        assert _build.launches["decode_attention"] == 1
        with pytest.raises(TypeError):  # mixed dtypes
            pda.paged_decode_attention(q.float(), kp, vp, tables, lens)
        assert _build.launches["paged_decode_attention"] == 1


@pytest.mark.cuda
def test_engine_on_the_card(cuda):
    """The main path on the card at reduced size: 4 streams on 2 servers
    through the paged batched engine give unbatched generate's fp32 tokens,
    leak no block, and run through all four kernels."""
    import dataclasses
    import threading

    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServeEngine, StreamSpec

    cfg = dataclasses.replace(get_config("internlm2_1_8b").reduced(),
                              dtype="float32")
    params = M.init_params(cfg, generator=torch.Generator(cuda).manual_seed(0),
                           device=cuda)
    prompts = {f"s{i}": np.arange(1, n + 1, dtype=np.int32)[None] % 128
               for i, n in enumerate([3, 5, 9, 17])}
    spec = lambda n, p: StreamSpec(name=n, priority=p, period_ms=8000.0,
                                   deadline_ms=8000.0, prefill_ms=50.0,
                                   decode_ms=5.0, decode_steps=6)
    ref = ServeEngine(cfg, params, max_seq=32, kv_block_size=8, device=cuda)
    _build.reset_launches()
    want = {}
    for i, n in enumerate(prompts):
        assert ref.admit(spec(n, 4 - i)).admitted
        want[n] = ref.generate(n, prompts[n], steps=6).tokens
    ref.close()
    eng = ServeEngine(cfg, params, max_seq=32, num_servers=2, batching=True,
                      max_batch=4, paged=True, kv_block_size=8, device=cuda)
    try:
        eng.precompile(prompt_buckets=(4, 8, 16, 32))
        for i, n in enumerate(prompts):
            assert eng.admit(spec(n, 4 - i)).admitted
        got = {}
        threads = [threading.Thread(
            target=lambda n=n: got.__setitem__(n, eng.generate(
                n, prompts[n], steps=6))) for n in prompts]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert {n: r.tokens for n, r in got.items()} == want
        assert eng.kv_blocks_in_use() == 0
        for name in ("rmsnorm", "flash_attention", "decode_attention",
                     "paged_decode_attention"):
            assert _build.launches[name] > 0, name
    finally:
        eng.close()


@pytest.mark.cuda
def test_engine_traced_on_the_card(cuda):
    """Tracing on the card: the graphed paged engine gives the same tokens
    traced as untraced, and each batched call's wait, ended by a stream
    synchronize, lies between its stage and its readback; the steps cover
    the call's ``seconds``."""
    import dataclasses
    import threading

    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServeEngine, StreamSpec

    cfg = dataclasses.replace(get_config("internlm2_1_8b").reduced(),
                              dtype="float32")
    params = M.init_params(cfg, generator=torch.Generator(cuda).manual_seed(0),
                           device=cuda)
    prompts = {f"s{i}": np.arange(1, n + 1, dtype=np.int32)[None] % 128
               for i, n in enumerate([3, 5, 9, 17])}
    eng = ServeEngine(cfg, params, max_seq=32, num_servers=2, batching=True,
                      max_batch=4, paged=True, kv_block_size=8, device=cuda)

    def round_():
        got = {}
        threads = [threading.Thread(
            target=lambda n=n: got.__setitem__(n, eng.generate(
                n, prompts[n], steps=6).tokens)) for n in prompts]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        return got

    try:
        eng.precompile(prompt_buckets=(4, 8, 16, 32))
        for n in prompts:
            assert eng.admit(StreamSpec(
                name=n, priority=1, period_ms=8000.0, deadline_ms=8000.0,
                prefill_ms=50.0, decode_ms=5.0, decode_steps=6)).admitted
        want = round_()
        before = [len(s.stats.batch_meta) for s in eng.pool.servers]
        eng.set_tracing(True)
        assert round_() == want
        eng.set_tracing(False)
        recs = eng.trace_records()
        for si, s in enumerate(eng.pool.servers):
            meta = list(s.stats.batch_meta)[before[si]:]
            steps = {}
            for r in recs:
                if r[0] == si and r[1] in ("stage", "wait", "readback"):
                    steps.setdefault(r[4], {})[r[1]] = r
            assert meta and len(steps) == len(meta)
            assert any(m["graphed"] for m in meta)
            for (_, got), m in zip(sorted(steps.items()), meta):
                stage, wait, read = got["stage"], got["wait"], got["readback"]
                assert stage[3] == wait[2] < wait[3] == read[2] < read[3]
                assert read[3] - stage[2] >= m["seconds"]
                # the packing before ``seconds``: well under 1 ms
                assert read[3] - stage[2] == pytest.approx(m["seconds"],
                                                           abs=1e-3)
    finally:
        eng.close()


# mamba2-780m widths
SSM_H, SSM_P, SSM_N, SSM_CDIM = 48, 64, 128, 3328


def _ssd_inputs(seed, dtype, rows, s, device, p=SSM_P, n=SSM_N):
    """The model's strided views for ssd_intra at chunk = s: x (M,H,Q,P)
    and B/C (M,Q,N) cut from an (rows, s, H*P + 2N) activation, dt/dA
    (M,H,Q) permuted from (rows, s, H) fp32.  dA lies on a grid of 2**-10,
    so cumsum(dA) is exact in any order: the kernel sums it sequentially,
    torch.cumsum on the card in parallel, and exp(seg_i - seg_j) would
    amplify their last-bit differences past the fp32 tolerance."""
    gen = torch.Generator().manual_seed(seed)
    d_in = SSM_H * p
    xbc = torch.randn((rows, s, d_in + 2 * n), generator=gen).to(
        getattr(torch, dtype)).to(device)
    dt = torch.nn.functional.softplus(torch.randn((rows, s, SSM_H),
                                                  generator=gen)).to(device)
    a = -torch.linspace(1.0, 16.0, SSM_H, device=device) * 0.01
    x = xbc[..., :d_in].view(rows, s, SSM_H, p).permute(0, 2, 1, 3)
    b = xbc[..., d_in:d_in + n]
    c = xbc[..., d_in + n:]
    da = torch.round(dt * a * 1024) / 1024
    return x, dt.permute(0, 2, 1), da.permute(0, 2, 1), b, c


@pytest.mark.cuda
class TestCudaSSDKernels:
    """ssd_intra and ssd_slab_decode against their plain versions on the
    card, at mamba2-780m widths."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("rows,q", [(4, 5), (3, 200), (4, 256), (2, 64),
                                        (2, 128)])
    def test_ssd_intra(self, cuda, dtype, rows, q):
        x, dt, da, b, c = _ssd_inputs(30, dtype, rows, q, cuda)
        y, s = ssd_intra(x, dt, da, b, c)
        y_want, s_want = ssd_intra_plain(x, dt, da, b, c)
        assert y.dtype == s.dtype == torch.float32
        _close(y, y_want, dtype)
        _close(s, s_want, dtype)

    @pytest.mark.parametrize("m", [1, 4])
    @pytest.mark.parametrize("q", [5, 37, 64, 128, 200, 256])
    @pytest.mark.parametrize("widths", sorted(SSD_TENSOR_CORE_WIDTHS))
    def test_ssd_intra_tensor_cores(self, cuda, widths, q, m):
        p, n = widths
        x, dt, da, b, c = _ssd_inputs(34, "bfloat16", m, q, cuda, p, n)
        assert ssd_intra_route(x, b, c) == "tensor_cores"
        y, s = ssd_intra(x, dt, da, b, c)
        y_want, s_want = ssd_intra_plain(x, dt, da, b, c)
        _close(y, y_want, "bfloat16")
        _close(s, s_want, "bfloat16")

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_ssd_intra_padding_adds_exact_zeros(self, cuda, dtype):
        """dt = 0 past a row's length: the bucketed chunk's y rows and state
        equal the exact-length chunk's bit for bit (bf16: on the tensor
        cores, 64 -> 37 in one tile and 256 -> 200 over four)."""
        x, dt, da, b, c = _ssd_inputs(31, dtype, 1, 256, cuda)
        dt, da = dt.clone(), da.clone()
        dt[..., 200:] = 0.0
        da[..., 200:] = 0.0
        y_pad, s_pad = ssd_intra(x, dt, da, b, c)
        y, s = ssd_intra(x[:, :, :200], dt[..., :200], da[..., :200],
                         b[:, :200], c[:, :200])
        assert torch.equal(y_pad[:, :, :200], y)
        assert torch.equal(s_pad, s)
        x, dt, da, b, c = _ssd_inputs(31, dtype, 1, 64, cuda)
        dt, da = dt.clone(), da.clone()
        dt[..., 37:] = 0.0
        da[..., 37:] = 0.0
        y_pad, s_pad = ssd_intra(x, dt, da, b, c)
        y, s = ssd_intra(x[:, :, :37], dt[..., :37], da[..., :37],
                         b[:, :37], c[:, :37])
        assert torch.equal(y_pad[:, :, :37], y)
        assert torch.equal(s_pad, s)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("slabs", [[7], [5, 2], [9, 3, 3, 1]])
    def test_ssd_slab_decode(self, cuda, dtype, slabs):
        gen = torch.Generator().manual_seed(32)
        rows, ns = len(slabs), 10
        pool = torch.randn((ns, SSM_H, SSM_P, SSM_N), generator=gen).to(cuda)
        xbc = torch.randn((rows, SSM_CDIM), generator=gen).to(
            getattr(torch, dtype)).to(cuda)
        d_in = SSM_H * SSM_P
        x = xbc[:, :d_in].view(rows, SSM_H, SSM_P)
        b = xbc[:, d_in:d_in + SSM_N].view(rows, 1, SSM_N)
        c = xbc[:, d_in + SSM_N:].view(rows, 1, SSM_N)
        dt = torch.nn.functional.softplus(
            torch.randn((rows, 1, SSM_H), generator=gen)).to(cuda)[:, 0]
        a = -torch.linspace(1.0, 16.0, SSM_H, device=cuda)
        for row in range(1, rows):  # a repeated id repeats its row, as
            if slabs[row] in slabs[:row]:  # padding rows do
                first = slabs.index(slabs[row])
                xbc[row], dt[row] = xbc[first], dt[first]
        ids = torch.tensor(slabs, dtype=torch.int32, device=cuda)
        y, states = ssd_slab_decode(pool, ids, x, dt, a, b, c)
        y_want, s_want = ssd_slab_decode_plain(pool, ids, x, dt, a, b, c)
        _close(y, y_want, dtype)
        _close(states, s_want, "float32")
        new_pool = pool.clone()
        new_pool.index_copy_(0, ids.long(), states)
        rest = [i for i in range(ns) if i not in slabs]
        assert torch.equal(new_pool[rest], pool[rest])
        assert torch.equal(new_pool[ids.long()], states)

    def test_ssd_launches_are_counted(self, cuda):
        x, dt, da, b, c = _ssd_inputs(33, "float32", 1, 8, cuda)
        _build.reset_launches()
        ssd_intra(x, dt, da, b, c)
        assert _build.launches["ssd_intra"] == 1


@pytest.mark.cuda
def test_ssm_engine_on_the_card(cuda, monkeypatch):
    """The SSM path on the card at reduced size: the slab-paged batched
    engine gives unbatched generate's fp32 tokens, leaks no slab, and its
    prefill and both decode paths run the SSD kernels -- the plain versions
    are never called."""
    import dataclasses
    import threading

    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ssd_scan
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServeEngine, StreamSpec

    def refuse(*args, **kwargs):
        raise AssertionError("plain SSD version called on the card")

    monkeypatch.setattr(ssd_scan, "ssd_intra_plain", refuse)
    monkeypatch.setattr(ssd_scan, "ssd_slab_decode_plain", refuse)
    cfg = dataclasses.replace(get_config("mamba2_780m").reduced(),
                              dtype="float32")
    params = M.init_params(cfg, generator=torch.Generator(cuda).manual_seed(0),
                           device=cuda)
    prompts = {f"s{i}": (np.arange(1, n + 1, dtype=np.int32)[None] * 7) % 128
               for i, n in enumerate([3, 5, 9, 17])}
    spec = lambda n, p: StreamSpec(name=n, priority=p, period_ms=8000.0,
                                   deadline_ms=8000.0, prefill_ms=50.0,
                                   decode_ms=5.0, decode_steps=6)
    ref = ServeEngine(cfg, params, max_seq=32, device=cuda)
    _build.reset_launches()
    want = {}
    for i, n in enumerate(prompts):
        assert ref.admit(spec(n, 4 - i)).admitted
        want[n] = ref.generate(n, prompts[n], steps=6).tokens
    ref.close()
    assert _build.launches["ssd_slab_decode"] == 4 * 6 * cfg.num_layers
    eng = ServeEngine(cfg, params, max_seq=32, num_servers=2, batching=True,
                      max_batch=4, paged=True, device=cuda)
    try:
        eng.precompile(prompt_buckets=(4, 8, 16, 32))
        _build.reset_launches()
        for i, n in enumerate(prompts):
            assert eng.admit(spec(n, 4 - i)).admitted
        got = {}
        threads = [threading.Thread(
            target=lambda n=n: got.__setitem__(n, eng.generate(
                n, prompts[n], steps=6))) for n in prompts]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert {n: r.tokens for n, r in got.items()} == want
        assert eng.kv_usage() == {"blocks": 0, "slabs": 0, "segments": 0}
        for name in ("rmsnorm", "ssd_intra", "ssd_slab_decode"):
            assert _build.launches[name] > 0, name
    finally:
        eng.close()


@pytest.mark.cuda
def test_hybrid_engine_on_the_card(cuda, monkeypatch):
    """The hybrid path on the card at reduced size (G 2, PG 2, R 2): the
    batched engine, staging shared-attention block pools and Mamba-2 slab
    pools in each decode call, gives unbatched generate's fp32 tokens,
    leaks no block or slab, and runs the attention and SSD kernels -- the
    plain versions are never called."""
    import dataclasses
    import threading

    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     paged_decode_attention, ssd_scan)
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServeEngine, StreamSpec

    def refuse(*args, **kwargs):
        raise AssertionError("plain version called on the card")

    for mod, name in ((ssd_scan, "ssd_intra_plain"),
                      (ssd_scan, "ssd_slab_decode_plain"),
                      (flash_attention, "flash_attention_plain"),
                      (decode_attention, "decode_attention_plain"),
                      (paged_decode_attention, "paged_decode_attention_plain")):
        monkeypatch.setattr(mod, name, refuse)
    cfg = dataclasses.replace(get_config("zamba2_7b").reduced(),
                              dtype="float32", num_layers=8, attn_every=3)
    params = M.init_params(cfg, generator=torch.Generator(cuda).manual_seed(0),
                           device=cuda)
    prompts = {f"s{i}": (np.arange(1, n + 1, dtype=np.int32)[None] * 7) % 128
               for i, n in enumerate([3, 5, 9, 17])}
    spec = lambda n, p: StreamSpec(name=n, priority=p, period_ms=8000.0,
                                   deadline_ms=8000.0, prefill_ms=50.0,
                                   decode_ms=5.0, decode_steps=6)
    ref = ServeEngine(cfg, params, max_seq=32, device=cuda)
    _build.reset_launches()
    want = {}
    for i, n in enumerate(prompts):
        assert ref.admit(spec(n, 4 - i)).admitted
        want[n] = ref.generate(n, prompts[n], steps=6).tokens
    ref.close()
    assert _build.launches["ssd_slab_decode"] == 4 * 6 * 6  # 6 Mamba-2 layers
    assert _build.launches["decode_attention"] == 4 * 6 * 2  # 2 applications
    eng = ServeEngine(cfg, params, max_seq=32, num_servers=2, batching=True,
                      max_batch=4, paged=True, kv_block_size=8, device=cuda)
    try:
        eng.precompile(prompt_buckets=(4, 8, 16, 32))
        _build.reset_launches()
        for i, n in enumerate(prompts):
            assert eng.admit(spec(n, 4 - i)).admitted
        got = {}
        threads = [threading.Thread(
            target=lambda n=n: got.__setitem__(n, eng.generate(
                n, prompts[n], steps=6))) for n in prompts]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert {n: r.tokens for n, r in got.items()} == want
        assert eng.kv_usage() == {"blocks": 0, "slabs": 0, "segments": 0}
        kinds = {m["kind"] for s in eng.pool.servers for m in s.stats.batch_meta}
        assert kinds == {"prefill@hybrid", "decode@hybrid"}
        for name in ("rmsnorm", "flash_attention", "paged_decode_attention",
                     "ssd_intra", "ssd_slab_decode"):
            assert _build.launches[name] > 0, name
    finally:
        eng.close()


# deepseek-v2-lite-16b widths
MLA_NQ, MLA_R, MLA_PR, MLA_QK, MLA_V = 16, 512, 64, 192, 128


def _mla_inputs(seed, dtype, lengths, device, nb=129, w=16):
    """q_lat, q_rope, latent pools (nb, 16, R) / (nb, 16, PR) with scratch
    block 0 full of 1e4, tables whose live blocks are drawn without
    replacement and whose lanes past them point at block 0."""
    q_lat, q_rope, ckv, krope = _inputs(
        seed, dtype, (len(lengths), MLA_NQ, MLA_R),
        (len(lengths), MLA_NQ, MLA_PR), (nb, 16, MLA_R), (nb, 16, MLA_PR),
        device=device)
    ckv[0], krope[0] = 1e4, 1e4
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(seed)) + 1
    tables = torch.zeros((len(lengths), w), dtype=torch.int32)
    used = 0
    for i, n in enumerate(lengths):
        tables[i, : -(-n // 16)] = perm[used: used + -(-n // 16)]
        used += -(-n // 16)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    return q_lat, q_rope, ckv, krope, tables.to(device), lens


@pytest.mark.cuda
class TestCudaMLAKernels:
    """paged_mla_decode_attention and flash attention with a value width
    different from the key width, at deepseek-v2-lite-16b widths."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_paged_mla_decode_attention(self, cuda, dtype):
        q_lat, q_rope, ckv, krope, tables, lens = _mla_inputs(
            40, dtype, [0, 38, 101, 233], cuda)
        scale = MLA_QK ** -0.5
        got = paged_mla_decode_attention(q_lat, q_rope, ckv, krope, tables,
                                         lens, scale=scale)
        want = paged_mla_decode_attention_plain(q_lat, q_rope, ckv, krope,
                                                tables, lens, scale=scale)
        _close(got[1:], want[1:], dtype)
        assert torch.equal(got[0], torch.zeros_like(got[0]))

    def test_identity_table_view_equals_paged(self, cuda):
        """The dense (B, Smax, R) cache viewed as (B*Smax/16, 16, R) with
        the identity table gives the paged result bit for bit."""
        q_lat, q_rope, ckv, krope, tables, lens = _mla_inputs(
            41, "bfloat16", [38, 101, 233, 17], cuda)
        paged = paged_mla_decode_attention(q_lat, q_rope, ckv, krope, tables,
                                           lens)
        b, w = tables.shape
        dense_ckv = ckv[tables.long()].reshape(b * w, 16, MLA_R)
        dense_kr = krope[tables.long()].reshape(b * w, 16, MLA_PR)
        ident = (torch.arange(b, device=cuda)[:, None] * w
                 + torch.arange(w, device=cuda)[None, :]).to(torch.int32)
        dense = paged_mla_decode_attention(q_lat, q_rope, dense_ckv, dense_kr,
                                           ident, lens)
        assert torch.equal(dense, paged)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_lengths_across_split_boundaries(self, cuda, dtype):
        """Lengths 0, 1, one block +- 1, every split boundary of a W-16
        table +- 1 (splits of MLA_TILES_PER_SPLIT blocks), and W * 16."""
        edge = 16 * MLA_TILES_PER_SPLIT
        lengths = sorted({0, 1, 15, 16, 17, 16 * 16}
                         | {n for k in range(1, 16 // MLA_TILES_PER_SPLIT)
                            for n in (k * edge - 1, k * edge, k * edge + 1)})
        nb = 1 + sum(-(-n // 16) for n in lengths)
        q_lat, q_rope, ckv, krope, tables, lens = _mla_inputs(
            42, dtype, lengths, cuda, nb=nb)
        scale = MLA_QK ** -0.5
        got = paged_mla_decode_attention(q_lat, q_rope, ckv, krope, tables,
                                         lens, scale=scale)
        want = paged_mla_decode_attention_plain(q_lat, q_rope, ckv, krope,
                                                tables, lens, scale=scale)
        _close(got[1:], want[1:], dtype)
        assert torch.equal(got[0], torch.zeros_like(got[0]))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("w", [16, 32])
    def test_dense_view_of_any_width_equals_paged(self, cuda, dtype, w):
        """Batched decode's width-16 table and unbatched decode's dense
        cache (B, W*16, R) under the identity table, at W 16 and 32, give
        the same bits: splits follow block indices, never the width."""
        q_lat, q_rope, ckv, krope, tables, lens = _mla_inputs(
            46, dtype, [38, 101, 233, 17], cuda)
        paged = paged_mla_decode_attention(q_lat, q_rope, ckv, krope, tables,
                                           lens)
        b = tables.shape[0]
        lanes = torch.zeros((b, w), dtype=torch.int32, device=cuda)
        lanes[:, :16] = tables  # lanes past the live blocks: scratch block 0
        dense_ckv = ckv[lanes.long()].reshape(b * w, 16, MLA_R)
        dense_kr = krope[lanes.long()].reshape(b * w, 16, MLA_PR)
        ident = (torch.arange(b, device=cuda)[:, None] * w
                 + torch.arange(w, device=cuda)[None, :]).to(torch.int32)
        dense = paged_mla_decode_attention(q_lat, q_rope, dense_ckv, dense_kr,
                                           ident, lens)
        assert torch.equal(dense, paged)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_two_streams_at_once_equal_one_after_the_other(self, cuda,
                                                           dtype):
        """Each call takes its scratch on the caller's stream: two calls in
        flight on two streams give the bits of the same calls in turn."""
        one = _mla_inputs(47, dtype, [233, 38, 101, 64], cuda)
        two = _mla_inputs(48, dtype, [17, 200, 0, 129], cuda)
        want = [paged_mla_decode_attention(*args) for args in (one, two)]
        torch.cuda.synchronize()
        streams = [torch.cuda.Stream(), torch.cuda.Stream()]
        got = []
        for _ in range(3):
            for stream, args in zip(streams, (one, two)):
                with torch.cuda.stream(stream):
                    got.append(paged_mla_decode_attention(*args))
        torch.cuda.synchronize()
        for i, out in enumerate(got):
            assert torch.equal(out, want[i % 2])

    def test_cuda_tensors_launch_or_raise(self, cuda, monkeypatch):
        from repro_torch.kernels import paged_decode_attention as pda

        def refuse(*args, **kwargs):
            raise AssertionError("plain MLA version called on the card")

        monkeypatch.setattr(pda, "paged_mla_decode_attention_plain", refuse)
        q_lat, q_rope, ckv, krope, tables, lens = _mla_inputs(
            43, "float32", [3, 20], cuda)
        _build.reset_launches()
        pda.paged_mla_decode_attention(q_lat, q_rope, ckv, krope, tables,
                                       lens)
        torch.cuda.synchronize()
        assert _build.launches["paged_mla_decode_attention"] == 1
        with pytest.raises(ValueError):  # strided queries are refused
            pda.paged_mla_decode_attention(q_lat.transpose(0, 1), q_rope,
                                           ckv, krope, tables, lens)
        with pytest.raises(ValueError):  # bf16 at widths with no kernel
            pda.paged_mla_decode_attention(
                q_lat[..., :256].contiguous().bfloat16(), q_rope.bfloat16(),
                ckv[..., :256].contiguous().bfloat16(), krope.bfloat16(),
                tables, lens)
        with pytest.raises(TypeError):  # mixed dtypes
            pda.paged_mla_decode_attention(q_lat.half(), q_rope, ckv, krope,
                                           tables, lens)
        assert _build.launches["paged_mla_decode_attention"] == 1

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("b", [1, 4])
    @pytest.mark.parametrize("s", [8, 40, 64, 100, 256])
    def test_flash_value_width(self, cuda, dtype, b, s):
        q, k, v = _inputs(44, dtype, (b, s, MLA_NQ, MLA_QK),
                          (b, s, MLA_NQ, MLA_QK), (b, s, MLA_NQ, MLA_V),
                          device=cuda)
        scale = MLA_QK ** -0.5
        got = flash_attention(q, k, v, scale=scale)
        assert tuple(got.shape) == (b, s, MLA_NQ, MLA_V)
        _close(got, flash_attention_plain(q, k, v, scale=scale), dtype)

    def test_flash_reads_v_through_its_own_strides(self, cuda):
        """Hv == H (the GQA case): v as a strided view of a wider tensor
        gives the result of its contiguous copy bit for bit."""
        q, k, wide = _inputs(45, "bfloat16", (2, 40, 16, 128), (2, 40, 8, 128),
                             (2, 40, 8, 256), device=cuda)
        v = wide[..., 64:192]
        got = flash_attention(q, k, v)
        assert torch.equal(got, flash_attention(q, k, v.contiguous()))
        _close(got, flash_attention_plain(q, k, v), "bfloat16")


@pytest.mark.cuda
def test_mla_engine_on_the_card(cuda, monkeypatch):
    """The MLA path on the card at reduced size: the paged batched engine
    gives unbatched generate's fp32 tokens, leaks no block, and its decode
    runs the MLA kernel in both the paged and the dense path -- the plain
    version is never called."""
    import dataclasses
    import threading

    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServeEngine, StreamSpec

    def refuse(*args, **kwargs):
        raise AssertionError("plain MLA version called on the card")

    monkeypatch.setattr(pda, "paged_mla_decode_attention_plain", refuse)
    cfg = dataclasses.replace(get_config("deepseek_v2_lite_16b").reduced(),
                              dtype="float32")
    params = M.init_params(cfg, generator=torch.Generator(cuda).manual_seed(0),
                           device=cuda)
    prompts = {f"s{i}": (np.arange(1, n + 1, dtype=np.int32)[None] * 7) % 128
               for i, n in enumerate([3, 5, 9, 17])}
    spec = lambda n, p: StreamSpec(name=n, priority=p, period_ms=8000.0,
                                   deadline_ms=8000.0, prefill_ms=50.0,
                                   decode_ms=5.0, decode_steps=6)
    ref = ServeEngine(cfg, params, max_seq=32, device=cuda)
    _build.reset_launches()
    want = {}
    for i, n in enumerate(prompts):
        assert ref.admit(spec(n, 4 - i)).admitted
        want[n] = ref.generate(n, prompts[n], steps=6).tokens
    ref.close()
    assert (_build.launches["paged_mla_decode_attention"]
            == 4 * 6 * cfg.num_layers)
    eng = ServeEngine(cfg, params, max_seq=32, num_servers=2, batching=True,
                      max_batch=4, paged=True, device=cuda)
    try:
        eng.precompile(prompt_buckets=(4, 8, 16, 32))
        _build.reset_launches()
        for i, n in enumerate(prompts):
            assert eng.admit(spec(n, 4 - i)).admitted
        got = {}
        threads = [threading.Thread(
            target=lambda n=n: got.__setitem__(n, eng.generate(
                n, prompts[n], steps=6))) for n in prompts]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert {n: r.tokens for n, r in got.items()} == want
        assert eng.kv_usage() == {"blocks": 0, "slabs": 0, "segments": 0}
        for name in ("rmsnorm", "flash_attention",
                     "paged_mla_decode_attention"):
            assert _build.launches[name] > 0, name
    finally:
        eng.close()


# whisper-medium widths: 16 query and 16 kv heads of 64, 1500 frames
ENC_N, ENC_H, ENC_T = 16, 64, 1500


@pytest.mark.cuda
class TestCudaEncDecKernels:
    """The two kernel shapes of the enc-dec path: full flash attention
    with a key length of its own (the encoder at S = Sk = 1500, the
    cross-attention prefill at S = a prompt bucket against Sk = 1500), and
    decode attention reading each row's segment of a pool through
    ``row_ids``."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("b,s,sk", [(1, 1500, 1500), (1, 1, 1500),
                                        (4, 8, 1500), (1, 40, 1500),
                                        (2, 256, 1500), (3, 24, 20)])
    def test_flash_sk_other_than_s(self, cuda, dtype, b, s, sk):
        q, k, v = _inputs(60, dtype, (b, s, ENC_N, ENC_H),
                          (b, sk, ENC_N, ENC_H), (b, sk, ENC_N, ENC_H),
                          device=cuda)
        got = flash_attention(q, k, v, causal=False)
        assert tuple(got.shape) == (b, s, ENC_N, ENC_H)
        _close(got, flash_attention_plain(q, k, v, causal=False), dtype)

    def test_flash_refuses_sk_when_causal(self, cuda):
        q, k = _inputs(61, "bfloat16", (1, 8, ENC_N, ENC_H),
                       (1, 16, ENC_N, ENC_H), device=cuda)
        before = _build.launches["flash_attention"]
        with pytest.raises(ValueError, match="Sk = S when causal"):
            flash_attention(q, k, k, causal=True)
        assert _build.launches["flash_attention"] == before

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_decode_row_ids_equal_dense_on_the_gathered_copy(self, cuda,
                                                             dtype):
        """Rows on permuted, repeated segments of a noisy (6, 1500, ...)
        pool at the full length (94 tiles of 16, the last ragged) and at
        ragged lengths: bit-identical to dense decode of the gathered
        copy, and within tolerance of the plain version."""
        q, kp, vp = _inputs(62, dtype, (4, ENC_N, ENC_H),
                            (6, ENC_T, ENC_N, ENC_H), (6, ENC_T, ENC_N, ENC_H),
                            device=cuda)
        ids = torch.tensor([5, 2, 5, 0], dtype=torch.int32, device=cuda)
        for lengths in ([ENC_T] * 4, [ENC_T, 1, 33, 1489]):
            lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
            got = decode_attention(q, kp, vp, lens, row_ids=ids)
            dense = decode_attention(q, kp[ids.long()], vp[ids.long()], lens)
            torch.cuda.synchronize()
            assert torch.equal(got, dense), lengths
            _close(got, decode_attention_plain(q, kp, vp, lens, row_ids=ids),
                   dtype)


@pytest.mark.cuda
def test_encdec_engine_on_the_card(cuda, monkeypatch):
    """The enc-dec path on the card at reduced size (20 frames, group size
    1): the batched engine, staging decoder KV block pools and one shared
    cross segment in each decode call, gives unbatched generate's fp32
    tokens, leaks no block or segment, and runs the attention kernels --
    the plain versions are never called."""
    import dataclasses
    import threading

    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     paged_decode_attention)
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServeEngine, StreamSpec

    def refuse(*args, **kwargs):
        raise AssertionError("plain version called on the card")

    for mod, name in ((flash_attention, "flash_attention_plain"),
                      (decode_attention, "decode_attention_plain"),
                      (paged_decode_attention, "paged_decode_attention_plain")):
        monkeypatch.setattr(mod, name, refuse)
    cfg = dataclasses.replace(get_config("whisper_medium").reduced(),
                              dtype="float32", encoder_seq=20, num_kv_heads=4)
    params = M.init_params(cfg, generator=torch.Generator(cuda).manual_seed(0),
                           device=cuda)
    prompts = {f"s{i}": (np.arange(1, n + 1, dtype=np.int32)[None] * 7) % 128
               for i, n in enumerate([3, 5, 9, 17])}
    spec = lambda n, p: StreamSpec(name=n, priority=p, period_ms=8000.0,
                                   deadline_ms=8000.0, prefill_ms=50.0,
                                   decode_ms=5.0, decode_steps=6)
    ref = ServeEngine(cfg, params, max_seq=32, device=cuda)
    _build.reset_launches()
    want = {}
    for i, n in enumerate(prompts):
        assert ref.admit(spec(n, 4 - i)).admitted
        want[n] = ref.generate(n, prompts[n], steps=6).tokens
    ref.close()
    # self and cross attention of every decoder layer, every step
    assert _build.launches["decode_attention"] == 4 * 6 * 2 * cfg.num_layers
    eng = ServeEngine(cfg, params, max_seq=32, num_servers=2, batching=True,
                      max_batch=4, paged=True, kv_block_size=8, device=cuda)
    try:
        eng.precompile(prompt_buckets=(4, 8, 16, 32))
        _build.reset_launches()
        for i, n in enumerate(prompts):
            assert eng.admit(spec(n, 4 - i)).admitted
        got = {}
        threads = [threading.Thread(
            target=lambda n=n: got.__setitem__(n, eng.generate(
                n, prompts[n], steps=6))) for n in prompts]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert {n: r.tokens for n, r in got.items()} == want
        assert eng.kv_usage() == {"blocks": 0, "slabs": 0, "segments": 0}
        kinds = {m["kind"] for s in eng.pool.servers for m in s.stats.batch_meta}
        assert kinds == {"prefill@encdec", "decode@encdec"}
        for name in ("rmsnorm", "flash_attention", "decode_attention",
                     "paged_decode_attention"):
            assert _build.launches[name] > 0, name
    finally:
        eng.close()


GRAPH_FAMILIES = ["internlm2_1_8b", "deepseek_v2_lite_16b", "mamba2_780m",
                  "zamba2_7b", "whisper_medium", "qwen2_vl_2b"]


def _graph_engine(arch, device, **kw):
    """A one-server paged engine at reduced size in fp32, its cells warmed
    and captured for prefill bucket 8."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServeEngine

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    params = M.init_params(cfg, generator=torch.Generator(device).manual_seed(0),
                           device=device)
    eng = ServeEngine(cfg, params, max_seq=32, batching=True, max_batch=2,
                      paged=True, kv_block_size=8, device=device, **kw)
    return eng, eng.precompile(prompt_buckets=(8,))


def _decode_pack(state, rows, w):
    """A decode cell's staged rows: tokens, lengths 5 and 9 (and on), slabs
    1.., one shared segment 1, each row's own blocks 1.. in its table."""
    import numpy as np

    pack = np.zeros((rows, 4 + w), np.int32)
    pack[:, 0] = np.arange(rows) * 5 + 3
    pack[:, 1] = np.arange(rows) * 4 + 5
    pack[:, 2] = np.arange(rows) + 1
    pack[:, 3] = 1
    if w:
        pack[:, 4:] = 1 + np.arange(rows * w).reshape(rows, w)
    return pack


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.cuda
class TestCudaGraphCells:
    """Each warm cell as a CUDA graph (``serving/graphs.py``), at reduced
    size in fp32 for every family: a replay gives its eager run's bits and
    launches the same kernels, a prefill cell's outputs survive a second
    replay of the cell, and a second ``precompile`` captures nothing."""

    @pytest.mark.parametrize("arch", GRAPH_FAMILIES)
    def test_replay_equals_the_eager_call(self, cuda, arch):
        import numpy as np

        eng, rep = _graph_engine(arch, cuda)
        try:
            state = eng._paged[0]
            # a migration width is two graphs: its gather and its scatter
            assert rep.captured == len(state.graphs) == (
                rep.compiled + len(rep.migrate_cells)) > 0
            rows, w = max(rep.decode_cells)
            cell = state.graphs[("decode", rows, w)]
            pack = _decode_pack(state, rows, w)

            # both start from the same pools: the step writes each row's
            # new KV in place, and an SSM step advances its slab's state
            pools = _leaves(state.pools)
            saved = [t.clone() for t in pools]

            def restore():
                for t, s in zip(pools, saved):
                    t.copy_(s)

            def eager_decode():
                restore()
                return eng._decode_paged_impl(eng._tensor(pack),
                                              state.pools).clone()

            def replay_decode():
                restore()
                return cell.replay(pack).clone()

            _build.reset_launches()
            want = eng._on_device(0, eager_decode)
            eager_launches = dict(_build.launches)
            _build.reset_launches()
            got = eng._on_device(0, replay_decode)
            assert torch.equal(got, want)
            assert dict(_build.launches) == eager_launches == dict(
                cell.launches)

            toks = np.random.default_rng(0).integers(
                0, 128, (rows, 8)).astype(np.int32)
            lens = np.array([8, 5][:rows], np.int32)
            cell = state.graphs[("prefill", rows, 8)]
            _build.reset_launches()
            want = eng._on_device(0, lambda: eng._prefill_batch_impl(
                eng._tensor(toks), eng._tensor(lens)))
            eager_launches = dict(_build.launches)
            _build.reset_launches()
            got = eng._on_device(0, lambda: cell.replay(toks, lens))
            for g, e in zip(_leaves(got), _leaves(want), strict=True):
                assert torch.equal(g, e)
            assert dict(_build.launches) == eager_launches == dict(
                cell.launches)
        finally:
            eng.close()

    @pytest.mark.parametrize("arch", GRAPH_FAMILIES)
    def test_prefill_outputs_survive_the_next_replay(self, cuda, arch):
        """Two coalesced prefills of one cell, then another of the same
        cell, and only then the inserts: the first call's cache was copied
        out of the graph's static outputs, which the second replay
        rewrote."""
        import numpy as np

        eng, _ = _graph_engine(arch, cuda)
        try:
            state = eng._paged[0]
            cell = state.graphs[("prefill", 2, 8)]
            run = eng._run_prefill_batch(0, 8)
            rng = np.random.default_rng(1)
            first = [(rng.integers(0, 128, n).astype(np.int32), n)
                     for n in (8, 5)]
            second = [(rng.integers(0, 128, n).astype(np.int32), n)
                      for n in (7, 3)]
            got = run(first)
            run(second)
            toks = np.zeros((2, 8), np.int32)
            for i, (p, n) in enumerate(first):
                toks[i, :n] = p
            lens = np.array([8, 5], np.int32)
            rows, cache = eng._on_device(0, lambda: eng._prefill_batch_impl(
                eng._tensor(toks), eng._tensor(lens)))
            for i in range(2):
                assert np.array_equal(got[i][0], rows[i].cpu().numpy())
            kept = got[0][1]
            for g, e, s in zip(_leaves(kept), _leaves(cache),
                               _leaves(cell.outputs[1]), strict=True):
                assert torch.equal(g, e)
            # the graph's own outputs now hold the second call's cache
            assert not all(torch.equal(e, s) for e, s in zip(
                _leaves(cache), _leaves(cell.outputs[1])))
            for i in range(2):  # the inserts, last
                eng._insert_slot_paged(0, kept, i, np.full(
                    (state.nb_max,), state.scratch_block, np.int32),
                    state.scratch_slab, state.scratch_seg)
            assert all(m["graphed"] for s in eng.pool.servers
                       for m in s.stats.batch_meta)
        finally:
            eng.close()

    def test_second_precompile_captures_nothing(self, cuda):
        eng, rep = _graph_engine("internlm2_1_8b", cuda)
        try:
            graphs = dict(eng._paged[0].graphs)
            again = eng.precompile(prompt_buckets=(8,))
            assert again.compiled == again.captured == 0
            assert again.skipped == rep.compiled
            assert eng._paged[0].graphs == graphs
        finally:
            eng.close()


@pytest.mark.cuda
def test_vlm_engine_on_the_card(cuda):
    """qwen2-vl at reduced size on the card: the graphed batched engine
    gives unbatched generate's fp32 tokens, every device call of the
    traffic replays a graph, nothing leaks, and the kernels' launches over
    the traffic are the replayed cells' captured counts."""
    import threading
    from collections import Counter

    import numpy as np

    from repro_torch.serving.engine import ServeEngine, StreamSpec

    eng, _ = _graph_engine("qwen2_vl_2b", cuda)
    cfg, params = eng.cfg, eng.params
    eng.close()
    prompts = {f"v{i}": (np.arange(1, n + 1, dtype=np.int32)[None] * 5) % 128
               for i, n in enumerate([3, 5, 9, 17])}
    spec = lambda n, p: StreamSpec(name=n, priority=p, period_ms=8000.0,
                                   deadline_ms=8000.0, prefill_ms=50.0,
                                   decode_ms=5.0, decode_steps=6)
    ref = ServeEngine(cfg, params, max_seq=32, device=cuda)
    want = {}
    for i, n in enumerate(prompts):
        assert ref.admit(spec(n, 4 - i)).admitted
        want[n] = ref.generate(n, prompts[n], steps=6).tokens
    ref.close()
    eng = ServeEngine(cfg, params, max_seq=32, num_servers=2, batching=True,
                      max_batch=4, paged=True, kv_block_size=8, device=cuda)
    try:
        eng.precompile(prompt_buckets=(4, 8, 16, 32))
        _build.reset_launches()
        for i, n in enumerate(prompts):
            assert eng.admit(spec(n, 4 - i)).admitted
        got = {}
        threads = [threading.Thread(
            target=lambda n=n: got.__setitem__(n, eng.generate(
                n, prompts[n], steps=6))) for n in prompts]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert {n: r.tokens for n, r in got.items()} == want
        assert eng.kv_usage() == {"blocks": 0, "slabs": 0, "segments": 0}
        expected = Counter()
        for si, server in enumerate(eng.pool.servers):
            for m in server.stats.batch_meta:
                assert m["graphed"] and not m["cold"], m
                key = (m["kind"], m["padded"], m.get("width", m.get("bucket")))
                expected.update(eng._paged[si].graphs[key].launches)
        assert Counter(_build.launches) == expected
        assert expected["paged_decode_attention"] > 0
    finally:
        eng.close()


def _a10_streams(eng, prompts, steps, during=None):
    import threading

    from repro_torch.serving.engine import StreamSpec

    for i, n in enumerate(prompts):
        assert eng.admit(StreamSpec(
            name=n, priority=len(prompts) - i, period_ms=8000.0,
            deadline_ms=8000.0, prefill_ms=50.0, decode_ms=5.0,
            decode_steps=steps)).admitted
    got = {}
    threads = [threading.Thread(target=lambda n=n: got.__setitem__(
        n, eng.generate(n, prompts[n], steps=steps).tokens))
        for n in prompts]
    for t in threads:
        t.start()
    if during is not None:
        during()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    return got


@pytest.mark.cuda
class TestCudaEngineA10:
    """Recovery, migration, elasticity and the masked-dense layout on the
    card at reduced size in fp32, every warm cell a graph: tokens equal
    unbatched ``generate``'s and every call of the traffic replays."""

    STEPS = 6

    def _setup(self, arch, cuda):
        import numpy as np

        from repro_torch.serving.engine import ServeEngine

        eng, _ = _graph_engine(arch, cuda)
        cfg, params = eng.cfg, eng.params
        eng.close()
        prompts = {f"a{i}": (np.arange(1, n + 1, dtype=np.int32)[None] * 3)
                   % 128 for i, n in enumerate([3, 6, 9, 13])}
        ref = ServeEngine(cfg, params, max_seq=32, device=cuda)
        want = {n: _a10_streams(ref, {n: p}, self.STEPS)[n]
                for n, p in prompts.items()}
        ref.close()
        return cfg, params, prompts, want

    @pytest.mark.parametrize("arch", GRAPH_FAMILIES)
    def test_masked_dense_replays_and_keeps_inactive_rows(self, cuda, arch):
        from repro_torch.serving.engine import ServeEngine, _cache_leaves

        cfg, params, prompts, want = self._setup(arch, cuda)
        eng = ServeEngine(cfg, params, max_seq=32, num_servers=1,
                          batching=True, max_batch=6, paged=False,
                          kv_block_size=8, device=cuda)
        try:
            rep = eng.precompile(prompt_buckets=(4, 8, 16))
            assert rep.captured == rep.compiled
            cache = eng._slots[0].cache
            rows = [leaf.select(ax, 0).clone() for leaf, (ax, _, _) in
                    zip(_cache_leaves(cache), eng._batch_axes)]
            assert _a10_streams(eng, prompts, self.STEPS) == want
            meta = eng.pool.servers[0].stats.batch_meta
            assert meta and all(m["graphed"] for m in meta)
            # slot 0 (precompile's scratch row) was never acquired
            for leaf, (ax, _, _), row in zip(_cache_leaves(cache),
                                             eng._batch_axes, rows):
                assert torch.equal(leaf.select(ax, 0), row)
        finally:
            eng.close()

    @pytest.mark.parametrize("arch", GRAPH_FAMILIES)
    def test_migration_and_added_server_replay(self, cuda, arch):
        from repro_torch.serving.engine import ServeEngine

        cfg, params, prompts, want = self._setup(arch, cuda)
        eng = ServeEngine(cfg, params, max_seq=32, num_servers=2,
                          batching=True, max_batch=4, paged=True,
                          kv_block_size=8, device=cuda)
        try:
            eng.precompile(prompt_buckets=(4, 8, 16))
            si = eng.add_server()
            assert len(eng._paged[si].graphs) == len(eng._paged[0].graphs)

            def move():
                mover = next(iter(prompts))
                src = eng.pool.server_of(mover)
                dst = si if src != si else 0
                assert eng.admission.migrate(mover, dst)[1] == dst
                assert eng.pool.request_migration(mover, dst)

            assert _a10_streams(eng, prompts, self.STEPS, during=move) == want
            assert eng.migrations_completed == 1
            meta = [m for s in eng.pool.servers for m in s.stats.batch_meta]
            assert all(m["graphed"] for m in meta)
            assert sum(m["kind"].startswith("migrate") for m in meta) == 2
            assert eng.kv_usage() == {"blocks": 0, "slabs": 0, "segments": 0}
        finally:
            eng.close()

    def test_recovery_replays_on_the_survivor(self, cuda):
        from repro_torch.runtime.faultinject import FaultInjector, ServerFault
        from repro_torch.serving.engine import ServeEngine

        cfg, params, prompts, want = self._setup("internlm2_1_8b", cuda)
        eng = ServeEngine(cfg, params, max_seq=32, num_servers=2,
                          batching=True, max_batch=4, paged=True,
                          kv_block_size=8, device=cuda)
        try:
            eng.precompile(prompt_buckets=(4, 8, 16, 32))
            eng.enable_fault_tolerance(heartbeat_timeout_s=30.0)
            eng.pool.attach_fault_injector(FaultInjector(
                [ServerFault(server=0, at_call=6, kind="die")]))
            assert _a10_streams(eng, prompts, self.STEPS) == want
            assert len(eng.degraded_reports) == 1
            assert all(m["graphed"] for m in
                       eng.pool.servers[1].stats.batch_meta)
            assert eng.kv_usage() == {"blocks": 0, "slabs": 0, "segments": 0}
        finally:
            eng.close()


def _close_to_max(got, want, tol):
    """max |got - want| within ``tol`` of max |want| (the backward's
    tolerances are stated against the reference gradient's scale)."""
    got, want = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= tol * max(want.abs().max().item(), 1e-30), (err, tol)


# deepseek-v2-lite-16b's routed experts: 64 of D 2048, F 1408, top 6
MOE_ARCH = "deepseek_v2_lite_16b"


def _moe_layer(dtype, device, seed=0, cfg=None):
    """One MoE layer's weights at ``cfg``'s widths (default: deepseek's)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe as MOE

    cfg = cfg or get_config(MOE_ARCH)
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg, MOE.init_moe(cfg, gen, getattr(torch, dtype), device)


def _routing(cfg, rows, dtype, device, seed):
    """x (rows, D) and a top-k routing of distinct experts a row, with
    weights that sum to 1, drawn from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((rows, cfg.d_model), generator=gen, device=device)
    logits = torch.randn((rows, cfg.num_experts), generator=gen,
                         device=device)
    top, idx = torch.topk(logits, cfg.num_experts_per_tok, dim=-1)
    weights = torch.softmax(top, dim=-1)
    dt = getattr(torch, dtype)
    return x.to(dt), idx, weights.to(dt)


def _experts(p):
    ex = p["experts"]
    return ex["w_gate"], ex["w_up"], ex["w_down"]


@pytest.mark.cuda
class TestCudaMoERoutedExperts:
    """``moe_routed_experts`` (``csrc/moe_routed_experts.cu``) against its
    plain version at deepseek-v2-lite-16b's widths: 1-16 rows, each row's
    bits alone equal to its bits among 15 others, replays of a captured
    graph under new routings, the counter, and the engine's decode path."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("rows", [1, 2, 8, 15, 16])
    def test_kernel_against_plain(self, cuda, dtype, rows):
        from repro_torch.kernels import moe_experts as ME

        cfg, p = _moe_layer(dtype, cuda)
        x, idx, w = _routing(cfg, rows, dtype, cuda, seed=rows)
        assert ME.moe_experts_route(x, *_experts(p)) == (
            "tensor_cores" if dtype == "bfloat16" else "scalar")
        _build.reset_launches()
        got = ME.moe_routed_experts(x, idx, w, *_experts(p))
        assert _build.launches["moe_routed_experts"] == 1
        _close(got, ME.moe_routed_experts_plain(x, idx, w, *_experts(p)),
               dtype)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_scalar_route_at_reduced_widths(self, cuda, dtype):
        import dataclasses

        from repro_torch.configs.registry import get_config
        from repro_torch.kernels import moe_experts as ME

        cfg, p = _moe_layer(dtype, cuda, cfg=dataclasses.replace(
            get_config(MOE_ARCH).reduced(), dtype=dtype))
        x, idx, w = _routing(cfg, 5, dtype, cuda, seed=3)
        assert ME.moe_experts_route(x, *_experts(p)) == "scalar"
        _close(ME.moe_routed_experts(x, idx, w, *_experts(p)),
               ME.moe_routed_experts_plain(x, idx, w, *_experts(p)), dtype)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_a_row_alone_equals_the_row_among_others(self, cuda, dtype):
        from repro_torch.kernels import moe_experts as ME

        cfg, p = _moe_layer(dtype, cuda)
        x, idx, w = _routing(cfg, 16, dtype, cuda, seed=7)
        x[5], idx[5], w[5] = x[2], idx[2], w[2]  # two rows share everything
        both = ME.moe_routed_experts(x, idx, w, *_experts(p))
        for i in range(16):
            alone = ME.moe_routed_experts(x[i:i + 1], idx[i:i + 1],
                                          w[i:i + 1], *_experts(p))
            assert torch.equal(alone[0], both[i]), i
        assert torch.equal(both[5], both[2])

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_graph_replays_follow_new_routing(self, cuda, dtype):
        from repro_torch.kernels import moe_experts as ME

        cfg, p = _moe_layer(dtype, cuda)
        static = _routing(cfg, 8, dtype, cuda, seed=11)
        ME.moe_routed_experts(*static, *_experts(p))  # warm, eagerly
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = ME.moe_routed_experts(*static, *_experts(p))
        counter = ME.experts_counter(cuda)
        for seed in (12, 13):
            new = _routing(cfg, 8, dtype, cuda, seed=seed)
            for dst, src in zip(static, new):
                dst.copy_(src)
            before = counter.clone()
            graph.replay()
            torch.cuda.synchronize()
            assert (counter - before).tolist() == [
                len(torch.unique(new[1])), cfg.num_experts]
            assert torch.equal(out, ME.moe_routed_experts(*new, *_experts(p)))

    @pytest.mark.parametrize("rows", [1, 6, 16])
    def test_counter_counts_the_distinct_experts(self, cuda, rows):
        from repro_torch.kernels import moe_experts as ME

        cfg, p = _moe_layer("bfloat16", cuda)
        x, idx, w = _routing(cfg, rows, "bfloat16", cuda, seed=20 + rows)
        idx[-1] = idx[0]  # a padding row: row 0's experts again
        ME.moe_routed_experts(x, idx, w, *_experts(p))
        counter = ME.experts_counter(cuda)
        before = counter.clone()
        ME.moe_routed_experts(x, idx, w, *_experts(p))
        torch.cuda.synchronize()
        assert (counter - before).tolist() == [len(torch.unique(idx)),
                                               cfg.num_experts]

    def test_refusals_come_before_any_launch(self, cuda):
        from repro_torch.kernels import moe_experts as ME

        cfg, p = _moe_layer("bfloat16", cuda)
        x, idx, w = _routing(cfg, 4, "bfloat16", cuda, seed=1)
        _build.reset_launches()
        with pytest.raises(ValueError, match="int64"):
            ME.moe_routed_experts(x, idx.int(), w, *_experts(p))
        with pytest.raises(TypeError):
            ME.moe_routed_experts(x.float(), idx, w, *_experts(p))
        big = ME.MAX_SLOTS // cfg.num_experts_per_tok + 1
        xb, ib, wb = _routing(cfg, big, "bfloat16", cuda, seed=2)
        with pytest.raises(ValueError, match="slots"):
            ME.moe_routed_experts(xb, ib, wb, *_experts(p))
        assert _build.launches["moe_routed_experts"] == 0

    def test_engine_decode_runs_the_routed_experts(self, cuda, monkeypatch):
        """deepseek reduced, fp32: unbatched generate launches the kernel
        once a MoE layer a decode step (prefill stays dense) and never its
        plain version, and the paged batched engine's graphed decode gives
        the same tokens through it."""
        import dataclasses
        import threading

        import numpy as np

        from repro_torch.configs.registry import get_config
        from repro_torch.kernels import moe_experts as ME
        from repro_torch.models import model as M
        from repro_torch.serving.engine import ServeEngine, StreamSpec

        def refuse(*args, **kwargs):
            raise AssertionError("plain routed experts called on the card")

        monkeypatch.setattr(ME, "moe_routed_experts_plain", refuse)
        cfg = dataclasses.replace(get_config(MOE_ARCH).reduced(),
                                  dtype="float32")
        params = M.init_params(cfg, generator=torch.Generator(cuda)
                               .manual_seed(0), device=cuda)
        prompts = {f"s{i}": (np.arange(1, n + 1, dtype=np.int32)[None] * 7)
                   % 128 for i, n in enumerate([3, 5, 9, 17])}
        spec = lambda n, p: StreamSpec(name=n, priority=p, period_ms=8000.0,
                                       deadline_ms=8000.0, prefill_ms=50.0,
                                       decode_ms=5.0, decode_steps=6)
        moe_layers = cfg.num_layers - cfg.first_dense_layers
        ref = ServeEngine(cfg, params, max_seq=32, device=cuda)
        want = {}
        try:
            _build.reset_launches()
            for i, n in enumerate(prompts):
                assert ref.admit(spec(n, 4 - i)).admitted
                want[n] = ref.generate(n, prompts[n], steps=6).tokens
            assert (_build.launches["moe_routed_experts"]
                    == 4 * 6 * moe_layers)
        finally:
            ref.close()
        eng = ServeEngine(cfg, params, max_seq=32, num_servers=2,
                          batching=True, max_batch=4, paged=True, device=cuda)
        try:
            eng.precompile(prompt_buckets=(4, 8, 16, 32))
            _build.reset_launches()
            eng.set_tracing(True)
            got = {}
            for i, n in enumerate(prompts):
                assert eng.admit(spec(n, 4 - i)).admitted
            threads = [threading.Thread(
                target=lambda n=n: got.__setitem__(n, eng.generate(
                    n, prompts[n], steps=6))) for n in prompts]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            eng.set_tracing(False)
            assert {n: r.tokens for n, r in got.items()} == want
            assert _build.launches["moe_routed_experts"] > 0
            read, possible = eng.experts_read()
            assert possible == _build.launches["moe_routed_experts"] * \
                cfg.num_experts
            assert 0 < read <= possible
        finally:
            eng.close()


@pytest.mark.cuda
class TestCudaGranite:
    """granite-4.0-h-small's widths: the routed experts at E 72, K 10,
    D 4096, F 768; the slab step at 128 heads of P 64, N 128; and one
    layer of each kind of its stack, where paged decode (block pools and
    slab pools) gives dense decode's logits."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("rows", [1, 8, 16])
    def test_routed_experts_against_plain(self, cuda, dtype, rows):
        from repro_torch.configs.granite_4_0_h_small import CONFIG
        from repro_torch.kernels import moe_experts as ME

        cfg, p = _moe_layer(dtype, cuda, cfg=CONFIG)
        x, idx, w = _routing(cfg, rows, dtype, cuda, seed=40 + rows)
        assert ME.moe_experts_route(x, *_experts(p)) == (
            "tensor_cores" if dtype == "bfloat16" else "scalar")
        counter = ME.experts_counter(cuda)
        before = counter.clone()
        got = ME.moe_routed_experts(x, idx, w, *_experts(p))
        torch.cuda.synchronize()
        assert (counter - before).tolist() == [len(torch.unique(idx)), 72]
        _close(got, ME.moe_routed_experts_plain(x, idx, w, *_experts(p)),
               dtype)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("slabs", [[7], [9, 3, 3, 1]])
    def test_ssd_slab_decode(self, cuda, dtype, slabs):
        h, p, n = 128, 64, 128
        gen = torch.Generator().manual_seed(41)
        rows = len(slabs)
        pool = torch.randn((10, h, p, n), generator=gen).to(cuda)
        xbc = torch.randn((rows, h * p + 2 * n), generator=gen).to(
            getattr(torch, dtype)).to(cuda)
        dt = torch.nn.functional.softplus(
            torch.randn((rows, h), generator=gen)).to(cuda)
        for row in range(1, rows):  # a repeated id repeats its row
            if slabs[row] in slabs[:row]:
                first = slabs.index(slabs[row])
                xbc[row], dt[row] = xbc[first], dt[first]
        x = xbc[:, :h * p].view(rows, h, p)
        b = xbc[:, h * p:h * p + n].view(rows, 1, n)
        c = xbc[:, h * p + n:].view(rows, 1, n)
        a = -torch.linspace(1.0, 16.0, h, device=cuda)
        ids = torch.tensor(slabs, dtype=torch.int32, device=cuda)
        y, states = ssd_slab_decode(pool, ids, x, dt, a, b, c)
        y_want, s_want = ssd_slab_decode_plain(pool, ids, x, dt, a, b, c)
        _close(y, y_want, dtype)
        _close(states, s_want, "float32")

    def test_paged_decode_gives_dense_decode(self, cuda):
        """One Mamba-2 layer and one attention layer, each with its MoE
        block, at full width in bf16: a padded prefill of three rows, then
        four decode steps dense and paged (permuted blocks and slabs).
        The slab states are the dense states bit for bit (one kernel, slab
        ids against 0..B-1); the logits agree to bf16's rounding, scaled
        to their size (the two decode attention kernels split the KV
        sweep on their own block sizes)."""
        import dataclasses

        from repro_torch.configs.granite_4_0_h_small import CONFIG
        from repro_torch.models import model as M

        cfg = dataclasses.replace(CONFIG, num_layers=2,
                                  layer_types=("mamba", "attention"),
                                  tie_embeddings=False)
        gen = torch.Generator(cuda).manual_seed(0)
        params = M.init_params(cfg, generator=gen, device=cuda)
        m = params["layers"]["mamba"]["mamba"]
        m["dt_bias"].copy_(torch.rand(m["dt_bias"].shape, generator=gen,
                                      device=cuda) - 4.0)
        tok = torch.Generator(cuda).manual_seed(1)
        toks = torch.randint(0, cfg.vocab_size, (3, 48), generator=tok,
                             device=cuda)
        lengths = torch.tensor([5, 48, 30], dtype=torch.int32, device=cuda)
        bs, max_seq = 16, 64
        with torch.inference_mode():
            _, dense, _ = M.apply(cfg, params, {
                "tokens": toks, "lengths": lengths, "max_seq": max_seq},
                mode="prefill")
            pools = M.init_paged_cache(cfg, 20, bs, num_slabs=7, device=cuda)
            blocks = torch.randperm(20, generator=tok, device=cuda)[:12]
            tables = blocks.view(3, 4).to(torch.int32)
            slabs = torch.tensor([4, 0, 6], dtype=torch.int32, device=cuda)
            for r in range(3):
                for pool, leaf in zip(pools["attn"], dense["attn"]):
                    pool[:, tables[r].long()] = leaf[:, r].reshape(
                        1, 4, bs, *leaf.shape[3:])
                for pool, leaf in zip(pools["mamba"], dense["mamba"]):
                    pool[:, slabs[r].long()] = leaf[:, r]
            for step in range(4):
                nxt = torch.randint(0, cfg.vocab_size, (3, 1), generator=tok,
                                    device=cuda)
                pos = dense["pos"]
                want, dense, _ = M.apply(cfg, params, {"tokens": nxt},
                                         mode="decode", cache=dense)
                got, _, _ = M.apply(cfg, params, {"tokens": nxt},
                                    mode="decode", cache={
                                        **pools, "pos": pos,
                                        "block_tables": tables,
                                        "slab_ids": slabs})
                scale = float(want.abs().max())
                torch.testing.assert_close(got, want, rtol=2e-2,
                                           atol=2e-2 * scale)
            assert torch.equal(pools["mamba"][1][0, slabs.long()],
                               dense["mamba"][1][0])


BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.mark.cuda
class TestCudaBackwardKernels:
    """The backward kernels of flash_attention (every training shape),
    rmsnorm and ssd_intra, and the forward's lse, against their plain
    versions on the card; the autograd Functions end to end; what the
    serving path launches."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("b,s", [(2, 100), (1, 128), (1, 64), (2, 8)])
    def test_forward_lse(self, cuda, dtype, b, s):
        """The lse (fp32 in both dtypes) within 1e-3 absolute, natural-log
        units; (2, 100) and (1, 128) take the bf16 kernel's 8-warp
        configuration, whose warp pairs merge their states."""
        from repro_torch.kernels.flash_attention import _flash_forward

        q, k, v = _inputs(40, dtype, (b, s, 16, 128), (b, s, 8, 128),
                          (b, s, 8, 128), device=cuda)
        out, lse = _flash_forward(q, k, v, True, 128 ** -0.5, with_lse=True)
        want, want_lse = flash_attention_plain(q, k, v, with_lse=True)
        _close(out, want, dtype)
        assert lse.dtype == torch.float32
        assert (lse - want_lse).abs().max().item() <= 1e-3

    @pytest.mark.parametrize("dtype,h", [
        ("float32", 16), ("float32", 32), ("float32", 128),
        ("bfloat16", 128)])  # the instantiated widths
    @pytest.mark.parametrize("b,s", [(2, 100), (1, 128), (1, 64), (2, 8)])
    def test_flash_backward(self, cuda, dtype, b, s, h):
        from repro_torch.kernels.flash_attention import (
            flash_attention_bwd, flash_attention_bwd_plain)

        nq, nkv = (16, 8) if h == 128 else (4, 2)
        q, k, v, do = _inputs(41, dtype, (b, s, nq, h), (b, s, nkv, h),
                              (b, s, nkv, h), (b, s, nq, h), device=cuda)
        o, lse = flash_attention_plain(q, k, v, with_lse=True)
        got = flash_attention_bwd(q, k, v, o, lse, do)
        want = flash_attention_bwd_plain(q, k, v, o, lse, do)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            _close_to_max(g, w, BWD_TOL[dtype])
        again = flash_attention_bwd(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        assert all(torch.equal(a, g) for a, g in zip(again, got))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("rows,d", [(64, 2048), (5, 3584), (5, 1032),
                                        (5, 100), (5, 37)] + [
        (rows, d) for d in (512, 1024, 1536, 2048, 3072, 3584, 7168)
        for rows in (1, 5, 4096, 6000) if (rows, d) != (5, 3584)])
    def test_rmsnorm_backward(self, cuda, dtype, rows, d):
        """Every training width at 1 row, 5 (a partial warp's worth of
        rows), 4096 and 6000, and the loops' widths; a rerun
        bit-identical."""
        from repro_torch.kernels.rmsnorm import rmsnorm_bwd, rmsnorm_bwd_plain

        x, w, dy = _inputs(42, dtype, (rows, d), (d,), (rows, d), device=cuda)
        x = x * 3.0
        got = rmsnorm_bwd(x, w, dy, 1e-5)
        want = rmsnorm_bwd_plain(x, w, dy, 1e-5)
        for g, ref in zip(got, want):
            assert g.dtype == ref.dtype and g.shape == ref.shape
            _close_to_max(g, ref, BWD_TOL[dtype])
        again = rmsnorm_bwd(x, w, dy, 1e-5)
        torch.cuda.synchronize()
        assert all(torch.equal(a, g) for a, g in zip(again, got))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("b,s", [(2, 40), (1, 128)])
    def test_functions_end_to_end(self, cuda, dtype, b, s):
        """(1, 128) takes the bf16 forward's 8-warp configuration, so the
        backward recomputes P from its merged lse."""
        from repro_torch.kernels.flash_attention import (
            flash_attention_bwd_plain)
        from repro_torch.kernels.rmsnorm import rmsnorm_bwd_plain

        q, k, v, do = _inputs(43, dtype, (b, s, 16, 128), (b, s, 8, 128),
                              (b, s, 8, 128), (b, s, 16, 128), device=cuda)
        x, w, dy = _inputs(44, dtype, (2, 40, 2048), (2048,), (2, 40, 2048),
                           device=cuda)
        for t in (q, k, v, x, w):
            t.requires_grad_(True)
        before = dict(_build.launches)
        out = flash_attention(q, k, v)
        out.backward(do)
        y = rmsnorm(x, w, 1e-5)
        y.backward(dy)
        for name in ("flash_attention", "flash_attention_bwd", "rmsnorm",
                     "rmsnorm_bwd"):
            assert _build.launches[name] == before.get(name, 0) + 1, name
        o, lse = flash_attention_plain(q.detach(), k.detach(), v.detach(),
                                       with_lse=True)
        want = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                         o, lse, do)
        for t, ref in zip((q, k, v), want):
            _close_to_max(t.grad, ref, BWD_TOL[dtype])
        for t, ref in zip((x, w), rmsnorm_bwd_plain(x.detach(), w.detach(),
                                                    dy, 1e-5)):
            _close_to_max(t.grad, ref, BWD_TOL[dtype])

    def test_serving_calls_launch_the_forward_alone(self, cuda, monkeypatch):
        """Under inference_mode (the engine) and no_grad, flash_attention and
        rmsnorm launch what they launched before: no lse, no Function."""
        calls = []
        launch = _build.launch

        def record(name, entry, *args):
            calls.append((name, args))
            launch(name, entry, *args)

        monkeypatch.setattr(_build, "launch", record)
        q, k, v = _inputs(45, "bfloat16", (1, 64, 16, 128), (1, 64, 8, 128),
                          (1, 64, 8, 128), device=cuda)
        x, w = _inputs(46, "bfloat16", (4, 2048), (2048,), device=cuda)
        for t in (q, k, v, x, w):
            t.requires_grad_(True)
        for ctx in (torch.inference_mode, torch.no_grad):
            calls.clear()
            with ctx():
                out = flash_attention(q, k, v)
                y = rmsnorm(x, w, 1e-5)
            assert out.grad_fn is None and y.grad_fn is None
            assert [c[0] for c in calls] == ["flash_attention", "rmsnorm"]
            assert calls[0][1][4] is None  # no lse pointer

    def test_refusals_come_before_any_launch(self, cuda):
        """What the backward kernel does not take -- a width with no
        instantiation (48), bf16 at a pair only fp32 has (16) -- raises
        under grad before the forward launches."""
        from repro_torch.kernels.flash_attention import FlashAttentionFunction

        before = dict(_build.launches)
        q = torch.zeros((1, 8, 4, 48), device=cuda, requires_grad=True)
        with pytest.raises(ValueError, match="backward kernel takes"):
            flash_attention(q, q, q)
        kv = torch.zeros((1, 20, 4, 16), device=cuda, dtype=torch.bfloat16,
                         requires_grad=True)
        with pytest.raises(ValueError, match="backward kernel takes"):
            FlashAttentionFunction.apply(kv[:, :8], kv, kv, False, 0.25)
        assert dict(_build.launches) == before

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("b,s,sk,nq,nkv,h,hv,causal", [
        (2, 100, 100, 16, 16, 192, 128, True),   # MLA prefill
        (1, 130, 130, 8, 8, 112, 112, True),     # zamba2's shared block
        (2, 100, 100, 16, 16, 64, 64, False),    # whisper's encoder
        (2, 1, 150, 16, 16, 64, 64, False),      # its cross-attention
        (2, 40, 150, 16, 16, 64, 64, False),
        (1, 70, 150, 16, 16, 64, 64, False),
        # the ragged edges of the 64-row tiles and of the 32-column
        # sub-tiles that (128, 128) and (192, 128) take: one row past a
        # tile, a sub-tile and a half, grouped heads over four tiles
        (1, 97, 97, 4, 2, 128, 128, True),
        (2, 65, 65, 8, 8, 192, 128, True),
        (1, 33, 161, 4, 4, 192, 128, False),
        (1, 129, 129, 4, 4, 112, 112, False),
        (1, 200, 200, 16, 4, 64, 64, True)])
    def test_flash_backward_wide(self, cuda, dtype, b, s, sk, nq, nkv, h, hv,
                                 causal):
        """The widened backward: Hv != H, full attention with a key length
        of its own (ragged last tiles), whisper's and zamba2's widths; the
        forward's lse on those routes too."""
        from repro_torch.kernels.flash_attention import (
            _flash_forward, flash_attention_bwd, flash_attention_bwd_plain)

        q, k, v, do = _inputs(47, dtype, (b, s, nq, h), (b, sk, nkv, h),
                              (b, sk, nkv, hv), (b, s, nq, hv), device=cuda)
        out, lse = _flash_forward(q, k, v, causal, h ** -0.5, with_lse=True)
        want_o, want_lse = flash_attention_plain(q, k, v, causal=causal,
                                                 with_lse=True)
        _close(out, want_o, dtype)
        assert (lse - want_lse).abs().max().item() <= 1e-3
        got = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        want = flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            _close_to_max(g, w, BWD_TOL[dtype])
        again = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        torch.cuda.synchronize()
        assert all(torch.equal(a, g) for a, g in zip(again, got))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("m,h,q,p,n", [
        (2, 48, 256, 64, 128), (3, 48, 5, 64, 128), (2, 112, 200, 64, 64),
        (2, 4, 1, 16, 16), (1, 3, 37, 128, 128), (4, 48, 128, 64, 128),
        (4, 48, 64, 64, 128),
        # the tensor-core route's edges: zamba2 at a whole chunk, 9 heads
        # in 8 groups of 2 (the last three empty), one row past a tile
        (2, 112, 256, 64, 64), (2, 9, 200, 64, 128), (1, 48, 65, 64, 64)])
    @pytest.mark.parametrize("cot", ["y", "s", "both"])
    def test_ssd_intra_backward(self, cuda, dtype, m, h, q, p, n, cot):
        """ssd_intra's backward on the model's strided views (x, B, C cut
        from one activation; dy a view of a (M,Q,H,P) buffer) against the
        plain formula, and a second run bit-identical."""
        from repro_torch.kernels.ssd_scan import (ssd_intra_bwd,
                                                  ssd_intra_bwd_plain)

        gen = torch.Generator().manual_seed(48)
        xbc = torch.randn((m, q, h * p + 2 * n), generator=gen).to(
            getattr(torch, dtype)).to(cuda)
        x = xbc[..., :h * p].view(m, q, h, p).permute(0, 2, 1, 3)
        b, c = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
        dt = torch.nn.functional.softplus(
            torch.randn((m, h, q), generator=gen)).to(cuda)
        # dA on a 2**-10 grid: cumsum(dA) exact in any order
        da = torch.round(dt * -0.5 * 1024) / 1024
        dy = torch.randn((m, q, h, p), generator=gen).to(cuda).permute(
            0, 2, 1, 3)
        ds = torch.randn((m, h, n, p), generator=gen).to(cuda)
        if cot == "y":
            ds = torch.zeros_like(ds)
        elif cot == "s":
            dy = torch.zeros_like(dy)
        got = ssd_intra_bwd(x, dt, da, b, c, dy, ds)
        want = ssd_intra_bwd_plain(x, dt, da, b, c, dy, ds)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            _close_to_max(g, w, BWD_TOL[dtype])
        again = ssd_intra_bwd(x, dt, da, b, c, dy, ds)
        torch.cuda.synchronize()
        assert all(torch.equal(a, g) for a, g in zip(again, got))

    @pytest.mark.parametrize("kernel", ["flash_attention_bwd",
                                        "ssd_intra_bwd"])
    def test_backward_reruns_bit_identical(self, cuda, kernel):
        """Five runs of each backward kernel in bf16 at a training shape,
        with other launches in between to move the blocks' schedule, give
        the same bits: every sum has a fixed order (no float atomics)."""
        from repro_torch.kernels.flash_attention import flash_attention_bwd
        from repro_torch.kernels.ssd_scan import ssd_intra_bwd, ssd_intra_route

        if kernel == "flash_attention_bwd":
            q, k, v, do = _inputs(51, "bfloat16", (2, 300, 16, 128),
                                  (2, 300, 8, 128), (2, 300, 8, 128),
                                  (2, 300, 16, 128), device=cuda)
            o, lse = flash_attention_plain(q, k, v, with_lse=True)

            def run():
                return flash_attention_bwd(q, k, v, o, lse, do)
        else:
            m, h, n, p = 4, 48, 128, 64
            xbc = _inputs(52, "bfloat16", (m, 256, h * p + 2 * n),
                          device=cuda)[0]
            x = xbc[..., :h * p].view(m, 256, h, p).permute(0, 2, 1, 3)
            b, c = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
            assert ssd_intra_route(x, b, c) == "tensor_cores"
            dt = torch.nn.functional.softplus(
                _inputs(53, "float32", (m, h, 256), device=cuda)[0])
            da = torch.round(dt * -0.5 * 1024) / 1024
            dy, ds = _inputs(54, "float32", (m, h, 256, p), (m, h, n, p),
                             device=cuda)

            def run():
                return ssd_intra_bwd(x, dt, da, b, c, dy, ds)
        first = run()
        noise = torch.randn(1 << 20, device=cuda)
        for _ in range(4):
            noise = noise.sin()
            again = run()
            torch.cuda.synchronize()
            assert all(torch.equal(a, g) for a, g in zip(again, first))

    def test_ssd_intra_function_end_to_end(self, cuda):
        """Under grad ssd_intra launches its forward once and, on backward,
        its backward kernel once; the gradients equal the plain formula's."""
        from repro_torch.kernels.ssd_scan import ssd_intra_bwd_plain

        m, h, q, p, n = 2, 48, 64, 64, 128
        x, b, c = _inputs(49, "float32", (m, h, q, p), (m, q, n), (m, q, n),
                          device=cuda)
        dt = torch.nn.functional.softplus(_inputs(50, "float32", (m, h, q),
                                                  device=cuda)[0])
        da = torch.round(dt * -0.5 * 1024) / 1024
        for t in (x, dt, da, b, c):
            t.requires_grad_(True)
        before = dict(_build.launches)
        y, st = ssd_intra(x, dt, da, b, c)
        dy, ds = torch.randn_like(y), torch.randn_like(st)
        torch.autograd.backward((y, st), (dy, ds))
        for name in ("ssd_intra", "ssd_intra_bwd"):
            assert _build.launches[name] == before.get(name, 0) + 1, name
        want = ssd_intra_bwd_plain(x.detach(), dt.detach(), da.detach(),
                                   b.detach(), c.detach(), dy, ds)
        for t, w in zip((x, dt, da, b, c), want):
            _close_to_max(t.grad, w, BWD_TOL["float32"])


@pytest.mark.cuda
class TestCudaTraining:
    """Reduced configs of every family in fp32: every parameter gets a
    gradient on the card, and the card's loss and gradients equal the
    CPU's plain path; bf16 internlm2 on the tensor-core paths."""

    def test_every_parameter_gets_a_gradient(self, cuda):
        import dataclasses

        import numpy as np

        from repro_torch.configs.registry import get_config
        from repro_torch.models import model as M

        cfg = dataclasses.replace(get_config("internlm2_1_8b").reduced(),
                                  dtype="float32")
        params = M.init_params(cfg, generator=torch.Generator().manual_seed(0),
                               device="cpu")
        rng = np.random.default_rng(0)
        batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 40),
                                                  dtype=np.int32))
                 for k in ("tokens", "labels")}
        grads = {}
        for dev in ("cpu", cuda):
            leaves = [t.detach().to(dev).requires_grad_(True)
                      for t in tree_leaves(params)]
            tree = unflatten(params, leaves)
            b = {k: t.to(dev) for k, t in batch.items()}
            loss, _ = M.loss_fn(cfg, tree, b, remat=True,
                                remat_policy="dots_no_batch")
            grads[str(dev)] = (loss.item(),
                               torch.autograd.grad(loss, leaves))
        (l_cpu, g_cpu), (l_gpu, g_gpu) = grads["cpu"], grads[str(cuda)]
        assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
        for gc, gg in zip(g_cpu, g_gpu):
            assert gg.abs().max() > 0
            _close_to_max(gg, gc, 1e-4)

    @pytest.mark.parametrize("arch", ["mamba2_780m", "zamba2_7b",
                                      "deepseek_v2_lite_16b",
                                      "whisper_medium"])
    def test_other_families_get_every_gradient(self, cuda, arch):
        """The SSM, hybrid, MLA + MoE and enc-dec stacks, reduced, in fp32:
        the card's loss and every gradient leaf (non-zero) equal the CPU's
        plain path (1e-5 relative, 1e-4 of the leaf's max |.|)."""
        import dataclasses

        import numpy as np

        from repro_torch.configs.registry import get_config
        from repro_torch.models import model as M

        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        params = M.init_params(cfg, generator=torch.Generator().manual_seed(0),
                               device="cpu")
        rng = np.random.default_rng(0)
        tok = rng.integers(0, cfg.vocab_size, (2, 65), dtype=np.int32)
        batch = {"tokens": torch.from_numpy(tok[:, :-1]),
                 "labels": torch.from_numpy(tok[:, 1:])}
        if cfg.family == "encdec":
            batch["frames"] = torch.from_numpy(rng.standard_normal(
                (2, cfg.encoder_seq, cfg.d_model), dtype=np.float32))
        grads = {}
        for dev in ("cpu", cuda):
            leaves = [t.detach().to(dev).requires_grad_(True)
                      for t in tree_leaves(params)]
            tree = unflatten(params, leaves)
            b = {k: t.to(dev) for k, t in batch.items()}
            loss, _ = M.loss_fn(cfg, tree, b, remat=True,
                                remat_policy="dots_no_batch")
            grads[str(dev)] = (loss.item(),
                               torch.autograd.grad(loss, leaves))
        (l_cpu, g_cpu), (l_gpu, g_gpu) = grads["cpu"], grads[str(cuda)]
        assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
        for gc, gg in zip(g_cpu, g_gpu):
            assert gg.abs().max() > 0
            _close_to_max(gg, gc, 1e-4)

    def test_bf16_step_on_the_tensor_core_paths(self, cuda):
        """bf16 at head width 128 (the tensor-core forward, the bf16
        backward, the bf16 logits GEMM's Function): every leaf gets a
        finite, non-zero gradient, within 5e-2 of its max |.| of the fp32
        CPU gradient at the same (bf16-rounded) weights (bf16 activations
        through two layers and the logits)."""
        import dataclasses

        import numpy as np

        from repro_torch.configs.registry import get_config
        from repro_torch.models import model as M

        cfg = dataclasses.replace(get_config("internlm2_1_8b").reduced(),
                                  head_dim=128)
        params = M.init_params(cfg, generator=torch.Generator().manual_seed(1),
                               device="cpu")  # bf16
        rng = np.random.default_rng(1)
        batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64),
                                                  dtype=np.int32))
                 for k in ("tokens", "labels")}
        out = {}
        for dev, dt in (("cpu", torch.float32), (cuda, torch.bfloat16)):
            leaves = [t.detach().to(dev, dt).requires_grad_(True)
                      for t in tree_leaves(params)]
            tree = unflatten(params, leaves)
            c = dataclasses.replace(cfg, dtype=str(dt).removeprefix("torch."))
            loss, _ = M.loss_fn(c, tree, {k: t.to(dev) for k, t in
                                          batch.items()})
            out[dt] = (loss.item(), torch.autograd.grad(loss, leaves))
        (l32, g32), (l16, g16) = out[torch.float32], out[torch.bfloat16]
        assert abs(l16 - l32) <= 2e-2 * abs(l32)
        for a, b in zip(g16, g32):
            assert a.dtype == torch.bfloat16 and a.abs().max() > 0
            _close_to_max(a, b, 5e-2)

