"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and the CUDA toolkit (the kernels build
at first use): each is marked ``cuda`` and skips elsewhere.  The file
imports neither JAX nor the reference package, so it runs on the machine
with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Shapes are the main path's widths (Nq=16, Nkv=8, H=128, D=2048, block
16); tolerances those of test_kernels.py (fp32 1e-5, bf16 2e-2, atol and
rtol).
"""

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention, paged_decode_attention_plain)
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

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
    @pytest.mark.parametrize("s", [8, 40, 256])
    def test_flash_attention(self, cuda, dtype, s):
        q, k, v = _inputs(21, dtype, (2, s, 16, 128), (2, s, 8, 128),
                          (2, s, 8, 128), device=cuda)
        _close(flash_attention(q, k, v), flash_attention_plain(q, k, v),
               dtype)

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
