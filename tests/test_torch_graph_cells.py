"""What the port's CUDA-graph cells rest on, checked on the CPU.

* The values every attention layer of a step shares (rope, each row's
  slot and length) are computed once per step; every family's paged and
  dense decode logits equal, bit for bit, those of a step in which each
  layer computes its own (the reference step below drops the shared
  values, so each layer falls back to computing them).
* ``unembed`` of bf16 activations gives fp32 logits within the bf16 bar
  (2e-2) of the reference's ``preferred_element_type`` product.
* On the CPU ``precompile`` captures nothing and the engine's tokens are
  those of unbatched ``generate``.
* A graph's kernel launches are counted once per replay, never at
  capture.

The replays themselves run on the card: ``TestCudaGraphCells`` in
``tests/test_torch_cuda.py``.
"""

import dataclasses
import threading
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch.configs.registry import get_config
from repro_torch.kernels import _build
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.params import params_from_numpy
from repro_torch.serving.engine import ServeEngine, StreamSpec
from repro_torch.serving.graphs import GraphCell

FAMILIES = ["internlm2_1_8b", "deepseek_v2_lite_16b", "mamba2_780m",
            "zamba2_7b", "whisper_medium", "qwen2_vl_2b"]
MAX_SEQ, BLOCK, ROWS = 32, 8, 3


def _cfg(arch):
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32")


def _params(cfg):
    return M.init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")


def _noisy(tree, gen):
    """Every floating leaf of a cache or pool tree filled with noise."""
    if isinstance(tree, dict):
        return {k: _noisy(v, gen) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_noisy(v, gen) for v in tree)
    if tree.is_floating_point():
        return torch.randn(tree.shape, generator=gen).to(tree.dtype)
    return tree


@pytest.fixture
def per_layer(monkeypatch):
    """The reference step: every attention layer computes its own rope,
    slots and lengths (the step's shared values are dropped)."""

    def drop(fn):
        return lambda *a, step=None, **k: fn(*a, **k)

    def use():
        monkeypatch.setattr(L, "attention", drop(L.attention))
        monkeypatch.setattr(L, "mla_attention", drop(L.mla_attention))

    return use


@pytest.mark.parametrize("arch", FAMILIES)
def test_shared_step_values_change_no_bit(arch, per_layer):
    cfg = _cfg(arch)
    params = _params(cfg)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.tensor([[3], [7], [11]], dtype=torch.int32)
    eng = ServeEngine(cfg, params, max_seq=MAX_SEQ, batching=True,
                      max_batch=4, paged=True, kv_block_size=BLOCK,
                      device="cpu")
    try:
        state = eng._paged[0]
        pools = _noisy(eng._make_pools(state), gen)
        w = MAX_SEQ // BLOCK if state.nb_max else 0
        pack = np.zeros((ROWS, 4 + w), np.int32)
        pack[:, 0] = tokens[:, 0].numpy()
        pack[:, 1] = [5, 17, 30]  # lengths: 1, 3 and 4 blocks
        pack[:, 2] = [1, 4, 2]  # slabs
        pack[:, 3] = [1, 1, 3]  # segments, one shared
        if w:
            perm = np.random.default_rng(1).permutation(
                state.mgr.num_blocks - 1) + 1
            pack[:, 4:] = perm[:ROWS * w].reshape(ROWS, w)
        dense = _noisy(M.init_cache(cfg, ROWS, MAX_SEQ, device="cpu"), gen)
        dense["pos"] = torch.tensor([5, 17, 30], dtype=torch.int32)

        def both():
            """A paged and a dense decode step, each on its own copy of
            the noisy pools or cache (both are written in place)."""
            copy = jax.tree.map(torch.clone, pools)
            paged = eng._decode_paged_impl(torch.from_numpy(pack), copy)
            cache = jax.tree.map(torch.clone, dense)
            out, _, _ = M.apply(cfg, params, {"tokens": tokens},
                                mode="decode", cache=cache)
            return paged, out, copy, cache

        with torch.inference_mode():
            hoisted = both()
            per_layer()
            reference = both()
        for got, want in zip(jax.tree.leaves(hoisted),
                             jax.tree.leaves(reference)):
            assert torch.equal(got, want)
    finally:
        eng.close()


def test_step_values_once_per_step(monkeypatch):
    """A GQA decode step computes rope and the slots once, not per layer."""
    cfg = dataclasses.replace(_cfg("internlm2_1_8b"), num_layers=3)
    params = _params(cfg)
    calls = Counter()
    for name in ("rope_cos_sin", "step_values"):
        fn = getattr(L, name)
        monkeypatch.setattr(L, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.update([_n]), _fn(*a, **k))[1])
    cache = M.init_cache(cfg, 2, MAX_SEQ, device="cpu")
    M.apply(cfg, params, {"tokens": torch.ones((2, 1), dtype=torch.int32)},
            mode="decode", cache=cache)
    assert calls == {"rope_cos_sin": 1, "step_values": 1}


def test_bf16_unembed_within_the_bf16_bar():
    """bf16 activations against the bf16 tied table: fp32 logits within
    2e-2 of the reference's bf16 product accumulated in fp32."""
    jcfg = jax_config("qwen2_vl_2b").reduced()
    tcfg = get_config("qwen2_vl_2b").reduced()
    assert jcfg.dtype == tcfg.dtype == "bfloat16" and tcfg.tie_embeddings
    jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(3).standard_normal((2, 5, jcfg.d_model),
                                                 dtype=np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = JT.unembed(jcfg, jp, xj)
    got = T.unembed(tcfg, tp, torch.from_numpy(
        np.array(xj.astype(jnp.float32))).to(torch.bfloat16))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                               atol=2e-2)


def _spec(name, prio):
    return StreamSpec(name=name, priority=prio, period_ms=8000.0,
                      deadline_ms=8000.0, prefill_ms=50.0, decode_ms=5.0,
                      decode_steps=5)


def test_cpu_precompile_captures_nothing():
    cfg = _cfg("internlm2_1_8b")
    params = _params(cfg)
    prompts = {f"c{i}": np.arange(1, n + 1, dtype=np.int32)[None] % 100
               for i, n in enumerate([3, 6, 10])}
    ref = ServeEngine(cfg, params, max_seq=MAX_SEQ, device="cpu")
    try:
        want = {}
        for i, n in enumerate(prompts):
            assert ref.admit(_spec(n, 3 - i)).admitted
            want[n] = ref.generate(n, prompts[n], steps=5).tokens
    finally:
        ref.close()
    eng = ServeEngine(cfg, params, max_seq=MAX_SEQ, num_servers=2,
                      batching=True, max_batch=2, paged=True,
                      kv_block_size=BLOCK, device="cpu")
    try:
        rep = eng.precompile(prompt_buckets=(4, 8, 16))
        assert rep.compiled and rep.captured == 0
        assert not any(st.graphs for st in eng._paged)
        got = {}
        for i, n in enumerate(prompts):
            assert eng.admit(_spec(n, 3 - i)).admitted
        threads = [threading.Thread(target=lambda n=n: got.__setitem__(
            n, eng.generate(n, prompts[n], steps=5).tokens))
            for n in prompts]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert got == want
        meta = [m for s in eng.pool.servers for m in s.stats.batch_meta]
        assert meta and not any(m["graphed"] for m in meta)
        assert eng.kv_blocks_in_use() == 0
    finally:
        eng.close()


class _FakeLib:
    def kernel_launch(self, *args):
        return 0


def test_captured_launches_count_once_per_replay(monkeypatch):
    """Launches made while capturing go to the graph's counter, not to
    ``launches``; each replay adds that counter once."""
    monkeypatch.setattr(_build, "library", lambda: _FakeLib())
    _build.reset_launches()
    _build.launch("outside", "kernel_launch")
    captured = Counter()
    with _build.count_into(captured):
        for _ in range(3):
            _build.launch("rmsnorm", "kernel_launch")
        _build.launch("flash_attention", "kernel_launch")
    assert captured == {"rmsnorm": 3, "flash_attention": 1}
    assert _build.launches == {"outside": 1}

    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1

    cell = GraphCell.__new__(GraphCell)
    cell.graph, cell.launches = Graph(), captured
    cell.inputs = (torch.zeros((2, 3), dtype=torch.int32),)
    cell.outputs = "static outputs"
    for i in range(4):
        staged = np.full((2, 3), i, np.int32)
        assert cell.replay(staged) == "static outputs"
        assert torch.equal(cell.inputs[0], torch.from_numpy(staged))
    assert Graph.replays == 4
    assert _build.launches == {"outside": 1, "rmsnorm": 12,
                               "flash_attention": 4}
    _build.reset_launches()
