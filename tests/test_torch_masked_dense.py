"""The port's masked-dense batched layout (``ServeEngine(batching=True,
paged=False)``): one dense slot cache of ``max_batch`` rows per server,
every decode call over all of its rows with the inactive ones masked --
the reference's yardstick for paged decode -- for every family the port
serves: GQA (internlm2), MLA with a dense prefix layer (deepseek-v2-lite),
SSM (mamba2), hybrid (zamba2), enc-dec (whisper) and the VLM backbone
(qwen2-vl, from tokens).

The bar, per family: greedy tokens equal unbatched ``generate``'s and the
JAX masked-dense engine's; one masked step leaves every cache leaf of an
inactive slot -- a finished row whose position is ``max_seq`` among them
-- bit for bit as it was, advances only the active rows, and gives them
the logits and cache of a dense step over those rows alone; afterwards
every slot is free and no block is held.

Configs: each family's reduced config, fp32 (the VLM with M-RoPE sections
(2, 3, 3)), on the CPU (every kernel takes its plain version there).
"""

import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import model as JM
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro.serving.engine import StreamSpec as JaxStreamSpec
from repro_torch.configs.registry import get_config
from repro_torch.models import model as M
from repro_torch.params import params_from_numpy
from repro_torch.serving.engine import (ServeEngine, StreamSpec,
                                        _cache_leaves)

STEPS = 5
MAX_SEQ = 32
FAMILY_ARCHS = {
    "gqa": ("internlm2_1_8b", {}),
    "mla": ("deepseek_v2_lite_16b", {}),
    "ssm": ("mamba2_780m", {}),
    "hybrid": ("zamba2_7b", {}),
    "encdec": ("whisper_medium", {}),
    "vlm": ("qwen2_vl_2b", {"mrope_sections": (2, 3, 3)}),
}


@pytest.fixture(scope="module", params=sorted(FAMILY_ARCHS))
def setup(request):
    arch, kw = FAMILY_ARCHS[request.param]
    jcfg, cfg = (dataclasses.replace(get(arch).reduced(), dtype="float32",
                                     **kw)
                 for get in (jax_config, get_config))
    jparams = jax.jit(JM.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(5))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, params, jcfg, jparams


def _spec(name, prio, cls=StreamSpec):
    return cls(name=name, priority=prio, period_ms=8000.0, deadline_ms=8000.0,
               prefill_ms=50.0, decode_ms=5.0, decode_steps=STEPS)


def _prompts(*lengths):
    return {f"s{i}": (np.arange(1, n + 1, dtype=np.int32)[None, :] * 5) % 128
            for i, n in enumerate(lengths)}


def _run_streams(eng, prompts):
    out = {}
    threads = [threading.Thread(target=lambda n=n: out.__setitem__(
        n, eng.generate(n, prompts[n], steps=STEPS))) for n in prompts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return {n: r.tokens for n, r in out.items()}


def _masked(cfg, params, cls=ServeEngine, **kw):
    if cls is ServeEngine:
        kw["device"] = "cpu"
    return cls(cfg, params, max_seq=MAX_SEQ, batching=True, paged=False,
               max_batch=4, kv_block_size=8, **kw)


def test_tokens_equal_unbatched_and_the_jax_engine(setup):
    """Three streams of different lengths on one server's four slots:
    every decode call runs all four rows; tokens equal unbatched
    ``generate`` and the JAX masked-dense engine; the block accounting
    and the slots drain."""
    cfg, params, jcfg, jparams = setup
    prompts = _prompts(3, 6, 11)
    ref = ServeEngine(cfg, params, max_seq=MAX_SEQ, device="cpu")
    try:
        want = {}
        for i, n in enumerate(prompts):
            assert ref.admit(_spec(n, 3 - i)).admitted
            want[n] = ref.generate(n, prompts[n], steps=STEPS).tokens
    finally:
        ref.close()
    eng = _masked(cfg, params, kv_blocks=16)
    jeng = _masked(jcfg, jparams, cls=JaxServeEngine)
    try:
        for i, n in enumerate(prompts):
            assert eng.admit(_spec(n, 3 - i)).admitted
            assert jeng.admit(_spec(n, 3 - i, cls=JaxStreamSpec)).admitted
        got = _run_streams(eng, prompts)
        assert got == want
        assert got == _run_streams(jeng, prompts)
        meta = [m for m in eng.pool.servers[0].stats.batch_meta
                if m["kind"] == "decode"]
        assert meta and all(m["padded"] == 4 and m["width"] == 0
                            for m in meta)
        assert eng.kv_blocks_in_use() == 0
        assert len(eng._slots[0].free) == 4
    finally:
        eng.close()
        jeng.close()


def test_inactive_slot_keeps_its_bits(setup):
    """One masked step on random slot content: rows 1 and 2 inactive (row
    2 finished, its ``pos`` at max_seq) keep every leaf and their ``pos``
    bit for bit; rows 0 and 3 advance and match a dense step over those
    two rows alone."""
    cfg, params, _, _ = setup
    eng = _masked(cfg, params)
    try:
        cache = eng._slot_cache(eng._slots[0])
        gen = torch.Generator().manual_seed(1)
        for leaf in _cache_leaves(cache):
            leaf.copy_(0.5 * torch.randn(leaf.shape, generator=gen))
        cache["pos"].copy_(torch.tensor([3, 7, MAX_SEQ, 5],
                                        dtype=torch.int32))
        before = {id(t): t.clone() for t in _cache_leaves(cache)}
        pos0 = cache["pos"].clone()
        axes = eng._batch_axes
        live = [0, 3]
        alone = {"pos": pos0[live].clone()}
        for k, v in cache.items():
            if k != "pos":
                alone[k] = _select(v, live, axes, cache, k)
        packed = torch.tensor([[11, 1], [12, 0], [13, 0], [14, 1]],
                              dtype=torch.int32)
        with torch.inference_mode():
            logits = eng._decode_masked_impl(packed, cache)
            want, after, _ = M.apply(cfg, params,
                                     {"tokens": packed[live, :1]},
                                     mode="decode", cache=alone)
        for leaf, (bax, _, _) in zip(_cache_leaves(cache), axes):
            old = before[id(leaf)]
            for row in (1, 2):
                assert torch.equal(leaf.select(bax, row),
                                   old.select(bax, row))
        assert cache["pos"].tolist() == [4, 7, MAX_SEQ, 6]
        torch.testing.assert_close(logits[live], want, rtol=1e-5, atol=1e-5)
        for leaf, new, (bax, _, _) in zip(_cache_leaves(cache),
                                          _cache_leaves(after), axes):
            torch.testing.assert_close(
                leaf.index_select(bax, torch.tensor(live)), new,
                rtol=1e-5, atol=1e-5)
    finally:
        eng.close()


def _select(tree, rows, axes, cache, key):
    """``tree`` (one entry of the slot cache) with only ``rows`` along
    each leaf's batch axis, copied."""
    order = {id(t): ax for t, ax in zip(_cache_leaves(cache), axes)}

    def one(t):
        if isinstance(t, (list, tuple)):
            return type(t)(one(v) for v in t)
        return t.index_select(order[id(t)][0], torch.tensor(rows)).clone()

    return one(tree)


def test_precompile_warms_the_one_masked_cell(setup):
    """The masked-dense layout has one decode cell, (max_batch, 0); the
    CPU captures nothing and serves the same tokens after it."""
    cfg, params, _, _ = setup
    eng = _masked(cfg, params)
    try:
        rep = eng.precompile(prompt_buckets=(4,))
        assert rep.decode_cells == ((4, 0),)
        assert rep.migrate_cells == ()
        assert rep.compiled == 1 + 3  # rows {1, 2, 4} x bucket 4
        assert rep.captured == 0
        assert eng.admit(_spec("p", 1)).admitted
        res = eng.generate("p", np.array([[1, 2, 3]], np.int32), steps=STEPS)
        assert len(res.tokens) == STEPS
        assert not any(m["cold"] for m in eng.pool.servers[0].stats.batch_meta)
    finally:
        eng.close()
