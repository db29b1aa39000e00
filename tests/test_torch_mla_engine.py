"""The port's serving engine on the MLA cache family (the deepseek case of
test_paged_families.py, without migration): ``ServeEngine(batching=True,
paged=True)`` with each stream's latent (c_kv, k_rope) rows in blocks of
the server's latent pools, and the dense prefix layer's rows in a second
pool pair addressed by the same block table.

The bar: paged batched greedy tokens equal the unbatched dense path's and
the JAX engine's on the same weights and prompts; a stream's rows land in
its own blocks in both the stacked and the prefix pools; afterwards every
pool kind reads zero in ``kv_usage``; calls are recorded under the
family-tagged kinds ``prefill@mla`` and ``decode@mla``.

Config: deepseek-v2-lite-16b reduced, fp32, on the CPU (every kernel takes
its plain version there).
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
from repro_torch.models import model as TM
from repro_torch.params import params_from_numpy
from repro_torch.serving.engine import ServeEngine, StreamSpec

STEPS = 5
BS = 8
ZERO = {"blocks": 0, "slabs": 0, "segments": 0}


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_config("deepseek_v2_lite_16b").reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("deepseek_v2_lite_16b").reduced(),
                              dtype="float32")
    jparams = jax.jit(JM.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(3))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, params, jcfg, jparams


def _spec(name, prio, cls=StreamSpec):
    return cls(name=name, priority=prio, period_ms=8000.0, deadline_ms=8000.0,
               prefill_ms=50.0, decode_ms=5.0, decode_steps=STEPS)


def _prompts(*lengths):
    return {f"s{i}": (np.arange(1, n + 1, dtype=np.int32)[None, :] * 7) % 128
            for i, n in enumerate(lengths)}


def _run_streams(eng, prompts):
    results = {}

    def worker(n):
        results[n] = eng.generate(n, prompts[n], steps=STEPS)

    threads = [threading.Thread(target=worker, args=(n,)) for n in prompts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return results


def _reference_tokens(cfg, params, prompts):
    eng = ServeEngine(cfg, params, max_seq=32, device="cpu")
    try:
        out = {}
        for i, n in enumerate(prompts):
            assert eng.admit(_spec(n, len(prompts) - i)).admitted
            out[n] = eng.generate(n, prompts[n], steps=STEPS).tokens
        return out
    finally:
        eng.close()


def _engine(cfg, params, **kw):
    kw = {"max_seq": 32, "batching": True, "paged": True, "max_batch": 4,
          "kv_block_size": BS, "device": "cpu", **kw}
    return ServeEngine(cfg, params, **kw)


def test_four_streams_two_servers_match_unbatched_and_jax(setup):
    cfg, params, jcfg, jparams = setup
    prompts = _prompts(2, 5, 9, 20)
    want = _reference_tokens(cfg, params, prompts)
    eng = _engine(cfg, params, num_servers=2)
    jeng = JaxServeEngine(jcfg, jparams, max_seq=32, num_servers=2,
                          batching=True, max_batch=4, paged=True,
                          kv_block_size=BS)
    try:
        assert eng._family == "mla"
        assert eng._pool_kinds == {"layers": "block", "first_layers": "block"}
        for i, n in enumerate(prompts):
            assert eng.admit(_spec(n, 4 - i)).admitted
            assert jeng.admit(_spec(n, 4 - i, JaxStreamSpec)).admitted
        assert {eng.pool.server_of(n) for n in prompts} == {0, 1}
        got = _run_streams(eng, prompts)
        jax_got = _run_streams(jeng, prompts)
        for n in prompts:
            assert got[n].tokens == want[n], n
            assert got[n].tokens == jax_got[n].tokens, n
            assert len(got[n].decode_latencies_s) == STEPS
        assert eng.kv_usage() == jeng.kv_usage() == ZERO
        assert eng.kv_blocks_in_use() == 0
        meta = [m for s in eng.pool.servers for m in s.stats.batch_meta]
        assert {m["kind"] for m in meta} == {"prefill@mla", "decode@mla"}
    finally:
        eng.close()
        jeng.close()


def test_prefix_pools_share_the_block_table(setup):
    """One stream's insert and decode steps write its prefix layer's rows
    and the stacked layers' rows at the same (block, offset) places: the
    blocks of its table, in both pool pairs, and nowhere else."""
    cfg, params, _, _ = setup
    eng = _engine(cfg, params, num_servers=1)
    try:
        eng.precompile(prompt_buckets=(16,))
        state = eng._paged[0]
        with torch.inference_mode():  # the pools are inference tensors
            for t in (*state.pools["layers"], *state.pools["first_layers"]):
                t.zero_()
        tables = []
        reserve = eng._paged_reserve

        def spy(*args):
            out = reserve(*args)
            tables.append(out[1].copy())
            return out

        eng._paged_reserve = spy
        prompt = _prompts(11)["s0"]
        assert eng.admit(_spec("s0", 1)).admitted
        eng.generate("s0", prompt, steps=STEPS)
        (table,) = tables
        live = sorted({int(b) for b in table[: -(-(11 + STEPS) // BS)]})
        assert state.scratch_block not in live
        for key in ("layers", "first_layers"):
            ckv = state.pools[key][0]
            written = sorted(int(b) for b in torch.nonzero(
                ckv.abs().sum(dim=(0, 2, 3))).flatten())
            assert written == live, key
        assert eng.kv_usage() == ZERO
    finally:
        eng.close()


def test_pools_and_precompile_cells(setup):
    cfg, params, _, _ = setup
    eng = _engine(cfg, params, num_servers=1)
    try:
        rep = eng.precompile(prompt_buckets=(8,))
        state = eng._paged[0]
        nb = 4 * (32 // BS) + 1
        assert set(rep.decode_cells) == {(r, w) for r in (1, 2, 4)
                                         for w in (1, 2, 4)}
        r, pr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
        for key, n in (("layers", cfg.num_layers - 1), ("first_layers", 1)):
            ckv, krope = state.pools[key]
            assert tuple(ckv.shape) == (n, nb, BS, r)
            assert tuple(krope.shape) == (n, nb, BS, pr)
        meta = eng.pool.servers[0].stats.batch_meta
        assert not meta  # warm-up runs are not recorded as traffic
        assert TM.paged_pool_kinds(cfg) == eng._pool_kinds
    finally:
        eng.close()
