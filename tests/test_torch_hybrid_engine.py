"""The port's serving engine on the hybrid cache family (the zamba2 case
of test_paged_families.py): ``ServeEngine(batching=True, paged=True)``
with each stream holding blocks of the shared block's KV pools (one plane
per application, one table per stream) AND a slab of the Mamba-2 state
pools, both staged in every decode call.

The bar: paged batched greedy tokens equal the unbatched dense path's and
the JAX engine's on the same weights and prompts; each stream holds blocks
and a slab of its own (never the scratch ones) and the rest of the pools
keeps its bits; afterwards every pool kind reads zero in ``kv_usage``;
calls are recorded under the family-tagged kinds ``prefill@hybrid`` and
``decode@hybrid``.  Migration of both kinds is held in
test_torch_paged_families.py.

Config: zamba2-7b reduced (G 2, PG 1, R 1) and the same with 8 layers
every 3rd shared (G 2, PG 2, R 2), fp32, on the CPU (every kernel takes
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
from repro_torch.params import params_from_numpy
from repro_torch.serving.engine import ServeEngine, StreamSpec

STEPS = 5
ZERO = {"blocks": 0, "slabs": 0, "segments": 0}
SHAPES = {"reduced": {}, "pg2_r2": dict(num_layers=8, attn_every=3)}


@pytest.fixture(scope="module", params=sorted(SHAPES))
def setup(request):
    jcfg, cfg = (dataclasses.replace(get("zamba2_7b").reduced(),
                                     dtype="float32", **SHAPES[request.param])
                 for get in (jax_config, get_config))
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
          "kv_block_size": 8, "device": "cpu", **kw}
    return ServeEngine(cfg, params, **kw)


def test_four_streams_two_servers_match_unbatched_and_jax(setup):
    cfg, params, jcfg, jparams = setup
    prompts = _prompts(2, 5, 9, 20)
    want = _reference_tokens(cfg, params, prompts)
    eng = _engine(cfg, params, num_servers=2)
    jeng = JaxServeEngine(jcfg, jparams, max_seq=32, num_servers=2,
                          batching=True, max_batch=4, paged=True,
                          kv_block_size=8)
    try:
        assert eng._family == "hybrid"
        assert eng._cache_kinds == {"block", "slab"}
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
        meta = [m for s in eng.pool.servers for m in s.stats.batch_meta]
        assert {m["kind"] for m in meta} == {"prefill@hybrid", "decode@hybrid"}
        assert all(m["width"] > 0 for m in meta
                   if m["kind"] == "decode@hybrid")
    finally:
        eng.close()
        jeng.close()


def test_streams_hold_their_own_blocks_and_slabs(setup):
    """Two streams on one server, with a held reservation between them:
    tokens equal unbatched; each stream's blocks and slab are its own,
    never the scratch ones; the held reservation's blocks (every group
    plane) and slab (every Mamba-2 layer) keep their bits."""
    cfg, params, _, _ = setup
    prompts = _prompts(4, 11)
    want = _reference_tokens(cfg, params, prompts)
    eng = _engine(cfg, params, num_servers=1)
    try:
        eng.precompile(prompt_buckets=(4, 16))
        state = eng._paged[0]
        holes = [eng._paged_reserve(0, f"hole{i}", 1, 1, 1) for i in range(3)]
        eng._paged_release(0, holes[1][0])  # frees the middle reservation
        _, held_table, held_slab, _ = holes[2]
        held_blocks = [b for b in held_table if b != state.scratch_block]
        attn0 = [t[:, held_blocks].clone() for t in state.pools["attn"]]
        mamba0 = [t[:, held_slab].clone() for t in state.pools["mamba"]]
        used = []
        reserve = eng._paged_reserve

        def spy(*args):
            out = reserve(*args)
            used.append(out)
            return out

        eng._paged_reserve = spy
        for i, n in enumerate(prompts):
            assert eng.admit(_spec(n, 2 - i)).admitted
        got = _run_streams(eng, prompts)
        assert {n: r.tokens for n, r in got.items()} == want
        blocks = [{b for b in table if b != state.scratch_block}
                  for _, table, _, _ in used]
        slabs = [slab for _, _, slab, _ in used]
        assert len(used) == 2 and all(blocks)
        assert not blocks[0] & blocks[1] and slabs[0] != slabs[1]
        assert state.scratch_slab not in slabs
        assert not (blocks[0] | blocks[1]) & set(held_blocks)
        assert held_slab not in slabs
        for t, before in zip(state.pools["attn"], attn0):
            assert torch.equal(t[:, held_blocks], before)
        for t, before in zip(state.pools["mamba"], mamba0):
            assert torch.equal(t[:, held_slab], before)
        for seq_id, *_ in (holes[0], holes[2]):
            eng._paged_release(0, seq_id)
        assert eng.kv_usage() == ZERO
        assert not any(m["cold"] for s in eng.pool.servers
                       for m in s.stats.batch_meta)
    finally:
        eng.close()


def test_reservation_takes_blocks_and_a_slab(setup):
    cfg, params, _, _ = setup
    eng = _engine(cfg, params, num_servers=1)
    try:
        state = eng._paged[0]
        assert state.nb_max == 32 // 8
        assert state.mgr.num_blocks == 4 * (32 // 8) + 1
        assert state.mgr.num_slabs == 2 * 4 + 2
        seq_id, table, slab, seg = eng._paged_reserve(0, "probe", 5, STEPS, 8)
        assert table[0] != state.scratch_block and slab != state.scratch_slab
        assert seg == state.scratch_seg
        assert eng.kv_usage() == {"blocks": 2, "slabs": 1, "segments": 0}
        eng._paged_release(0, seq_id)
        eng.remove("probe")
        assert eng.kv_usage() == ZERO
    finally:
        eng.close()


def test_precompile_builds_both_pool_kinds(setup):
    """precompile walks every (rows, width) cell and allocates the two pool
    kinds: G group planes of blocks and G*PG + R layers of fp32 slabs."""
    cfg, params, _, _ = setup
    eng = _engine(cfg, params, num_servers=1)
    try:
        rep = eng.precompile(prompt_buckets=(8,))
        assert set(rep.decode_cells) == {(r, w) for r in (1, 2, 4)
                                         for w in (1, 2, 4)}
        assert set(rep.prefill_cells) == {(1, 8), (2, 8), (4, 8)}
        pools = eng._paged[0].pools
        g = cfg.num_layers // cfg.attn_every
        n_mamba = cfg.num_layers - g
        assert tuple(pools["attn"][0].shape) == (
            g, 17, 8, cfg.num_kv_heads, cfg.head_dim)
        assert tuple(pools["mamba"][1].shape) == (
            n_mamba, 10, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state_dim)
        assert pools["mamba"][1].dtype == torch.float32
    finally:
        eng.close()
