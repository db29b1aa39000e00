"""The port's serving engine (repro_torch.serving.engine) on the main path:
``ServeEngine(batching=True, paged=True)`` with the unbatched ``generate``
as its reference -- the cases of test_serving_batched.py re-run on the
port, plus greedy tokens equal to the JAX engine's on the same weights and
prompts, and no leaked KV block.

Config: internlm2-1.8b reduced, fp32, on the CPU (every kernel takes its
plain version there).
"""

import dataclasses
import threading

import jax
import numpy as np
import pytest

from repro.configs.registry import get_config as jax_config
from repro.models import model as JM
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro.serving.engine import StreamSpec as JaxStreamSpec
from repro_torch.configs.registry import get_config
from repro_torch.params import params_from_numpy
from repro_torch.serving.engine import ServeEngine, StreamSpec
from repro_torch.serving.kvcache import OutOfBlocksError

STEPS = 6


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_config("internlm2_1_8b").reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("internlm2_1_8b").reduced(),
                              dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(1))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, params, jcfg, jparams


def _spec(name, prio, steps=STEPS, cls=StreamSpec):
    return cls(name=name, priority=prio, period_ms=8000.0, deadline_ms=8000.0,
               prefill_ms=50.0, decode_ms=5.0, decode_steps=steps)


def _engine(cfg, params, **kw):
    kw = {"max_seq": 32, "batching": True, "paged": True,
          "kv_block_size": 8, "device": "cpu", **kw}
    return ServeEngine(cfg, params, **kw)


def _reference_tokens(cfg, params, prompt):
    eng = ServeEngine(cfg, params, max_seq=32, device="cpu")
    try:
        assert eng.admit(_spec("ref", 1)).admitted
        return eng.generate("ref", prompt, steps=STEPS).tokens
    finally:
        eng.close()


def _run_streams(eng, prompts, steps=STEPS):
    results = {}

    def worker(n):
        results[n] = eng.generate(n, prompts[n], steps=steps)

    threads = [threading.Thread(target=worker, args=(n,)) for n in prompts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return results


def _decode_meta(eng, si=None):
    servers = eng.pool.servers if si is None else [eng.pool.servers[si]]
    return [m for s in servers for m in s.stats.batch_meta
            if m["kind"] == "decode"]


def test_four_streams_two_servers_match_unbatched(setup):
    cfg, params, _, _ = setup
    prompt = np.array([[1, 2, 3, 4]], np.int32)
    want = _reference_tokens(cfg, params, prompt)
    eng = _engine(cfg, params, num_servers=2, max_batch=4)
    try:
        names = [f"p{i}" for i in range(4)]
        for i, n in enumerate(names):
            assert eng.admit(_spec(n, 4 - i)).admitted
        assert {eng.pool.server_of(n) for n in names} == {0, 1}
        pools = {si: None for si in range(2)}
        results = _run_streams(eng, {n: prompt for n in names})
        for n in names:
            assert results[n].tokens == want, n
            assert len(results[n].decode_latencies_s) == STEPS
        # 4 streams x (prefill + insert + STEPS decodes)
        assert sum(s.stats.completed for s in eng.pool.servers) == 4 * (2 + STEPS)
        decodes = _decode_meta(eng)
        # prompt 4 + 6 steps <= 16 tokens -> 2 blocks of 8
        assert decodes and all(m["width"] <= 2 for m in decodes)
        meta = [m for s in eng.pool.servers for m in s.stats.batch_meta]
        assert all(m["bucket"] == 4 for m in meta if m["kind"] == "prefill")
        assert eng.kv_usage() == {"blocks": 0, "slabs": 0, "segments": 0}
        assert all(st.mgr.blocks_in_use == 1 for st in eng._paged)  # scratch
        for si in pools:  # the pools are allocated once and updated in place
            pools[si] = eng._paged[si].pools["layers"][0].data_ptr()
        _run_streams(eng, {n: prompt for n in names[:2]})
        assert all(eng._paged[si].pools["layers"][0].data_ptr() == ptr
                   for si, ptr in pools.items())
    finally:
        eng.close()


def test_mixed_prompt_lengths_match_unbatched(setup):
    cfg, params, _, _ = setup
    prompts = {f"m{i}": np.arange(1, n + 1, dtype=np.int32)[None, :] % 100
               for i, n in enumerate([2, 5, 9])}
    want = {n: _reference_tokens(cfg, params, p) for n, p in prompts.items()}
    eng = _engine(cfg, params, num_servers=1, max_batch=4)
    try:
        for i, n in enumerate(prompts):
            assert eng.admit(_spec(n, 3 - i)).admitted
        results = _run_streams(eng, prompts)
        for n in prompts:
            assert results[n].tokens == want[n], n
        assert eng.kv_blocks_in_use() == 0
    finally:
        eng.close()


def test_tokens_equal_the_jax_engine(setup):
    """Same weights, same prompts: the port's paged engine and the JAX
    paged engine produce the same greedy tokens."""
    cfg, params, jcfg, jparams = setup
    prompts = {f"j{i}": np.arange(3, n + 3, dtype=np.int32)[None, :] % 128
               for i, n in enumerate([3, 7])}
    jeng = JaxServeEngine(jcfg, jparams, max_seq=32, num_servers=1,
                          batching=True, max_batch=2, paged=True,
                          kv_block_size=8)
    eng = _engine(cfg, params, num_servers=1, max_batch=2)
    try:
        for i, n in enumerate(prompts):
            assert jeng.admit(_spec(n, 2 - i, cls=JaxStreamSpec)).admitted
            assert eng.admit(_spec(n, 2 - i)).admitted
        want = _run_streams(jeng, prompts)
        got = _run_streams(eng, prompts)
        for n in prompts:
            assert got[n].tokens == want[n].tokens, n
        assert eng.kv_usage() == jeng.kv_usage()
    finally:
        jeng.close()
        eng.close()


def test_single_stream_compacts(setup):
    """One live stream in an 8-slot server: the device call shrinks to a
    single row."""
    cfg, params, _, _ = setup
    eng = _engine(cfg, params, max_seq=64, max_batch=8)
    try:
        assert eng.admit(_spec("solo", 1)).admitted
        res = eng.generate("solo", np.array([[7, 8, 9]], np.int32), steps=4)
        assert len(res.tokens) == 4
        decodes = _decode_meta(eng)
        assert decodes
        assert all(m["padded"] == 1 and m["compacted"] for m in decodes)
    finally:
        eng.close()


def test_slots_recycled_across_jobs(setup):
    cfg, params, _, _ = setup
    eng = _engine(cfg, params, max_batch=2)
    try:
        for i in range(3):
            assert eng.admit(_spec(f"j{i}", 3 - i, steps=2)).admitted
        for i in range(3):  # sequential: each job acquires + releases
            res = eng.generate(f"j{i}", np.array([[5, 6]], np.int32), steps=2)
            assert len(res.tokens) == 2
        assert len(eng._slots[0].free) == 2
    finally:
        eng.close()


def test_batched_requires_single_row_prompt(setup):
    cfg, params, _, _ = setup
    eng = _engine(cfg, params, max_batch=2)
    try:
        assert eng.admit(_spec("w", 1)).admitted
        with pytest.raises(ValueError, match="one sequence"):
            eng.generate("w", np.zeros((2, 4), np.int32), steps=1)
    finally:
        eng.close()


def test_precompile_visits_all_shape_buckets(setup):
    """precompile() warms every (rows, width) cell once; a second call
    skips them all and traffic afterwards never runs a cold cell."""
    cfg, params, _, _ = setup
    eng = _engine(cfg, params, num_servers=2, max_batch=4)
    try:
        # rows {1,2,4} x widths {1,2,4} (nb_max = 32/8) = 9 decode cells,
        # plus one migration (gather + scatter) cell per width = 12
        rep = eng.precompile()
        assert rep.compiled == 12 and rep.skipped == 0
        assert rep.migrate_cells == (1, 2, 4)
        rep2 = eng.precompile()
        assert rep2.compiled == 0 and rep2.skipped == 12
        assert eng.admit(_spec("w", 1)).admitted
        res = eng.generate("w", np.array([[1, 2, 3]], np.int32), steps=4)
        assert len(res.tokens) == 4
        assert not any(m["cold"] for m in _decode_meta(eng))
    finally:
        eng.close()


def test_precompile_covers_nonpow2_max_batch(setup):
    """max_batch=6 clamps the pow2 row rule to a SIX-row cell: the ladder
    includes the cap and precompile warms it."""
    cfg, params, _, _ = setup
    eng = _engine(cfg, params, max_batch=6)
    try:
        assert eng._row_buckets == (1, 2, 4, 6)
        rep = eng.precompile(prompt_buckets=(4,))
        # rows {1,2,4,6} x widths {1,2,4} decode + rows x bucket 4 prefill
        # + the 3 per-width migration cells
        assert rep.compiled == 12 + 4 + 3
        assert (6, 1) in rep.decode_cells and (6, 4) in rep.prefill_cells
    finally:
        eng.close()


def test_traffic_aware_precompile_bumps_cold_cells(setup):
    """precompile(traffic=...) warms only the predicted-hit cells plus the
    largest-cell fallback; a cold cell at runtime bumps UP to a warm cover."""
    cfg, params, _, _ = setup
    eng = _engine(cfg, params, max_batch=4)
    try:
        rep = eng.precompile(traffic={("decode", 2, 2)})
        # the hot cell + the (4, 4) fallback + the width-4 migration
        # fallback (a steal can hit any stream regardless of traffic)
        assert rep.compiled == 3
        assert set(rep.decode_cells) == {(2, 2), (4, 4)}
        assert rep.migrate_cells == (4,)
        assert rep.skipped == (9 - 2) + (3 - 1)
        assert eng.admit(_spec("t", 1)).admitted
        res = eng.generate("t", np.array([[1, 2, 3]], np.int32), steps=4)
        assert len(res.tokens) == 4
        decodes = _decode_meta(eng)
        assert decodes and all(
            (m["padded"], m["width"]) == (2, 2) and not m["cold"]
            for m in decodes)
    finally:
        eng.close()


def test_tune_buckets_minimizes_padding_waste(setup):
    cfg, params, _, _ = setup
    eng = _engine(cfg, params, max_batch=4)
    try:
        pb, wb = eng.tune_buckets([3, 3, 4], steps_hint=3, max_buckets=2)
        assert pb == (4, 32)   # tight cover 4 + forced max_seq
        assert wb == (1, 4)    # every need is 1 block + forced nb_max
        # rows {1,2,4} x widths {1,4} + the 2 tuned-width migration cells
        assert eng.precompile().compiled == 8
        assert eng.admit(_spec("b", 1)).admitted
        res = eng.generate("b", np.array([[1, 2, 3]], np.int32), steps=4)
        assert len(res.tokens) == 4
    finally:
        eng.close()


def test_pool_exhaustion_rejects_before_dispatch(setup):
    cfg, params, _, _ = setup
    eng = _engine(cfg, params, max_batch=2, kv_blocks=3)  # scratch + 2 blocks
    try:
        assert eng.admit(_spec("big", 1)).admitted
        with pytest.raises(OutOfBlocksError):
            # needs ceil((17+6)/8) = 3 blocks, only 2 available
            eng.generate("big", np.zeros((1, 17), np.int32), steps=6)
        assert eng._paged[0].mgr.blocks_in_use == 1  # nothing leaked
        assert eng.pool.servers[0].stats.completed == 0  # no device call
    finally:
        eng.close()




def test_remove_frees_held_blocks(setup):
    """A stream removed while it still holds a reservation gives its
    blocks back."""
    cfg, params, _, _ = setup
    eng = _engine(cfg, params, max_batch=2)
    try:
        assert eng.admit(_spec("r", 1)).admitted
        eng._paged_reserve(0, "r", 5, 3, 8)
        assert eng.kv_blocks_in_use() == 1  # 8 tokens of 8-token blocks
        eng.remove("r")
        assert eng.kv_blocks_in_use() == 0
    finally:
        eng.close()
