"""The port's serving engine on the enc-dec cache family (the whisper case
of test_paged_families.py, migration aside): ``ServeEngine(batching=True,
paged=True)`` with each stream holding blocks of the decoder's self-KV
block pools and a reference to ONE cross-attention segment that every
stream of the server shares (the engine encodes the same zero frames for
every prompt: the copy-on-write dedup case), both staged in every decode
call.

The bar: paged batched greedy tokens equal the unbatched dense path's and
the JAX engine's on the same weights and prompts; each server holds
exactly one segment while its streams run; afterwards every pool kind
reads zero in ``kv_usage``; calls are recorded under the family-tagged
kinds ``prefill@encdec`` and ``decode@encdec``.  Migration, and a
migrated stream joining a resident segment, are held in
test_torch_paged_families.py.

Config: whisper-medium reduced (2 + 2 layers, d 64, 16 frames) and the
same with 20 frames and group size 1, fp32, on the CPU (every kernel
takes its plain version there).
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
KINDS = {"block": "blocks", "slab": "slabs", "segment": "segments"}
SHAPES = {"reduced": {}, "enc20_g1": dict(encoder_seq=20, num_kv_heads=4)}


@pytest.fixture(scope="module", params=sorted(SHAPES))
def setup(request):
    jcfg, cfg = (dataclasses.replace(get("whisper_medium").reduced(),
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


def _run_streams(eng, prompts, during=None):
    """Each stream on its own thread.  With ``during``, every stream waits
    after its reservation until all have reserved and ``during()`` has
    run, so it sees every reservation live."""
    results = {}
    if during is not None:
        reserved = threading.Barrier(len(prompts) + 1)
        probed = threading.Event()
        reserve = eng._paged_reserve

        def reserve_then_wait(*args):
            out = reserve(*args)
            reserved.wait(timeout=60)
            probed.wait(timeout=60)
            return out

        eng._paged_reserve = reserve_then_wait

    def worker(n):
        results[n] = eng.generate(n, prompts[n], steps=STEPS)

    threads = [threading.Thread(target=worker, args=(n,)) for n in prompts]
    for t in threads:
        t.start()
    if during is not None:
        reserved.wait(timeout=60)
        during()
        probed.set()
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
    """Four streams on two servers: tokens equal unbatched ``generate``'s
    and the JAX engine's; while all four hold their reservations each
    server holds exactly one segment; afterwards nothing is held."""
    cfg, params, jcfg, jparams = setup
    prompts = _prompts(2, 5, 9, 20)
    want = _reference_tokens(cfg, params, prompts)
    eng = _engine(cfg, params, num_servers=2)
    jeng = JaxServeEngine(jcfg, jparams, max_seq=32, num_servers=2,
                          batching=True, max_batch=4, paged=True,
                          kv_block_size=8)
    try:
        assert eng._family == "encdec"
        assert eng._cache_kinds == {"block", "segment"}
        for i, n in enumerate(prompts):
            assert eng.admit(_spec(n, 4 - i)).admitted
            assert jeng.admit(_spec(n, 4 - i, JaxStreamSpec)).admitted
        assert {eng.pool.server_of(n) for n in prompts} == {0, 1}
        held = []

        def probe():
            held.append([st.mgr.segments_in_use - 1 for st in eng._paged])

        got = _run_streams(eng, prompts, during=probe)
        jax_got = _run_streams(jeng, prompts)
        assert held == [[1, 1]]  # one shared segment per server
        for n in prompts:
            assert got[n].tokens == want[n], n
            assert got[n].tokens == jax_got[n].tokens, n
            assert len(got[n].decode_latencies_s) == STEPS
        assert eng.kv_usage() == jeng.kv_usage() == ZERO
        meta = [m for s in eng.pool.servers for m in s.stats.batch_meta]
        assert {m["kind"] for m in meta} == {"prefill@encdec",
                                             "decode@encdec"}
        assert all(m["width"] > 0 for m in meta
                   if m["kind"] == "decode@encdec")
    finally:
        eng.close()
        jeng.close()


def test_leak_probe_reports_per_kind(setup):
    """While a reservation is live, kv_usage() shows blocks and segments
    (the kinds the family uses) and no slabs; the reservation holds real
    blocks and a real segment, never the scratch ones."""
    cfg, params, _, _ = setup
    eng = _engine(cfg, params, num_servers=1)
    try:
        state = eng._paged[0]
        assert state.mgr.num_segments == 4 + 2
        assert state.mgr.num_slabs == 0
        used_kinds = {KINDS[k] for k in eng._cache_kinds}
        seq_id, table, slab, seg = eng._paged_reserve(0, "probe", 5, STEPS, 8)
        usage = eng.kv_usage()
        for kind in ("blocks", "slabs", "segments"):
            assert (usage[kind] > 0) == (kind in used_kinds), kind
        assert usage["segments"] == 1
        assert table[0] != state.scratch_block
        assert seg != state.scratch_seg
        assert slab == state.scratch_slab
        eng._paged_release(0, seq_id)
        eng.remove("probe")
        assert eng.kv_usage() == ZERO
    finally:
        eng.close()


def test_shared_segment_dedup_across_streams(setup):
    """Two concurrent reservations share ONE cross segment (the engine's
    constant frames stub makes every stream's encoder content identical):
    the segment stays while either holds it."""
    cfg, params, _, _ = setup
    eng = _engine(cfg, params, num_servers=1)
    try:
        sid_a, _, _, seg_a = eng._paged_reserve(0, "a", 4, STEPS, 8)
        sid_b, _, _, seg_b = eng._paged_reserve(0, "b", 4, STEPS, 8)
        assert seg_a == seg_b  # deduped by content key
        assert eng.kv_usage()["segments"] == 1
        eng._paged_release(0, sid_a)
        assert eng.kv_usage()["segments"] == 1  # b still holds it
        eng._paged_release(0, sid_b)
        assert eng.kv_usage()["segments"] == 0
        eng.remove("a")
        eng.remove("b")
    finally:
        eng.close()


def test_streams_hold_their_own_blocks_and_share_a_segment(setup):
    """Two streams on one server after precompile, with a held reservation
    between them: tokens equal unbatched; their blocks are their own, never
    the scratch or the held ones, which keep their bits; both streams
    address the held reservation's segment, whose content is the encoder
    output of the zero frames (every insert rewrites the same values), and
    no other segment is written."""
    cfg, params, _, _ = setup
    prompts = _prompts(4, 11)
    want = _reference_tokens(cfg, params, prompts)
    eng = _engine(cfg, params, num_servers=1)
    try:
        eng.precompile(prompt_buckets=(4, 16))
        state = eng._paged[0]
        held_id, held_table, _, held_seg = eng._paged_reserve(0, "held", 1,
                                                              1, 1)
        held_blocks = [b for b in held_table if b != state.scratch_block]
        self0 = [t[:, held_blocks].clone() for t in state.pools["self"]]
        free = [i for i in range(state.mgr.num_segments)
                if i not in (held_seg, state.scratch_seg)]
        cross0 = [t[:, free].clone() for t in state.pools["cross"]]
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
        assert len(used) == 2 and all(blocks) and not blocks[0] & blocks[1]
        assert not (blocks[0] | blocks[1]) & set(held_blocks)
        assert [seg for _, _, _, seg in used] == [held_seg, held_seg]
        for t, before in zip(state.pools["self"], self0):
            assert torch.equal(t[:, held_blocks], before)
        for t, before in zip(state.pools["cross"], cross0):
            assert torch.equal(t[:, free], before)
        _, cache, _ = eng._prefill(np.zeros((1, 4), np.int32))
        for pool, leaf in zip(state.pools["cross"], cache["cross"]):
            torch.testing.assert_close(pool[:, held_seg], leaf[:, 0])
        eng._paged_release(0, held_id)
        assert eng.kv_usage() == ZERO
        assert not any(m["cold"] for s in eng.pool.servers
                       for m in s.stats.batch_meta)
    finally:
        eng.close()


def test_precompile_builds_both_pool_kinds(setup):
    """precompile walks every (rows, width) cell and allocates the two pool
    kinds: self-KV blocks per decoder layer and max_batch + 2 cross
    segments of encoder_seq frames."""
    cfg, params, _, _ = setup
    eng = _engine(cfg, params, num_servers=1)
    try:
        rep = eng.precompile(prompt_buckets=(8,))
        assert set(rep.decode_cells) == {(r, w) for r in (1, 2, 4)
                                         for w in (1, 2, 4)}
        assert set(rep.prefill_cells) == {(1, 8), (2, 8), (4, 8)}
        pools = eng._paged[0].pools
        assert tuple(pools["self"][0].shape) == (
            cfg.num_layers, 17, 8, cfg.num_kv_heads, cfg.head_dim)
        assert tuple(pools["cross"][1].shape) == (
            cfg.num_layers, 6, cfg.encoder_seq, cfg.num_kv_heads,
            cfg.head_dim)
    finally:
        eng.close()
