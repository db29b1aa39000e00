"""The port's paged engine over every cache family it serves, with live
migration: test_paged_families.py re-run on the port, plus the bytes of a
migration held exactly.

Families: GQA KV blocks (internlm2), MLA latent blocks with the dense
prefix layer's pools (deepseek-v2-lite), SSM state slabs (mamba2), hybrid
blocks + slabs (zamba2), enc-dec blocks + shared cross segments (whisper)
and the VLM backbone's GQA blocks at group size 6 (qwen2-vl, served from
tokens).

The bar, per family: greedy tokens through the paged engine equal the
unbatched dense path's; a live migration mid-decode keeps them, and they
equal the JAX engine's migrated run; a migration copies every row of the
stream's blocks, slab and segment bit for bit into the destination's own
pool tensors (the ones its graphs read) and writes nothing else but the
destination's scratch; after the streams drain the per-kind leak probe
(``kv_usage``) reads zero everywhere.  For the enc-dec family, streams
share one cross segment per server, and a migrated stream joins the
segment of its key already resident on the destination.

Configs: each family's reduced config, fp32 (the VLM with M-RoPE sections
(2, 3, 3)), on the CPU (every kernel takes its plain version there).
"""

import dataclasses

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
from repro_torch.serving.engine import ServeEngine, StreamSpec

STEPS = 4
ZERO = {"blocks": 0, "slabs": 0, "segments": 0}
KINDS = {"block": "blocks", "slab": "slabs", "segment": "segments"}
FAMILY_ARCHS = {
    "gqa": ("internlm2_1_8b", {}),
    "mla": ("deepseek_v2_lite_16b", {}),
    "ssm": ("mamba2_780m", {}),
    "hybrid": ("zamba2_7b", {}),
    "encdec": ("whisper_medium", {}),
    "vlm": ("qwen2_vl_2b", {"mrope_sections": (2, 3, 3)}),
}
PROMPT = np.array([[1, 2, 3, 4, 5]], np.int32)


def _configs(family):
    arch, kw = FAMILY_ARCHS[family]
    jcfg, cfg = (dataclasses.replace(get(arch).reduced(), dtype="float32",
                                     **kw)
                 for get in (jax_config, get_config))
    jparams = jax.jit(JM.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(3))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, params, jcfg, jparams


@pytest.fixture(scope="module", params=sorted(FAMILY_ARCHS))
def setup(request):
    return (*_configs(request.param), request.param)


@pytest.fixture(scope="module")
def encdec():
    return _configs("encdec")


def _spec(name, prio, cls=StreamSpec):
    return cls(name=name, priority=prio, period_ms=8000.0, deadline_ms=8000.0,
               prefill_ms=50.0, decode_ms=5.0, decode_steps=STEPS)


def _reference_tokens(cfg, params, prompt):
    eng = ServeEngine(cfg, params, max_seq=32, device="cpu")
    try:
        assert eng.admit(_spec("ref", 1)).admitted
        return eng.generate("ref", prompt, steps=STEPS).tokens
    finally:
        eng.close()


def _paged_engine(cfg, params, *, num_servers=2, cls=ServeEngine, **kw):
    if cls is ServeEngine:
        kw["device"] = "cpu"
    return cls(cfg, params, max_seq=32, num_servers=num_servers,
               batching=True, max_batch=4, paged=True, kv_block_size=8, **kw)


def _migrate(eng, name):
    """Place a migration intent for ``name`` onto the other server;
    returns (source, destination)."""
    src = eng.pool.server_of(name)
    dst = 1 - src
    decision, d = eng.admission.migrate(name, dst)
    assert decision.admitted and d == dst
    assert eng.pool.request_migration(name, dst)
    return src, dst


def _fill(pools, gen):
    """Random content in every pool leaf, in place."""
    for leaf in (t for v in pools.values() for t in v):
        leaf.copy_(torch.randn(leaf.shape, generator=gen).to(leaf.dtype))


def _pool_rows(eng, pools, blocks, slab, seg):
    """The rows of one stream in every pool leaf, in ``_pool_kinds``
    order."""
    out = []
    for key, kind in eng._pool_kinds.items():
        for leaf in pools[key]:
            idx = {"block": list(blocks), "slab": [slab], "segment": [seg]}
            out.append(leaf[:, idx[kind]].clone())
    return out


class TestPagedFamiliesEngine:
    def test_greedy_tokens_and_migration_bit_identical(self, setup):
        cfg, params, jcfg, jparams, family = setup
        want = _reference_tokens(cfg, params, PROMPT)
        jeng = _paged_engine(jcfg, jparams, cls=JaxServeEngine)
        try:
            assert jeng.admit(_spec("s0", 1, cls=JaxStreamSpec)).admitted
            _migrate(jeng, "s0")
            jax_tokens = jeng.generate("s0", PROMPT, steps=STEPS).tokens
            assert jeng.migrations_completed == 1
        finally:
            jeng.close()
        eng = _paged_engine(cfg, params)
        try:
            assert eng.admit(_spec("s0", 1)).admitted
            assert eng.generate("s0", PROMPT, steps=STEPS).tokens == want
            # live migration at a step boundary: the same tokens
            src, dst = _migrate(eng, "s0")
            got = eng.generate("s0", PROMPT, steps=STEPS).tokens
            assert got == want == jax_tokens
            assert eng.migrations_completed == 1
            assert eng.pool.server_of("s0") == dst
            kinds = {m["kind"] for s in eng.pool.servers
                     for m in s.stats.batch_meta}
            assert eng._migrate_kind in kinds
            # drained: every pool kind back to zero (scratch excluded)
            assert eng.kv_usage() == ZERO
            assert all(len(st.free) == eng.max_batch for st in eng._slots)
        finally:
            eng.close()

    def test_migration_copies_rows_exactly(self, setup):
        """``_execute_migration`` on random pool content: the stream's
        blocks, slab and segment land on the destination bit for bit, in
        the destination's own pool tensors, and no other destination row
        changes but the scratch ones; the source side is freed."""
        cfg, params, _, _, family = setup
        eng = _paged_engine(cfg, params)
        try:
            assert eng.admit(_spec("s0", 1)).admitted
            seq_id, table, slab, seg = eng._paged_reserve(0, "s0", 5, STEPS,
                                                          8)
            src, dst = eng._paged
            n = len(src.mgr.seqs[seq_id].blocks)
            gen = torch.Generator().manual_seed(0)
            for st in (src, dst):
                st.pools = eng._make_pools(st)
                _fill(st.pools, gen)
            ptrs = [t.data_ptr() for v in dst.pools.values() for t in v]
            before = [t.clone() for v in dst.pools.values() for t in v]
            want = _pool_rows(eng, src.pools, table[:n], slab, seg)
            new_table, new_slab, new_seg = eng._execute_migration(
                "s0", seq_id, 0, 1, 0)
            assert seq_id not in src.mgr.seqs
            assert [t.data_ptr() for v in dst.pools.values()
                    for t in v] == ptrs
            got = _pool_rows(eng, dst.pools, new_table[:n], new_slab,
                             new_seg)
            for g, w in zip(got, want, strict=True):
                assert torch.equal(g, w)
            touched = {"block": set(new_table[:n]) | {dst.scratch_block},
                       "slab": {new_slab, dst.scratch_slab},
                       "segment": {new_seg, dst.scratch_seg}}
            leaves = iter(before)
            for key, kind in eng._pool_kinds.items():
                for leaf in dst.pools[key]:
                    old = next(leaves)
                    keep = [i for i in range(leaf.shape[1])
                            if i not in touched[kind]]
                    assert torch.equal(leaf[:, keep], old[:, keep])
            assert eng.migrations_completed == 1
            eng._paged_release(1, seq_id)
            eng.remove("s0")
            assert eng.kv_usage() == ZERO
        finally:
            eng.close()

    def test_leak_probe_reports_per_kind(self, setup):
        """The kinds the family uses show up in kv_usage() while a
        reservation is live, and only those kinds."""
        cfg, params, _, _, family = setup
        eng = _paged_engine(cfg, params, num_servers=1)
        try:
            used_kinds = {KINDS[k] for k in eng._cache_kinds}
            seq_id, table, slab, seg = eng._paged_reserve(
                0, "probe", 5, STEPS, 8)
            usage = eng.kv_usage()
            for kind in ("blocks", "slabs", "segments"):
                if kind in used_kinds:
                    assert usage[kind] > 0, kind
                else:
                    assert usage[kind] == 0, kind
            state = eng._paged[0]
            if "block" in eng._cache_kinds:
                assert table[0] != state.scratch_block
            if "slab" in eng._cache_kinds:
                assert slab != state.scratch_slab
            if "segment" in eng._cache_kinds:
                assert seg != state.scratch_seg
            eng._paged_release(0, seq_id)
            eng.remove("probe")
            assert eng.kv_usage() == ZERO
        finally:
            eng.close()


class TestSharedSegments:
    def test_shared_segment_dedup_across_streams(self, encdec):
        """Two concurrent reservations share one cross segment (the
        engine's constant frames stub makes every stream's encoder content
        the same -- the COW-dedup case)."""
        cfg, params, _, _ = encdec
        eng = _paged_engine(cfg, params, num_servers=1)
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

    def test_migrated_stream_joins_the_resident_segment(self, encdec):
        """A stream migrating onto a server where its key is resident joins
        that segment (refcount 2, still one segment there), and both
        streams' tokens stay the unmigrated ones."""
        cfg, params, _, _ = encdec
        want = _reference_tokens(cfg, params, PROMPT)
        eng = _paged_engine(cfg, params)
        try:
            for n in ("mover", "resident"):
                assert eng.admit(_spec(n, 1)).admitted
            assert eng.pool.server_of("mover") != eng.pool.server_of(
                "resident")
            dst_si = eng.pool.server_of("resident")
            dst = eng._paged[dst_si]
            sid, _, _, seg = eng._paged_reserve(dst_si, "resident", 5, STEPS,
                                                8)
            _migrate(eng, "mover")
            assert eng.generate("mover", PROMPT, steps=STEPS).tokens == want
            assert eng.pool.server_of("mover") == dst_si
            joined = [m for m in eng.pool.servers[dst_si].stats.batch_meta
                      if m["kind"] == "migrate@encdec"]
            assert joined and joined[0]["side"] == "import"
            assert dst.mgr.segments_in_use - 1 == 1  # scratch aside
            eng._paged_release(dst_si, sid)
            assert eng.generate("resident", PROMPT, steps=STEPS).tokens == want
            assert eng.kv_usage() == ZERO
        finally:
            eng.close()

    def test_segment_import_reuses_the_resident_row(self, encdec):
        """The manager-level join: ``_execute_migration`` onto a server
        holding the key returns that server's segment id."""
        cfg, params, _, _ = encdec
        eng = _paged_engine(cfg, params)
        try:
            assert eng.admit(_spec("s0", 1)).admitted
            sid, _, _, _ = eng._paged_reserve(0, "s0", 5, STEPS, 8)
            other, _, _, seg = eng._paged_reserve(1, "t0", 5, STEPS, 8)
            for st in eng._paged:
                st.pools = eng._make_pools(st)
            _, _, new_seg = eng._execute_migration("s0", sid, 0, 1, 0)
            assert new_seg == seg
            assert eng._paged[1].mgr.segment_refcount[seg] == 2
            eng._paged_release(1, sid)
            eng._paged_release(1, other)
            eng.remove("s0")
            eng.remove("t0")
            assert eng.kv_usage() == ZERO
        finally:
            eng.close()
