"""The port's serving engine on the SSM cache family (the mamba2 case of
test_paged_families.py): ``ServeEngine(batching=True, paged=True)`` with
each stream's constant-size state in a slab of the server's slab pools.

The bar: paged batched greedy tokens equal the unbatched dense path's and
the JAX engine's on the same weights and prompts; each stream holds a slab
of its own (never the scratch slab) and the rest of the pool keeps its
bits; afterwards every pool kind reads zero in ``kv_usage``; decode calls
are recorded under the family-tagged kind ``decode@ssm``.

Config: mamba2-780m reduced, fp32, on the CPU (every kernel takes its
plain version there).
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


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_config("mamba2_780m").reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("mamba2_780m").reduced(),
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
          "device": "cpu", **kw}
    return ServeEngine(cfg, params, **kw)


def test_four_streams_two_servers_match_unbatched_and_jax(setup):
    cfg, params, jcfg, jparams = setup
    prompts = _prompts(2, 5, 9, 20)
    want = _reference_tokens(cfg, params, prompts)
    eng = _engine(cfg, params, num_servers=2)
    jeng = JaxServeEngine(jcfg, jparams, max_seq=32, num_servers=2,
                          batching=True, max_batch=4, paged=True)
    try:
        assert eng._family == "ssm" and eng.width_buckets == (0,)
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
        assert {m["kind"] for m in meta} == {"prefill@ssm", "decode@ssm"}
        assert all(m["width"] == 0 for m in meta if m["kind"] == "decode@ssm")
    finally:
        eng.close()
        jeng.close()


def test_streams_hold_their_own_slabs(setup):
    """Two streams on one server on distinct, non-adjacent slabs (a held
    slab between them): tokens equal unbatched, neither uses the scratch
    slab, and the held slab's state keeps its bits."""
    cfg, params, _, _ = setup
    prompts = _prompts(4, 11)
    want = _reference_tokens(cfg, params, prompts)
    eng = _engine(cfg, params, num_servers=1)
    try:
        eng.precompile(prompt_buckets=(4, 16))
        state = eng._paged[0]
        holes = [eng._paged_reserve(0, f"hole{i}", 1, 1, 1) for i in range(3)]
        eng._paged_release(0, holes[1][0])  # frees the middle slab
        held = holes[2][2]
        conv0, state0 = (t[:, held].clone() for t in state.pools["layers"])
        used = []
        reserve = eng._paged_reserve

        def spy(*args):
            out = reserve(*args)
            used.append(out[2])
            return out

        eng._paged_reserve = spy
        for i, n in enumerate(prompts):
            assert eng.admit(_spec(n, 2 - i)).admitted
        got = _run_streams(eng, prompts)
        assert {n: r.tokens for n, r in got.items()} == want
        assert len(set(used)) == 2 and abs(used[0] - used[1]) > 1
        assert state.scratch_slab not in used
        for t, before in zip(state.pools["layers"], (conv0, state0)):
            assert torch.equal(t[:, held], before)
        for seq_id, *_ in (holes[0], holes[2]):
            eng._paged_release(0, seq_id)
        assert eng.kv_usage() == ZERO
        assert not any(m["cold"] for s in eng.pool.servers
                       for m in s.stats.batch_meta)
    finally:
        eng.close()


def test_reservation_takes_a_slab_and_no_block(setup):
    cfg, params, _, _ = setup
    eng = _engine(cfg, params, num_servers=1)
    try:
        state = eng._paged[0]
        assert state.nb_max == 0 and state.mgr.num_blocks == 0
        assert state.mgr.num_slabs == 2 * 4 + 2
        seq_id, table, slab, seg = eng._paged_reserve(0, "probe", 5, STEPS, 8)
        assert table.shape == (0,) and slab != state.scratch_slab
        assert seg == state.scratch_seg
        assert eng.kv_usage() == {"blocks": 0, "slabs": 1, "segments": 0}
        eng._paged_release(0, seq_id)
        eng.remove("probe")
        assert eng.kv_usage() == ZERO
    finally:
        eng.close()


def test_precompile_walks_the_width_zero_cells(setup):
    cfg, params, _, _ = setup
    eng = _engine(cfg, params, num_servers=1)
    try:
        rep = eng.precompile(prompt_buckets=(8,))
        assert set(rep.decode_cells) == {(1, 0), (2, 0), (4, 0)}
        assert set(rep.prefill_cells) == {(1, 8), (2, 8), (4, 8)}
        assert eng.precompile(prompt_buckets=(8,)).compiled == 0
        layers = eng._paged[0].pools["layers"]
        assert tuple(layers[1].shape) == (cfg.num_layers, 10, cfg.ssm_nheads,
                                          cfg.ssm_head_dim, cfg.ssm_state_dim)
        assert layers[1].dtype == torch.float32
    finally:
        eng.close()
