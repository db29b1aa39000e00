"""The port's live cache migration, work stealing and elastic pool
(``ServeEngine.rebalance_once`` / ``consolidate`` / ``add_server`` /
``remove_server``, ``runtime.elastic.ElasticPoolController``):
test_migration.py's engine cases re-run on the port.

Every end-to-end case holds two invariants: greedy tokens equal a run
that never migrated, and nothing leaks -- after the streams drain,
``kv_blocks_in_use()`` is 0 and every surviving server has all its slots
free.  A manual migration also gives the JAX engine's tokens, and a
``remove`` that races a migration frees each side exactly once.

Config: internlm2-1.8b reduced, fp32, on the CPU (every kernel takes its
plain version there).
"""

import dataclasses
import threading
import time

import jax
import numpy as np
import pytest

from repro.configs.registry import get_config as jax_config
from repro.models import model as JM
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro.serving.engine import StreamSpec as JaxStreamSpec
from repro_torch.configs.registry import get_config
from repro_torch.core.faults import StreamShedError
from repro_torch.params import params_from_numpy
from repro_torch.runtime.elastic import ElasticPoolController, LoadTrajectory
from repro_torch.serving.engine import ServeEngine, StreamSpec
from repro_torch.serving.kvcache import OutOfBlocksError

STEPS = 6
PROMPT8 = np.array([[1, 2, 3, 4, 5, 6, 7, 8]], np.int32)


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
    return cls(name=name, priority=prio, period_ms=8000.0,
               deadline_ms=8000.0, prefill_ms=50.0, decode_ms=5.0,
               decode_steps=steps)


def _reference_tokens(cfg, params, prompt, steps=STEPS):
    eng = ServeEngine(cfg, params, max_seq=32, device="cpu")
    try:
        assert eng.admit(_spec("ref", 1, steps=steps)).admitted
        return eng.generate("ref", prompt, steps=steps).tokens
    finally:
        eng.close()


def _engine(cfg, params, *, num_servers=2, max_batch=4):
    return ServeEngine(cfg, params, max_seq=32, num_servers=num_servers,
                       batching=True, max_batch=max_batch, paged=True,
                       kv_block_size=8, device="cpu")


def _migrated_job(eng, spec, prompt):
    """Place a migration intent for ``spec``'s stream before its job: the
    stream's thread moves its cache at the first decode-step boundary.
    Returns (tokens, source server, destination server)."""
    assert eng.admit(spec).admitted
    src = eng.pool.server_of(spec.name)
    dst = 1 - src
    decision, d = eng.admission.migrate(spec.name, dst)
    assert decision.admitted and d == dst
    assert eng.pool.request_migration(spec.name, dst)
    return eng.generate(spec.name, prompt, steps=STEPS).tokens, src, dst


def _run_streams(eng, prompts, steps=STEPS):
    out = {}

    def worker(n):
        try:
            out[n] = eng.generate(n, prompts[n], steps=steps)
        except Exception as e:  # noqa: BLE001 - recorded for assertions
            out[n] = e

    threads = [threading.Thread(target=worker, args=(n,)) for n in prompts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return out


def _assert_no_leaks(eng):
    assert eng.kv_blocks_in_use() == 0
    for si in eng.pool.alive_servers():
        assert len(eng._slots[si].free) == eng.max_batch


class TestEngineMigration:
    def test_manual_migration_bit_identical(self, setup):
        """A migration intent placed before the run moves the stream's
        blocks mid-decode; tokens match the never-migrated reference and
        the JAX engine's migrated run, nothing leaks on either server, and
        each side records its half of the copy."""
        cfg, params, jcfg, jparams = setup
        want = _reference_tokens(cfg, params, PROMPT8)
        jeng = JaxServeEngine(jcfg, jparams, max_seq=32, num_servers=2,
                              batching=True, max_batch=4, paged=True,
                              kv_block_size=8)
        try:
            jax_tokens, _, _ = _migrated_job(
                jeng, _spec("s0", 1, cls=JaxStreamSpec), PROMPT8)
            assert jeng.migrations_completed == 1
        finally:
            jeng.close()
        eng = _engine(cfg, params)
        try:
            tokens, src, dst = _migrated_job(eng, _spec("s0", 1), PROMPT8)
            assert tokens == want == jax_tokens
            assert eng.migrations_completed == 1
            assert eng.pool.server_of("s0") == dst
            assert eng.admission.device_of("s0") == dst
            _assert_no_leaks(eng)
            sides = {}
            for si in (src, dst):
                for m in eng.pool.servers[si].stats.batch_meta:
                    if m["kind"] == "migrate":
                        sides[m["side"]] = (si, m)
            assert sides["export"][0] == src and sides["import"][0] == dst
            exp = sides["export"][1]
            # 8 + 6 tokens in blocks of 8: 2 blocks, k and v of every layer
            assert exp["rows"] == 2 and exp["padded"] == 2
            leaf = cfg.num_kv_heads * cfg.head_dim * 8 * 4  # fp32 block row
            assert exp["nbytes"] == 2 * cfg.num_layers * 2 * leaf
            # the moved stream keeps serving from the destination
            assert eng.generate("s0", PROMPT8, steps=STEPS).tokens == want
            _assert_no_leaks(eng)
        finally:
            eng.close()

    def test_work_stealing_rebalances_live(self, setup):
        """All streams pinned on one server, the other idle: a rebalance
        pass steals at least one mid-flight stream, tokens stay exact, and
        the ledger drains to zero."""
        cfg, params, _, _ = setup
        prompt = np.array([[1, 2, 3, 4]], np.int32)
        steps = 12
        want = _reference_tokens(cfg, params, prompt, steps=steps)
        eng = _engine(cfg, params)
        try:
            names = [f"s{i}" for i in range(3)]
            for i, n in enumerate(names):
                assert eng.admit(_spec(n, i + 1, steps=steps)).admitted
            for n in names:  # pin everything onto server 0
                if eng.admission.device_of(n) != 0:
                    assert eng.admission.migrate(n, 0)[1] == 0
                eng.pool.reassign(n, 0, priority=eng._streams[n].priority)
            gate = threading.Event()
            run_batch = eng._run_paged_decode

            def held_decode(si):
                """Server 0's decode waits until the pass has run, so every
                stream is mid-flight when it looks."""
                run = run_batch(si)

                def gated(payloads):
                    gate.wait(timeout=60)
                    return run(payloads)

                return gated

            eng._run_paged_decode = held_decode
            out = {}

            def worker(n):
                out[n] = eng.generate(n, prompt, steps=steps)

            threads = [threading.Thread(target=worker, args=(n,))
                       for n in names]
            for t in threads:
                t.start()
            deadline = time.monotonic() + 60
            while (len(eng._active_jobs) < len(names)
                   and time.monotonic() < deadline):
                time.sleep(0.001)
            stolen = eng.rebalance_once()
            gate.set()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            assert stolen >= 1
            assert eng.migrations_completed >= 1
            for n in names:
                assert out[n].tokens == want, n
            _assert_no_leaks(eng)
        finally:
            eng.close()
            vars(eng).pop("_run_paged_decode", None)

    def test_steal_loop_under_fault_tolerance_tick(self, setup):
        """enable_work_stealing piggybacks on the heartbeat tick when fault
        tolerance is on; a full concurrent run keeps its tokens and leaks
        nothing."""
        cfg, params, _, _ = setup
        prompt = np.array([[1, 2, 3, 4]], np.int32)
        want = _reference_tokens(cfg, params, prompt)
        eng = _engine(cfg, params)
        eng.enable_fault_tolerance(heartbeat_timeout_s=30.0, poll_s=0.005)
        eng.enable_work_stealing()
        assert eng.pool._monitor.on_tick is not None
        try:
            names = [f"s{i}" for i in range(4)]
            for i, n in enumerate(names):
                assert eng.admit(_spec(n, i + 1)).admitted
            out = _run_streams(eng, {n: prompt for n in names})
            for n in names:
                assert not isinstance(out[n], Exception), out[n]
                assert out[n].tokens == want, n
            _assert_no_leaks(eng)
        finally:
            eng.close()

    def test_stealing_stress_keeps_tokens_and_ledger(self, setup):
        """Twelve streams (more than the host's cores) pinned on one of
        three servers of twelve slots each, stealing every 5 ms, the
        interpreter switching threads every 10 us: every stream keeps the
        unmigrated tokens and the ledger, the pools and the slots drain."""
        import sys

        cfg, params, _, _ = setup
        prompt = np.array([[3, 1, 4, 1, 5]], np.int32)
        want = _reference_tokens(cfg, params, prompt)
        eng = _engine(cfg, params, num_servers=3, max_batch=12)
        interval = sys.getswitchinterval()
        try:
            names = [f"x{i}" for i in range(12)]
            for n in names:
                assert eng.admit(_spec(n, 1)).admitted
                if eng.admission.device_of(n) != 0:
                    assert eng.admission.migrate(n, 0)[1] == 0
                eng.pool.reassign(n, 0, priority=1)
            eng.enable_work_stealing(interval_s=0.005)
            sys.setswitchinterval(1e-5)
            out = _run_streams(eng, {n: prompt for n in names})
        finally:
            sys.setswitchinterval(interval)
            eng.close()
        for n in names:
            assert not isinstance(out[n], Exception), out[n]
            assert out[n].tokens == want, n
        assert eng.migrations_completed >= 1
        assert not any(eng._held.values())
        _assert_no_leaks(eng)

    def test_steal_timer_stops_on_close(self, setup):
        """Without fault tolerance, work stealing runs its own timer
        thread, and close() stops it."""
        cfg, params, _, _ = setup
        eng = _engine(cfg, params)
        eng.enable_work_stealing(interval_s=0.01)
        timer = next(t for t in threading.enumerate()
                     if t.name == "steal-rebalance")
        eng.close()
        timer.join(timeout=5)
        assert not timer.is_alive()

    def test_remove_race_frees_both_sides_once(self, setup):
        """The remove()-during-migration race, replayed deterministically:
        the stream is removed while the gather is in flight.  remove()
        frees both ledger sides; the migration's commit must observe the
        empty ledger and raise instead of freeing twice."""
        cfg, params, _, _ = setup
        eng = _engine(cfg, params)
        try:
            assert eng.admit(_spec("s0", 1)).admitted
            seq_id, _, _, _ = eng._paged_reserve(0, "s0", 4, STEPS, 8)
            assert eng.kv_blocks_in_use() > 0
            src = eng._paged[0]
            src.pools = eng._make_pools(src)
            real_export = eng._export_call
            fired = []
            frees = []
            for st in eng._paged:
                free = st.mgr.free_seq

                def counted(seq, missing_ok=False, free=free):
                    frees.append(seq in free.__self__.seqs)
                    return free(seq, missing_ok=missing_ok)

                st.mgr.free_seq = counted

            def export_and_remove(si, idx, w):
                out = real_export(si, idx, w)
                if not fired:
                    fired.append(True)
                    eng.remove("s0")  # lands mid-copy, before commit
                return out

            eng._export_call = export_and_remove
            with pytest.raises(StreamShedError, match="removed"):
                eng._execute_migration("s0", seq_id, 0, 1, 0)
            assert fired
            assert eng.kv_blocks_in_use() == 0  # freed once, by remove()
            assert frees.count(True) == 2  # one real free per side
            assert eng.migrations_completed == 0
        finally:
            vars(eng).pop("_export_call", None)
            eng.close()

    def test_migration_to_full_destination_aborts_clean(self, setup):
        """Destination pool exhaustion aborts the move all-or-nothing: the
        stream keeps its source blocks and the destination stays empty."""
        cfg, params, _, _ = setup
        eng = _engine(cfg, params)
        try:
            assert eng.admit(_spec("s0", 1)).admitted
            seq_id, _, _, _ = eng._paged_reserve(0, "s0", 4, STEPS, 8)
            src = eng._paged[0]
            src.pools = eng._make_pools(src)
            src_used = src.mgr.blocks_in_use
            dst = eng._paged[1]
            hog = dst.mgr.allocate("hog#0", dst.mgr.num_blocks
                                   * dst.mgr.block_size - dst.mgr.block_size)
            assert hog
            with pytest.raises(OutOfBlocksError):
                eng._execute_migration("s0", seq_id, 0, 1, 0)
            assert eng._paged[0].mgr.blocks_in_use == src_used
            assert seq_id not in dst.mgr.seqs
            dst.mgr.free_seq("hog#0")
            eng._paged_release(0, seq_id)
            eng.remove("s0")
            assert eng.kv_blocks_in_use() == 0
        finally:
            eng.close()


class TestElastic:
    def test_steal_into_a_draining_server_is_dropped(self, setup):
        """A steal asked for before its destination began to drain is
        dropped at the stream's next step boundary: the stream stays on
        its server (moving it into the draining one would leave that
        server a stream its drain has already re-placed, and
        ``remove_server`` would wait for it forever)."""
        cfg, params, _, _ = setup
        want = _reference_tokens(cfg, params, PROMPT8)
        eng = _engine(cfg, params)
        try:
            assert eng.admit(_spec("s0", 1)).admitted
            src = eng.pool.server_of("s0")
            dst = 1 - src
            _, d = eng.admission.migrate("s0", dst)
            assert d == dst and eng.pool.request_migration("s0", dst)
            eng.pool.begin_drain(dst)
            assert eng.generate("s0", PROMPT8, steps=STEPS).tokens == want
            assert eng.pool.server_of("s0") == src
            assert eng.pool.pending_migration("s0") is None
            assert eng.migrations_completed == 0
            _assert_no_leaks(eng)
        finally:
            eng.close()

    def test_drain_that_begins_during_the_copy_keeps_the_stream(self, setup):
        """``remove_server`` of a steal's destination, started while the
        steal's copy runs: the commit finds the destination draining (or
        already retired) and refuses it, so the stream keeps its source, the destination's
        allocation is rolled back, and the removal does not wait for the
        stream (moving it in would leave the drained server a stream its
        drain has already re-placed)."""
        cfg, params, _, _ = setup
        want = _reference_tokens(cfg, params, PROMPT8)
        eng = _engine(cfg, params)
        errors, removal = [], []

        def remove(dst):
            try:
                eng.remove_server(dst, timeout_s=30.0)
            except BaseException as e:  # noqa: BLE001 - asserted below
                errors.append(e)

        try:
            assert eng.admit(_spec("s0", 1)).admitted
            src = eng.pool.server_of("s0")
            dst = 1 - src
            _, d = eng.admission.migrate("s0", dst)
            assert d == dst and eng.pool.request_migration("s0", dst)
            import_call = eng._import_call

            def drain_mid_copy(si, *args):
                if not removal:  # the first import: the steal's copy
                    removal.append(threading.Thread(target=remove,
                                                    args=(dst,)))
                    removal[0].start()
                    deadline = time.monotonic() + 30.0
                    while (dst in eng.pool.alive_servers()
                           and dst not in eng.pool.draining()):
                        assert time.monotonic() < deadline, errors
                        time.sleep(0.001)
                return import_call(si, *args)

            eng._import_call = drain_mid_copy
            assert eng.generate("s0", PROMPT8, steps=STEPS).tokens == want
            removal[0].join(60.0)
            assert not removal[0].is_alive() and not errors, errors
            assert eng.pool.alive_servers() == [src]
            assert eng.pool.server_of("s0") == src
            assert eng.pool.pending_migration("s0") is None
            assert eng.migrations_completed == 0
            _assert_no_leaks(eng)
        finally:
            eng.close()

    def test_remove_server_when_the_job_ends_before_its_migration(
            self, setup):
        """``remove_server`` plans a live migration for a stream whose job
        is in its last decode step: the job ends on the draining server
        without reaching another step boundary, so the migration is never
        taken.  The removal binds the finished stream where the drain
        placed it instead of waiting for it until it times out."""
        cfg, params, _, _ = setup
        eng = _engine(cfg, params)
        errors, removal = [], []

        def remove(si):
            try:
                eng.remove_server(si, timeout_s=30.0)
            except BaseException as e:  # noqa: BLE001 - asserted below
                errors.append(e)

        try:
            assert eng.admit(_spec("s0", 1)).admitted
            src = eng.pool.server_of("s0")
            run_decode = eng._run_paged_decode
            calls = []

            def last_step_drains(si):
                run = run_decode(si)

                def hooked(payloads):
                    calls.append(si)
                    if len(calls) == STEPS:  # the job's last decode call
                        removal.append(threading.Thread(target=remove,
                                                        args=(src,)))
                        removal[0].start()
                        deadline = time.monotonic() + 30.0
                        while eng.pool.pending_migration("s0") is None:
                            assert time.monotonic() < deadline, errors
                            time.sleep(0.001)
                    return run(payloads)

                return hooked

            eng._run_paged_decode = last_step_drains
            eng.generate("s0", PROMPT8, steps=STEPS)
            removal[0].join(60.0)
            assert not removal[0].is_alive() and not errors, errors
            assert eng.pool.alive_servers() == [1 - src]
            assert eng.pool.server_of("s0") == 1 - src
            assert eng.pool.pending_migration("s0") is None
            assert eng.migrations_completed == 0
            _assert_no_leaks(eng)
        finally:
            eng.close()

    def test_consolidate_then_remove_server(self, setup):
        """Scale-down end to end: grow to 3 servers, consolidate server 0,
        retire it (its pools and graphs are released), and keep serving
        the same tokens from the survivors."""
        cfg, params, _, _ = setup
        want = _reference_tokens(cfg, params, PROMPT8)
        eng = _engine(cfg, params)
        try:
            eng.precompile((8,))
            names = [f"s{i}" for i in range(3)]
            for i, n in enumerate(names):
                assert eng.admit(_spec(n, i + 1)).admitted
            si = eng.add_server()
            assert si == 2
            assert set(eng.pool.alive_servers()) == {0, 1, 2}
            assert eng._paged[2].pools is not None  # warmed on its thread
            on0 = eng.pool.streams_on(0)
            moved = eng.consolidate(0)
            assert set(moved) == set(on0)
            assert all(d != 0 for d in moved.values())
            eng.remove_server(0, timeout_s=10.0)
            assert 0 not in eng.pool.alive_servers()
            assert eng._paged[0].pools is None
            assert len(eng.degraded_reports) == 1
            assert not eng.degraded_reports[0].shed  # idle pool: all moved
            out = _run_streams(eng, {n: PROMPT8 for n in names})
            for n in names:
                assert not isinstance(out[n], Exception), out[n]
                assert out[n].tokens == want, n
            _assert_no_leaks(eng)
        finally:
            eng.close()

    def test_remove_server_migrates_live_streams(self, setup):
        """remove_server while streams decode on the server: each moves its
        live cache to a survivor at a step boundary and finishes with the
        unmigrated tokens."""
        cfg, params, _, _ = setup
        steps = 12
        want = _reference_tokens(cfg, params, PROMPT8, steps=steps)
        eng = _engine(cfg, params)
        try:
            names = ["a", "b"]
            for n in names:
                assert eng.admit(_spec(n, 1, steps=steps)).admitted
                if eng.admission.device_of(n) != 0:
                    assert eng.admission.migrate(n, 0)[1] == 0
                eng.pool.reassign(n, 0, priority=1)
            started = threading.Event()
            run_batch = eng._run_paged_decode

            def signalling(si):
                run = run_batch(si)

                def first(payloads):
                    started.set()
                    return run(payloads)

                return first

            eng._run_paged_decode = signalling
            out = {}
            threads = [threading.Thread(
                target=lambda n=n: out.__setitem__(
                    n, eng.generate(n, PROMPT8, steps=steps)))
                for n in names]
            for t in threads:
                t.start()
            assert started.wait(60)
            eng.remove_server(0, timeout_s=60.0)
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            assert eng.pool.alive_servers() == [1]
            assert eng.migrations_completed >= 1
            for n in names:
                assert out[n].tokens == want, n
            _assert_no_leaks(eng)
        finally:
            eng.close()
            vars(eng).pop("_run_paged_decode", None)

    def test_elastic_controller_ramp(self, setup):
        """LoadTrajectory drives scale_to up and down; a stream admitted at
        any pool size keeps generating the reference tokens throughout."""
        cfg, params, _, _ = setup
        prompt = np.array([[1, 2, 3, 4]], np.int32)
        want = _reference_tokens(cfg, params, prompt)
        eng = _engine(cfg, params)
        try:
            assert eng.admit(_spec("s0", 1)).admitted
            ctl = ElasticPoolController(eng, min_servers=1, max_servers=4)
            traj = LoadTrajectory(((0.0, 2), (1.0, 4), (2.0, 2)))
            assert traj.target_at(0.0) == 2
            assert traj.target_at(1.5) == 4
            assert traj.target_at(99.0) == 2
            assert len(ctl.live()) == 2
            ctl.scale_to(traj.target_at(1.5))
            assert len(ctl.live()) == 4
            assert eng.generate("s0", prompt, steps=STEPS).tokens == want
            ctl.scale_to(traj.target_at(2.0))
            assert len(ctl.live()) == 2
            assert eng.generate("s0", prompt, steps=STEPS).tokens == want
            _assert_no_leaks(eng)
            assert [e[0] for e in ctl.events].count("add") == 2
            assert [e[0] for e in ctl.events].count("remove") == 2
        finally:
            eng.close()

    def test_added_server_participates_in_admission(self, setup):
        """add_server grows the admission partition in lockstep: a stream
        that no longer fits the old pool is provable on the new device."""
        cfg, params, _, _ = setup
        eng = _engine(cfg, params, num_servers=1, max_batch=2)
        try:
            admitted = []
            for i in range(64):
                spec = StreamSpec(name=f"s{i}", priority=1, period_ms=100.0,
                                  deadline_ms=100.0, prefill_ms=20.0,
                                  decode_ms=5.0, decode_steps=4)
                if not eng.admit(spec).admitted:
                    break
                admitted.append(spec.name)
            else:
                pytest.fail("single device never saturated")
            reject = StreamSpec(name="late", priority=1, period_ms=100.0,
                                deadline_ms=100.0, prefill_ms=20.0,
                                decode_ms=5.0, decode_steps=4)
            assert not eng.admit(reject).admitted
            eng.add_server()
            assert eng.admit(reject).admitted
            assert eng.admission.device_of("late") == 1
            assert eng.pool.server_of("late") == 1
        finally:
            eng.close()
