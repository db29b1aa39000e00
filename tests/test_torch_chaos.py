"""The port's stream recovery (``ServeEngine.enable_fault_tolerance``):
test_chaos.py's matrix of deterministic faults injected into the live
serving pool (``repro_torch.runtime.faultinject``), re-run on the port.

Every scenario holds the two recovery invariants end to end:
  * the tokens of a stream that survives a failure equal the failure-free
    greedy tokens (the re-prefill of the retained prefix rebuilds the dead
    server's cache state), and those equal the JAX engine's recovered
    tokens on the same weights, prompt and fault;
  * nothing leaks: after the streams drain, ``kv_blocks_in_use() == 0``
    and every live server has all its slots free.

Matrix: kill 1 of N mid-decode (paged and masked-dense), kill during
prefill, double failure, transient-error storm below and above the retry
budget, a stall detected by the heartbeat monitor, and degraded-mode
shedding on an overloaded survivor.

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
from repro.runtime.faultinject import FaultInjector as JaxFaultInjector
from repro.runtime.faultinject import ServerFault as JaxServerFault
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro.serving.engine import StreamSpec as JaxStreamSpec
from repro_torch.configs.registry import get_config
from repro_torch.core.faults import StreamShedError
from repro_torch.params import params_from_numpy
from repro_torch.runtime.faultinject import FaultInjector, ServerFault
from repro_torch.serving.engine import ServeEngine, StreamSpec

STEPS = 6
KILL_PROMPT = np.array([[1, 2, 3, 4]], np.int32)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_config("internlm2_1_8b").reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("internlm2_1_8b").reduced(),
                              dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(1))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, params, jcfg, jparams


@pytest.fixture(scope="module")
def jax_recovered(setup):
    """The JAX engine's tokens for test_kill_one_of_two_mid_decode's
    streams under the same fault, computed once."""
    _, _, jcfg, jparams = setup
    eng = JaxServeEngine(jcfg, jparams, max_seq=32, num_servers=2,
                         batching=True, max_batch=4, paged=True,
                         kv_block_size=8)
    eng.enable_fault_tolerance(heartbeat_timeout_s=30.0)
    try:
        names = [f"s{i}" for i in range(4)]
        for i, n in enumerate(names):
            assert eng.admit(_spec(n, 4 - i, cls=JaxStreamSpec)).admitted
        victim = eng.pool.server_of(names[0])
        eng.pool.attach_fault_injector(JaxFaultInjector(
            [JaxServerFault(server=victim, at_call=6, kind="die")]))
        out = _run_streams(eng, {n: KILL_PROMPT for n in names})
        assert len(eng.degraded_reports) == 1
        return {n: out[n].tokens for n in names}
    finally:
        eng.close()


def _spec(name, prio, steps=STEPS, deadline_ms=8000.0, cls=StreamSpec):
    return cls(name=name, priority=prio, period_ms=8000.0,
               deadline_ms=deadline_ms, prefill_ms=50.0, decode_ms=5.0,
               decode_steps=steps)


def _reference_tokens(cfg, params, prompt, steps=STEPS):
    eng = ServeEngine(cfg, params, max_seq=32, device="cpu")
    try:
        assert eng.admit(_spec("ref", 1, steps=steps)).admitted
        return eng.generate("ref", prompt, steps=steps).tokens
    finally:
        eng.close()


def _engine(cfg, params, *, num_servers=2, paged=True, max_batch=4,
            heartbeat_timeout_s=30.0):
    eng = ServeEngine(cfg, params, max_seq=32, num_servers=num_servers,
                      batching=True, max_batch=max_batch, paged=paged,
                      kv_block_size=8, device="cpu")
    eng.enable_fault_tolerance(heartbeat_timeout_s=heartbeat_timeout_s)
    return eng


def _run_streams(eng, prompts, steps=STEPS):
    """Generate all streams concurrently; returns {name: result or the
    error its worker raised}."""
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


class TestChaosMatrix:
    @pytest.mark.parametrize("paged", [True, False],
                             ids=["paged", "masked_dense"])
    def test_kill_one_of_two_mid_decode(self, setup, jax_recovered, paged):
        """A server dies while its streams are decoding: they move to the
        survivor, re-prefill their retained prefix, and finish with the
        failure-free tokens -- the JAX engine's under the same fault."""
        cfg, params, _, _ = setup
        want = _reference_tokens(cfg, params, KILL_PROMPT)

        eng = _engine(cfg, params, paged=paged)
        try:
            names = [f"s{i}" for i in range(4)]
            for i, n in enumerate(names):
                assert eng.admit(_spec(n, 4 - i)).admitted
            assert {eng.pool.server_of(n) for n in names} == {0, 1}
            victim = eng.pool.server_of(names[0])
            on_victim = {n for n in names if eng.pool.server_of(n) == victim}
            inj = FaultInjector([ServerFault(server=victim, at_call=6,
                                             kind="die")])
            eng.pool.attach_fault_injector(inj)

            out = _run_streams(eng, {n: KILL_PROMPT for n in names})
            assert inj.events and inj.events[0].kind == "die"
            for n in names:
                assert not isinstance(out[n], Exception), out[n]
                assert out[n].tokens == want, n
                assert out[n].tokens == jax_recovered[n], n
            # the victim's streams actually went through recovery
            assert any(out[n].recoveries > 0 for n in on_victim)
            assert all(len(out[n].resumed_at_monotonic) == out[n].recoveries
                       for n in names)
            assert len(eng.degraded_reports) == 1
            rep = eng.degraded_reports[0]
            assert rep.device == victim and not rep.shed
            assert set(rep.moved) == on_victim  # everyone re-placed
            assert all(rep.recovery_ms[n] > 0 for n in on_victim)
            assert eng.pool.alive_servers() == [1 - victim]
            _assert_no_leaks(eng)
        finally:
            eng.close()

    def test_kill_during_prefill(self, setup):
        """The victim dies on its very first device call -- the prefill
        itself -- so recovery re-runs from an empty retained prefix."""
        cfg, params, _, _ = setup
        prompt = np.array([[5, 6, 7]], np.int32)
        want = _reference_tokens(cfg, params, prompt)

        eng = _engine(cfg, params)
        try:
            names = ["p0", "p1"]
            for i, n in enumerate(names):
                assert eng.admit(_spec(n, 2 - i)).admitted
            victim = eng.pool.server_of("p0")
            inj = FaultInjector([ServerFault(server=victim, at_call=0,
                                             kind="die")])
            eng.pool.attach_fault_injector(inj)

            out = _run_streams(eng, {n: prompt for n in names})
            for n in names:
                assert not isinstance(out[n], Exception), out[n]
                assert out[n].tokens == want, n
            assert any(out[n].recoveries > 0 for n in names)
            _assert_no_leaks(eng)
        finally:
            eng.close()

    def test_double_failure(self, setup):
        """Two of three servers die at different times; every stream ends
        on the last survivor with the failure-free tokens."""
        cfg, params, _, _ = setup
        prompt = np.array([[2, 4, 6]], np.int32)
        want = _reference_tokens(cfg, params, prompt)

        eng = _engine(cfg, params, num_servers=3)
        try:
            names = [f"d{i}" for i in range(3)]
            for i, n in enumerate(names):
                assert eng.admit(_spec(n, 3 - i)).admitted
            servers = {eng.pool.server_of(n) for n in names}
            assert len(servers) == 3
            dead = sorted(servers)[:2]
            inj = FaultInjector([
                ServerFault(server=dead[0], at_call=3, kind="die"),
                ServerFault(server=dead[1], at_call=5, kind="die"),
            ])
            eng.pool.attach_fault_injector(inj)

            out = _run_streams(eng, {n: prompt for n in names})
            for n in names:
                assert not isinstance(out[n], Exception), out[n]
                assert out[n].tokens == want, n
            assert len(eng.degraded_reports) == 2
            assert len(eng.pool.alive_servers()) == 1
            _assert_no_leaks(eng)
        finally:
            eng.close()

    def test_transient_storm_within_retry_budget(self, setup):
        """Transient device errors under the retry budget are absorbed by
        backoff-retry: no recovery, no eviction, the same tokens."""
        cfg, params, _, _ = setup
        prompt = np.array([[3, 1, 4]], np.int32)
        want = _reference_tokens(cfg, params, prompt)

        eng = _engine(cfg, params, num_servers=1)
        try:
            assert eng.admit(_spec("t0", 1)).admitted
            inj = FaultInjector([ServerFault(server=0, at_call=2,
                                             kind="transient", count=2)])
            eng.pool.attach_fault_injector(inj)

            res = eng.generate("t0", prompt, steps=STEPS)
            assert res.tokens == want
            assert res.recoveries == 0
            assert not eng.degraded_reports
            assert eng.pool.alive_servers() == [0]
            assert len(inj.events) == 2  # both transient hits logged
            _assert_no_leaks(eng)
        finally:
            eng.close()

    def test_transient_storm_exhausts_retries_and_recovers(self, setup):
        """A storm longer than the retry budget escalates to device loss;
        the stream recovers on the survivor."""
        cfg, params, _, _ = setup
        prompt = np.array([[9, 8]], np.int32)
        want = _reference_tokens(cfg, params, prompt)

        eng = _engine(cfg, params)
        try:
            names = ["x0", "x1"]
            for i, n in enumerate(names):
                assert eng.admit(_spec(n, 2 - i)).admitted
            victim = eng.pool.server_of("x0")
            inj = FaultInjector([ServerFault(server=victim, at_call=4,
                                             kind="transient", count=10)])
            eng.pool.attach_fault_injector(inj)

            out = _run_streams(eng, {n: prompt for n in names})
            for n in names:
                assert not isinstance(out[n], Exception), out[n]
                assert out[n].tokens == want, n
            assert len(eng.degraded_reports) == 1
            assert victim not in eng.pool.alive_servers()
            _assert_no_leaks(eng)
        finally:
            eng.close()

    def test_stall_detected_by_heartbeat(self, setup):
        """A wedged device call never returns in time; the heartbeat
        monitor declares the server dead from outside (a per-device-call
        timeout) and the streams recover on the survivor.  The stall lasts
        ten heartbeat timeouts, so the streams can only have resumed before
        it ended if the monitor evicted the server."""
        cfg, params, _, _ = setup
        prompt = np.array([[1, 1, 2]], np.int32)
        want = _reference_tokens(cfg, params, prompt)
        timeout_s = 1.0

        # warm every cell first (the recovery re-prefill's buckets too),
        # then arm the heartbeat and wake each server with a first call:
        # a server idle since before detection was enabled never beats
        eng = ServeEngine(cfg, params, max_seq=32, num_servers=2,
                          batching=True, max_batch=4, paged=True,
                          kv_block_size=8, device="cpu")
        try:
            eng.precompile((4, 8, 16))
            eng.enable_fault_tolerance(heartbeat_timeout_s=timeout_s)
            for s in eng.pool.servers:
                assert s.submit(lambda: None).wait(10.0) is None
            names = ["h0", "h1"]
            for i, n in enumerate(names):
                assert eng.admit(_spec(n, 2 - i)).admitted
            victim = eng.pool.server_of("h0")
            on_victim = [n for n in names if eng.pool.server_of(n) == victim]
            inj = FaultInjector([ServerFault(server=victim, at_call=4,
                                             kind="stall",
                                             delay_s=10 * timeout_s)])
            eng.pool.attach_fault_injector(inj)

            out = _run_streams(eng, {n: prompt for n in names})
            for n in names:
                assert not isinstance(out[n], Exception), out[n]
                assert out[n].tokens == want, n
            assert victim not in eng.pool.alive_servers()
            assert len(eng.degraded_reports) == 1
            stalled_at = inj.events[0].at_monotonic
            for n in on_victim:
                assert out[n].recoveries == 1
                assert (out[n].resumed_at_monotonic[0] - stalled_at
                        < 10 * timeout_s)
            _assert_no_leaks(eng)
        finally:
            eng.close()

    def test_degraded_admission_sheds_lowest_priority(self, setup):
        """When the survivor cannot host everyone, degraded-mode admission
        sheds in reverse priority order: the shed stream's generator raises
        StreamShedError, the survivors' tokens stay the failure-free ones,
        and the shed stream's blocks are all released."""
        cfg, params, _, _ = setup
        prompt = np.array([[1, 2, 3, 4]], np.int32)
        want = _reference_tokens(cfg, params, prompt)

        eng = _engine(cfg, params)
        try:
            # deadline 500ms fits exactly two of these streams per device;
            # after eviction the survivor cannot hold all four
            names = [f"g{i}" for i in range(4)]
            for i, n in enumerate(names):
                assert eng.admit(_spec(n, 4 - i, deadline_ms=500.0)).admitted
            assert {eng.pool.server_of(n) for n in names} == {0, 1}
            victim = eng.pool.server_of("g0")  # holds g0 (prio 4), g2 (2)
            inj = FaultInjector([ServerFault(server=victim, at_call=6,
                                             kind="die")])
            eng.pool.attach_fault_injector(inj)

            out = _run_streams(eng, {n: prompt for n in names})
            assert len(eng.degraded_reports) == 1
            rep = eng.degraded_reports[0]
            # g0 (highest) displaces g3 (globally lowest) and is re-admitted
            # with its recovery segment; g2 finds no lower victim -> shed
            assert rep.moved == {"g0": 1 - victim}
            assert rep.shed == ["g3", "g2"]
            assert rep.recovery_ms["g0"] > 0
            for n in ("g0", "g1"):
                assert not isinstance(out[n], Exception), out[n]
                assert out[n].tokens == want, n
            for s in rep.shed:
                # a shed stream either observed the shed or had already
                # finished -- then its tokens must be right
                if isinstance(out[s], Exception):
                    assert isinstance(out[s], StreamShedError), out[s]
                else:
                    assert out[s].tokens == want, s
                eng.remove(s)
            _assert_no_leaks(eng)
        finally:
            eng.close()

    def test_remove_releases_leaked_blocks(self, setup):
        """engine.remove(stream) frees cache still held for the stream (a
        failure can orphan a reservation if the generating thread is
        gone)."""
        cfg, params, _, _ = setup
        eng = _engine(cfg, params, num_servers=1)
        try:
            assert eng.admit(_spec("leaky", 1)).admitted
            si = eng.pool.server_of("leaky")
            eng._paged_reserve(si, "leaky", 4, STEPS, 4)
            assert eng.kv_blocks_in_use() > 0
            eng.remove("leaky")
            assert eng.kv_blocks_in_use() == 0
        finally:
            eng.close()

    def test_shutdown_drains_inflight_work(self, setup):
        """close() finishes queued work before joining the server
        threads."""
        cfg, params, _, _ = setup
        eng = _engine(cfg, params, num_servers=1)
        try:
            assert eng.admit(_spec("d0", 1)).admitted
            res = eng.generate("d0", np.array([[4, 2]], np.int32),
                               steps=STEPS)
            assert len(res.tokens) == STEPS
        finally:
            eng.close()  # drains: must not raise or hang
        assert all(not s._thread.is_alive() for s in eng.pool.servers)
