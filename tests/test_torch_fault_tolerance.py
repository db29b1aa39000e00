"""The port's failure detection (repro_torch.runtime.fault_tolerance and
``ServerPool.enable_failure_detection``) on the CPU.

The heartbeat tests mirror ``tests/test_runtime.py::TestHeartbeat`` against
the port's classes; the pool tests drive the port's ``ServerPool`` through
a stalled device call: the monitor evicts the silent server, reports its
death once, and reports nothing after ``close()``.

A server that went idle before detection was enabled waits without
beating until its next request (the reference's server loop does the
same), so each test wakes every server with a first call.  The pool
tests allow a second of silence, so that a server thread starved on a
loaded host is not taken for a stalled one.
"""

import threading
import time

from repro_torch.core.dispatch import ServerPool
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor, WorkerState


def _wake(pool, streams):
    """One quick call per stream's server: each idle server then beats."""
    for name in streams:
        assert pool.submit(name, lambda: None).wait(5.0) is None


def _wait_for(cond, timeout=5.0):
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end and not cond():
        time.sleep(0.02)
    return cond()


class TestHeartbeat:
    def test_detects_silent_worker_once(self):
        failures = []
        mon = HeartbeatMonitor(timeout=0.3, poll=0.05,
                               on_failure=failures.append)
        try:
            mon.register("w0")
            mon.register("w1")
            t_end = time.monotonic() + 5.0
            while time.monotonic() < t_end and not failures:
                mon.beat("w0")  # w1 goes silent
                time.sleep(0.02)
            for _ in range(10):  # w0 stays alive: no extra detection
                mon.beat("w0")
                time.sleep(0.02)
            assert failures == ["w1"]
            assert mon.alive_workers() == ["w0"]
            assert mon.workers["w1"] == WorkerState(
                "w1", mon.workers["w1"].last_beat, alive=False)
        finally:
            mon.close()

    def test_context_manager_and_no_callback_after_close(self):
        failures = []
        with HeartbeatMonitor(timeout=0.05, poll=0.01,
                              on_failure=failures.append) as mon:
            mon.register("w0")
        time.sleep(0.2)  # w0 is overdue, but the monitor is closed
        assert failures == []
        mon.close()  # idempotent

    def test_unregister_stops_tracking(self):
        failures = []
        mon = HeartbeatMonitor(timeout=0.1, poll=0.02,
                               on_failure=failures.append)
        try:
            mon.register("gone")
            mon.unregister("gone")
            time.sleep(0.3)
            assert failures == []
            assert mon.alive_workers() == []
        finally:
            mon.close()


class TestPoolFailureDetection:
    def test_evicts_a_stalled_server_and_reports_it_once(self):
        pool = ServerPool(2, name="p")
        deaths = []
        release = threading.Event()
        try:
            monitor = pool.enable_failure_detection(
                timeout=1.0, poll=0.02,
                on_death=lambda si, displaced: deaths.append((si, displaced)))
            assert isinstance(monitor, HeartbeatMonitor)
            pool.assign("a", server=0, priority=2)
            pool.assign("b", server=1)
            _wake(pool, ["a", "b"])
            stalled = pool.submit("a", lambda: release.wait(10.0))
            assert _wait_for(lambda: deaths)
            time.sleep(0.5)  # later polls see server 0 dead already
            assert deaths == [(0, {"a": None})]
            assert pool.alive_servers() == [1]
            assert pool.submit("b", lambda: 7).wait(5.0) == 7
            release.set()  # the stalled call returns into a failed server
            time.sleep(0.1)
            assert len(deaths) == 1
            assert stalled.done  # its client was woken with the failure
        finally:
            release.set()
            pool.shutdown(drain=False)

    def test_rerouted_streams_without_on_death(self):
        pool = ServerPool(2, name="q")
        release = threading.Event()
        try:
            pool.enable_failure_detection(timeout=1.0, poll=0.02)
            pool.assign("a", server=0)
            pool.assign("b", server=1)
            _wake(pool, ["a", "b"])
            pool.submit("a", lambda: release.wait(10.0))
            assert _wait_for(lambda: pool.alive_servers() == [1])
            assert pool.server_of("a") == 1
            assert pool.submit("a", lambda: 3).wait(5.0) == 3
        finally:
            release.set()
            pool.shutdown(drain=False)

    def test_no_report_after_close(self):
        pool = ServerPool(2, name="r")
        deaths = []
        release = threading.Event()
        try:
            monitor = pool.enable_failure_detection(
                timeout=0.2, poll=0.02,
                on_death=lambda si, displaced: deaths.append(si))
            pool.assign("a", server=0)
            monitor.close()
            pool.submit("a", lambda: release.wait(10.0))
            time.sleep(0.6)  # server 0 is silent past the timeout
            assert deaths == []
            assert pool.alive_servers() == [0, 1]
        finally:
            release.set()
            pool.shutdown(drain=False)
