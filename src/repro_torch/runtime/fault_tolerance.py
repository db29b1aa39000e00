"""Failure detection: the heartbeat monitor that ``ServerPool`` wires
across its servers (``core/dispatch/pool.py``,
``enable_failure_detection``).

Counterpart of part of ``repro/runtime/fault_tolerance.py``: its
``WorkerState`` and ``HeartbeatMonitor``, copied word for word (they are
host-side: threads and ``time.monotonic``; ``tests/test_torch_imports.py``
pins their text to the source's).  The rest of that module --
``CheckpointManager`` and ``TrainSupervisor`` -- waits for the training
slice of the port (ROADMAP A11): it rests on ``training.checkpoint``, which
the port does not have yet.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable




@dataclass
class WorkerState:
    name: str
    last_beat: float
    alive: bool = True


class HeartbeatMonitor:
    """Failure detector: workers call ``beat(name)``; a monitor thread marks
    a worker dead after ``timeout`` seconds of silence and fires
    ``on_failure(name)`` exactly once per transition.

    Usable as a context manager; after ``close()`` returns, ``on_failure``
    is guaranteed not to fire again — callbacks run under a dedicated lock
    that ``close()`` takes before setting the stop flag, so a close racing
    the monitor thread either waits out the in-flight callback or suppresses
    the pending one (the old code could fire into torn-down owners)."""

    def __init__(self, *, timeout: float = 1.0, poll: float = 0.1,
                 on_failure: Callable[[str], None] | None = None,
                 on_tick: Callable[[], None] | None = None):
        self.timeout = timeout
        self.poll = poll
        self.on_failure = on_failure
        # periodic hook, fired once per poll under the callback lock — the
        # serving engine piggybacks its work-stealing rebalance pass here
        # (same cadence and teardown guarantees as failure callbacks)
        self.on_tick = on_tick
        self.workers: dict[str, WorkerState] = {}
        self._lock = threading.Lock()
        self._cb_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def register(self, name: str) -> None:
        with self._lock:
            self.workers[name] = WorkerState(name, time.monotonic())

    def unregister(self, name: str) -> None:
        """Stop watching ``name`` (e.g. a server already declared dead by
        another path — no point re-reporting it)."""
        with self._lock:
            self.workers.pop(name, None)

    def beat(self, name: str) -> None:
        with self._lock:
            w = self.workers.get(name)
            if w is not None:
                w.last_beat = time.monotonic()
                w.alive = True

    def alive_workers(self) -> list[str]:
        with self._lock:
            return [w.name for w in self.workers.values() if w.alive]

    def _run(self) -> None:
        while not self._stop.wait(self.poll):
            now = time.monotonic()
            dead = []
            with self._lock:
                for w in self.workers.values():
                    if w.alive and now - w.last_beat > self.timeout:
                        w.alive = False
                        dead.append(w.name)
            for name in dead:
                with self._cb_lock:
                    if self._stop.is_set():
                        return  # closed mid-scan: suppress late callbacks
                    if self.on_failure:
                        self.on_failure(name)
            with self._cb_lock:
                if self._stop.is_set():
                    return
                if self.on_tick:
                    self.on_tick()

    def close(self) -> None:
        """Idempotent; once it returns, no further ``on_failure`` fires."""
        with self._cb_lock:
            self._stop.set()
        self._thread.join(timeout=2)

    def __enter__(self) -> "HeartbeatMonitor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
