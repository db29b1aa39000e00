"""Fault-tolerance runtime: checkpoint manager, failure detection, and the
restart policy glue.

Counterpart of ``repro/runtime/fault_tolerance.py``.  ``WorkerState``,
``HeartbeatMonitor`` (which ``ServerPool`` wires across its servers,
``core/dispatch/pool.py``, ``enable_failure_detection``) and
``TrainSupervisor`` are copied word for word: they are host-side (threads
and ``time.monotonic``), and ``tests/test_torch_imports.py`` pins their
text to the source's.  ``CheckpointManager`` wraps the port's
``training.checkpoint``; its async save snapshots the leaves to host
memory with a copy (``.to("cpu", copy=True)``) where the reference calls
``jax.device_get``: a CPU tensor's ``.cpu()`` is the tensor itself, which
the optimizer's in-place update would change under the writer thread.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.training import checkpoint as ckpt
from repro_torch.training.tree import tree_map


class CheckpointManager:
    """Wraps training.checkpoint with step-interval policy and async save.

    Async mode snapshots leaves to host memory synchronously -- the cheap
    part -- and does file IO on a background thread so the train loop only
    stalls for the transfer, not the disk.
    """

    def __init__(self, root: str, *, interval: int = 100, keep_last: int = 3,
                 async_save: bool = True):
        self.root = root
        self.interval = interval
        self.keep_last = keep_last
        self.async_save = async_save
        self._pending: threading.Thread | None = None
        self.saved_steps: list[int] = []

    def maybe_save(self, step: int, tree) -> bool:
        if step % self.interval:
            return False
        self.save(step, tree)
        return True

    def save(self, step: int, tree) -> None:
        self.wait()  # one in-flight save at a time
        if self.async_save:
            host_tree = tree_map(
                lambda x: (x.detach().to("cpu", copy=True)
                           if isinstance(x, torch.Tensor) else x), tree)
            self._pending = threading.Thread(
                target=ckpt.save, args=(self.root, step, host_tree),
                kwargs=dict(keep_last=self.keep_last), daemon=True)
            self._pending.start()
        else:
            ckpt.save(self.root, step, tree, keep_last=self.keep_last)
        self.saved_steps.append(step)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def restore_latest(self, tree_like, *, shardings=None):
        self.wait()
        return ckpt.restore(self.root, tree_like, shardings=shardings)

    def latest_step(self):
        self.wait()
        return ckpt.latest_step(self.root)




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


class TrainSupervisor:
    """Restart-from-checkpoint policy: wires the monitor to the manager.

    run_step is the application's step callable; on a detected failure the
    supervisor (1) notes the event, (2) calls ``rescale(alive)`` to get a
    new world size (elastic), (3) restores the latest checkpoint, and
    (4) resumes.  Used in-process by tests and examples; on real clusters
    the same object runs inside the controller process.
    """

    def __init__(self, manager: CheckpointManager,
                 rescale: Callable[[list[str]], None] | None = None):
        self.manager = manager
        self.rescale = rescale
        self.failures: list[str] = []
        self._failed = threading.Event()

    def on_failure(self, name: str) -> None:
        self.failures.append(name)
        self._failed.set()

    @property
    def failure_pending(self) -> bool:
        return self._failed.is_set()

    def recover(self, tree_like, alive: list[str], *, shardings=None):
        """Restore latest checkpoint (optionally on a reshaped mesh)."""
        if self.rescale is not None:
            self.rescale(alive)
        tree, step = self.manager.restore_latest(tree_like, shardings=shardings)
        self._failed.clear()
        return tree, step
