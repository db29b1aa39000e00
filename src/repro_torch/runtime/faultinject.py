"""Deterministic fault injection for the serving pool.

This is the runtime half of the fault story (``core.faults`` holds the
shared vocabulary; ``core.simulator`` replays ``DeviceFault`` schedules
against the discrete-event model).  Here, faults are injected into LIVE
``AcceleratorServer``/``BatchingServer`` threads: every server runs its
device calls through ``_attempt``, which first invokes an installed
``fault_hook`` — the injector's per-server closure — so a schedule can
make a real device call die, stall, run slow, or fail transiently at an
exact call index, deterministically and repeatably.

Failure model
=============

Four fault kinds, matching how real accelerators misbehave:

``die``
    The device is gone: the hook raises ``DeviceLostError``.  The server
    declares itself failed — every queued and in-flight request completes
    with ``ServerFailedError``, waking suspended clients into the stream-
    recovery path (``ServeEngine`` re-prefills each stream's retained
    prefix on a survivor; ``ServerPool.evict_server`` re-routes).

``stall``
    The call hangs for ``delay_s`` and THEN raises ``DeviceLostError`` —
    modeling a wedged device whose call never returns usefully.  Because
    servers heartbeat between device calls, a stall longer than the
    monitor timeout is detected from OUTSIDE by the ``HeartbeatMonitor``
    (``ServerPool.enable_failure_detection``): the monitor thread evicts
    the server while the call is still stuck, which is what makes the
    stall path a *per-device-call timeout* rather than a hang.

``slow``
    The call sleeps ``delay_s`` and then proceeds normally — a straggler
    step, visible to the server's ``StepTimeWatchdog`` (consecutive slow
    steps mark the server ``degraded``).

``transient``
    The hook raises ``TransientDeviceError`` for ``count`` consecutive
    attempts, then lets the call through.  The server retries with
    bounded exponential backoff (``max_retries``); a storm longer than
    the retry budget escalates to ``DeviceLostError`` — i.e. ``die``.

Recovery-delay analysis term
============================

The analysis side prices a death as a ``core.faults.DeviceFault``: the
failed device's streams migrate to a single survivor and each gains one
extra GPU request — the *recovery segment*, the re-prefill of the
stream's retained prefix (prompt + tokens generated so far), priced by
the calibrated ``StepCostModel`` at admission time
(``PoolAdmissionController.evict_device(recovery_cost_ms=...)``).  The
per-task bound becomes a sum of per-phase Eqs (1)-(6) bounds plus the
detection gap (``server_analysis.analyze_pool_under_faults``), and the
property suite pins it above simulated WCRT under the same schedule.

Writing a fault schedule
========================

A schedule is a list of :class:`ServerFault` events, each pinned to a
server index and a 0-based device-call ordinal on that server::

    from repro_torch.runtime.faultinject import FaultInjector, ServerFault

    inj = FaultInjector([
        ServerFault(server=1, at_call=5, kind="die"),
        ServerFault(server=0, at_call=3, kind="transient", count=2),
        ServerFault(server=2, at_call=0, kind="stall", delay_s=1.0),
    ])
    inj.attach(pool)          # or pool.attach_fault_injector(inj)

Call indices count the calls the schedule's hook sees on that server
(prefill and decode alike), so a fixed workload + fixed schedule is
bit-reproducible.  ``FaultInjector.seeded(...)`` derives a schedule from
a seed for chaos matrices; ``injector.events`` logs every fired fault
with a timestamp, which the recovery benchmark uses to measure
detection -> resume latency.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field

# Re-exported so schedule authors import one module.
from repro_torch.core.faults import (DeviceFault, DeviceLostError,  # noqa: F401
                               ServerFailedError, StreamShedError,
                               TransientDeviceError, seeded_device_faults)

__all__ = [
    "FaultInjector",
    "ServerFault",
    "DeviceFault",
    "DeviceLostError",
    "ServerFailedError",
    "StreamShedError",
    "TransientDeviceError",
    "seeded_device_faults",
]

_KINDS = ("die", "stall", "slow", "transient")


@dataclass(frozen=True)
class ServerFault:
    """One scheduled fault against a live server.

    Fires when server ``server`` makes its ``at_call``-th device call
    (0-based, counted per server).  ``count`` extends ``transient`` faults
    over that many consecutive attempts; ``delay_s`` is the hang length
    for ``stall`` / ``slow``."""

    server: int
    at_call: int
    kind: str
    count: int = 1
    delay_s: float = 0.0

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, got {self.kind!r}")
        if self.at_call < 0 or self.count < 1 or self.delay_s < 0:
            raise ValueError(f"invalid fault: {self}")


@dataclass
class FaultEvent:
    """One fired fault, logged for the recovery benchmark."""

    server: int
    call: int
    kind: str
    at_monotonic: float


class FaultInjector:
    """Installs per-server fault hooks realizing a :class:`ServerFault`
    schedule.  Deterministic: hooks key off each server's device-call
    ordinal, not wall time.  One injector serves one pool run."""

    def __init__(self, schedule: list[ServerFault]):
        self.schedule = list(schedule)
        self.events: list[FaultEvent] = []
        self._calls: dict[int, int] = {}
        self._lock = threading.Lock()

    @classmethod
    def seeded(cls, seed: int, *, num_servers: int, num_faults: int = 1,
               max_call: int = 20, kinds: tuple = ("die",),
               delay_s: float = 0.0, transient_count: int = 2,
               ) -> "FaultInjector":
        """Derive a deterministic schedule from ``seed``: ``num_faults``
        distinct victim servers, each faulted at a random call ordinal in
        [1, max_call] with a random kind from ``kinds``."""
        if num_faults >= num_servers:
            raise ValueError(
                f"cannot fault {num_faults} of {num_servers} servers")
        rng = random.Random(seed)
        victims = rng.sample(range(num_servers), num_faults)
        schedule = [
            ServerFault(server=v, at_call=rng.randint(1, max_call),
                        kind=rng.choice(list(kinds)),
                        count=transient_count, delay_s=delay_s)
            for v in victims
        ]
        return cls(schedule)

    def hook_for(self, si: int):
        """The ``fault_hook`` closure for server ``si`` (runs on that
        server's thread at the top of every device-call attempt)."""
        faults = sorted((f for f in self.schedule if f.server == si),
                        key=lambda f: f.at_call)
        if not faults:
            return None

        def hook() -> None:
            with self._lock:
                call = self._calls.get(si, 0)
                self._calls[si] = call + 1
                live = [f for f in faults
                        if f.at_call <= call < f.at_call + f.count]
                for f in live:
                    self.events.append(FaultEvent(
                        si, call, f.kind, time.monotonic()))
            for f in live:
                if f.kind == "die":
                    raise DeviceLostError(
                        f"injected death on server {si} at call {call}")
                if f.kind == "stall":
                    time.sleep(f.delay_s)
                    raise DeviceLostError(
                        f"injected stall on server {si} at call {call}")
                if f.kind == "slow":
                    time.sleep(f.delay_s)
                elif f.kind == "transient":
                    raise TransientDeviceError(
                        f"injected transient error on server {si} "
                        f"at call {call}")

        return hook

    def attach(self, pool) -> None:
        """Install hooks into every scheduled server of ``pool``."""
        for si in range(len(pool.servers)):
            hook = self.hook_for(si)
            if hook is not None:
                pool.servers[si].fault_hook = hook
