"""Shared fault model: the exception vocabulary of the serving stack and the
analysis/simulator-level device-failure description.

Three layers consume this module:

  * the RUNTIME (``core.server_runtime`` / ``core.dispatch``) raises and
    handles the exceptions — a device call that raises
    :class:`TransientDeviceError` is retried with bounded backoff; one that
    raises :class:`DeviceLostError` (or exhausts its retries, or stalls past
    the heartbeat timeout) marks the whole server failed, and every queued or
    in-flight request on it completes with :class:`ServerFailedError` so
    suspended clients wake and can run stream recovery;
  * the SIMULATOR (``core.simulator``) takes a list of :class:`DeviceFault`
    events and replays them exactly: at ``at_ms`` the device stops mid-work,
    at ``at_ms + detect_ms`` its orphaned requests are re-submitted to the
    surviving device ``to`` with the ``recovery`` re-prefill segment folded
    in, and all later requests of its tasks follow;
  * the ANALYSIS (``core.server_analysis.analyze_pool_under_faults``) prices
    the same events into a per-task recovery-augmented response-time bound
    that is property-tested to dominate the simulated WCRT.

The runtime-side *injection* harness (scripted/seeded schedules of death,
stall, slow-step and transient errors against a live ``ServerPool``) lives
in ``runtime.faultinject``; it re-exports these exceptions so schedule
authors import one module.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

from .task_model import GpuSegment, System

__all__ = [
    "DeviceFault",
    "DeviceLostError",
    "ServerFailedError",
    "StreamShedError",
    "TransientDeviceError",
    "seeded_device_faults",
]


class DeviceLostError(RuntimeError):
    """The accelerator behind a server is gone (fatal): the device call
    failed in a way retry cannot fix, or transient retries were exhausted.
    Raising this inside a device call declares the server dead."""


class TransientDeviceError(RuntimeError):
    """A device call failed in a way worth retrying (e.g. a transient
    interconnect error).  The server retries with bounded exponential
    backoff before escalating to :class:`DeviceLostError`."""


class ServerFailedError(RuntimeError):
    """Completion status of a request whose server died before (or while)
    serving it.  Clients suspended on ``Request.wait()`` receive this and
    should re-route the work — the serving engine's stream recovery path.

    ``server`` carries the failed server's name for diagnostics."""

    def __init__(self, message: str, *, server: str = ""):
        super().__init__(message)
        self.server = server


class StreamShedError(RuntimeError):
    """The stream was shed by degraded-mode admission (the shrunk pool can
    no longer prove its deadline) — its job is aborted, not retried."""


@dataclass(frozen=True)
class DeviceFault:
    """One device-death event for the simulator/analysis pair.

    At ``at_ms`` device ``device`` dies mid-work (its in-flight segment
    never completes, its queue freezes).  Detection takes ``detect_ms``
    (heartbeat timeout); at ``at_ms + detect_ms`` every orphaned request is
    re-submitted to surviving device ``to`` with the ``recovery`` segment's
    cost folded in (the re-prefill of the retained token prefix), and all
    of the dead device's tasks are re-routed to ``to`` from then on.

    The single-target ``to`` mirrors how degraded admission typically lands
    a dead device's streams, and keeps the post-failure partitions
    core-disjoint so ``analyze_pool`` still decomposes.
    """

    device: int
    at_ms: float
    detect_ms: float
    to: int
    recovery: GpuSegment = field(default_factory=lambda: GpuSegment(0.0, 0.0))

    def __post_init__(self) -> None:
        if self.device == self.to:
            raise ValueError(f"device {self.device} cannot fail over to itself")
        if self.at_ms < 0 or self.detect_ms < 0:
            raise ValueError("at_ms and detect_ms must be >= 0")


def seeded_device_faults(system: System, seed: int, *, num_faults: int = 1,
                         horizon_ms: float, detect_ms: float = 1.0,
                         recovery_scale: float = 1.0) -> list[DeviceFault]:
    """Deterministic random fault schedule for a multi-device system: kill
    ``num_faults`` distinct devices at seeded-random instants inside the
    horizon, each failing over to the lowest-index surviving device.  The
    recovery segment is priced at ``recovery_scale`` x the largest single
    GPU segment in the system (a conservative stand-in for the re-prefill
    of the longest retained prefix)."""
    rng = random.Random(seed)
    devices = list(range(system.num_gpus))
    if num_faults >= len(devices):
        raise ValueError(f"cannot kill {num_faults} of {len(devices)} devices")
    dead: list[int] = []
    seg_max = max((s.total for t in system.tasks for s in t.segments),
                  default=0.0)
    rec = GpuSegment(e=0.9 * seg_max * recovery_scale,
                     m=0.1 * seg_max * recovery_scale)
    faults = []
    t = 0.0
    for _ in range(num_faults):
        victim = rng.choice([d for d in devices if d not in dead])
        dead.append(victim)
        survivors = [d for d in devices if d not in dead]
        t += rng.uniform(0.05, 0.45) * horizon_ms
        faults.append(DeviceFault(device=victim, at_ms=t,
                                  detect_ms=detect_ms, to=survivors[0],
                                  recovery=rec))
    return faults
