"""ServerPool: one accelerator server per device / mesh slice.

The paper partitions tasks to cores and gives the single GPU one server
task; here the accelerators themselves are plural, and the same partitioned
discipline applies one level up: every *stream* is assigned to exactly one
server when it is admitted, and all of its requests go through that server
for its lifetime.  Partitioned assignment is what keeps the analysis
compositional — each server's queue contains only its own streams, so
Eqs (1)-(6) apply within the partition (``server_analysis.analyze_pool``)
and admission of a stream on device d cannot disturb deadlines on device
d' != d.

Routing is priority-aware worst-fit: a new stream lands on the server with
the least declared device utilization, ties broken toward the server with
the fewest already-assigned streams of equal-or-higher priority (so
high-priority streams spread out instead of queueing behind each other),
then by index.  The caller may also pin a stream to an explicit server —
the serving engine does this to follow the admission controller's
device-assignment step (``allocation.allocate_pool``).

Fault tolerance: a server can die mid-traffic (its device call raises
``DeviceLostError``, exhausts transient retries, or stalls past the
heartbeat timeout).  ``evict_server(si)`` is the single choke point — it
marks the server dead for routing, fails it (waking every suspended
client with ``ServerFailedError``), and displaces its streams: either
re-routed worst-fit onto survivors or handed back to the caller so
degraded-mode admission can place (or shed) them.
``enable_failure_detection`` wires a ``HeartbeatMonitor``: each server
thread beats between device calls, so a call outlasting the timeout is a
stall and the monitor thread evicts the server from outside.

Planned migration (work stealing / consolidation / elastic scale): the
"for its lifetime" pinning above has one sanctioned exception — a stream
may be MOVED between servers through a two-step protocol that keeps the
partitioned-analysis story intact:

  1. ``request_migration(stream, dst)`` records the intent (admission has
     already re-proven the stream on ``dst`` with its migration cost);
  2. the stream's own generating thread observes ``pending_migration`` at
     its next decode-step boundary, copies its live KV blocks across
     (``ServeEngine._execute_migration``), and calls
     ``complete_migration`` — the binding flips only after the blocks
     landed, so requests are never routed at a server that does not hold
     the stream's state.  ``cancel_migration`` abandons the intent (e.g.
     destination pool exhausted); the stream stays where it was.

The STEAL POLICY lives in ``ServeEngine.rebalance_once`` (piggybacked on
the heartbeat tick): pick the deepest and shallowest live queues by
active-stream count, stop when the gap is < 2, move the lowest-priority
stream of the deep server iff the cost model prices the migration copy
below the predicted queueing-delay saving — steal only when it pays.

Elastic membership: ``add_server()`` grows the pool mid-traffic;
``begin_drain(si)`` takes a server out of routing (existing streams keep
running until migrated away); ``retire_server(si)`` removes an empty
drained server.  Draining servers accept no new assignments and are never
a migration destination.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Hashable

from repro_torch.core.dispatch.batching import BatchingServer, BatchRequest
from repro_torch.core.server_runtime import AcceleratorServer, CellStats, Request

__all__ = ["ServerPool", "StreamAssignment"]


@dataclass
class StreamAssignment:
    server: int
    utilization: float
    priority: int


class ServerPool:
    """A fixed set of accelerator servers plus the stream router."""

    def __init__(self, num_servers: int, *, ordering: str = "priority",
                 batching: bool = False, max_batch: int = 8,
                 name: str = "pool"):
        if num_servers < 1:
            raise ValueError(f"num_servers must be >= 1, got {num_servers}")
        self.batching = batching
        self._name = name
        self._ordering = ordering
        self._max_batch = max_batch
        if batching:
            self.servers: list[AcceleratorServer] = [
                BatchingServer(ordering=ordering, max_batch=max_batch,
                               name=f"{name}-{i}")
                for i in range(num_servers)
            ]
        else:
            self.servers = [
                AcceleratorServer(ordering=ordering, name=f"{name}-{i}")
                for i in range(num_servers)
            ]
        self._assign_lock = threading.Lock()
        self._streams: dict[str, StreamAssignment] = {}
        self._alive = [True] * num_servers
        self._monitor = None  # HeartbeatMonitor when detection is enabled
        self._detection = None  # (timeout, poll, on_death) once enabled
        self._draining: set[int] = set()
        self._migrations: dict[str, int] = {}  # stream -> destination

    # -- routing (partitioned, priority-aware worst-fit) -------------------
    def _route(self, utilization: float, priority: int) -> int:
        def load(i: int) -> tuple[float, int, int]:
            util = sum(a.utilization for a in self._streams.values()
                       if a.server == i)
            hp = sum(1 for a in self._streams.values()
                     if a.server == i and a.priority >= priority)
            return (util, hp, i)

        candidates = [i for i in range(len(self.servers))
                      if self._alive[i] and i not in self._draining]
        if not candidates:
            raise RuntimeError("no surviving servers in the pool")
        return min(candidates, key=load)

    def assign(self, stream: str, *, utilization: float = 0.0,
               priority: int = 0, server: int | None = None) -> int:
        """Bind ``stream`` to a server for its lifetime; returns the index.
        ``server`` pins the choice (e.g. from the admission controller's
        device assignment); otherwise the router picks worst-fit."""
        with self._assign_lock:
            if stream in self._streams:
                raise ValueError(f"stream {stream!r} already assigned")
            if server is None:
                server = self._route(utilization, priority)
            elif not (0 <= server < len(self.servers)):
                raise ValueError(f"server {server} outside pool of "
                                 f"{len(self.servers)}")
            elif not self._alive[server]:
                raise ValueError(f"server {server} has failed")
            elif server in self._draining:
                raise ValueError(f"server {server} is draining")
            self._streams[stream] = StreamAssignment(server, utilization, priority)
            return server

    def remove(self, stream: str) -> None:
        with self._assign_lock:
            self._streams.pop(stream, None)
            self._migrations.pop(stream, None)

    def server_of(self, stream: str) -> int:
        return self._streams[stream].server

    def server_for(self, stream: str) -> AcceleratorServer:
        return self.servers[self._streams[stream].server]

    def streams_on(self, si: int) -> list[str]:
        with self._assign_lock:
            return [n for n, a in self._streams.items() if a.server == si]

    # -- planned migration (see module docstring: steal policy lives in the
    # engine; this is the intent/commit protocol the router honors) --------
    def request_migration(self, stream: str, dst: int) -> bool:
        """Record the intent to move ``stream`` to server ``dst``.  The
        stream's own generating thread performs the actual block copy at
        its next decode-step boundary and then calls
        ``complete_migration``.  Returns False (no-op) when the move is
        not currently legal: unknown stream, dead/draining destination, or
        the stream is already there."""
        with self._assign_lock:
            a = self._streams.get(stream)
            if (a is None or not (0 <= dst < len(self.servers))
                    or not self._alive[dst] or dst in self._draining
                    or a.server == dst):
                return False
            self._migrations[stream] = dst
            return True

    def pending_migration(self, stream: str) -> int | None:
        with self._assign_lock:
            return self._migrations.get(stream)

    def cancel_migration(self, stream: str) -> None:
        with self._assign_lock:
            self._migrations.pop(stream, None)

    def complete_migration(self, stream: str) -> None:
        """Flip the binding AFTER the blocks landed on the destination —
        from here on the router sends the stream's requests there."""
        with self._assign_lock:
            dst = self._migrations.pop(stream, None)
            a = self._streams.get(stream)
            if dst is not None and a is not None and self._alive[dst]:
                a.server = dst

    # -- elastic membership ------------------------------------------------
    def draining(self) -> set[int]:
        with self._assign_lock:
            return set(self._draining)

    def begin_drain(self, si: int) -> None:
        """Take server ``si`` out of routing: no new assignments, never a
        migration destination.  Existing streams keep running until moved
        away; ``retire_server`` completes the removal."""
        if not (0 <= si < len(self.servers)) or not self._alive[si]:
            raise ValueError(f"server {si} is not alive")
        with self._assign_lock:
            self._draining.add(si)

    def retire_server(self, si: int) -> None:
        """Remove an empty drained server from the pool: it must hold no
        stream bindings (migrate or remove them first).  The server thread
        drains its queue and joins; the slot stays in ``servers`` (dead)
        so indices of other servers never shift."""
        with self._assign_lock:
            left = [n for n, a in self._streams.items() if a.server == si]
            if left:
                raise RuntimeError(
                    f"server {si} still owns streams {left}; migrate or "
                    "remove them before retiring")
            if not self._alive[si]:
                return
            self._alive[si] = False
            self._draining.discard(si)
            self._migrations = {s: d for s, d in self._migrations.items()
                                if d != si}
        if self._monitor is not None:
            self._monitor.unregister(self.servers[si].name)
        self.servers[si].shutdown(drain=True)

    def add_server(self) -> int:
        """Grow the pool by one server mid-traffic; returns its index.  The
        new server is wired into the heartbeat monitor when detection is
        enabled, and immediately eligible for routing and as a migration
        destination."""
        with self._assign_lock:
            si = len(self.servers)
            if self.batching:
                server: AcceleratorServer = BatchingServer(
                    ordering=self._ordering, max_batch=self._max_batch,
                    name=f"{self._name}-{si}")
            else:
                server = AcceleratorServer(ordering=self._ordering,
                                           name=f"{self._name}-{si}")
            self.servers.append(server)
            self._alive.append(True)
        if self._monitor is not None:
            self._wire_server(si)
        return si

    # -- fault tolerance ---------------------------------------------------
    def alive_servers(self) -> list[int]:
        return [i for i in range(len(self.servers)) if self._alive[i]]

    def evict_server(self, si: int, *, cause: BaseException | None = None,
                     reroute: bool = True) -> dict[str, int | None] | None:
        """Declare server ``si`` dead and displace its streams.

        Idempotent and safe to call from any thread — the heartbeat monitor
        calls it on stall, the server's own thread on fatal device error,
        the engine's recovery path when a client wakes with
        ``ServerFailedError``; whichever races first wins and the rest see
        ``None`` (already evicted — nothing displaced by *this* call).  The
        server is failed (all its suspended clients wake), and every stream
        assigned to it is displaced in decreasing priority: with
        ``reroute=True`` each is re-bound worst-fit among survivors
        (returned as ``{stream: new_server}``); with ``reroute=False`` the
        bindings are dropped and returned as ``{stream: None}`` so the
        caller (degraded-mode admission) decides placement — or shedding —
        itself.
        """
        if not (0 <= si < len(self.servers)):
            raise ValueError(f"server {si} outside pool of {len(self.servers)}")
        with self._assign_lock:
            if not self._alive[si]:
                return None
            self._alive[si] = False
            self._draining.discard(si)
            displaced = sorted(
                (name for name, a in self._streams.items() if a.server == si),
                key=lambda n: -self._streams[n].priority)
            # pending migrations to or from the dead server are moot: the
            # destination is gone, or the stream is being displaced anyway
            self._migrations = {
                s: d for s, d in self._migrations.items()
                if d != si and s not in displaced}
            if not any(self._alive):
                reroute = False  # nowhere left to put them
            moved: dict[str, int | None] = {}
            for name in displaced:
                a = self._streams.pop(name)
                if reroute:
                    new = self._route(a.utilization, a.priority)
                    self._streams[name] = StreamAssignment(
                        new, a.utilization, a.priority)
                    moved[name] = new
                else:
                    moved[name] = None
        if self._monitor is not None:
            self._monitor.unregister(self.servers[si].name)
        self.servers[si].fail(cause)  # reentrant-safe: _alive already False
        return moved

    def reassign(self, stream: str, server: int, *, utilization: float = 0.0,
                 priority: int = 0) -> None:
        """Re-bind a (possibly displaced) stream to an explicit live server
        — the degraded-admission path after ``evict_server(reroute=False)``."""
        with self._assign_lock:
            if not (0 <= server < len(self.servers)) or not self._alive[server]:
                raise ValueError(f"server {server} is not alive")
            if server in self._draining:
                raise ValueError(f"server {server} is draining")
            self._streams[stream] = StreamAssignment(
                server, utilization, priority)

    def enable_failure_detection(
        self, *, timeout: float = 1.0, poll: float = 0.05,
        on_death: Callable[[int, dict], None] | None = None,
    ) -> "Any":
        """Wire a ``HeartbeatMonitor`` across the pool: every server thread
        beats between device calls (and each ``poll``-ish interval while
        idle), so a single device call outlasting ``timeout`` is a stall
        and the monitor thread evicts that server from outside — the
        per-device-call timeout.  Detection covers every death path: stall
        (monitor thread) and fatal device error / retry exhaustion (the
        server's own thread, via ``fail`` -> ``on_failure``).

        With ``on_death`` set, eviction uses ``reroute=False`` and
        ``on_death(si, displaced)`` receives the dropped bindings — the
        serving engine hangs degraded-mode admission here.  Whichever path
        evicts first is the only one that fires ``on_death``.  Returns the
        monitor (owned by the pool; ``shutdown`` closes it)."""
        from repro_torch.runtime.fault_tolerance import HeartbeatMonitor

        self._detection = (timeout, poll, on_death)

        def _stalled(worker: str) -> None:
            si = next(i for i, s in enumerate(self.servers)
                      if s.name == worker)
            self._report_death(si, TimeoutError(
                f"no heartbeat from {worker!r} for {timeout}s"))

        monitor = HeartbeatMonitor(timeout=timeout, poll=poll,
                                   on_failure=_stalled)
        self._monitor = monitor
        for i in range(len(self.servers)):
            self._wire_server(i)
        return monitor

    def _report_death(self, si: int, cause: BaseException) -> None:
        on_death = self._detection[2] if self._detection else None
        displaced = self.evict_server(si, cause=cause,
                                      reroute=on_death is None)
        if displaced is not None and on_death is not None:
            on_death(si, displaced)

    def _wire_server(self, i: int) -> None:
        """Hook server ``i`` into the active HeartbeatMonitor — shared by
        ``enable_failure_detection`` (all servers) and ``add_server``
        (elastic join after detection is already on)."""
        _timeout, poll, _on_death = self._detection
        monitor, s = self._monitor, self.servers[i]
        monitor.register(s.name)
        s.beat = (lambda name=s.name: monitor.beat(name))
        s.beat_interval_s = min(s.beat_interval_s, max(poll, 1e-3))
        s.on_failure = (lambda server, si=i:
                        self._report_death(si, server.fail_cause))

    def attach_fault_injector(self, injector: "Any") -> None:
        """Install a ``runtime.faultinject.FaultInjector``'s per-server
        hooks into every server's device-call path."""
        injector.attach(self)

    # -- dispatch ----------------------------------------------------------
    def submit(self, stream: str, fn: Callable[[], Any], *, priority: int = 0,
               deadline: float | None = None, name: str = "") -> Request:
        return self.server_for(stream).submit(
            fn, priority=priority, deadline=deadline, name=name)

    def submit_batch(self, stream: str, payload: Any, *,
                     run_batch: Callable[[list[Any]], list[Any]],
                     batch_key: Hashable, priority: int = 0,
                     deadline: float | None = None,
                     name: str = "") -> BatchRequest:
        server = self.server_for(stream)
        if not isinstance(server, BatchingServer):
            raise TypeError("pool was built with batching=False")
        return server.submit_batch(payload, run_batch=run_batch,
                                   batch_key=batch_key, priority=priority,
                                   deadline=deadline, name=name)

    # -- measurement export ------------------------------------------------
    def cell_stats(self) -> dict:
        """Per-cell device-call aggregates merged across every server in the
        pool — one measurement table for the whole device fleet, in the
        shape ``analysis.cost_model.StepCostModel.ingest`` consumes.  The
        servers share jitted step functions (one engine), so same-cell calls
        on different devices price identically and pooling them is sound."""
        merged: dict = {}
        for s in self.servers:
            for key, cell in s.stats.cell_stats.items():
                if key in merged:
                    merged[key].merge(cell)
                else:
                    acc = CellStats()
                    acc.merge(cell)
                    merged[key] = acc
        return merged

    # -- lifecycle ---------------------------------------------------------
    def shutdown(self, *, drain: bool = True, timeout: float = 30.0) -> None:
        """Close the pool.  The monitor goes down FIRST — servers stop
        beating the moment they are told to stop, and a monitor left
        running would race eviction callbacks into a half-torn-down pool.
        With ``drain=True`` every server then finishes its queued and
        in-flight work before joining; with ``drain=False`` pending
        requests are failed (clients wake) and only in-flight work runs
        out."""
        if self._monitor is not None:
            self._monitor.close()
            self._monitor = None
        for s in self.servers:
            s.shutdown(drain=drain, timeout=timeout)

    def __len__(self) -> int:
        return len(self.servers)

    def __enter__(self) -> "ServerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
