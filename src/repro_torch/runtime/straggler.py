"""Straggler mitigation.

Two mechanisms, matching the two workload kinds:

  * Serving: the GPU server's request queue is the single control point
    (the paper's central-knowledge observation, §7).  ``DeadlineAwarePolicy``
    watches per-request handling times; when a stream's p95 handling time
    approaches its deadline it promotes the stream (or flips the server to
    EDF ordering), which is exactly the paper's priority-queue mechanism
    applied online.

  * Training: ``StepTimeWatchdog`` tracks per-step wall times; a step
    exceeding ``factor`` x the running p50 flags a straggler.  The standard
    mitigations at fleet scale are (a) within-pod: rely on XLA's collective
    timeouts, (b) cross-pod: drop the slow DP replica at the next
    checkpoint boundary (runtime.elastic plans the shrink).  The watchdog
    emits the signal; the supervisor applies (b).
"""

from __future__ import annotations

import statistics
import time
from collections import deque
from dataclasses import dataclass, field


class StepTimeWatchdog:
    def __init__(self, *, window: int = 50, factor: float = 3.0,
                 min_samples: int = 5, escalate_after: int = 3):
        self.times: deque[float] = deque(maxlen=window)
        self.factor = factor
        self.min_samples = min_samples
        self.escalate_after = escalate_after
        self.flagged: list[tuple[int, float]] = []
        self.consecutive = 0  # straggler steps in a row (degraded health)
        self._step = 0

    def observe(self, duration_s: float) -> bool:
        """Record a step duration; returns True if it is a straggler step."""
        self._step += 1
        is_straggler = False
        if len(self.times) >= self.min_samples:
            p50 = statistics.median(self.times)
            if duration_s > self.factor * p50:
                self.flagged.append((self._step, duration_s))
                is_straggler = True
        self.consecutive = self.consecutive + 1 if is_straggler else 0
        self.times.append(duration_s)
        return is_straggler

    @property
    def degraded(self) -> bool:
        """True once ``escalate_after`` consecutive steps ran slow — the
        owner should treat the device as unhealthy (serving wires this next
        to the heartbeat stall path as a softer escalation signal)."""
        return self.consecutive >= self.escalate_after


@dataclass
class StreamStats:
    deadline_ms: float
    handling_ms: deque = field(default_factory=lambda: deque(maxlen=100))


class DeadlineAwarePolicy:
    """Serving-side mitigation on top of core.server_runtime.

    ``observe(stream, handling_ms)`` feeds completions;
    ``at_risk()`` lists streams whose p95 handling time is within
    ``margin`` of their deadline;  ``boost(stream)`` returns the suggested
    priority bump (applied by the engine when submitting that stream's next
    requests)."""

    def __init__(self, *, margin: float = 0.8):
        self.margin = margin
        self.streams: dict[str, StreamStats] = {}

    def register(self, name: str, deadline_ms: float) -> None:
        self.streams[name] = StreamStats(deadline_ms)

    def observe(self, name: str, handling_ms: float) -> None:
        self.streams[name].handling_ms.append(handling_ms)

    def p95(self, name: str) -> float:
        h = sorted(self.streams[name].handling_ms)
        if not h:
            return 0.0
        return h[min(int(0.95 * len(h)), len(h) - 1)]

    def at_risk(self) -> list[str]:
        return [n for n, s in self.streams.items()
                if s.handling_ms and self.p95(n) > self.margin * s.deadline_ms]

    def boost(self, name: str, current_priority: int) -> int:
        return current_priority + (100 if name in self.at_risk() else 0)
