"""A traced sub-window of a run: the profiler's device activities reduced
to device time by kernel name, the device's busy and idle time, and the
idle gaps named by the benchmark's host spans that were open in them.

The profiler runs on the main thread, which only sleeps inside it, so its
own host events are one marker: a ``record_function`` taken at a known
``time.monotonic()``, which puts the profiler's clock and the host spans
(``monotonic`` seconds) on one time line.  Only the key figures are kept,
never a raw timeline.
"""

from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass, field

import torch

MARK = "portbench.clock"


@dataclass
class Trace:
    t0: float            # host monotonic seconds the sub-window opened
    t1: float            # and closed
    busy_s: float        # union of device activity inside [t0, t1]
    kernel_s: Counter = field(default_factory=Counter)   # name -> seconds
    kernel_n: Counter = field(default_factory=Counter)   # name -> count
    gaps: list = field(default_factory=list)  # (seconds, midpoint host s)
    events: int = 0

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


def _ns(e, what: str) -> float:
    fn = getattr(e, f"{what}_ns", None)
    if fn is not None:
        return float(fn())
    return float(getattr(e, f"{what}_us")()) * 1e3


def profile(seconds: float, quiet) -> Trace:
    """Trace the card for ``seconds`` from now (the caller's thread sleeps
    meanwhile) and reduce the trace.  The profiler is started and stopped
    inside ``quiet()``, with no device call in flight: stopping it while
    other threads replayed CUDA graphs hung the process on the card.  The
    profiler's own parse of its events is skipped; the raw events are
    reduced here."""
    prof = torch.autograd.profiler.profile(use_device="cuda", use_kineto=True)
    prof._parse_kineto_results = lambda results: []
    with quiet():
        prof.__enter__()
    mark = time.monotonic()
    with torch.profiler.record_function(MARK):
        pass
    time.sleep(seconds)
    end = time.monotonic()
    with quiet():
        prof.__exit__(None, None, None)
    return reduce(prof.kineto_results.events(), mark, end)


def reduce(events, mark: float, end: float) -> Trace:
    """``events`` (kineto events) against the host clock: ``mark`` is the
    monotonic instant of the MARK annotation; the sub-window is [mark,
    end].  Device activity is clipped to it."""
    clock = [e for e in events if e.name() == MARK]
    if not clock:
        raise RuntimeError("the profiler lost its clock marker")
    base = _ns(clock[0], "start")
    out = Trace(t0=mark, t1=end, busy_s=0.0)
    spans = []
    for e in events:
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        s = mark + (_ns(e, "start") - base) / 1e9
        d = _ns(e, "duration") / 1e9
        a, b = max(s, mark), min(s + d, end)
        if b <= a:
            continue
        name = _short(e.name())
        out.kernel_s[name] += b - a
        out.kernel_n[name] += 1
        spans.append((a, b))
    out.events = len(spans)
    merged: list[list[float]] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    prev = mark
    for a, b in merged:
        out.busy_s += b - a
        if a > prev:
            out.gaps.append((a - prev, (a + prev) / 2))
        prev = b
    if end > prev:
        out.gaps.append((end - prev, (end + prev) / 2))
    return out


def _short(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    return name.removeprefix("void ").split("(")[0].split("<")[0]


def name_gaps(trace: Trace, spans, top: int = 10) -> list:
    """The ``top`` longest idle gaps, each named by the benchmark spans
    (``(name, t0, t1)`` in host seconds) open at its midpoint."""
    out = []
    for sec, mid in sorted(trace.gaps, reverse=True)[:top]:
        open_ = sorted({n for n, a, b in spans if a <= mid <= b})
        out.append(["+".join(open_) or "no_span", sec])
    return out


def device_ops(trace: Trace, top: int = 10) -> list:
    return [[n, s] for n, s in trace.kernel_s.most_common(top)]
