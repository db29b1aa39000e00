"""The program's own spans read against the traced sub-window.

The program traces while the profiler records: each server switches at
its first device call after the profiler starts or stops, and the switch
takes effect at its next dispatch unit.  The records, read from the engine
(``ServeEngine.trace_records``) once the window has drained, are tuples
(server, name, t0, t1, call_id, request_id) on the host clock
(``time.monotonic``), the clock the trace's idle gaps are on.  A batched
call's "call" span holds its steps, "stage", "wait" and "readback", under
its call id; an insert's call holds an "insert"; each request has a
"request" span (submit to end) and its client a "wake" (the request's end
to the client's return from ``wait``).  A decode call is known by its
``batch_meta`` entry, which the benchmark copied (``Recorder.meta``) with
the instant it was recorded, inside its call on its server.

Every reader of a run returns None when the run holds no trace or no
program spans (a program without ``trace_records``, or one that recorded
none).
"""

from __future__ import annotations

import bisect
import statistics
from collections import defaultdict

SERVER, NAME, T0, T1, CALL, REQUEST = range(6)
STEPS = ("stage", "wait", "readback")


def records(run):
    """The program's records, or None without a trace, or when the
    program keeps none or recorded none."""
    fn = getattr(run.rec.eng, "trace_records", None)
    return None if fn is None or run.trace is None else fn() or None


def traced_from(spans, trace) -> float:
    """The instant from which every server that made a call in the
    sub-window traced each of its calls: the latest of the servers' first
    traced calls that began inside the sub-window, or its start.  A
    server's first call after the profiler starts is the one in which it
    switches, and goes untraced."""
    first: dict = {}
    for s in spans:
        if s[NAME] == "call" and s[T0] < trace.t1:
            first[s[SERVER]] = min(first.get(s[SERVER], s[T0]), s[T0])
    return max([trace.t0, *first.values()])


def decode_calls(run) -> list[dict] | None:
    """The decode calls that began and ended inside the traced sub-window,
    each as {"server", "call_id", "meta" (its ``batch_meta`` entry),
    "steps" (step name -> seconds)}; calls traced without all three steps
    are left out."""
    spans = records(run)
    if spans is None:
        return None
    tr = run.trace
    calls = defaultdict(list)  # server -> [(t0, t1, call_id)], by t0
    steps = defaultdict(dict)  # (server, call_id) -> {name: seconds}
    for s in spans:
        if s[NAME] == "call" and tr.t0 <= s[T0] and s[T1] <= tr.t1:
            calls[s[SERVER]].append((s[T0], s[T1], s[CALL]))
        elif s[NAME] in STEPS:
            steps[(s[SERVER], s[CALL])][s[NAME]] = s[T1] - s[T0]
    for v in calls.values():
        v.sort()
    out = []
    for t, si, meta in run.rec.meta:
        if meta["kind"].split("@")[0] != "decode":
            continue
        mine = calls.get(si, ())
        i = bisect.bisect_right(mine, (t, float("inf"))) - 1
        if i < 0 or not mine[i][0] <= t <= mine[i][1]:
            continue
        cid = mine[i][2]
        found = steps.get((si, cid), {})
        if len(found) == len(STEPS):
            out.append({"server": si, "call_id": cid, "meta": meta,
                        "steps": found})
    return out


def step_ms(run, name: str) -> float | None:
    """Mean seconds of step ``name`` of the sub-window's decode calls, in
    ms.  A step holds no span of its own, so its length is its self
    time."""
    calls = decode_calls(run)
    if not calls:
        return None
    return 1e3 * statistics.fmean(c["steps"][name] for c in calls)


def wake_ms(run) -> float | None:
    """Mean "wake" of the requests the sub-window's decode calls served,
    in ms."""
    calls = decode_calls(run)
    if not calls:
        return None
    keys = {(c["server"], c["call_id"]) for c in calls}
    wakes = [s[T1] - s[T0] for s in records(run)
             if s[NAME] == "wake" and (s[SERVER], s[CALL]) in keys]
    return 1e3 * statistics.fmean(wakes) if wakes else None


def coalesced_share(run) -> float | None:
    """Mean over the sub-window's decode calls of their rows over the
    server's streams in their decode loop when the call began, in %."""
    calls = decode_calls(run)
    shares = [c["meta"]["rows"] / c["meta"]["decoding"]
              for c in calls or () if c["meta"].get("decoding")]
    return 100.0 * statistics.fmean(shares) if shares else None


def idle_intervals(trace, start=None) -> list[tuple[float, float]]:
    """The trace's idle gaps, (seconds, midpoint), as intervals clipped to
    the sub-window (from ``start`` when given), in order."""
    out = []
    lo = trace.t0 if start is None else start
    for sec, mid in trace.gaps:
        a, b = max(mid - sec / 2, lo), min(mid + sec / 2, trace.t1)
        if b > a:
            out.append((a, b))
    return sorted(out)


def union(intervals) -> list[tuple[float, float]]:
    """Disjoint intervals, in order, that cover ``intervals``."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap(xs, ys) -> float:
    """Length of the intersection of two lists of disjoint intervals, each
    in order."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share_in(run, names, *, inside: bool = True) -> float | None:
    """Share of the sub-window's device-idle time during which a span
    named in ``names`` was open on some server (``inside``), or none was,
    in %.  The idle time is taken from ``traced_from`` on, where every
    server's spans are whole."""
    spans = records(run)
    if spans is None or not run.trace.events:
        return None
    idle = idle_intervals(run.trace, traced_from(spans, run.trace))
    total = sum(b - a for a, b in idle)
    if total <= 0:
        return None
    covered = overlap(idle, union((s[T0], s[T1]) for s in spans
                                  if s[NAME] in names))
    return 100.0 * (covered if inside else total - covered) / total


def named_gaps(run, top: int = 10) -> list | None:
    """The ``top`` longest idle gaps of the sub-window, longest first,
    each as [ms, the program's spans open at its midpoint as
    "server:name", joined by "+", or "none"]."""
    spans = records(run)
    if spans is None:
        return None
    out = []
    for sec, mid in sorted(run.trace.gaps, reverse=True)[:top]:
        names = sorted({f"{s[SERVER]}:{s[NAME]}" for s in spans
                        if s[T0] <= mid <= s[T1]})
        out.append([1e3 * sec, "+".join(names) or "none"])
    return out
