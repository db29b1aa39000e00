"""Pluggable arrival models: when does each task release jobs?

Every model emits a list of absolute release instants (float ms) for one
task over the simulation horizon.  The one invariant every registered model
MUST keep — and :func:`check_min_separation` verifies — is the sporadic
task model's contract: consecutive releases of a task are separated by at
least its minimum inter-arrival time ``T``.  The schedulability analyses
(Eqs (1)-(6) and the MPCP/FMLP+ baselines) assume exactly that and nothing
more about arrivals, so any model registered here is automatically inside
the workload class the bounds claim to cover; richer traffic shapes
(bursts, diurnal swells, flash crowds, recorded traces) only modulate gaps
UPWARD from ``T``.

Releases are computed by integer-nanosecond accumulation, matching the
simulator's internal clock, so the ``periodic`` model replays the legacy
``simulate()`` release loop bit-for-bit (the golden-replay property test
pins this).

Registering a new model::

    @ARRIVALS.register("my_arrivals")
    class MyArrivals:
        def __init__(self, **config_params): ...
        def releases(self, task, horizon_ms, rng) -> list[float]: ...
"""

from __future__ import annotations

import json
import math
import pathlib
import re
import zlib
from typing import Mapping, Sequence

from repro_torch.core.task_model import Task

from .registry import Registry

__all__ = ["ARRIVALS", "check_min_separation"]

ARRIVALS = Registry("arrival model")

_NS = 1_000_000  # ns per ms, the simulator's clock resolution


def _ns(ms: float) -> int:
    return int(round(ms * _NS))


def check_min_separation(task: Task, releases: Sequence[float]) -> None:
    """Raise if ``releases`` violates the sporadic contract (gap < T)."""
    for a, b in zip(releases, releases[1:]):
        if b - a < task.T - 1e-6:
            raise ValueError(
                f"{task.name}: inter-arrival {b - a:.6f} ms < T={task.T} ms "
                f"(arrival models must respect the sporadic minimum gap)")


@ARRIVALS.register("periodic")
class Periodic:
    """Strictly periodic releases: t = offset + k*T (the paper's §6.3
    synchronous-release experiments; ``offset_ms`` per-task phasing)."""

    def __init__(self, offset_ms: float = 0.0):
        self.offset_ms = offset_ms

    def releases(self, task: Task, horizon_ms: float, rng) -> list[float]:
        t, step, horizon = _ns(self.offset_ms), _ns(task.T), _ns(horizon_ms)
        out = []
        while t < horizon:
            out.append(t / _NS)
            t += step
        return out


@ARRIVALS.register("sporadic")
class Sporadic:
    """Sporadic releases: each gap is T * (1 + U[slack]) — the legal
    worst case (slack=(0,0)) up to arbitrarily lazy arrivals."""

    def __init__(self, slack: tuple[float, float] = (0.0, 0.5),
                 offset_ms: float = 0.0):
        lo, hi = slack
        if lo < 0 or hi < lo:
            raise ValueError(f"need 0 <= lo <= hi slack, got {slack}")
        self.slack = (lo, hi)
        self.offset_ms = offset_ms

    def releases(self, task: Task, horizon_ms: float, rng) -> list[float]:
        t, horizon = _ns(self.offset_ms), _ns(horizon_ms)
        out = []
        while t < horizon:
            out.append(t / _NS)
            t += _ns(task.T * (1.0 + rng.uniform(*self.slack)))
        return out


@ARRIVALS.register("bursty")
class Bursty:
    """Two-state MMPP-style bursts: a Markov chain alternates between a
    BURST state (back-to-back legal arrivals, gap = T) and an IDLE state
    (gap = T * idle_factor).  ``p_exit``/``p_enter`` are the per-arrival
    transition probabilities out of burst / into burst; a flash crowd is
    the limit of long idle dwell followed by a long burst dwell
    (small p_enter, small p_exit)."""

    def __init__(self, p_enter: float = 0.15, p_exit: float = 0.3,
                 idle_factor: float = 4.0, start_bursting: bool = False):
        for name, p in (("p_enter", p_enter), ("p_exit", p_exit)):
            if not (0.0 < p <= 1.0):
                raise ValueError(f"{name} must be in (0, 1], got {p}")
        if idle_factor < 1.0:
            raise ValueError(
                f"idle_factor must be >= 1 (gap >= T), got {idle_factor}")
        self.p_enter, self.p_exit = p_enter, p_exit
        self.idle_factor = idle_factor
        self.start_bursting = start_bursting

    def releases(self, task: Task, horizon_ms: float, rng) -> list[float]:
        t, horizon = 0, _ns(horizon_ms)
        bursting = self.start_bursting
        out = []
        while t < horizon:
            out.append(t / _NS)
            if bursting:
                gap = task.T
                if rng.random() < self.p_exit:
                    bursting = False
            else:
                gap = task.T * self.idle_factor
                if rng.random() < self.p_enter:
                    bursting = True
            t += _ns(gap)
        return out


@ARRIVALS.register("diurnal")
class Diurnal:
    """Slow sinusoidal load modulation: the gap multiplier swings between 1
    (peak traffic, gap = T) and 1 + amplitude (trough) over ``cycles`` full
    periods of the horizon — the compressed diurnal curve."""

    def __init__(self, cycles: float = 2.0, amplitude: float = 2.0,
                 phase: float = 0.0):
        if cycles <= 0:
            raise ValueError(f"cycles must be > 0, got {cycles}")
        if amplitude < 0:
            raise ValueError(f"amplitude must be >= 0, got {amplitude}")
        self.cycles, self.amplitude, self.phase = cycles, amplitude, phase

    def releases(self, task: Task, horizon_ms: float, rng) -> list[float]:
        t, horizon = 0, _ns(horizon_ms)
        out = []
        while t < horizon:
            out.append(t / _NS)
            # load(x) in [0,1]: 1 at the daily peak, 0 at the trough
            x = (t / horizon) * self.cycles + self.phase
            load = 0.5 * (1.0 + math.sin(2.0 * math.pi * x))
            gap = task.T * (1.0 + self.amplitude * (1.0 - load))
            t += _ns(gap)
        return out


@ARRIVALS.register("trace")
class TraceDriven:
    """Replay recorded release instants.

    Two sources, one required: ``releases_ms`` maps task name to absolute
    release times (ms) inline; ``path`` loads a JSONL trace file — one
    ``{"at_ms": <float>, "task": "<key>"}`` event per line (lines without
    ``at_ms`` are metadata and skipped).  Relative paths resolve against
    the checked-in corpus at ``repro/scenarios/traces/``.

    ``assign`` maps generated tasks onto trace keys: ``"by_name"`` (the
    default) requires exact name matches, tasks absent from the trace fall
    back to periodic releases; ``"round_robin"`` deals the sorted trace
    keys out by each task's numeric suffix (``tau7`` -> keys[7 % n]), so
    any generated taskset replays a fixed corpus.

    ``normalize=True`` rescales each task's recorded gaps so its MINIMUM
    gap equals its declared ``T`` (events shifted to start at 0) — the
    trace contributes its burst *shape* while the sporadic contract holds
    by construction.  Without it, the raw instants must already respect
    every task's T: the minimum-gap check is validated at generation time,
    and a trace that violates it is outside what the analysis covers and
    is rejected loudly."""

    def __init__(self, releases_ms: Mapping[str, Sequence[float]] | None
                 = None, path: str | None = None,
                 assign: str = "by_name", normalize: bool = False):
        if (releases_ms is None) == (path is None):
            raise ValueError("give exactly one of releases_ms= or path=")
        if assign not in ("by_name", "round_robin"):
            raise ValueError(f"unknown assign mode {assign!r}")
        if path is not None:
            releases_ms = _load_trace(path)
        self.releases_ms = {k: tuple(float(x) for x in v)
                            for k, v in releases_ms.items()}
        self.assign = assign
        self.normalize = normalize

    def _key_for(self, task: Task) -> str | None:
        if self.assign == "by_name":
            return task.name if task.name in self.releases_ms else None
        keys = sorted(self.releases_ms)
        if not keys:
            return None
        m = re.search(r"(\d+)$", task.name)
        idx = int(m.group(1)) if m else zlib.crc32(task.name.encode())
        return keys[idx % len(keys)]

    def releases(self, task: Task, horizon_ms: float, rng) -> list[float]:
        key = self._key_for(task)
        if key is None:
            return Periodic().releases(task, horizon_ms, rng)
        rec = sorted(self.releases_ms[key])
        if self.normalize and len(rec) > 1:
            min_gap = min(b - a for a, b in zip(rec, rec[1:]))
            if min_gap <= 0:
                raise ValueError(
                    f"trace key {key!r} has duplicate instants; cannot "
                    "normalize")
            scale = task.T / min_gap
            rec = [(r - rec[0]) * scale for r in rec]
        out = [r for r in rec if r < horizon_ms]
        check_min_separation(task, out)
        return out


def _load_trace(path: str) -> dict[str, list[float]]:
    """Parse a JSONL arrival trace into {task_key: [at_ms, ...]}."""
    p = pathlib.Path(path)
    if not p.is_absolute():
        p = pathlib.Path(__file__).parent / "traces" / p
    out: dict[str, list[float]] = {}
    with open(p) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            ev = json.loads(line)
            if "at_ms" not in ev:
                continue  # metadata line
            out.setdefault(str(ev["task"]), []).append(float(ev["at_ms"]))
    if not out:
        raise ValueError(f"trace {p} holds no events")
    return out
