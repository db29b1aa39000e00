"""Arrival models: when does a stream release its jobs?

Copied from the port's ``scenarios/arrivals.py`` (``Periodic``,
``Sporadic``, ``Bursty``) so that the yardstick lives with the benchmark;
the models take a stream's period in ms instead of the port's ``Task``.
Each emits the absolute release instants (float ms) of one stream over a
horizon, by integer-nanosecond accumulation, and keeps the sporadic
contract: consecutive releases are at least one period apart.
"""

from __future__ import annotations

_NS = 1_000_000  # ns per ms


def _ns(ms: float) -> int:
    return int(round(ms * _NS))


class Periodic:
    """Strictly periodic releases: t = offset + k*T."""

    def __init__(self, offset_ms: float = 0.0):
        self.offset_ms = offset_ms

    def releases(self, period_ms: float, horizon_ms: float, rng) -> list[float]:
        t, step, horizon = _ns(self.offset_ms), _ns(period_ms), _ns(horizon_ms)
        out = []
        while t < horizon:
            out.append(t / _NS)
            t += step
        return out


class Sporadic:
    """Sporadic releases: each gap is T * (1 + U[slack])."""

    def __init__(self, slack: tuple[float, float] = (0.0, 0.5),
                 offset_ms: float = 0.0):
        lo, hi = slack
        if lo < 0 or hi < lo:
            raise ValueError(f"need 0 <= lo <= hi slack, got {slack}")
        self.slack = (lo, hi)
        self.offset_ms = offset_ms

    def releases(self, period_ms: float, horizon_ms: float, rng) -> list[float]:
        t, horizon = _ns(self.offset_ms), _ns(horizon_ms)
        out = []
        while t < horizon:
            out.append(t / _NS)
            t += _ns(period_ms * (1.0 + rng.uniform(*self.slack)))
        return out


class Bursty:
    """Two-state bursts: a Markov chain alternates between a BURST state
    (gap = T) and an IDLE state (gap = T * idle_factor); ``p_exit`` /
    ``p_enter`` are the per-arrival transition probabilities."""

    def __init__(self, p_enter: float = 0.15, p_exit: float = 0.3,
                 idle_factor: float = 4.0, start_bursting: bool = False,
                 offset_ms: float = 0.0):
        for name, p in (("p_enter", p_enter), ("p_exit", p_exit)):
            if not (0.0 < p <= 1.0):
                raise ValueError(f"{name} must be in (0, 1], got {p}")
        if idle_factor < 1.0:
            raise ValueError(
                f"idle_factor must be >= 1 (gap >= T), got {idle_factor}")
        self.p_enter, self.p_exit = p_enter, p_exit
        self.idle_factor = idle_factor
        self.start_bursting = start_bursting
        self.offset_ms = offset_ms

    def releases(self, period_ms: float, horizon_ms: float, rng) -> list[float]:
        t, horizon = _ns(self.offset_ms), _ns(horizon_ms)
        bursting = self.start_bursting
        out = []
        while t < horizon:
            out.append(t / _NS)
            if bursting:
                gap = period_ms
                if rng.random() < self.p_exit:
                    bursting = False
            else:
                gap = period_ms * self.idle_factor
                if rng.random() < self.p_enter:
                    bursting = True
            t += _ns(gap)
        return out


ARRIVALS = {"periodic": Periodic, "sporadic": Sporadic, "bursty": Bursty}


def make(model: str, **params):
    try:
        return ARRIVALS[model](**params)
    except KeyError:
        raise ValueError(f"unknown arrival model {model!r}; "
                         f"available: {sorted(ARRIVALS)}") from None
