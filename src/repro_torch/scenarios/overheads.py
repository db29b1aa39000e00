"""Pluggable overhead models: what does one server invocation cost?

The paper folds all server-side CPU overhead into a single bound ``eps``
(Lemma 1: 2*eps extra CPU per request).  An overhead model maps the
taskset generator's base epsilon to the value the built ``System`` carries
— the analyses and the simulator both consume ``System.epsilon``, so one
knob moves both sides in lockstep and bound-dominance is preserved by
construction.

The ``measured`` model closes the loop to real timings the same way the
``measured`` ETM does: epsilon becomes the fitted per-call dispatch
intercept of a :class:`~repro_torch.analysis.cost_model.StepCostModel` — the
runtime analogue of the paper's eps (see ``dispatch_overhead_s``).
"""

from __future__ import annotations

import math

from .registry import Registry

__all__ = ["OVERHEADS"]

OVERHEADS = Registry("overhead model")


@OVERHEADS.register("constant")
class Constant:
    """A fixed epsilon: the explicit ``epsilon_ms`` when given, else the
    generator's base value passes through unchanged."""

    def __init__(self, epsilon_ms: float | None = None):
        if epsilon_ms is not None and epsilon_ms < 0:
            raise ValueError(f"epsilon_ms must be >= 0, got {epsilon_ms}")
        self.epsilon_ms = epsilon_ms

    def epsilon(self, base_ms: float) -> float:
        return base_ms if self.epsilon_ms is None else self.epsilon_ms


@OVERHEADS.register("zero")
class Zero:
    """Idealized zero-overhead server (the eps -> 0 limit the paper's
    Fig. 13 sensitivity sweep approaches)."""

    def epsilon(self, base_ms: float) -> float:
        return 0.0


@OVERHEADS.register("scaled")
class Scaled:
    """Base epsilon scaled by ``factor`` (the Fig. 13 eps-sensitivity axis)."""

    def __init__(self, factor: float = 1.0):
        if factor < 0:
            raise ValueError(f"factor must be >= 0, got {factor}")
        self.factor = factor

    def epsilon(self, base_ms: float) -> float:
        return base_ms * self.factor


@OVERHEADS.register("measured")
class MeasuredIntercept:
    """Epsilon = the cost model's fitted per-call dispatch intercept (the
    measured analogue of the paper's eps), floored at the generator's base
    value so the bound never claims less overhead than the paper assumes."""

    def __init__(self, cost_model=None, phase: str = "decode",
                 floor_at_base: bool = True):
        if cost_model is None:
            raise ValueError(
                "overheads 'measured' needs a StepCostModel: pass "
                "cost_model= to scenario build()/run()")
        self.cost_model = cost_model
        self.phase = phase
        self.floor_at_base = floor_at_base

    def epsilon(self, base_ms: float) -> float:
        eps_ms = self.cost_model.dispatch_overhead_s(self.phase) * 1e3
        if not math.isfinite(eps_ms):
            return base_ms  # unmeasured phase: keep the declared overhead
        return max(eps_ms, base_ms) if self.floor_at_base else eps_ms
