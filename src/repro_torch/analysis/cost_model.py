"""Calibrated step-cost model: measured batch_meta cells -> priced shapes.

The serving stack buckets every device call into a shape CELL —
``("decode", padded_rows, table_width)`` or ``("prefill", padded_rows,
len_bucket)``, the post-bucketing shape that names the jit trace
(``core.server_runtime.cell_key``) — and the dispatcher reports each call's
cell plus its timed duration into running per-cell aggregates
(``ServerStats.cell_stats``, merged pool-wide by ``ServerPool.cell_stats``).

This module closes the measurement -> admission loop on those aggregates,
PPT-style (hybrid analytic/empirical: an analytic surface calibrated
against a few measured points prices unseen shapes):

  * ``StepCostModel.ingest`` loads measured cells; ``fit`` solves a
    per-phase non-negative least-squares surface over roofline-shaped
    features — an intercept (the per-call dispatch overhead, the runtime
    analogue of the paper's eps), a ``rows`` term (per-row compute +
    parameter traffic: the compute_ms axis), and a ``rows*width`` term (KV
    bytes gathered: the memory_ms axis).  The fitted coefficients are the
    ACHIEVED per-unit rates, where ``analysis.roofline`` uses peak-hardware
    constants; ``roofline_features`` swaps in statically priced
    (flops, bytes) per cell — e.g. from ``hlo_cost.analyze_text`` — so the
    coefficients become dimensionless efficiency factors.
  * ``predict`` prices any cell: the measured mean where the cell was
    observed, the fitted surface elsewhere (interpolation via the roofline
    terms).  ``error_report`` tracks surface-vs-measured relative error per
    cell — the BENCH_cost_model.json artifact.
  * Three consumers feed back:
      (a) ``recost`` re-prices a task's GPU segments at
          ``min(declared, predicted)`` for the cell it actually runs in —
          calibrated admission (``core.admission`` with ``cost_model=``)
          admits a superset of the worst-case-declared sets by
          construction, and the per-server bounds stay sound because the
          analysis and the simulated execution use the same calibrated
          costs (Eqs (1)-(6) are monotone in segment costs).
      (b) ``autotune_buckets`` picks the pow2 bucket boundaries minimizing
          predicted padding waste for an observed length distribution
          (``ServeEngine.tune_buckets``).
      (c) ``TrafficModel`` names the cells a workload will actually hit so
          ``ServeEngine.precompile(traffic=...)`` warms only those.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Callable, Iterable, Mapping, Sequence

import numpy as np

from repro_torch.core.server_runtime import CellStats, cell_key

__all__ = [
    "CellKey",
    "StepCostModel",
    "TrafficModel",
    "autotune_buckets",
    "bucket_up",
    "hlo_cell_features",
    "roofline_features",
]

CellKey = tuple  # (phase, rows, width_or_bucket), pow2-bucketed values


def bucket_up(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; the largest bucket when none covers (callers
    guarantee the largest bucket covers every legal n)."""
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


def _default_work(cell: CellKey) -> tuple[float, float]:
    """Roofline-shaped features of a cell: (rows, rows*width).

    ``rows`` scales the per-row compute + parameter-read term (every row
    reads the full weight stack once per step on the compute_ms axis);
    ``rows*width`` scales the KV-gather traffic (bytes grow with the block
    table's live width on the memory_ms axis).  The fit's coefficients are
    then the achieved seconds-per-row and seconds-per-block-row."""
    _, rows, width = cell
    return (float(rows), float(rows) * float(width))


def roofline_features(flops_of: Callable[[CellKey], float],
                      bytes_of: Callable[[CellKey], float]):
    """Build a ``work`` callable from static per-cell pricing — e.g.
    ``hlo_cost.analyze_text`` FLOPs/bytes of the cell's trace — normalized
    by the peak-rate constants so the fitted coefficients are dimensionless
    achieved-fraction-of-peak factors (the roofline interpolation input)."""
    from repro_torch.analysis import roofline

    def work(cell: CellKey) -> tuple[float, float]:
        return (flops_of(cell) / roofline.PEAK_FLOPS,
                bytes_of(cell) / roofline.HBM_BW)

    return work


def hlo_cell_features(costs: Mapping[CellKey, tuple[float, float]]):
    """Build a ``work`` callable from static HLO per-cell pricing.

    ``costs`` maps CellKey -> (flops, hbm_bytes) — e.g.
    ``ServeEngine.static_cell_costs``, which compiles each cell's trace and
    walks the optimized HLO with ``analysis.hlo_cost``.  Listed cells get
    their EXACT normalized roofline features; an unlisted cell of a listed
    phase is extrapolated from a per-phase least-squares fit of the listed
    cells' flops/bytes over the default ``[1, rows, rows*width]`` basis —
    so a migration or scatter width never observed at runtime still prices
    off static analysis instead of falling to ``inf``/declared worst case.
    Phases with no static pricing at all keep the default
    ``(rows, rows*width)`` analytic features, making this a strict
    refinement of ``_default_work``."""
    by_phase: dict[str, list[CellKey]] = {}
    for cell in costs:
        by_phase.setdefault(cell[0], []).append(cell)
    fits: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    for phase, keys in by_phase.items():
        X = np.array([[1.0, k[1], float(k[1]) * float(k[2])] for k in keys])
        fl = np.array([costs[k][0] for k in keys])
        by = np.array([costs[k][1] for k in keys])
        tf, *_ = np.linalg.lstsq(X, fl, rcond=None)
        tb, *_ = np.linalg.lstsq(X, by, rcond=None)
        fits[phase] = (tf, tb)

    def _static(cell: CellKey) -> tuple[float, float] | None:
        got = costs.get(cell)
        if got is not None:
            return got
        fit = fits.get(cell[0])
        if fit is None:
            return None
        x = np.array([1.0, cell[1], float(cell[1]) * float(cell[2])])
        return (max(float(fit[0] @ x), 0.0), max(float(fit[1] @ x), 0.0))

    normalized = roofline_features(lambda c: _static(c)[0],
                                   lambda c: _static(c)[1])

    def work(cell: CellKey) -> tuple[float, float]:
        if _static(cell) is None:
            return _default_work(cell)
        return normalized(cell)

    return work


def _nnls(X: np.ndarray, y: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Weighted least squares with non-negative coefficients (single-pass
    active set: solve, clamp negatives to zero, re-solve the rest).  A
    negative cost coefficient is nonphysical — cells cannot get cheaper as
    they grow — and would break the monotonicity calibrated admission
    leans on."""
    sw = np.sqrt(w)[:, None]
    active = list(range(X.shape[1]))
    theta = np.zeros(X.shape[1])
    for _ in range(X.shape[1]):
        sol, *_ = np.linalg.lstsq(X[:, active] * sw, y * sw[:, 0],
                                  rcond=None)
        if (sol >= 0).all() or len(active) == 1:
            sol = np.maximum(sol, 0.0)
            for i, a in enumerate(active):
                theta[a] = sol[i]
            return theta
        active = [a for a, s in zip(active, sol) if s >= 0]
    return theta


@dataclass
class _PhaseFit:
    theta: np.ndarray  # (1 + n_features,): intercept first
    n_cells: int


@dataclass
class StepCostModel:
    """Per-cell step-cost surfaces fit from measured device calls.

    ``work`` maps a cell to its analytic feature vector (default: the
    (rows, rows*width) roofline axes; see ``roofline_features`` for
    statically priced variants).  ``safety`` scales predictions used for
    admission recosting — a calibration margin over the measured mean."""

    work: Callable[[CellKey], Sequence[float]] = _default_work
    safety: float = 1.2
    cells: dict = field(default_factory=dict)  # CellKey -> CellStats
    _fits: dict = field(default_factory=dict)  # phase -> _PhaseFit

    # -- measurement intake ------------------------------------------------
    def observe(self, cell: CellKey, seconds: float, *,
                rows: int | None = None) -> None:
        """Add one timed call of ``cell`` (bench-run intake path)."""
        stats = self.cells.get(cell)
        if stats is None:
            stats = self.cells[cell] = CellStats()
        stats.add({"rows": rows if rows is not None else cell[1],
                   "seconds": seconds})
        self._fits.clear()

    def ingest(self, source) -> int:
        """Load measurements from ``ServerPool.cell_stats()`` /
        ``ServerStats.cell_stats`` (a mapping of CellKey -> CellStats) or
        from an iterable of raw ``batch_meta`` dicts carrying ``seconds``.
        Returns the number of cells updated."""
        n = 0
        if isinstance(source, Mapping):
            for key, stats in source.items():
                if not stats.timed:
                    continue
                mine = self.cells.get(key)
                if mine is None:
                    mine = self.cells[key] = CellStats()
                mine.merge(stats)
                n += 1
        else:
            touched = set()
            for meta in source:
                key = cell_key(meta)
                if key is None or meta.get("seconds") is None:
                    continue
                mine = self.cells.get(key)
                if mine is None:
                    mine = self.cells[key] = CellStats()
                mine.add(meta)
                touched.add(key)
            n = len(touched)
        if n:
            self._fits.clear()
        return n

    # -- fitting -----------------------------------------------------------
    def fit(self) -> dict:
        """Fit one non-negative least-squares surface per phase over the
        measured cell means, weighted by sample count.  Returns
        {phase: intercept-first coefficient list}."""
        by_phase: dict[str, list[CellKey]] = {}
        for key, stats in self.cells.items():
            if stats.timed:
                by_phase.setdefault(key[0], []).append(key)
        self._fits.clear()
        for phase, keys in by_phase.items():
            X = np.array([[1.0, *self.work(k)] for k in keys])
            y = np.array([self.cells[k].mean_s for k in keys])
            w = np.array([float(self.cells[k].timed) for k in keys])
            self._fits[phase] = _PhaseFit(_nnls(X, y, w), len(keys))
        return {p: f.theta.tolist() for p, f in self._fits.items()}

    def _surface(self, cell: CellKey) -> float:
        if not self._fits:
            self.fit()
        f = self._fits.get(cell[0])
        if f is None:
            return math.inf  # unmeasured phase: calibration cannot price it
        return float(f.theta @ np.array([1.0, *self.work(cell)]))

    # -- pricing -----------------------------------------------------------
    def predict(self, phase: str, rows: int, width: int, *,
                surface_only: bool = False) -> float:
        """Predicted step cost of one cell in SECONDS: the measured mean
        where the cell was observed, the fitted surface elsewhere
        (roofline-feature interpolation).  ``inf`` when the model has no
        data for the phase at all — callers degrade to their declared
        worst case, so an empty model is exactly the uncalibrated mode."""
        cell = (phase, rows, width)
        stats = self.cells.get(cell)
        if stats is not None and stats.timed and not surface_only:
            return stats.mean_s
        return self._surface(cell)

    def dispatch_overhead_s(self, phase: str = "decode") -> float:
        """The fitted intercept: per-device-call cost at zero work — the
        measured analogue of the paper's server overhead eps."""
        if not self._fits:
            self.fit()
        f = self._fits.get(phase)
        return float(f.theta[0]) if f is not None else math.inf

    # -- admission feedback ------------------------------------------------
    def recost(self, task, cells) -> "object":
        """Re-price a task's GPU segments at ``min(declared,
        safety * predict(cell))`` — the calibrated-admission input.

        ``cells`` is one CellKey applied to every segment, or a sequence of
        eta_i keys (``None`` entries keep that segment's declared cost).
        The min() keeps each calibrated cost <= the declared worst case, so
        every task set admitted under declared costs is admitted under
        calibrated costs (the analysis is monotone in segment costs), and
        the bound stays sound as long as real calls run within the
        calibrated cost — which the safety margin over the measured mean
        plus the error report are there to police."""
        if not task.segments:
            return task
        if cells is None or isinstance(cells, tuple) and cells and \
                isinstance(cells[0], str):
            cells = [cells] * len(task.segments)
        if len(cells) != len(task.segments):
            raise ValueError(
                f"{task.name}: {len(cells)} cells for {task.eta} segments")
        segs = []
        for seg, cell in zip(task.segments, cells):
            if cell is None:
                segs.append(seg)
                continue
            pred_ms = self.predict(*cell) * self.safety * 1e3
            if not pred_ms < seg.total:  # inf or no improvement: declared
                segs.append(seg)
                continue
            scale = pred_ms / seg.total
            segs.append(replace(seg, e=seg.e * scale, m=seg.m * scale))
        return replace(task, segments=tuple(segs))

    # -- tracking ----------------------------------------------------------
    def error_report(self) -> dict:
        """Surface-vs-measured relative error per measured cell (the
        tracked predicted-vs-measured artifact).  The surface is used even
        for measured cells here — this scores the interpolator that prices
        UNSEEN cells, not the lookup table."""
        rows = []
        errs = []
        for key in sorted(self.cells):
            stats = self.cells[key]
            if not stats.timed:
                continue
            pred = self._surface(key)
            rel = (abs(pred - stats.mean_s) / stats.mean_s
                   if stats.mean_s > 0 else math.inf)
            errs.append(rel)
            rows.append({
                "cell": list(key), "calls": stats.calls,
                "timed": stats.timed, "measured_s": stats.mean_s,
                "std_s": math.sqrt(stats.var_s), "predicted_s": pred,
                "rel_err": rel,
            })
        errs.sort()
        median = errs[len(errs) // 2] if errs else math.inf
        return {"cells": rows, "n_cells": len(rows),
                "median_rel_err": median,
                "coeffs": {p: f.theta.tolist()
                           for p, f in self._fits.items()}}


class TrafficModel:
    """Which cells will traffic actually hit?  Fitted from the observed
    per-cell call counts; ``hot_cells`` names every cell carrying at least
    ``min_share`` of a phase's calls — the precompile planner's input
    (``ServeEngine.precompile(traffic=...)``)."""

    def __init__(self, counts: Mapping[CellKey, int]):
        self.counts = {k: int(v) for k, v in counts.items() if v > 0}

    @classmethod
    def from_stats(cls, cell_stats: Mapping[CellKey, CellStats]
                   ) -> "TrafficModel":
        return cls({k: s.calls for k, s in cell_stats.items()})

    def hot_cells(self, *, min_share: float = 0.0) -> set:
        phase_total: dict[str, int] = {}
        for key, n in self.counts.items():
            phase_total[key[0]] = phase_total.get(key[0], 0) + n
        return {key for key, n in self.counts.items()
                if n >= min_share * phase_total[key[0]]}


def autotune_buckets(values: Iterable[int], candidates: Sequence[int], *,
                     max_buckets: int,
                     cost_of: Callable[[int, int], float] | None = None,
                     ) -> tuple[int, ...]:
    """Pick <= ``max_buckets`` bucket boundaries from ``candidates`` (the
    pow2 ladder — trace shapes must stay pow2-bucketed) minimizing the
    total bucketing cost of the observed ``values`` distribution.

    ``cost_of(bucket, value)`` prices one value landing in ``bucket``
    (default: the padding waste ``bucket - value``; pass a closure over
    ``StepCostModel.predict`` to price in predicted seconds instead).  The
    largest candidate is always kept so every legal value stays covered —
    dropping the cover would re-route work to a trace that cannot hold it.
    Exact DP over (candidate index, buckets used): candidates and
    max_buckets are O(log) sized, so the cubic scan is trivial."""
    vals = sorted(int(v) for v in values)
    cands = sorted(set(int(c) for c in candidates))
    if not cands:
        raise ValueError("no bucket candidates")
    if vals and vals[-1] > cands[-1]:
        raise ValueError(f"value {vals[-1]} exceeds the largest candidate "
                         f"{cands[-1]} (no bucket could cover it)")
    if cost_of is None:
        cost_of = lambda bucket, value: float(bucket - value)  # noqa: E731
    if not vals:
        return (cands[-1],)
    max_buckets = max(1, min(max_buckets, len(cands)))

    # seg_cost[i][j]: cost of values in (cands[i-1], cands[j]] all landing
    # in bucket cands[j]  (i.e. cands[j] is the next boundary above cands[i-1])
    n = len(cands)
    import bisect

    def seg_cost(lo_idx: int, j: int) -> float:
        lo = cands[lo_idx - 1] if lo_idx > 0 else 0
        a = bisect.bisect_right(vals, lo)
        b = bisect.bisect_right(vals, cands[j])
        return sum(cost_of(cands[j], v) for v in vals[a:b])

    INF = math.inf
    # best[j][k]: min cost covering all values <= cands[j] using k buckets,
    # with cands[j] the largest chosen so far
    best = [[INF] * (max_buckets + 1) for _ in range(n)]
    back: dict[tuple[int, int], tuple[int, int] | None] = {}
    for j in range(n):
        best[j][1] = seg_cost(0, j)
        back[(j, 1)] = None
    for k in range(2, max_buckets + 1):
        for j in range(n):
            for i in range(j):
                if best[i][k - 1] is INF:
                    continue
                c = best[i][k - 1] + seg_cost(i + 1, j)
                if c < best[j][k]:
                    best[j][k] = c
                    back[(j, k)] = (i, k - 1)
    # the cover constraint: the last candidate must be chosen
    j = n - 1
    k = min(range(1, max_buckets + 1), key=lambda kk: best[j][kk])
    chosen = []
    cur: tuple[int, int] | None = (j, k)
    while cur is not None:
        chosen.append(cands[cur[0]])
        cur = back[cur]
    return tuple(sorted(chosen))
