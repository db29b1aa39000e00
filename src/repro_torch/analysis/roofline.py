"""Roofline analysis from compiled dry-run artifacts (no real hardware).

Terms (per step, per chip), TPU v5e constants:

    compute_ms    = HLO_FLOPs   / (chips * 197e12 FLOP/s)  * 1e3
    memory_ms     = HLO_bytes   / (chips * 819e9  B/s)     * 1e3
    collective_ms = coll_bytes  / (chips * 50e9   B/s/link)* 1e3

HLO_FLOPs / HLO_bytes come from ``compiled.cost_analysis()``.
collective_bytes is parsed from the optimized HLO text: the summed operand
sizes of all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute ops (cost_analysis does not expose it).

roofline_fraction = compute_ms / max(compute_ms, memory_ms, collective_ms):
how close the step is to being compute-bound at peak — the number reported
in EXPERIMENTS.md §Perf.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, asdict

PEAK_FLOPS = 197e12  # bf16 FLOP/s per v5e chip
HBM_BW = 819e9  # B/s per chip
ICI_BW = 50e9  # B/s per link (~per chip, one direction)

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8, "f8e4m3fn": 1, "f8e5m2": 1,
    "bf16": 2, "f16": 2, "f32": 4, "f64": 8, "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(shape_str: str) -> int:
    """'bf16[128,256]' -> bytes; tuples handled by caller."""
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> dict[str, int]:
    """Sum output-shape bytes of every collective op in the optimized HLO.

    HLO line form:  %name = bf16[...]{...} all-gather(...), replica_groups=...
    We count the op's RESULT shape (for all-gather that's the gathered size,
    for reduce-scatter the scattered size; a consistent, conservative proxy
    for wire bytes per participating device).
    """
    out: dict[str, int] = {k: 0 for k in _COLLECTIVES}
    counts: dict[str, int] = {k + "_count": 0 for k in _COLLECTIVES}
    for line in hlo_text.splitlines():
        line = line.strip()
        m = re.match(r"^(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\(?[^=]+?)\s+(\w[\w\-]*)\(", line)
        if not m:
            continue
        shape_str, op = m.group(1), m.group(2)
        # async collective pairs: count -start only, skip -done
        base = op.replace("-start", "")
        if op.endswith("-done") or base not in _COLLECTIVES:
            continue
        out[base] += _shape_bytes(shape_str)
        counts[base + "_count"] += 1
    out.update(counts)
    return out


@dataclass
class RooflineTerms:
    compute_ms: float
    memory_ms: float
    collective_ms: float
    bottleneck: str
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    model_flops: float
    model_flops_ratio: float  # MODEL_FLOPS / HLO_FLOPS (useful-compute share)
    roofline_fraction: float
    per_collective: dict

    def to_dict(self):
        return asdict(self)


def analyze(cost: dict, hlo_text: str, *, chips: int, model_flops: float,
            flops_are_global: bool = True) -> RooflineTerms:
    """cost: compiled.cost_analysis() (kept for reference only); hlo_text:
    the compiled (SPMD-partitioned, per-device) module text.

    The terms come from analysis.hlo_cost, which walks the call graph and
    multiplies while-loop bodies by their known_trip_count —
    cost_analysis() counts scanned layer stacks once and is unusable for a
    scanned 126-layer model (verified; see tests/test_roofline.py).
    """
    from repro_torch.analysis import hlo_cost

    walked = hlo_cost.analyze_text(hlo_text)
    flops = walked.flops
    bytes_ = walked.hbm_bytes
    per_coll = {**walked.collective_bytes,
                **{k + "_count": v for k, v in walked.collective_counts.items()}}
    coll = walked.total_collective_bytes

    compute_ms = flops / PEAK_FLOPS * 1e3
    memory_ms = bytes_ / HBM_BW * 1e3
    collective_ms = coll / ICI_BW * 1e3
    terms = {"compute": compute_ms, "memory": memory_ms, "collective": collective_ms}
    bottleneck = max(terms, key=terms.get)
    mf_per_chip = model_flops / chips
    return RooflineTerms(
        compute_ms=compute_ms,
        memory_ms=memory_ms,
        collective_ms=collective_ms,
        bottleneck=bottleneck,
        hlo_flops=flops,
        hlo_bytes=bytes_,
        coll_bytes=coll,
        model_flops=mf_per_chip,
        model_flops_ratio=(mf_per_chip / flops) if flops else 0.0,
        roofline_fraction=(compute_ms / max(max(terms.values()), 1e-12)),
        per_collective=per_coll,
    )


def train_model_flops(n_params: int, tokens: int) -> float:
    """MODEL_FLOPS = 6*N*D (dense) — pass active params for MoE."""
    return 6.0 * n_params * tokens


def decode_model_flops(n_params: int, batch: int) -> float:
    """One decode token per sequence: 2*N FLOPs each (fwd only)."""
    return 2.0 * n_params * batch


def prefill_model_flops(n_params: int, tokens: int) -> float:
    return 2.0 * n_params * tokens
