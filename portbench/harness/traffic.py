"""The one traffic generator: a traffic mix is a JSON file of parameters
(``portbench/traffic/<name>.json``) that this module turns into streams
of jobs from ``--seed``.

Every seed gets the same multiset of prompt and output lengths and the
same set of first-release offsets, in another order: lengths are the
distribution's quantiles at (i + 0.5) / N, and offsets the points
(i + 0.5) / S of one period, each permuted by the seed.  So seeds differ
in which stream sends what and when, not in how much work a run holds.
Prompt token ids are drawn per job from the seed.
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass, field

import numpy as np

from harness import arrivals

_NORMAL = statistics.NormalDist()


@dataclass
class StreamPlan:
    index: int
    offset_ms: float
    # open loop: the release instant (ms after the traffic starts) of each
    # job; closed loop: None (a job is released when the last one ends)
    releases_ms: list[float] | None
    prompt_lens: list[int] = field(default_factory=list)
    out_lens: list[int] = field(default_factory=list)


def rng_for(seed: int, *words: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**64, *words])


def quantile_lengths(dist: dict, n: int, rng) -> list[int]:
    """``n`` lengths at the quantiles (i + 0.5) / n of ``dist`` (a
    lognormal with ``median`` and ``sigma``, clipped to [min, max]), in the
    order of a permutation drawn from ``rng``."""
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    vals = [min(dist["max"], max(dist["min"], round(
        dist["median"] * math.exp(dist["sigma"] * _NORMAL.inv_cdf((i + .5) / n)))))
        for i in range(n)]
    return [vals[i] for i in rng.permutation(n)]


def plan(traffic: dict, seed: int, horizon_s: float) -> list[StreamPlan]:
    """Every stream's jobs for a run whose releases stop ``horizon_s``
    seconds after the traffic starts."""
    s = traffic["streams"]
    period = traffic["period_ms"]
    spread = traffic.get("first_release_spread_ms", period)
    rng = rng_for(seed, 0)
    slots = rng.permutation(s)
    streams = []
    for i in range(s):
        offset = (slots[i] + rng.uniform(0.25, 0.75)) / s * spread
        if traffic["loop"] == "open":
            model = arrivals.make(traffic["arrivals"]["model"],
                                  offset_ms=offset,
                                  **traffic["arrivals"].get("params", {}))
            rel = model.releases(period, horizon_s * 1e3, rng_for(seed, 1, i))
        elif traffic["loop"] == "closed":
            rel = None
        else:
            raise ValueError(f"unknown loop {traffic['loop']!r}")
        streams.append(StreamPlan(i, offset, rel))
    counts = [len(p.releases_ms) if p.releases_ms is not None
              else traffic["closed_jobs_per_stream"] for p in streams]
    n = sum(counts)
    prompts = quantile_lengths(traffic["prompt_len"], n, rng_for(seed, 2))
    outs = quantile_lengths(traffic["output_len"], n, rng_for(seed, 3))
    at = 0
    for p, c in zip(streams, counts):
        p.prompt_lens = prompts[at:at + c]
        p.out_lens = outs[at:at + c]
        at += c
    return streams


def prompt_tokens(seed: int, stream: int, job: int, length: int,
                  vocab: int) -> np.ndarray:
    """The prompt of job ``job`` of stream ``stream``: (1, length) int32."""
    return rng_for(seed, 4, stream, job).integers(
        0, vocab, size=(1, length), dtype=np.int32)
