"""What one run measured, and the arithmetic the metric readers share.

A reader (``portbench/metrics/<metric>.py``) is a ``read(run)`` that
returns the metric's value or None when the run holds nothing to read;
the harness leaves a None out of the result line.  Every tail is taken
over all the jobs, tokens or gaps of the window, never from medians of
parts of it.  Jobs that failed are counted in ``failed`` and are not in
the tails.
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass

import numpy as np

from harness import peaks
from harness import spec as S


@dataclass
class Run:
    conf: dict             # the configuration file
    traffic: dict
    seconds: float
    served: object         # driver.Served
    rec: object            # driver.Recorder
    setup_s: float
    trace: object = None   # trace.Trace of the traced sub-window

    @property
    def w0(self) -> float:
        return self.served.w0

    @property
    def w1(self) -> float:
        return self.served.w1

    @property
    def host_end(self) -> float:
        """The end of the part of the window the host-clock readers read:
        the window's end, or in a traced run the traced sub-window's start
        (it lies at the window's end; the profiler slows what runs while
        it is on, and starting and stopping it holds the servers)."""
        return self.trace.t0 - 0.1 if self.trace is not None else self.w1

    def window_jobs(self) -> list:
        """Jobs released in the window (finished or failed)."""
        return [j for j in self.served.jobs if self.w0 <= j.release < self.w1]

    def ok_jobs(self) -> list:
        return [j for j in self.window_jobs() if j.ok]

    def meta(self, kind: str) -> list[dict]:
        """``batch_meta`` of the window's device calls of ``kind``
        ("decode" / "prefill"; a family's tag after "@" is ignored)."""
        return [m for t, _, m in self.rec.meta
                if self.w0 <= t < self.host_end
                and m["kind"].split("@")[0] == kind]

    def calls(self, kind: str, t0: float, t1: float) -> list:
        """The benchmark's records of the ``kind`` calls that began and
        ended inside [t0, t1]."""
        src = self.rec.decode_calls if kind == "decode" else self.rec.prefill_calls
        return [c for c in src if t0 <= c[0] and c[1] <= t1]

    def work(self):
        return S.load_module("work", self.conf["work"])


def p95(values) -> float | None:
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95)) \
        if len(values) else None


def job_ms(run: Run) -> list[float]:
    return [(j.token_ends[-1] if j.token_ends else j.first) * 1e3
            - j.release * 1e3 for j in run.ok_jobs()]


def ttft_ms(run: Run) -> list[float]:
    return [(j.first - j.release) * 1e3 for j in run.ok_jobs()]


def token_gaps_ms(run: Run) -> list[float]:
    out = []
    for j in run.ok_jobs():
        ts = np.asarray([j.first, *j.token_ends])
        out.extend((np.diff(ts) * 1e3).tolist())
    return out


def decode_tokens_in_window(run: Run) -> list[int]:
    """The row length before each decode token completed in [w0,
    host_end), whatever job it belongs to."""
    out = []
    for j in run.served.jobs:
        if not j.ok:
            continue
        for i, t in enumerate(j.token_ends):
            if run.w0 <= t < run.host_end:
                out.append(j.prompt_len + i)
    return out


def deadline_met_share(run: Run) -> float | None:
    """Share of the jobs whose deadline fell in [w0, host_end) -- released
    in the window, failed and unfinished ones included -- that finished
    by it."""
    d = run.traffic["period_ms"] / 1e3
    jobs = [j for j in run.window_jobs() + list(run.served.unfinished)
            if j.release + d <= run.host_end]
    if not jobs:
        return None
    met = sum(1 for j in jobs if j.ok and (j.token_ends[-1] if j.token_ends
                                           else j.first) <= j.release + d)
    return 100.0 * met / len(jobs)


def mean(values) -> float | None:
    return statistics.fmean(values) if values else None


def call_mfu(run: Run, kind: str) -> float | None:
    """Needed FLOPs of the window's ``kind`` calls over the sum of their
    ``batch_meta`` seconds, as a share of the bf16 peak."""
    work = run.work()
    calls = run.calls(kind, run.w0, run.host_end)
    secs = sum(m["seconds"] for m in run.meta(kind))
    if not calls or secs <= 0:
        return None
    fn = work.decode_flops if kind == "decode" else work.prefill_flops
    flops = sum(fn(run.conf, n) for c in calls for n in c[3])
    return 100.0 * flops / (secs * peaks.BF16_FLOPS)


def window_mfu(run: Run) -> float | None:
    toks = decode_tokens_in_window(run)
    if not toks:
        return None
    work = run.work()
    flops = sum(work.decode_flops(run.conf, n) for n in toks)
    return 100.0 * flops / ((run.host_end - run.w0) * peaks.BF16_FLOPS)


def kernel_roofline(run: Run, kernel: str, kind: str) -> float | None:
    """A kernel's share of its roofline over the traced sub-window: the
    least time the live rows' true lengths need, over the device time of
    the kernel's launches.  The work is summed over the calls the
    benchmark saw begin and end inside the sub-window and scaled to the
    launches the trace holds (a call cut by the window's edges counts by
    its share of launches)."""
    tr = run.trace
    if tr is None:
        return None
    mod = S.load_module("kernels", kernel)
    dev_s = sum(tr.kernel_s.get(n, 0.0) for n in mod.NAMES)
    n_launch = tr.kernel_n.get(mod.COUNT, 0)
    calls = run.calls(kind, tr.t0, tr.t1)
    if dev_s <= 0 or not n_launch or not calls:
        return None
    bs = run.traffic["block_size"]
    flops = nbytes = 0.0
    for c in calls:
        f, b = mod.work(run.conf, c[3], bs)
        flops += f
        nbytes += b
    scale = n_launch / (mod.launches(run.conf) * len(calls))
    return 100.0 * peaks.bound_s(flops * scale, nbytes * scale) / dev_s


def idle_share(run: Run) -> float | None:
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.events:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def finite(x):
    return x if x is not None and math.isfinite(x) else None
