"""The paper's response time: 95th percentile, over every job released in
the window that finished, of release to its last token (ms)."""

from harness import readers as R


def read(run):
    return R.p95(R.job_ms(run))
