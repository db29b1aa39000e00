"""Device: share of the traced sub-window in which no kernel or copy ran
on the card (%), from the profiler's device activities."""

from harness import readers as R


def read(run):
    return R.idle_share(run)
