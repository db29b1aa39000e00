"""Dispatch layer: mean of the servers' ``wakeup_latencies`` (submit to
dequeue) of the requests dequeued in the window (ms)."""

from harness import readers as R


def read(run):
    m = R.mean(run.served.wake)
    return None if m is None else m * 1e3
