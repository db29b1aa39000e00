"""Dispatch layer: mean "wake" of the requests the traced sub-window's
decode calls served -- a request's end to its client thread's return from
``wait``, the GIL's and the scheduler's share of suspending -- from the
program's spans (ms)."""

from harness import spans as SP


def read(run):
    return SP.wake_ms(run)
