"""Dispatch layer: mean true (unpadded) rows of the window's decode
calls, from ``batch_meta``."""

from harness import readers as R


def read(run):
    return R.mean([m["rows"] for m in run.meta("decode")])
