"""Engine layer: mean ``batch_meta`` seconds of the window's prefill
calls (ms)."""

from harness import readers as R


def read(run):
    m = R.mean([x["seconds"] for x in run.meta("prefill")])
    return None if m is None else m * 1e3
