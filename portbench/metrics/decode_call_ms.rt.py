"""Engine layer: mean ``batch_meta`` seconds (staging to the stream's
sync) of the window's decode calls (ms)."""

from harness import readers as R


def read(run):
    m = R.mean([x["seconds"] for x in run.meta("decode")])
    return None if m is None else m * 1e3
