"""Model step: needed FLOPs of the window's prefill calls (true prompt
lengths, the head at each last token) over the sum of their
``batch_meta`` seconds, as a share of 989 TFLOP/s (%)."""

from harness import readers as R


def read(run):
    return R.call_mfu(run, "prefill")
