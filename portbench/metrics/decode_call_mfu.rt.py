"""Model step: needed FLOPs of the window's decode calls (live rows at
their true lengths) over the sum of their ``batch_meta`` seconds, as a
share of the H100's 989 TFLOP/s bf16 peak (%)."""

from harness import readers as R


def read(run):
    return R.call_mfu(run, "decode")
