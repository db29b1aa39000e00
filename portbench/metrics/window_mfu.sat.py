"""Model step: needed FLOPs of the decode tokens completed in the window
over (window seconds x 989 TFLOP/s) (%)."""

from harness import readers as R


def read(run):
    return R.window_mfu(run)
