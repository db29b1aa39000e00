"""Engine layer: mean "wait" of the traced sub-window's decode calls --
the replay issued until the server's stream has drained, behind the
other server's kernels too -- from the program's spans (ms)."""

from harness import spans as SP


def read(run):
    return SP.step_ms(run, "wait")
