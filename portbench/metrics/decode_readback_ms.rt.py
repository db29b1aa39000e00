"""Engine layer: mean "readback" of the traced sub-window's decode calls
-- the rows x vocab fp32 logits copied to the host as numpy -- from the
program's spans (ms)."""

from harness import spans as SP


def read(run):
    return SP.step_ms(run, "readback")
