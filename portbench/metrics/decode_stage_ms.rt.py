"""Engine layer: mean "stage" of the traced sub-window's decode calls --
bucket choice, packing the rows and the copy into the graph's inputs --
from the program's spans (ms)."""

from harness import spans as SP


def read(run):
    return SP.step_ms(run, "stage")
