"""Kernels: ``flash_attention``'s share of its roofline in the prefill
calls of the traced sub-window (%)."""

from harness import readers as R


def read(run):
    return R.kernel_roofline(run, "flash_attention", "prefill")
