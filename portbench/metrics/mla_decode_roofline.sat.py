"""Kernels: ``paged_mla_decode_attention``'s share of its roofline over
the traced sub-window (%)."""

from harness import readers as R


def read(run):
    return R.kernel_roofline(run, "paged_mla_decode_attention", "decode")
