"""Kernels: ``ssd_slab_decode``'s share of its roofline over the traced
sub-window (%): the state bytes and the step of the calls' live rows, in
every Mamba-2 layer, over the device time of ``slab_decode_kernel``."""

from harness import readers as R


def read(run):
    return R.kernel_roofline(run, "ssd_slab_decode", "decode")
