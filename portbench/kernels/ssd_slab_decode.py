"""Work of the port's ``ssd_slab_decode`` (one Mamba-2 recurrent step with
each row's state read through its slab id; CUDA kernel
``slab_decode_kernel``) in one decode call, every Mamba-2 layer: each live
row's fp32 state read once and its stepped state written once (the
kernel hands the states back gathered; the scatter into the pool is a
copy of its own), its x, y, dt, B and C and its slab id, and the layer's
A once.  The step's FLOPs: the state decayed and the input added (3), the
output read along the state (2), per state element."""

NAMES = ("slab_decode_kernel",)
COUNT = "slab_decode_kernel"   # launched once a Mamba-2 layer a call
BYTES = 2                      # x, y, B, C in bf16


def launches(c) -> int:
    return c["layer_types"].count("mamba")


def work(c, lengths, block_size: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one call whose live rows hold ``lengths``."""
    h, p, n = c["mamba_n_heads"], c["mamba_d_head"], c["mamba_d_state"]
    g = c["mamba_n_groups"]
    rows = len(lengths)
    flops = rows * 5 * h * p * n
    nbytes = (rows * (2 * h * p * n * 4 + 2 * h * p * BYTES + h * 4
                      + 2 * g * n * BYTES + 4) + h * 4)
    return flops * launches(c), nbytes * launches(c)
