"""Work of the port's ``paged_decode_attention`` (GQA decode over KV block
pools; CUDA kernels ``decode_tc_kernel`` and, after a split of the KV
sweep, ``split_merge_kernel``) in one decode call, every layer: each live
row's query and output once, its K and V over its true length (the new
token included), its lengths entry and the table entries it uses.  The
QK^T and PV products over that length."""

NAMES = ("decode_tc_kernel", "split_merge_kernel")
COUNT = "decode_tc_kernel"   # launched once a layer a call
BYTES = 2                    # bf16


def launches(c) -> int:
    return c["num_hidden_layers"]


def work(c, lengths, block_size: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one call whose live rows hold ``lengths``."""
    d, n, nkv = c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"]
    hd = d // n
    flops = nbytes = 0
    for length in lengths:
        ctx = length + 1
        flops += 4 * n * hd * ctx
        nbytes += (2 * ctx * nkv * hd + 2 * n * hd) * BYTES
        nbytes += 4 + 4 * -(-ctx // block_size)
    return flops * launches(c), nbytes * launches(c)
