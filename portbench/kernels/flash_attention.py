"""Work of the port's ``flash_attention`` (causal prefill; CUDA kernel
``flash_tc_kernel``) on a GQA model in one bucketed prefill call, every
layer: each live row's queries, keys, values and outputs over its true
length (padding is not needed work), and the causal QK^T and PV
products."""

NAMES = ("flash_tc_kernel",)
COUNT = "flash_tc_kernel"
BYTES = 2


def launches(c) -> int:
    return c["num_hidden_layers"]


def work(c, lengths, block_size: int) -> tuple[float, float]:
    d, n, nkv = c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"]
    hd = d // n
    flops = nbytes = 0
    for length in lengths:
        flops += 4 * n * hd * length * (length + 1) // 2
        nbytes += length * (2 * n + 2 * nkv) * hd * BYTES
    return flops * launches(c), nbytes * launches(c)
