"""Work of the port's ``paged_mla_decode_attention`` (absorbed MLA decode
over latent block pools; CUDA kernels ``mla_tc_kernel`` and
``split_merge_kernel``) in one decode call, every layer: each live row's
latent and rotary queries and its latent output once, its latent and
rotary key rows over its true length (the new token included), its
lengths entry and the table entries it uses.  The scores over latent and
rotary widths and the latent output product over that length."""

NAMES = ("mla_tc_kernel", "split_merge_kernel")
COUNT = "mla_tc_kernel"
BYTES = 2


def launches(c) -> int:
    return c["num_hidden_layers"]


def work(c, lengths, block_size: int) -> tuple[float, float]:
    n, r, pr = c["num_attention_heads"], c["kv_lora_rank"], c["qk_rope_head_dim"]
    flops = nbytes = 0
    for length in lengths:
        ctx = length + 1
        flops += 2 * n * ctx * (r + pr) + 2 * n * ctx * r
        nbytes += (ctx * (r + pr) + n * (r + pr) + n * r) * BYTES
        nbytes += 4 + 4 * -(-ctx // block_size)
    return flops * launches(c), nbytes * launches(c)
