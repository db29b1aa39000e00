"""The reading of ``decode_readback_ms.rt``, in the cells where the
card is kept busy, so that it moves ``tokens_per_s`` there."""

from harness import spec as S

read = S.load_module("metrics", "decode_readback_ms.rt").read
