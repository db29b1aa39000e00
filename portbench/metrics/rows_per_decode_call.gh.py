"""The reading of ``rows_per_decode_call.rt``, in the granite-4.0-h-small cell,
so that it moves ``tokens_per_s`` there."""

from harness import spec as S

read = S.load_module("metrics", "rows_per_decode_call.rt").read
