"""The reading of ``decode_call_ms.rt``, in the granite-4.0-h-small cell,
so that it moves ``tokens_per_s`` there."""

from harness import spec as S

read = S.load_module("metrics", "decode_call_ms.rt").read
