"""The reading of ``idle_in_call_share.rt``, in the granite-4.0-h-small cell,
so that it moves ``tokens_per_s`` there."""

from harness import spec as S

read = S.load_module("metrics", "idle_in_call_share.rt").read
