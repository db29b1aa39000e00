"""The reading of ``idle_in_call_share.rt``, in the cells where the
card is kept busy, so that it moves ``tokens_per_s`` there."""

from harness import spec as S

read = S.load_module("metrics", "idle_in_call_share.rt").read
