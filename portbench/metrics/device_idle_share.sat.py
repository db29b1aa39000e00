"""The reading of ``device_idle_share.rt``, in the cells where the
card is kept busy, so that it moves ``tokens_per_s`` there."""

from harness import spec as S

read = S.load_module("metrics", "device_idle_share.rt").read
