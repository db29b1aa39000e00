"""The reading of ``experts_read_share.sat`` in the granite-4.0-h-small
cell: the share of the routed experts' weights that the decode calls read
over the traced sub-window, every MoE layer of every routed decode call
counted, whether a Mamba-2 mixer or an attention layer precedes it (%)."""

from harness import spec as S

read = S.load_module("metrics", "experts_read_share.sat").read
