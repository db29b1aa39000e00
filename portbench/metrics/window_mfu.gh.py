"""The reading of ``window_mfu.sat`` in the granite-4.0-h-small cell:
needed FLOPs of the decode tokens completed in the window
(``portbench/work/granite_hybrid.py``) over (window seconds x 989
TFLOP/s) (%)."""

from harness import spec as S

read = S.load_module("metrics", "window_mfu.sat").read
