"""The control of ``correct``: the plain reference with every weight
rounded to fp8 e4m3 (the precision below the configurations' bf16), read
as the program is read.  On the card, at each cell's own size, over three
seeds, the program's readings pass each cell's limits and the control's
fail them (``python -m pytest -m cuda portbench/tests``; about 7 minutes,
a process a run).
On the CPU, at a small size, the control's readings stand above the
fp32 program's, which reads none."""

import json
import pathlib
import subprocess
import sys

import pytest
import torch

import small
from harness import correct as C
from harness import spec as S
from harness import weights as W

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = ("internlm2-rt-decode", "deepseek-sat-decode")


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_above_the_program_on_the_cpu(name):
    cell, cfg = small.small_cell(name)
    conf = cell.config
    params = W.make(cfg, 17, torch.device("cpu"))
    ref = S.load_module("reference", conf["reference"])
    gen = torch.Generator().manual_seed(1)
    seqs = [torch.randint(0, conf["vocab_size"], (n,), generator=gen)
            for n in (30, 45)]
    full = ref.logits(conf, params, seqs, [10, 10])
    served = [lg.argmax(-1) for lg in full]   # a sound fp32 program's tokens
    low = ref.logits(conf, params, seqs, [10, 10], cast=C.fp8_cast)
    program = C.readings(full, served)
    control = C.readings(full, [lg.argmax(-1) for lg in low])
    assert program["max_gap"] == 0.0 and program["mean_gap"] == 0.0
    assert control["mean_gap"] > 0.0 and control["mismatch_pct"] > 0.0


def test_fp8_cast_rounds_to_e4m3():
    t = torch.tensor([1.0, 1.06, -3.3, 448.0 / 7])
    r = C.fp8_cast(t)
    assert torch.equal(C.fp8_cast(r), r)
    assert (r - t).abs().max() <= 0.07 * t.abs().max()
    assert not torch.equal(r, t)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size")
    limits = S.load_cell(name).limits
    out = subprocess.run(
        [sys.executable, "portbench/control.py", "--workload", name,
         "--seconds", "8", "--seeds", "11", "12", "13"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200, check=True)
    rows = [json.loads(line.split(" ", 1)[1])
            for line in out.stdout.splitlines() if line.startswith("control ")]
    assert len(rows) == 3
    for row in rows:
        for key, limit in limits.items():
            assert row[key] <= limit, row
        assert any(row[f"control_{k}"] > lim for k, lim in limits.items()), row
