"""A whole run of each cell on the CPU at a small size -- the harness's
look for a card skipped, everything else as on the card -- is correct,
and comes out not correct when the timed path is broken underneath: a
token altered where it is produced, half of each batch left out, a
decode step that leaves the cache as it was.  (One card: there is no
exchange between cards to leave out.)"""

import time

import pytest
import torch

import small
import run as RUN
from harness.faults import FAULTS


CELLS = ("internlm2-rt-decode", "deepseek-sat-decode")


def _run(name, fault, seed):
    torch.set_num_threads(2)
    cell, cfg = small.small_cell(name)
    return RUN.run_cell(cell, seed, 2.0, False, torch.device("cpu"),
                        t_start=time.monotonic(), cfg=cfg, fault=fault)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = _run(name, None, 2**31 + 3)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    metrics = set(res["metrics"])
    assert "setup_s" in metrics and len(metrics) >= 2


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(name, fault):
    res = _run(name, FAULTS[fault], 2**31 + 3)
    assert not res["correct"], res["checks"]
