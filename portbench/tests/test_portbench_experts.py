"""The reader of ``experts_read_share.sat`` (the program's counter of the
routed MoE decode experts) on synthetic runs, and on a traced run of the
deepseek cell on the CPU at a small size, with the profiler replaced by a
synthetic trace: it reads the engine's counter when the engine keeps one
(``experts_read``) and is left out of the result line when it does not."""

import time

import pytest
import torch

import small
import run as RUN
from harness import spec as S
from harness import trace as TR
from test_portbench_spans import _fake_profile, _run

NAME = "experts_read_share.sat"
CELL = "deepseek-sat-decode"


def _reader():
    return S.load_module("metrics", NAME).read


def _with_counter(got):
    run = _run(None, [], gaps=[])
    run.rec.eng.experts_read = lambda: got
    return run


def test_share_of_the_experts_read():
    assert _reader()(_with_counter((30, 64))) == pytest.approx(46.875)
    assert _reader()(_with_counter((64, 64))) == pytest.approx(100.0)


def test_none_without_a_counter_a_trace_or_a_routed_call():
    read = _reader()
    assert read(_run(None, [], gaps=[])) is None  # no experts_read
    assert read(_with_counter(None)) is None      # no interval closed
    assert read(_with_counter((0, 0))) is None    # no routed layer ran
    run = _with_counter((30, 64))
    run.trace = None
    assert read(run) is None


def test_listed_for_the_deepseek_cell_alone():
    assert NAME in [m["name"] for m in S.load_cell(CELL).metrics(True)]
    assert NAME not in [m["name"] for m in
                        S.load_cell("internlm2-rt-decode").metrics(True)]


@pytest.fixture
def default_precision():
    torch.set_float32_matmul_precision("highest")


@pytest.mark.usefixtures("default_precision")
@pytest.mark.parametrize("counter", [True, False])
def test_traced_run_reads_the_counter(counter, monkeypatch):
    """A small traced run of the deepseek cell: each decode row reads K of
    the E experts of each MoE layer, so the share lies in [K / E, 100]; a
    program without the counter is still correct and leaves it out."""
    from repro_torch.serving.engine import ServeEngine

    monkeypatch.setattr(TR, "profile", _fake_profile())
    if not counter:
        monkeypatch.delattr(ServeEngine, "experts_read")
    torch.set_num_threads(2)
    cell, cfg = small.small_cell(CELL)
    cell.traffic["trace_s"] = 1.0
    res = RUN.run_cell(cell, 2**31 + 11, 3.0, True, torch.device("cpu"),
                       t_start=time.monotonic(), cfg=cfg)
    assert res["correct"], res["checks"]
    got = res["metrics"].get(NAME)
    if not counter:
        assert got is None
        return
    share = 100.0 * cfg.num_experts_per_tok / cfg.num_experts
    assert share - 1e-9 <= got["value"] <= 100.0
