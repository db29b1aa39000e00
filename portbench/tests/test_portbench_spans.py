"""The readers of the program's spans (``harness/spans.py``) on a
synthetic run, and a traced run of each cell on the CPU at a small size
with the profiler replaced by a synthetic trace (the profiler's own flag
is raised while it "records"): the program traces and the new readers
read its spans when it keeps them (``trace_records``), and every new
reader returns None when it does not."""

import time

import pytest
import torch

import small
import run as RUN
from harness import driver as D
from harness import readers as R
from harness import spans as SP
from harness import spec as S
from harness import trace as TR

CELLS = ("internlm2-rt-decode", "deepseek-sat-decode")
NEW = ("decode_stage_ms", "decode_wait_ms", "decode_readback_ms",
       "client_wake_ms", "decode_coalesced_share", "idle_in_call_share",
       "idle_no_request_share")


def _new_metrics(cell):
    return [m["name"] for m in cell.metrics(True)
            if m["name"].rsplit(".", 1)[0] in NEW]


def _run(spans, meta, gaps, t0=10.0, t1=11.0):
    """A run whose sub-window is [t0, t1] with idle ``gaps`` given as
    (start, end) and rebuilt by the trace's own (seconds, midpoint)."""
    tr = TR.Trace(t0=t0, t1=t1, busy_s=0.0, events=5)
    tr.gaps = [(b - a, (a + b) / 2) for a, b in gaps]
    served = D.Served(jobs=[], unfinished=[], w0=0.0, w1=20.0, wake=[],
                      trace=tr)
    eng = type("Eng", (), {} if spans is None else
               {"trace_records": lambda self: list(spans)})()
    rec = type("Rec", (), {"meta": meta, "eng": eng})()
    return R.Run(conf={}, traffic={}, seconds=20.0, served=served, rec=rec,
                 setup_s=1.0, trace=tr)


def _flat(intervals):
    return [x for iv in intervals for x in iv]


def _call(server, cid, t0, stage, wait, read, rows=()):
    """The records of one decode call from ``t0`` whose steps last
    ``stage``, ``wait`` and ``read`` seconds, and of its requests (ids
    ``rows``), each submitted 1 ms before it began and woken 0.1 ms after
    it ended."""
    a, b, c, d = t0, t0 + stage, t0 + stage + wait, t0 + stage + wait + read
    out = [(server, "call", a, d + 1e-4, cid, None),
           (server, "stage", a, b, cid, None),
           (server, "wait", b, c, cid, None),
           (server, "readback", c, d, cid, None)]
    for r in rows:
        out += [(server, "request", a - 1e-3, d + 1e-4, cid, r),
                (server, "wake", d + 1e-4, d + 2e-4, cid, r)]
    return out


def test_step_means_wake_and_coalescing_over_the_sub_windows_calls():
    spans = (_call(0, 1, 10.10, 0.001, 0.003, 0.0005, rows=(1, 2))
             + _call(1, 7, 10.20, 0.002, 0.005, 0.0015, rows=(3,))
             # begins before the sub-window: left out
             + _call(0, 2, 9.99, 0.004, 0.004, 0.004, rows=(4,)))
    meta = [(10.1045, 0, {"kind": "decode", "rows": 2, "decoding": 4,
                          "seconds": 0.0045}),
            (10.2085, 1, {"kind": "decode", "rows": 1, "decoding": 4,
                          "seconds": 0.0085}),
            (10.001, 0, {"kind": "decode", "rows": 1, "decoding": 1,
                         "seconds": 0.012}),
            # a prefill call's entry, and one no call span holds
            (10.5, 0, {"kind": "prefill", "rows": 1, "seconds": 0.01}),
            (10.7, 1, {"kind": "decode", "rows": 1, "decoding": 1,
                       "seconds": 0.01})]
    run = _run(spans, meta, gaps=[])
    calls = SP.decode_calls(run)
    assert [(c["server"], c["call_id"]) for c in calls] == [(0, 1), (1, 7)]
    assert SP.step_ms(run, "stage") == pytest.approx(1.5)
    assert SP.step_ms(run, "wait") == pytest.approx(4.0)
    assert SP.step_ms(run, "readback") == pytest.approx(1.0)
    assert SP.wake_ms(run) == pytest.approx(0.1)
    assert SP.coalesced_share(run) == pytest.approx(100 * (0.5 + 0.25) / 2)
    for c in calls:  # here the call had no packing before ``seconds``
        assert sum(c["steps"].values()) == pytest.approx(c["meta"]["seconds"])


def test_idle_is_rebuilt_from_the_gaps_and_clipped_to_the_sub_window():
    spans = [(0, "stage", 9.90, 10.02, 1, None),
             (1, "readback", 10.50, 10.53, 2, None),
             (0, "request", 9.80, 10.06, 1, 5),
             (1, "request", 10.40, 10.55, 2, 6)]
    # idle: [9.95, 10.05] (clipped to 10.00-10.05), [10.45, 10.56],
    # [10.95, 11.05] (clipped to 10.95-11.00): 0.05 + 0.11 + 0.05 s
    run = _run(spans, [], gaps=[(9.95, 10.05), (10.45, 10.56),
                                (10.95, 11.05)])
    assert _flat(SP.idle_intervals(run.trace)) == pytest.approx(
        [10.0, 10.05, 10.45, 10.56, 10.95, 11.0])
    total = 0.21
    # in a call's host step: 10.00-10.02 and 10.50-10.53
    assert SP.idle_share_in(run, ("stage", "readback", "insert")) == \
        pytest.approx(100 * 0.05 / total)
    # no request open: 10.45-10.40 none, 10.55-10.56, 10.95-11.00
    assert SP.idle_share_in(run, ("request",), inside=False) == \
        pytest.approx(100 * (0.01 + 0.05) / total)


def test_a_gap_that_spans_two_program_spans_counts_each_part_once():
    spans = [(0, "stage", 10.10, 10.13, 1, None),
             (1, "stage", 10.12, 10.16, 2, None),  # overlaps
             (0, "readback", 10.18, 10.25, 1, None)]
    run = _run(spans, [], gaps=[(10.11, 10.20)])
    # covered: 10.11-10.16 and 10.18-10.20 of 0.09 s idle
    assert _flat(SP.union([(s[2], s[3]) for s in spans])) == \
        pytest.approx([10.10, 10.16, 10.18, 10.25])
    assert SP.idle_share_in(run, ("stage", "readback")) == \
        pytest.approx(100 * 0.07 / 0.09)
    assert SP.overlap([(0.0, 1.0), (2.0, 3.0)], [(0.5, 2.5)]) == \
        pytest.approx(1.0)


def test_idle_is_read_from_where_every_server_traced():
    # server 0 traced from 10.10, server 1 from 10.30 (the first call in
    # which each switched went untraced), and a call after the sub-window
    spans = [(0, "call", 10.10, 10.20, 1, None),
             (0, "request", 10.05, 10.20, 1, 3),
             (1, "call", 10.30, 10.40, 1, None),
             (1, "request", 10.30, 10.40, 1, 4),
             (0, "call", 11.01, 11.02, 2, None)]
    run = _run(spans, [], gaps=[(10.0, 10.5)])
    assert SP.traced_from(spans, run.trace) == pytest.approx(10.30)
    # idle 10.30-10.50, a request open 10.30-10.40
    assert SP.idle_share_in(run, ("request",), inside=False) == \
        pytest.approx(50.0)
    assert SP.traced_from([], run.trace) == run.trace.t0


def test_without_program_spans_every_new_reader_returns_none():
    meta = [(10.1, 0, {"kind": "decode", "rows": 2, "seconds": 0.005})]
    run = _run(None, meta, gaps=[(10.2, 10.3)])
    for cell in CELLS:
        names = _new_metrics(S.load_cell(cell))
        assert names
        for name in names:
            assert S.load_module("metrics", name).read(run) is None, name
    run.trace = None
    assert SP.idle_share_in(run, ("request",)) is None
    # a program that keeps spans but recorded none
    run = _run([], meta, gaps=[(10.2, 10.3)])
    assert SP.idle_share_in(run, ("request",), inside=False) is None
    assert SP.decode_calls(run) is None


def _fake_profile(gap_ms=3.0):
    """``trace.profile`` with no profiler: the profiler's flag raised and
    lowered as the profiler does, the sub-window's length slept through,
    its host clock taken, and idle gaps every 10 ms."""
    def profile(seconds, quiet):
        with quiet():
            torch.autograd.profiler._run_on_profiler_start()
        t0 = time.monotonic()
        time.sleep(seconds)
        t1 = time.monotonic()
        with quiet():
            torch.autograd.profiler._run_on_profiler_stop()
        n = int((t1 - t0) / 0.01)
        gaps = [(gap_ms / 1e3, t0 + 0.01 * k + 0.005) for k in range(n)]
        return TR.Trace(t0=t0, t1=t1, busy_s=(t1 - t0) - gap_ms / 1e3 * n,
                        gaps=gaps, events=n)
    return profile


@pytest.fixture
def default_precision():
    """The process's default matmul precision, set through the current
    API: a test that set TF32 through the legacy flags leaves a mixed
    state in which the reference cannot read the precision."""
    torch.set_float32_matmul_precision("highest")


@pytest.mark.usefixtures("default_precision")
@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_the_programs_spans(name, monkeypatch):
    monkeypatch.setattr(TR, "profile", _fake_profile())
    torch.set_num_threads(2)
    cell, cfg = small.small_cell(name)
    cell.traffic["trace_s"] = 1.0
    res = RUN.run_cell(cell, 2**31 + 5, 3.0, True, torch.device("cpu"),
                       t_start=time.monotonic(), cfg=cfg)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    for m in _new_metrics(cell):
        assert m in got, m
    stage = [v for k, v in got.items() if k.startswith("decode_stage_ms")]
    assert stage and stage[0]["value"] > 0
    share = [v["value"] for k, v in got.items()
             if k.startswith("decode_coalesced_share")]
    assert share and 0 < share[0] <= 100
    if name == "internlm2-rt-decode":
        assert got["idle_in_call_share.rt"]["value"] \
            + got["idle_no_request_share.rt"]["value"] <= 100 + 1e-9


@pytest.mark.usefixtures("default_precision")
@pytest.mark.parametrize("name", CELLS)
def test_traced_run_of_a_program_without_tracing(name, monkeypatch):
    from repro_torch.serving.engine import ServeEngine

    monkeypatch.setattr(TR, "profile", _fake_profile())
    monkeypatch.delattr(ServeEngine, "set_tracing")
    monkeypatch.delattr(ServeEngine, "trace_records")
    torch.set_num_threads(2)
    cell, cfg = small.small_cell(name)
    cell.traffic["trace_s"] = 1.0
    res = RUN.run_cell(cell, 2**31 + 7, 3.0, True, torch.device("cpu"),
                       t_start=time.monotonic(), cfg=cfg)
    assert res["correct"], res["checks"]
    assert not set(_new_metrics(cell)) & set(res["metrics"])
    assert res["metrics"]  # the accepted per-layer metrics still read
