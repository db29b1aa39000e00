"""The traffic generator, the tail arithmetic and the work formulas, on
the CPU with no card."""

import math

import numpy as np
import pytest

import small  # noqa: F401  (paths)
from harness import arrivals as A
from harness import driver as D
from harness import readers as R
from harness import spec as S
from harness import traffic as T

CELLS = ("internlm2-rt-decode", "deepseek-sat-decode")
SEEDS = (3, 2**31 + 11, 4100000001)


@pytest.mark.parametrize("model,params", [
    ("periodic", {"offset_ms": 7.5}),
    ("sporadic", {"slack": (0.0, 0.5), "offset_ms": 3.0}),
    ("bursty", {"p_enter": 0.3, "p_exit": 0.4, "idle_factor": 3.0})])
def test_arrivals_repeat_for_a_seed_and_keep_the_period(model, params):
    def draw(seed):
        return A.make(model, **params).releases(100.0, 5000.0,
                                                T.rng_for(seed, 1, 0))
    a, b = draw(5), draw(5)
    assert a == b and len(a) > 10
    assert all(y - x >= 100.0 - 1e-6 for x, y in zip(a, a[1:]))
    if model != "periodic":
        assert draw(6) != a


@pytest.mark.parametrize("cell", CELLS)
def test_plan_repeats_and_every_seed_gets_the_same_work(cell):
    traffic = S.load_cell(cell).traffic
    plans = [T.plan(traffic, s, 40.0) for s in SEEDS]
    again = T.plan(traffic, SEEDS[0], 40.0)
    assert [(p.offset_ms, p.releases_ms, p.prompt_lens, p.out_lens)
            for p in again] == [(p.offset_ms, p.releases_ms, p.prompt_lens,
                                 p.out_lens) for p in plans[0]]
    multisets = [sorted(n for p in ps for n in p.prompt_lens) for ps in plans]
    assert multisets[0] == multisets[1] == multisets[2]
    outs = [sorted(n for p in ps for n in p.out_lens) for ps in plans]
    assert outs[0] == outs[1] == outs[2]
    assert [p.prompt_lens for p in plans[0]] != [p.prompt_lens for p in plans[1]]
    lens = multisets[0]
    lo, hi = traffic["prompt_len"]["min"], traffic["prompt_len"]["max"]
    assert lo <= lens[0] and lens[-1] <= hi
    assert abs(lens[len(lens) // 2] - traffic["prompt_len"]["median"]) <= 2
    p = T.prompt_tokens(SEEDS[1], 3, 2, 40, 1000)
    assert p.shape == (1, 40) and (p == T.prompt_tokens(SEEDS[1], 3, 2, 40, 1000)).all()


def _run(jobs, seconds=10.0, period_ms=1000.0):
    served = D.Served(jobs=jobs, unfinished=[], w0=0.0, w1=seconds,
                      wake=[])
    return R.Run(conf={}, traffic={"period_ms": period_ms}, seconds=seconds,
                 served=served, rec=None, setup_s=1.0)


def _job(stream, k, release, start, first, gap, n):
    j = D.Job(stream, k, release, prompt_len=10, out_len=n + 1, start=start,
              ok=True, first=first,
              token_ends=[first + gap * (i + 1) for i in range(n)])
    j.end = j.token_ends[-1]
    return j


def test_tails_are_over_every_job_and_timed_from_release():
    # stream 0: one job stalls 2 s; the next is due at 1.0 but starts when
    # the stalled one ends, and its latency counts the wait
    jobs = [_job(0, 0, 0.0, 0.0, 2.0, 0.01, 5),
            _job(0, 1, 1.0, 2.05, 2.1, 0.01, 5)]
    jobs += [_job(1, k, 0.5 + k, 0.5 + k, 0.52 + k, 0.01, 5) for k in range(8)]
    run = _run(jobs)
    lat = sorted(R.job_ms(run))
    assert lat[-1] == pytest.approx(2050.0) and lat[-2] == pytest.approx(1150.0)
    assert R.p95(R.job_ms(run)) == pytest.approx(
        float(np.percentile(lat, 95)))
    assert max(R.ttft_ms(run)) == pytest.approx(2000.0)
    gaps = R.token_gaps_ms(run)
    assert len(gaps) == 10 * 5 and max(gaps) == pytest.approx(10.0)
    # deadline 1 s: the stalled job and the one behind it miss
    assert R.deadline_met_share(run) == pytest.approx(80.0)
    # a failed job is in the share's count and out of the tails
    bad = D.Job(2, 0, 3.0, 10, 6, ok=False, error="x")
    run = _run(jobs + [bad])
    assert R.deadline_met_share(run) == pytest.approx(8 / 11 * 100)
    assert len(R.job_ms(run)) == 10


def test_decode_tokens_are_counted_in_the_window():
    j = _job(0, 0, -1.0, -1.0, -0.5, 0.25, 8)  # tokens at -0.25 .. 1.5
    run = _run([j], seconds=1.0)
    # tokens at 0.0, 0.25, 0.5, 0.75 are inside [0, 1)
    assert R.decode_tokens_in_window(run) == [11, 12, 13, 14]


def _conf(name):
    return S.read_json(S.BENCH / "configs" / f"{name}.json")


def test_dense_flops_against_the_ports_param_count():
    from harness import driver as D

    conf = _conf("internlm2-1.8b")
    cfg = D.port_config(conf)
    work = S.load_module("work", conf["work"])
    d, v, nl = 2048, 92544, 24
    non_matmul = v * d + d + 2 * d * nl  # embedding lookup, norms
    assert work.body_params(conf) + d * v == cfg.param_count() - non_matmul
    assert work.head_flops(conf) == 2 * d * v
    # one decode token at 99 tokens of context: 2 N + 4 n hd ctx per layer
    assert work.decode_flops(conf, 99) == (
        2 * (cfg.param_count() - non_matmul) + 24 * 4 * 16 * 128 * 100)
    assert work.prefill_flops(conf, 3) == (
        2 * work.body_params(conf) * 3 + 2 * d * v + 24 * 4 * 16 * 128 * 6)


def test_moe_flops_count_six_routed_and_two_shared_experts():
    from harness import driver as D

    conf = _conf("deepseek-v2-lite-16b")
    cfg = D.port_config(conf)
    work = S.load_module("work", conf["work"])
    d, v, nl = 2048, 102400, 27
    non_matmul = v * d + d + 2 * d * nl
    active = cfg.active_param_count()
    assert work.body_params(conf) + d * v == active - non_matmul
    # by hand: 27 MLA layers, one dense MLP, 26 x (8 experts' SwiGLU + router)
    mla = (d * 16 * 192 + d * 576 + 512 * 16 * 128 * 2 + 16 * 128 * d)
    hand = 27 * mla + 3 * d * 10944 + 26 * (8 * 3 * d * 1408 + d * 64)
    assert work.body_params(conf) == hand
    assert 2.3e9 < active - v * d < 2.5e9   # "16B-A2.4B", the embedding aside
    assert work.decode_flops(conf, 0) == (
        2 * hand + 2 * d * v + 27 * 2 * 16 * 1 * (2 * 512 + 64))


def test_kernel_work_by_hand():
    gqa = _conf("internlm2-1.8b")
    mod = S.load_module("kernels", "paged_decode_attention")
    f, b = mod.work(gqa, [15, 31], 16)
    # rows at 16 and 32 positions: QK and PV over 16 heads of 128
    assert f == 24 * 4 * 16 * 128 * (16 + 32)
    per_row = lambda ctx, blocks: (2 * ctx * 8 * 128 + 2 * 16 * 128) * 2 + 4 + 4 * blocks
    assert b == 24 * (per_row(16, 1) + per_row(32, 2))
    mla = _conf("deepseek-v2-lite-16b")
    mod = S.load_module("kernels", "paged_mla_decode_attention")
    f, b = mod.work(mla, [9], 16)
    assert f == 27 * (2 * 16 * 10 * 576 + 2 * 16 * 10 * 512)
    assert b == 27 * ((10 * 576 + 16 * 576 + 16 * 512) * 2 + 4 + 4)
    mod = S.load_module("kernels", "flash_attention")
    f, b = mod.work(gqa, [4], 16)
    assert f == 24 * 4 * 16 * 128 * 10 and b == 24 * 4 * (32 + 16) * 128 * 2


def test_roofline_reader_scales_to_the_launches_traced():
    from harness import trace as TR

    conf = _conf("internlm2-1.8b")
    tr = TR.Trace(t0=0.0, t1=1.0, busy_s=0.5)
    tr.kernel_s.update({"decode_tc_kernel": 0.01, "split_merge_kernel": 0.002})
    tr.kernel_n.update({"decode_tc_kernel": 48})  # two calls of 24 layers
    rec = type("Rec", (), {"decode_calls": [(0.1, 0.2, 0, (99,) * 4)],
                           "prefill_calls": []})()
    run = _run([], seconds=1.0)
    run.conf, run.rec, run.trace = conf, rec, tr
    run.traffic = {"block_size": 16, "period_ms": 1.0}
    mod = S.load_module("kernels", "paged_decode_attention")
    f, b = mod.work(conf, (99,) * 4, 16)
    want = 100 * max(2 * b / 3.35e12, 2 * f / 989e12) / 0.012
    assert R.kernel_roofline(run, "paged_decode_attention", "decode") == \
        pytest.approx(want)
    assert R.idle_share(run) is None  # no device events read
    tr.events = 10
    assert R.idle_share(run) == pytest.approx(50.0)
    assert math.isfinite(want)


def test_trace_reduction_busy_and_gaps():
    from harness import trace as TR
    import torch

    class Ev:
        def __init__(self, name, start, dur, cuda=True):
            self._n, self._s, self._d, self._c = name, start, dur, cuda

        def name(self):
            return self._n

        def start_ns(self):
            return self._s

        def duration_ns(self):
            return self._d

        def device_type(self):
            return (torch.autograd.DeviceType.CUDA if self._c
                    else torch.autograd.DeviceType.CPU)

    ms = 1_000_000
    evs = [Ev(TR.MARK, 1000 * ms, 0, cuda=False),
           Ev("void k1<int>(float*)", 1001 * ms, 2 * ms),
           Ev("k2", 1002 * ms, 2 * ms),          # overlaps k1
           Ev("k1", 1010 * ms, 5 * ms),
           Ev("k3", 1018 * ms, 10 * ms)]          # cut at the window's end
    tr = TR.reduce(evs, 50.0, 50.020)
    assert tr.busy_s == pytest.approx(0.003 + 0.005 + 0.002)
    assert tr.kernel_n["k1"] == 2 and tr.kernel_s["k1"] == pytest.approx(0.007)
    assert sorted(round(g, 6) for g, _ in tr.gaps) == [0.001, 0.003, 0.006]
    named = TR.name_gaps(tr, [("decode_call", 50.004, 50.0105)])
    assert named[0] == ["decode_call", pytest.approx(0.006)]
