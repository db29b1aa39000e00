"""Tracing in the port's servers and serving engine, on the CPU.

By default tracing follows the torch profiler: with none recording,
nothing is recorded and no ring exists; a server switches at its first
device call after a profiler starts or stops, from its next dispatch unit
on.  Switched on (``ServeEngine.set_tracing``): every batched decode and
prefill call is
split into its stage, wait and readback inside its call span, every
request names the call that served it, every client's wake starts at its
request's end, and every decode call counts the server's streams in their
decode loop.

Config: internlm2-1.8b reduced, fp32, paged, 4 streams on 2 servers.
"""

import dataclasses
import threading
from collections import defaultdict

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core import server_runtime
from repro_torch.core.server_runtime import ServerStats
from repro_torch.models import model as M
from repro_torch.serving.engine import ServeEngine, StreamSpec

STEPS = 6
STREAMS = 4


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_config("internlm2_1_8b").reduced(),
                              dtype="float32")
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.default_rng(7)
    prompts = {f"s{i}": rng.integers(0, cfg.vocab_size, (1, 5 + 2 * i),
                                     dtype=np.int32) for i in range(STREAMS)}
    return cfg, params, prompts


def _engine(cfg, params, prompts, **kw):
    kw = {"max_seq": 32, "batching": True, "paged": True, "kv_block_size": 8,
          "num_servers": 2, "max_batch": 4, "device": "cpu", **kw}
    eng = ServeEngine(cfg, params, **kw)
    for n in prompts:
        assert eng.admit(StreamSpec(
            name=n, priority=1, period_ms=8000.0, deadline_ms=8000.0,
            prefill_ms=50.0, decode_ms=5.0, decode_steps=STEPS)).admitted
    return eng


def _run_streams(eng, prompts):
    results = {}

    def worker(n):
        results[n] = eng.generate(n, prompts[n], steps=STEPS)

    threads = [threading.Thread(target=worker, args=(n,)) for n in prompts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert all(len(r.tokens) == STEPS for r in results.values())
    return results


@pytest.fixture(scope="module")
def rounds(setup):
    """One round of jobs untraced, then one traced, on one engine: what
    the untraced round left, the traced round's records and each server's
    ``batch_meta`` entries of the traced round."""
    cfg, params, prompts = setup
    eng = _engine(cfg, params, prompts)
    try:
        servers = eng.pool.servers
        assert {eng.pool.server_of(n) for n in prompts} == {0, 1}
        _run_streams(eng, prompts)
        off = {"spans": [s.stats.spans for s in servers],
               "call_ids": [s.stats.call_id for s in servers],
               "records": eng.trace_records(),
               "meta": [list(s.stats.batch_meta) for s in servers]}
        before = [len(s.stats.batch_meta) for s in servers]
        eng.set_tracing(True)
        _run_streams(eng, prompts)
        eng.set_tracing(False)
        on = {"records": eng.trace_records(),
              "meta": [list(s.stats.batch_meta)[k:]
                       for s, k in zip(servers, before)]}
        return off, on
    finally:
        eng.close()


def _by_call(records):
    """{(server, call_id): {"call": record, step name: record}} of the
    calls and the steps recorded inside them."""
    out = defaultdict(dict)
    for r in records:
        if r[4] is not None and r[1] not in ("request", "wake"):
            out[(r[0], r[4])][r[1]] = r
    return out


def test_tracing_off_records_nothing(rounds):
    off, _ = rounds
    assert off["spans"] == [None, None]  # no ring was allocated
    assert off["call_ids"] == [0, 0]
    assert off["records"] == []
    # the counter is kept all the same
    assert all("decoding" in m for ms in off["meta"] for m in ms
               if m["kind"] == "decode")


def test_every_batched_call_splits_into_its_steps(rounds):
    _, on = rounds
    calls = _by_call(on["records"])
    for si in (0, 1):
        batched = [calls[k] for k in sorted(calls) if k[0] == si
                   and "stage" in calls[k]]
        meta = on["meta"][si]
        assert meta and len(batched) == len(meta)
        assert {m["kind"] for m in meta} == {"decode", "prefill"}
        for steps, m in zip(batched, meta):
            call = steps["call"]
            stage, wait, read = steps["stage"], steps["wait"], steps["readback"]
            assert call[2] <= stage[2] <= stage[3] == wait[2] <= wait[3] \
                == read[2] <= read[3] <= call[3]
            # the steps cover ``seconds`` and the packing before it
            total = read[3] - stage[2]
            assert total >= m["seconds"]
            assert total == pytest.approx(m["seconds"], rel=0.05)
    # the inserts are calls of their own, with one step
    inserts = [c for c in calls.values() if "insert" in c]
    assert len(inserts) == STREAMS
    for c in inserts:
        assert c["call"][2] <= c["insert"][2] <= c["insert"][3] <= c["call"][3]


def test_requests_name_their_call(rounds):
    _, on = rounds
    recs = on["records"]
    calls = _by_call(recs)
    requests = [r for r in recs if r[1] == "request"]
    # a prefill, an insert and STEPS decode requests a job
    assert len(requests) == STREAMS * (STEPS + 2)
    assert len({(r[0], r[5]) for r in requests}) == len(requests)
    served = defaultdict(int)
    for r in requests:
        call = calls[(r[0], r[4])]["call"]
        assert call[2] >= r[2] and r[3] <= call[3]
        served[(r[0], r[4])] += 1
    # a batched call served as many requests as it had rows
    for si in (0, 1):
        batched = [k for k in sorted(calls) if k[0] == si
                   and "stage" in calls[k]]
        assert [served[k] for k in batched] == [m["rows"]
                                                for m in on["meta"][si]]


def test_every_wake_starts_at_its_request_end(rounds):
    _, on = rounds
    recs = on["records"]
    ends = {(r[0], r[5]): r for r in recs if r[1] == "request"}
    wakes = [r for r in recs if r[1] == "wake"]
    assert len(wakes) == len(ends)
    for w in wakes:
        req = ends[(w[0], w[5])]
        assert w[2] == req[3] and w[3] >= w[2]
        assert w[4] == req[4]


def test_decoding_counts_the_rows_streams(rounds):
    _, on = rounds
    decode = [m for ms in on["meta"] for m in ms if m["kind"] == "decode"]
    assert decode
    for m in decode:
        assert STREAMS >= m["decoding"] >= m["rows"] >= 1


def _units(eng, before, prompts):
    """Dispatch units each server ran since ``before`` (its ``batch_meta``
    lengths): its batched calls and one insert for each of its streams."""
    servers = eng.pool.servers
    inserts = [sum(eng.pool.server_of(n) == si for n in prompts)
               for si in range(len(servers))]
    return [len(s.stats.batch_meta) - k + i
            for s, k, i in zip(servers, before, inserts)]


def _calls(records):
    return [sum(r[1] == "call" and r[0] == si for r in records)
            for si in (0, 1)]


def test_tracing_follows_the_profiler(setup):
    cfg, params, prompts = setup
    eng = _engine(cfg, params, prompts)
    servers = eng.pool.servers
    try:
        _run_streams(eng, prompts)
        assert eng.trace_records() == []
        before = [len(s.stats.batch_meta) for s in servers]
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            _run_streams(eng, prompts)
        during = eng.trace_records()
        # each server's first unit under the profiler switched it on and
        # went untraced; every later one was traced
        assert _calls(during) == [n - 1 for n in
                                  _units(eng, before, prompts)]
        _run_streams(eng, prompts)
        after = eng.trace_records()
        # the first unit after the profiler stopped switched it off
        assert set(during) < set(after)
        assert _calls(after) == [n + 1 for n in _calls(during)]
        assert all(not s.stats.tracing for s in servers)
        # switched off for good: a profiler does not switch it on
        eng.set_tracing(False)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            _run_streams(eng, prompts)
        assert eng.trace_records() == after
        assert all(not s.stats.tracing for s in servers)
    finally:
        eng.close()


def test_unbatched_generate_traces_its_calls(setup):
    cfg, params, prompts = setup
    eng = _engine(cfg, params, {"s0": prompts["s0"]}, batching=False,
                  paged=False, num_servers=1)
    try:
        eng.set_tracing(True)
        eng.generate("s0", prompts["s0"], steps=STEPS)
        eng.set_tracing(False)
        recs = eng.trace_records()
    finally:
        eng.close()
    names = [r[1] for r in recs]
    assert names.count("call") == names.count("request") == STEPS + 1
    assert names.count("wake") == STEPS + 1
    calls = {r[4]: r for r in recs if r[1] == "call"}
    for r in recs:
        if r[1] == "request":
            assert calls[r[4]][2] >= r[2] and r[3] <= calls[r[4]][3]


def test_span_ring_wraps_at_its_cap(monkeypatch):
    monkeypatch.setattr(server_runtime, "SPAN_CAP", 8)
    stats = ServerStats()
    stats.set_tracing(True)
    for i in range(20):
        stats.span("x", float(i), i + 0.5, call_id=i)
    assert len(stats.spans) == 8
    assert [s.call_id for s in stats.spans] == list(range(12, 20))
    stats.set_tracing(False)
    assert len(stats.spans) == 8  # readable after tracing stops
    stats.set_tracing(True)
    assert len(stats.spans) == 0  # a fresh ring
