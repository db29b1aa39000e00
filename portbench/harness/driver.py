"""The system under test and its traffic: the port's paged batching engine
(``ServeEngine(batching=True, paged=True)``), one client thread per
stream, a warm-up of the cell's own traffic, the measured window and the
drain.

Every stream is a real-time task: it releases jobs (open loop: on its
schedule; closed loop: when its last job ends) and runs them one after
another through ``ServeEngine.generate``.  Times are taken from each
job's release, so a stall shows in every later job of the stream.

The benchmark reads the program through wrappers it sets on the engine
instance and its servers (removed again before the engine is closed):
each request's submit, start and end (a job's first token is its prefill
request's end, every later token a decode request's end), each device
call's ``batch_meta`` as the server records it (the ring holds 4096, so
it is copied as it comes), the live rows' lengths of each decode and
prefill call, each prefill row's first token, and the host spans that
name the idle gaps of a trace.
"""

from __future__ import annotations

import contextlib
import importlib
import threading
import time
import weakref
from dataclasses import dataclass, field

import numpy as np

from harness import traffic as T


@dataclass
class Job:
    stream: int
    index: int
    release: float               # host monotonic seconds
    prompt_len: int
    out_len: int                 # tokens served: the prefill's and steps'
    start: float = 0.0
    end: float = 0.0
    ok: bool = False
    error: str = ""
    first: float = 0.0           # the first token's time
    prefill_wait: float = 0.0    # its prefill request's submit to dequeue
    token_ends: list = field(default_factory=list)  # each decode token's
    tokens: list = field(default_factory=list)      # served token ids


class _Timed:
    """A submitted request whose ``wait`` records its times."""

    __slots__ = ("req", "sink")

    def __init__(self, req, sink):
        self.req, self.sink = req, sink

    def wait(self, timeout=None):
        try:
            return self.req.wait(timeout)
        finally:
            r = self.req
            self.sink.append((r.name, r.submit_t, r.start_t, r.end_t))
            self.req = None


class Recorder:
    """The benchmark's wrappers on one engine."""

    WRAPPED = ("_run_paged_decode", "_run_prefill_batch",
               "_insert_slot_paged", "_on_device")

    def __init__(self, eng, num_streams: int):
        self.eng = eng
        self.requests = {f"s{i}": [] for i in range(num_streams)}
        self.first_token: dict[bytes, int] = {}
        self.decode_calls: list = []   # (t0, t1, server, lengths)
        self.prefill_calls: list = []  # (t0, t1, server, lengths, bucket)
        self.meta: list = []           # (t, server, batch_meta entry)
        self.spans: list = []          # (name, t0, t1), host seconds
        # a test's fault: fn(payloads, rows) -> rows, applied to each
        # decode call's result
        self.fault = None
        # the gate that ``quiet`` closes: no device call in flight
        self._gate = threading.Condition()
        self._closed = False
        self._inflight = 0
        self._install()

    @contextlib.contextmanager
    def quiet(self):
        """Hold every server's next device call and wait for those in
        flight: the profiler is started and stopped with no kernel being
        launched from another thread."""
        with self._gate:
            self._closed = True
            while self._inflight:
                self._gate.wait()
        try:
            yield
        finally:
            with self._gate:
                self._closed = False
                self._gate.notify_all()

    def _install(self):
        eng = self.eng
        decode, prefill, insert, on_device = (getattr(eng, n)
                                              for n in self.WRAPPED)

        def gated(si, fn):
            with self._gate:
                while self._closed:
                    self._gate.wait()
                self._inflight += 1
            try:
                return on_device(si, fn)
            finally:
                with self._gate:
                    self._inflight -= 1
                    self._gate.notify_all()

        def run_decode(si):
            inner = decode(si)

            def run(payloads):
                t0 = time.monotonic()
                rows = inner(payloads)
                t1 = time.monotonic()
                self.decode_calls.append(
                    (t0, t1, si, tuple(p[2] for p in payloads)))
                self.spans.append(("decode_call", t0, t1))
                if self.fault is not None:
                    rows = self.fault(payloads, rows)
                return rows
            return run

        def run_prefill(si, bucket):
            inner = prefill(si, bucket)

            def run(payloads):
                t0 = time.monotonic()
                out = inner(payloads)
                t1 = time.monotonic()
                self.prefill_calls.append(
                    (t0, t1, si, tuple(int(p[1]) for p in payloads), bucket))
                self.spans.append(("prefill_call", t0, t1))
                for (prefix, _), (row, _, _) in zip(payloads, out):
                    self.first_token[np.asarray(prefix).tobytes()] = int(
                        np.argmax(row))
                return out
            return run

        def insert_slot(*args):
            t0 = time.monotonic()
            try:
                return insert(*args)
            finally:
                self.spans.append(("insert", t0, time.monotonic()))

        eng._run_paged_decode = run_decode
        eng._run_prefill_batch = run_prefill
        eng._insert_slot_paged = insert_slot
        eng._on_device = gated
        for si, server in enumerate(eng.pool.servers):
            self._wrap_server(si, server)

    def _wrap_server(self, si, server):
        submit_batch, record_meta = server.submit_batch, server.record_meta

        def timed_submit(payload, **kw):
            req = submit_batch(payload, **kw)
            return _Timed(req, self.requests[req.name.split("/", 1)[0]])

        def record(**decision):
            self.meta.append((time.monotonic(), si, decision))
            record_meta(**decision)

        server.submit_batch = timed_submit
        server.record_meta = record

    def remove(self):
        """Drop every wrapper: each refers back to the engine."""
        for n in self.WRAPPED:
            vars(self.eng).pop(n, None)
        for server in self.eng.pool.servers:
            vars(server).pop("submit_batch", None)
            vars(server).pop("record_meta", None)


@dataclass
class Served:
    jobs: list
    unfinished: list
    w0: float
    w1: float
    # wakeup latencies (s) of every server from the window's start to its
    # end, or to the traced sub-window's start
    wake: list
    trace: object = None


def make_engine(cfg, params, traffic: dict, device):
    """The engine under test.  Each server's precompile starts from an
    emptied allocator cache: a CUDA graph's capture cannot take back the
    blocks that the previous server's eager warm-up left cached, and with
    deepseek's 31.4 GB of weights one run in fifteen ran the card out of
    memory there."""
    import torch

    from repro_torch.serving.engine import ServeEngine

    eng = ServeEngine(cfg, params, max_seq=traffic["max_seq"],
                      num_servers=traffic["servers"], batching=True,
                      max_batch=traffic["max_batch"], paged=True,
                      kv_block_size=traffic["block_size"], device=device)
    if eng.device.type == "cuda":
        precompile_server = type(eng)._precompile_server
        ref = weakref.ref(eng)  # no cycle: a closed engine is freed at once

        def emptied_first(*args, **kw):
            torch.cuda.empty_cache()
            return precompile_server(ref(), *args, **kw)

        eng._precompile_server = emptied_first
    return eng


def admit(eng, traffic: dict, num_streams: int) -> list[bool]:
    """Admit every stream with the declared segment costs of the traffic
    file; returns which streams were admitted.  Priorities are rate
    monotonic: every stream has the same period, so the same priority,
    and each server's queue serves them in arrival order."""
    from repro_torch.serving.engine import StreamSpec

    d = traffic["declared"]
    period = traffic["period_ms"]
    out = []
    for i in range(num_streams):
        spec = StreamSpec(name=f"s{i}", priority=1,
                          period_ms=period, deadline_ms=period,
                          prefill_ms=d["prefill_ms"], decode_ms=d["decode_ms"],
                          decode_steps=d["decode_steps"], cpu_ms=d["cpu_ms"])
        out.append(bool(eng.admit(spec).admitted))
    return out


def port_base(port: dict):
    """The base config that a configuration file's ``port`` names: the
    ``CONFIG`` of the module ``repro_torch.configs.<arch>``, ``-`` read as
    ``_``.  That is what ``registry.get_config`` returns for its own archs,
    without its list of them, so a port-only module (whose ``CONFIG`` may
    be an instance of a subclass of ``ModelConfig``, with keys the
    registry's configs lack) is named the same way.  Both ``port_config``
    and the CPU tests' cuts start here."""
    from repro_torch.configs.registry import ModelConfig

    arch = port.get("arch")
    if not (isinstance(arch, str) and arch.replace("-", "_").isidentifier()):
        raise ValueError(f"port {port!r}: 'arch' names no module of "
                         f"repro_torch.configs")
    name = "repro_torch.configs." + arch.replace("-", "_")
    try:
        module = importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"port {port!r}: no module {name}") from None
    base = getattr(module, "CONFIG", None)
    if not isinstance(base, ModelConfig):
        raise ValueError(f"port {port!r}: {name} has no CONFIG that is a "
                         f"ModelConfig")
    return base


def port_config(conf: dict):
    """The port's config of a configuration file: the base its ``port``
    names, with the ``port.fields`` replaced."""
    import dataclasses

    port = conf["port"]
    return dataclasses.replace(port_base(port), **port.get("fields", {}))


@dataclass
class Bench:
    """One cell set up and ready to serve: its weights, the engine with
    the benchmark's wrappers on, every stream admitted, and the traffic's
    per-stream plans."""
    cfg: object
    params: dict
    eng: object
    rec: Recorder
    plans: list
    admitted: list
    steps: dict   # set-up step -> seconds


def setup(cell, seed: int, horizon_s: float, device, *, cfg=None,
          traffic=None, fault=None) -> Bench:
    """The one set-up of every run on the card and of the sweep and the
    control: the port's modules, the build, the weights from ``seed``,
    the engine, buckets tuned to the traffic's own lengths, the cells
    that traffic reaches precompiled (and captured), and every stream
    admitted.  ``horizon_s``: the seconds of traffic to plan.  ``cfg``
    (default: the configuration file's), ``traffic`` (default: the
    cell's) and ``fault`` (``fault(eng, rec)`` breaks the timed path
    once the wrappers are on) are for the tests and the control."""
    import functools

    import torch

    from harness import weights as W

    t = time.monotonic()
    import repro_torch.serving.engine  # noqa: F401  (the port's modules)
    from repro_torch.analysis.cost_model import bucket_up
    from repro_torch.kernels import _build

    log = functools.partial(print, flush=True)
    traffic = traffic if traffic is not None else cell.traffic
    cfg = cfg if cfg is not None else port_config(cell.config)
    steps = {"import": time.monotonic() - t}
    t = time.monotonic()
    steps["build"] = _build.build() if device.type == "cuda" else 0.0
    t = time.monotonic()
    torch.empty(1, device=device)
    steps["device_init"] = time.monotonic() - t
    t = time.monotonic()
    tree = W.layout(cfg)
    steps["weights_layout"] = time.monotonic() - t
    t = time.monotonic()
    params = W.allocate(tree, device)
    W.fill(params, seed)
    if device.type == "cuda":
        torch.cuda.synchronize()
    steps["weights_draw"] = time.monotonic() - t
    log(f"set-up: weights {W.param_bytes(params) / 1e9:.3f} GB "
        f"({cfg.dtype}) drawn from the seed")

    plans = T.plan(traffic, seed, horizon_s)
    lens = [n for p in plans for n in p.prompt_lens]
    eng = make_engine(cfg, params, traffic, device)
    rec = Recorder(eng, traffic["streams"])
    if fault is not None:
        fault(eng, rec)
    t = time.monotonic()
    outs = sorted(n for p in plans for n in p.out_lens)
    eng.tune_buckets(lens, steps_hint=outs[len(outs) // 2])
    steps["tune_buckets"] = time.monotonic() - t
    t = time.monotonic()
    rep = eng.precompile(prompt_buckets=tuple(sorted(
        {bucket_up(n, eng.prefill_buckets) for n in lens})))
    steps["precompile"] = time.monotonic() - t
    servers = traffic["servers"]
    log(f"set-up: precompile {rep.compiled} cells a server "
        f"({len(rep.decode_cells)} decode, {len(rep.prefill_cells)} prefill,"
        f" {len(rep.migrate_cells)} migration widths), "
        f"{rep.captured // servers} graphs a server; prefill buckets "
        f"{eng.prefill_buckets}, width buckets {eng.width_buckets}")
    admitted = admit(eng, traffic, traffic["streams"])
    log(f"set-up: {sum(admitted)} of {len(admitted)} streams admitted")
    return Bench(cfg=cfg, params=params, eng=eng, rec=rec, plans=plans,
                 admitted=admitted, steps=steps)


def serve(eng, rec: Recorder, traffic: dict, plans, seed: int, vocab: int,
          *, warm_s: float, seconds: float, trace_at=None) -> Served:
    """Run the traffic: ``warm_s`` seconds of warm-up, then the window of
    ``seconds``; releases stop at the window's end and the jobs in flight
    drain for at most the traffic's ``drain_cap_s``.  ``trace_at`` =
    (offset into the window, seconds) traces a sub-window."""
    closed = traffic["loop"] == "closed"
    jobs: list[Job] = []
    current: dict[int, Job] = {}
    origin = time.monotonic() + 0.05
    w0 = origin + warm_s
    w1 = w0 + seconds

    def client(p):
        name = f"s{p.index}"
        sink = rec.requests[name]
        k = 0
        prev_end = origin + p.offset_ms / 1e3
        n = len(p.prompt_lens)
        while True:
            if closed:
                release = prev_end
            else:
                if k >= len(p.releases_ms):
                    return
                release = origin + p.releases_ms[k] / 1e3
            if release >= w1:
                return
            now = time.monotonic()
            if release > now:
                time.sleep(release - now)
            job = Job(p.index, k, release, p.prompt_lens[k % n],
                      p.out_lens[k % n])
            prompt = T.prompt_tokens(seed, p.index, k, job.prompt_len, vocab)
            current[p.index] = job
            sink.clear()
            job.start = time.monotonic()
            try:
                res = eng.generate(name, prompt, steps=job.out_len - 1)
                job.end = time.monotonic()
                first = rec.first_token.get(prompt[0].tobytes())
                if first is None:
                    raise RuntimeError("no prefill row recorded for the job")
                job.tokens = [first, *res.tokens]
                times = {r[0].split("/", 1)[1]: r[3] for r in sink}
                job.first = times["prefill"]
                job.prefill_wait = next(r[2] - r[1] for r in sink
                                        if r[0].endswith("/prefill"))
                job.token_ends = [times[f"decode{i}"]
                                  for i in range(job.out_len - 1)]
                job.ok = True
            except Exception as e:  # counted as failed, never swallowed
                job.end = time.monotonic()
                job.error = f"{type(e).__name__}: {e}"
            jobs.append(job)
            del current[p.index]
            prev_end = job.end
            k += 1

    threads = [threading.Thread(target=client, args=(p,), daemon=True,
                                name=f"client-s{p.index}") for p in plans]
    for t in threads:
        t.start()

    def wait_until(t):
        now = time.monotonic()
        if t > now:
            time.sleep(t - now)

    servers = eng.pool.servers
    wait_until(w0)
    wake0 = [len(s.stats.wakeup_latencies) for s in servers]
    trace = None
    if trace_at is not None:
        from harness import trace as TR

        wait_until(w0 + trace_at[0])
        wake1 = [len(s.stats.wakeup_latencies) for s in servers]
        trace = TR.profile(trace_at[1], rec.quiet)
    wait_until(w1)
    if trace is None:
        wake1 = [len(s.stats.wakeup_latencies) for s in servers]
    wake = [x for s, i, k in zip(servers, wake0, wake1)
            for x in list(s.stats.wakeup_latencies)[i:k]]
    cap = w1 + traffic["drain_cap_s"]
    for t in threads:
        t.join(max(0.0, cap - time.monotonic()))
    unfinished = [j for j in list(current.values()) if w0 <= j.release < w1]
    return Served(jobs=list(jobs), unfinished=unfinished, w0=w0, w1=w1,
                  wake=wake, trace=trace)
