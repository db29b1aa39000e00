"""The granite-4.0-h-small cell on the CPU at a small cut
(``small_hybrid.py``): the plain reference against the port's plain path
on the same weights; the reference sees every layer and refuses what it
does not compute; the served engine's prefill of mixed true lengths and
its paged decode give the reference's full-forward logits; the weights
sit where the harness's draw expects them; a whole run is correct and
reports its metrics, and each planted fault makes it not correct; the
slab-decode kernel's roofline arithmetic.  This test may import the port;
the reference may not.

The two accepted cells' port logits (small cuts, train, padded prefill
and one dense decode step) keep the digests they had before this
family's scale was threaded through ``layers.attention`` and its dispatch
added to ``models/model.py``."""

import hashlib
import threading
import time

import numpy as np
import pytest
import torch

import small
import run as RUN
import small_hybrid as SH
from harness import readers as R
from harness import spec as S
from harness import trace as TR
from harness import weights as W
from harness.faults import FAULTS
from test_portbench_spans import _fake_profile

# fp32 on both sides: the port's sums run in another order than the
# reference's (the chunked scan against the quadratic form, routed
# experts against a loop), so rounding alone; the logits are ~0.05 (the
# tied embedding drawn at 0.02, divided by 16), so the absolute part is
# set well under their size
TOL = dict(rtol=1e-4, atol=1e-6)


def _conf():
    return SH.small_conf(S.read_json(S.BENCH / "configs"
                                     / "granite-4.0-h-small.json"))


def _ref():
    return S.load_module("reference", "granite_hybrid")


@pytest.mark.parametrize("seed", [0, 2**31 + 7])
def test_reference_matches_port_forward(seed):
    from repro_torch.models import model as M

    conf = _conf()
    cfg = SH.port_cfg(conf)
    params = W.make(cfg, seed, torch.device("cpu"))
    gen = torch.Generator().manual_seed(seed % 1000)
    tokens = torch.randint(0, conf["vocab_size"], (2, 37), generator=gen)
    with torch.no_grad():
        want, _, _ = M.apply(cfg, params, {"tokens": tokens}, mode="train")
    got = _ref().logits(conf, params, list(tokens), [3, 0])
    for row, start, g in zip(want, (3, 0), got):
        assert g.shape == (37 - start, conf["vocab_size"])
        torch.testing.assert_close(g, row[start:].float(), **TOL)


@pytest.mark.parametrize("where", ["mamba", "attention", "expert"])
def test_reference_sees_every_layer(where):
    """One weight of the last Mamba-2 layer, of the last attention layer
    and of each expert of the last layer moves the reference's logits."""
    conf = _conf()
    cfg = SH.port_cfg(conf)
    params = W.make(cfg, 5, torch.device("cpu"))
    seq = [torch.randint(0, conf["vocab_size"], (40,),
                         generator=torch.Generator().manual_seed(1))]
    before = _ref().logits(conf, params, seq, [0])[0]
    if where == "expert":
        # the last layer is a Mamba-2 layer: its MoE block, expert by expert
        w_down = params["layers"]["mamba"]["moe"]["experts"]["w_down"][-1]
        for e in range(conf["num_local_experts"]):
            w_down[e].mul_(2.0)
            after = _ref().logits(conf, params, seq, [0])[0]
            w_down[e].div_(2.0)
            assert (after - before).abs().max() > 1e-6, e
        return
    w = (params["layers"]["mamba"]["mamba"]["out_proj"] if where == "mamba"
         else params["layers"]["attention"]["attn"]["wo"])
    w[-1].mul_(2.0)
    after = _ref().logits(conf, params, seq, [0])[0]
    assert (after - before).abs().max() > 1e-6


@pytest.mark.parametrize("change", [
    {"position_embedding_type": "rope"}, {"mamba_n_groups": 2},
    {"attention_bias": True}, {"mamba_conv_bias": False}])
def test_reference_refuses_what_it_does_not_compute(change):
    conf = _conf()
    cfg = SH.port_cfg(conf)
    params = W.make(cfg, 3, torch.device("cpu"))
    conf.update(change)
    with pytest.raises(NotImplementedError):
        _ref().logits(conf, params, [torch.arange(5)], [0])


def test_weights_sit_where_the_draw_expects_them():
    """Every stack under ``layers`` led by its kind's count; products at
    1/sqrt(fan-in), the router at 0.02 in fp32, Mamba-2's own leaves in
    mamba_ssm's ranges."""
    conf = _conf()
    conf.update(hidden_size=256, mamba_n_heads=32, num_attention_heads=8,
                intermediate_size=128, shared_intermediate_size=192)
    cfg = SH.port_cfg(conf)
    p = W.make(cfg, 2**31 + 1, torch.device("cpu"))
    m, a = p["layers"]["mamba"], p["layers"]["attention"]
    assert m["ln1"]["scale"].shape[0] == 3 and a["ln1"]["scale"].shape[0] == 1
    d, f = 256, 128
    for t, std in ((m["mamba"]["in_proj"], d ** -0.5),
                   (m["mamba"]["out_proj"], (32 * 16) ** -0.5),
                   (a["attn"]["wq"], d ** -0.5),
                   (a["attn"]["wo"], (8 * 32) ** -0.5),
                   (m["moe"]["experts"]["w_gate"], d ** -0.5),
                   (m["moe"]["experts"]["w_down"], f ** -0.5),
                   (m["moe"]["shared"]["w_down"], 192 ** -0.5),
                   (m["moe"]["router"], 0.02)):
        assert float(t.std()) == pytest.approx(std, rel=0.1)
    assert m["moe"]["router"].dtype == torch.float32
    A = torch.exp(m["mamba"]["A_log"])
    assert 1.0 <= float(A.min()) and float(A.max()) <= 16.0
    dt = torch.nn.functional.softplus(m["mamba"]["dt_bias"])
    assert 1e-4 <= float(dt.min()) and float(dt.max()) <= 0.1 + 1e-6
    assert torch.all(m["mamba"]["ssm_D"] == 1)
    assert torch.all(m["mamba"]["gate_norm"] == 1)


def test_engine_prefill_and_paged_decode_match_the_reference():
    """Four streams on ``ServeEngine(batching=True, paged=True)``: prompts
    of mixed true lengths prefilled in padded calls (the first call is
    held until the others' requests are queued, so three share the
    32-token bucket's calls), then paged decode; every logits row a call
    returns equals the reference's full forward at its position.  The
    prompts' positions do not overlap, so a row's length names its
    stream."""
    from repro_torch.serving.engine import ServeEngine, StreamSpec

    steps = 6
    conf = _conf()
    cfg = SH.port_cfg(conf)
    params = W.make(cfg, 2**31 + 13, torch.device("cpu"))
    rng = np.random.default_rng(3)
    prompts = {f"s{i}": rng.integers(0, conf["vocab_size"], (1, n),
                                     dtype=np.int32)
               for i, n in enumerate((9, 17, 24, 31))}
    eng = ServeEngine(cfg, params, max_seq=48, num_servers=1, batching=True,
                      max_batch=4, paged=True, kv_block_size=8, device="cpu")
    rows = {}   # position -> logits rows served there
    lock = threading.Lock()
    decode, prefill = eng._decode_paged_impl, eng._prefill_batch_impl

    def record_decode(packed, pools, params=None):
        out = decode(packed, pools, params)
        with lock:
            for r, lg in zip(packed[:, 1].tolist(), out[:, 0]):
                rows.setdefault(r, []).append(lg.clone())
        return out

    def record_prefill(tokens, lengths, params=None):
        if not rows:
            time.sleep(0.5)
        out, cache = prefill(tokens, lengths, params)
        with lock:
            for n, lg in zip(lengths.tolist(), out):
                rows.setdefault(n - 1, []).append(lg.clone())
        return out, cache

    eng._decode_paged_impl = record_decode
    eng._prefill_batch_impl = record_prefill
    results = {}
    try:
        for n in prompts:
            assert eng.admit(StreamSpec(
                name=n, priority=1, period_ms=8000.0, deadline_ms=8000.0,
                prefill_ms=50.0, decode_ms=5.0, decode_steps=steps)).admitted

        def worker(n):
            results[n] = eng.generate(n, prompts[n], steps=steps)

        threads = [threading.Thread(target=worker, args=(n,))
                   for n in prompts]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        meta = [m for s in eng.pool.servers for m in s.stats.batch_meta]
    finally:
        eng.close()
    assert {m["kind"] for m in meta} == {"prefill@hybrid", "decode@hybrid"}
    assert any(m["rows"] > 1 for m in meta if m["kind"] == "prefill@hybrid")
    seqs, starts = [], []
    for n, prompt in prompts.items():
        # the first served token comes from the prefill row
        first = int(torch.argmax(rows[prompt.shape[1] - 1][0]))
        toks = [first, *results[n].tokens]
        seqs.append(torch.cat([torch.as_tensor(prompt[0], dtype=torch.long),
                               torch.as_tensor(toks[:-1])]))
        starts.append(prompt.shape[1] - 1)
    ref = _ref().logits(conf, params, seqs, starts)
    for want, start in zip(ref, starts):
        for j, row in enumerate(want):
            for got in rows[start + j]:
                torch.testing.assert_close(got, row, **TOL)


def _small_run(fault=None, trace=False, seed=2**31 + 3):
    torch.set_num_threads(2)
    cell, cfg = SH.small_cell()
    if trace:
        cell.traffic["trace_s"] = 1.0
    return RUN.run_cell(cell, seed, 3.0 if trace else 2.0, trace,
                        torch.device("cpu"), t_start=time.monotonic(),
                        cfg=cfg, fault=fault)


@pytest.fixture
def default_precision():
    torch.set_float32_matmul_precision("highest")


@pytest.mark.usefixtures("default_precision")
def test_sound_run_is_correct():
    res = _small_run()
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"tokens_per_s", "setup_s"}


@pytest.mark.usefixtures("default_precision")
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(fault):
    res = _small_run(FAULTS[fault])
    assert not res["correct"], res["checks"]


GH = ("rows_per_decode_call.gh", "decode_call_ms.gh", "decode_wait_ms.gh",
      "device_idle_share.gh", "idle_in_call_share.gh", "window_mfu.gh",
      "experts_read_share.gh", "ssd_decode_roofline.gh",
      "decode_stage_ms.gh", "decode_readback_ms.gh",
      "decode_coalesced_share.gh")


def test_the_cell_lists_its_metrics():
    cell = S.load_cell(SH.CELL)
    assert [m["name"] for m in cell.metrics(True)] == list(GH)
    assert [m["name"] for m in cell.metrics(False)] == ["tokens_per_s",
                                                         "setup_s"]
    for other in ("internlm2-rt-decode", "deepseek-sat-decode"):
        assert not set(GH) & {m["name"] for m in
                              S.load_cell(other).metrics(True)}


@pytest.mark.usefixtures("default_precision")
def test_traced_run_reports_the_cells_metrics(monkeypatch):
    """A traced run with the profiler replaced by a synthetic trace, which
    holds no kernel: every metric but the kernel's roofline is read, and
    each routed decode layer reads at least K of E experts."""
    monkeypatch.setattr(TR, "profile", _fake_profile())
    res = _small_run(trace=True, seed=2**31 + 11)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert set(got) == set(GH) - {"ssd_decode_roofline.gh"}
    cfg = SH.port_cfg(_conf())
    share = 100.0 * cfg.num_experts_per_tok / cfg.num_experts
    assert share - 1e-9 <= got["experts_read_share.gh"]["value"] <= 100.0


def test_slab_decode_roofline_arithmetic():
    """The kernel's work at the served widths, and its share over a
    synthetic trace of two calls."""
    conf = S.read_json(S.BENCH / "configs" / "granite-4.0-h-small.json")
    mod = S.load_module("kernels", "ssd_slab_decode")
    assert mod.launches(conf) == 18
    flops, nbytes = mod.work(conf, [100, 7], 16)
    state = 128 * 64 * 128
    assert flops == 2 * 5 * state * 18
    assert nbytes == 18 * (2 * (2 * state * 4 + 2 * 128 * 64 * 2 + 128 * 4
                                + 2 * 128 * 2 + 4) + 128 * 4)
    tr = TR.Trace(t0=0.0, t1=2.0, busy_s=1.0)
    tr.kernel_s["slab_decode_kernel"] = 0.004
    tr.kernel_n["slab_decode_kernel"] = 36
    rec = type("Rec", (), {"decode_calls": [(0.1, 0.2, 0, (100, 7)),
                                            (0.5, 0.6, 1, (100, 7))],
                           "prefill_calls": []})()
    run = R.Run(conf=conf, traffic={"block_size": 16}, seconds=2.0,
                served=None, rec=rec, setup_s=0.0, trace=tr)
    want = 100.0 * 2 * nbytes / 3.35e12 / 0.004
    assert S.load_module("metrics", "ssd_decode_roofline.gh").read(
        run) == pytest.approx(want)


def _digest(name, seed):
    from repro_torch.models import model as M

    conf = small.small_conf(S.read_json(S.BENCH / "configs" / f"{name}.json"))
    cfg = small.port_cfg(conf)
    params = W.make(cfg, seed, torch.device("cpu"))
    gen = torch.Generator().manual_seed(seed % 1000)
    tokens = torch.randint(0, conf["vocab_size"], (2, 21), generator=gen)
    h = hashlib.sha256()
    with torch.no_grad():
        lg, _, _ = M.apply(cfg, params, {"tokens": tokens}, mode="train")
        h.update(lg.float().numpy().tobytes())
        lg, cache, _ = M.apply(cfg, params, {"tokens": tokens, "max_seq": 32},
                               mode="prefill")
        h.update(lg.float().numpy().tobytes())
        lg, _, _ = M.apply(cfg, params, {"tokens": tokens[:, -1:]},
                           mode="decode", cache=cache)
        h.update(lg.float().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name, seed, digest", [
    ("internlm2-1.8b", 0,
     "14acac04e433063634684b75a0d3d8df4b0a2c68cd9771581095f163ef0080d5"),
    ("internlm2-1.8b", 2**31 + 7,
     "ff78360bf0fdb69949d61ea17b2f135fbb88550accf838f17e8892dff4432014"),
    ("deepseek-v2-lite-16b", 0,
     "8a0bfa1b05bc60be5638db5c5aa5a7352ea5b0f095da831c51dea13bd1545d7a"),
    ("deepseek-v2-lite-16b", 2**31 + 7,
     "44d3ddd6f3f824172beefae75f7c28ba43b64f1f8b4bfbfbbad07b8ffb4530bd")])
def test_accepted_cells_logits_keep_their_digests(name, seed, digest):
    assert _digest(name, seed) == digest
