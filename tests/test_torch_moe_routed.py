"""The routed MoE decode path on the CPU: ``moe_routed_experts_plain``
(what the CUDA kernel computes) against ``moe_dense`` in fp32, the route
choice of ``models/moe.py::moe_route``, ``moe_layer`` on the routed path
against the dense path, the mechanism's counter, and the engine's
``experts_read`` over a traced interval.

Configs: deepseek-v2-lite-16b and qwen3-moe-235b-a22b reduced (64 wide, 4
experts of 32, top 2), fp32.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import moe_experts as ME
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.serving.engine import ServeEngine, StreamSpec

ARCHS = ("deepseek_v2_lite_16b", "qwen3_moe_235b_a22b")
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg(name):
    return dataclasses.replace(get_config(name).reduced(), dtype="float32")


def _moe(name, seed=0):
    cfg = _cfg(name)
    gen = torch.Generator().manual_seed(seed)
    return cfg, MOE.init_moe(cfg, gen, torch.float32, "cpu"), gen


def _dense_experts(x, idx, weights, ex):
    """``moe_dense``'s expert part for a given routing: every expert on every
    token, combined by the zero-padded routing weights."""
    g = F.silu(torch.matmul(x, ex["w_gate"]))
    y_all = torch.matmul(g * torch.matmul(x, ex["w_up"]), ex["w_down"])
    combine = torch.zeros((x.shape[0], ex["w_gate"].shape[0]), dtype=x.dtype)
    combine.scatter_add_(1, idx, weights)
    return torch.einsum("te,etd->td", combine, y_all)


def _plain(x, idx, weights, ex):
    return ME.moe_routed_experts_plain(x, idx, weights, ex["w_gate"],
                                       ex["w_up"], ex["w_down"])


def _counter():
    return ME.experts_counter("cpu").clone()


@pytest.mark.parametrize("rows", [1, 3, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_plain_equals_moe_dense(arch, rows):
    cfg, p, gen = _moe(arch)
    x = torch.randn(rows, 1, cfg.d_model, generator=gen)
    with torch.no_grad():
        got, aux = MOE.moe_routed(cfg, p, x)
        want, aux_d = MOE.moe_dense(cfg, p, x)
    torch.testing.assert_close(got, want, **TOL)
    assert aux.item() == aux_d.item()


@pytest.mark.parametrize("arch", ARCHS)
def test_duplicated_rows_give_equal_outputs(arch):
    """The engine pads a decode call by copies of row 0: each copy chooses
    row 0's experts and gets row 0's output bit for bit."""
    cfg, p, gen = _moe(arch)
    x = torch.randn(3, cfg.d_model, generator=gen)
    x = torch.cat([x, x[:1].expand(5, -1)])
    idx, weights, _ = MOE.router_topk(cfg, p, x)
    before = _counter()
    got = _plain(x, idx, weights, p["experts"])
    for i in range(3, 8):
        assert torch.equal(got[i], got[0])
    torch.testing.assert_close(got, _dense_experts(x, idx, weights,
                                                   p["experts"]), **TOL)
    assert (_counter() - before)[0] == len(torch.unique(idx[:3]))


@pytest.mark.parametrize("arch", ARCHS)
def test_every_row_routed_to_one_expert(arch):
    cfg, p, gen = _moe(arch)
    k = cfg.num_experts_per_tok
    x = torch.randn(6, cfg.d_model, generator=gen)
    idx = torch.tensor([[2] + list(range(3, 3 + k - 1))] * 6)
    weights = torch.softmax(torch.randn(6, k, generator=gen), dim=-1)
    before = _counter()
    got = _plain(x, idx, weights, p["experts"])
    torch.testing.assert_close(got, _dense_experts(x, idx, weights,
                                                   p["experts"]), **TOL)
    assert (_counter() - before).tolist() == [k, cfg.num_experts]


class _Recorded:
    """An expert stack that records which experts are indexed."""

    def __init__(self, w, read):
        self.w, self.read, self.shape = w, read, w.shape

    def __getitem__(self, e):
        self.read.append(e)
        return self.w[e]


@pytest.mark.parametrize("arch", ARCHS)
def test_an_expert_no_row_chose_is_not_read(arch):
    """The experts no row chose are neither indexed nor counted."""
    cfg, p, gen = _moe(arch)
    k = cfg.num_experts_per_tok
    x = torch.randn(4, cfg.d_model, generator=gen)
    idx = torch.stack([torch.randperm(cfg.num_experts - 1, generator=gen)[:k]
                       for _ in range(4)])  # the last expert is never chosen
    weights = torch.softmax(torch.randn(4, k, generator=gen), dim=-1)
    read = []
    ex = {n: _Recorded(w, read) for n, w in p["experts"].items()}
    before = _counter()
    got = _plain(x, idx, weights, ex)
    torch.testing.assert_close(got, _dense_experts(x, idx, weights,
                                                   p["experts"]), **TOL)
    assert sorted(set(read)) == sorted(torch.unique(idx).tolist())
    assert cfg.num_experts - 1 not in read
    assert (_counter() - before).tolist() == [len(torch.unique(idx)),
                                              cfg.num_experts]


def test_route_choice(monkeypatch):
    cfg, p, gen = _moe("deepseek_v2_lite_16b")
    x1 = torch.randn(4, 1, cfg.d_model, generator=gen)
    x3 = torch.randn(4, 3, cfg.d_model, generator=gen)
    # an expert's share of the slots, B * K / E, fits one row tile or not
    wide = ME.ROW_TILE * cfg.num_experts // cfg.num_experts_per_tok
    x_fit = torch.randn(wide, 1, cfg.d_model, generator=gen)
    x_wide = torch.randn(wide + 1, 1, cfg.d_model, generator=gen)
    with torch.no_grad():
        assert MOE.moe_route(cfg, p, x1) == "routed"
        assert MOE.moe_route(cfg, p, x3) == "dense"
        assert MOE.moe_route(cfg, p, x_fit) == "routed"
        assert MOE.moe_route(cfg, p, x_wide) == "dense"
    with torch.inference_mode():
        assert MOE.moe_route(cfg, p, x1) == "routed"
    # grad on but nothing requires it: no gradient is wanted
    assert MOE.moe_route(cfg, p, x1) == "routed"
    assert MOE.moe_route(cfg, p, x1.clone().requires_grad_()) == "dense"
    p_grad = {**p, "experts": {**p["experts"], "w_up":
                               p["experts"]["w_up"].clone().requires_grad_()}}
    assert MOE.moe_route(cfg, p_grad, x1) == "dense"
    with torch.no_grad():
        assert MOE.moe_route(cfg, p_grad, x1) == "routed"
        assert MOE.moe_route(cfg, p, x1.to("meta")) == "dense"
        rules = types.SimpleNamespace(mesh=object(), model_axis="model")
        monkeypatch.setattr(shd, "axis_size", lambda mesh, name: 2)
        assert MOE.moe_route(cfg, p, x1, rules) == "expert_parallel"
        monkeypatch.setattr(shd, "axis_size", lambda mesh, name: 1)
        assert MOE.moe_route(cfg, p, x1, rules) == "routed"
        assert MOE.moe_route(cfg, p, x1, types.SimpleNamespace(mesh=None)) \
            == "routed"


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_routed_equals_dense(arch):
    """``moe_layer`` on a decode step: the routed path (no grad) against the
    dense path (x requires grad), shared experts included."""
    cfg, p, gen = _moe(arch)
    x = torch.randn(5, 1, cfg.d_model, generator=gen)
    before = _counter()
    with torch.no_grad():
        got, aux = MOE.moe_layer(cfg, p, x)
    assert (_counter() - before)[1] == cfg.num_experts  # routed: counted
    before = _counter()
    want, aux_d = MOE.moe_layer(cfg, p, x.clone().requires_grad_())
    assert (_counter() - before).tolist() == [0, 0]  # dense: not counted
    torch.testing.assert_close(got, want.detach(), **TOL)
    assert aux.item() == aux_d.item()


def test_kernel_route_by_dtype_and_width():
    def stacks(d, f, dtype):
        return (torch.zeros(2, d, f, dtype=dtype),
                torch.zeros(2, d, f, dtype=dtype),
                torch.zeros(2, f, d, dtype=dtype))

    x = torch.zeros(3, 2048, dtype=torch.bfloat16)
    assert ME.moe_experts_route(x, *stacks(2048, 1408, torch.bfloat16)) \
        == "tensor_cores"
    assert ME.moe_experts_route(x.float(), *stacks(2048, 1408,
                                                   torch.float32)) == "scalar"
    x = torch.zeros(3, 64, dtype=torch.bfloat16)
    assert ME.moe_experts_route(x, *stacks(64, 32, torch.bfloat16)) == "scalar"


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    from repro_torch.kernels import _build

    cfg, p, gen = _moe("deepseek_v2_lite_16b")
    x = torch.randn(2, cfg.d_model, generator=gen)
    idx, weights, _ = MOE.router_topk(cfg, p, x)
    _build.reset_launches()
    ex = p["experts"]
    got = ME.moe_routed_experts(x, idx, weights, ex["w_gate"], ex["w_up"],
                                ex["w_down"])
    assert torch.equal(got, _plain(x, idx, weights, ex))
    assert _build.launches["moe_routed_experts"] == 0


def test_engine_reads_the_experts_of_its_traced_decode_steps():
    """Unbatched generate: each decode step runs every MoE layer on one row
    (its K experts of E), prefill runs dense and is not counted; the engine
    reads the counter from the switch on to the switch off."""
    cfg = _cfg("deepseek_v2_lite_16b")
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    eng = ServeEngine(cfg, params, max_seq=32, device="cpu")
    try:
        assert eng.admit(StreamSpec(name="s", priority=1, period_ms=8000.0,
                                    deadline_ms=8000.0, prefill_ms=50.0,
                                    decode_ms=5.0, decode_steps=4)).admitted
        prompt = (np.arange(1, 6, dtype=np.int32)[None] * 7) % 128
        assert eng.experts_read() is None
        eng.generate("s", prompt, steps=2)  # untraced
        eng.set_tracing(True)
        assert eng.experts_read() is None  # not closed yet
        eng.generate("s", prompt, steps=4)
        eng.set_tracing(False)
        moe_layers = cfg.num_layers - cfg.first_dense_layers
        assert eng.experts_read() == (
            4 * moe_layers * cfg.num_experts_per_tok,
            4 * moe_layers * cfg.num_experts)
    finally:
        eng.close()


def test_engine_interval_needs_no_earlier_routed_call(monkeypatch):
    """The switch on makes the counter where no routed call has made it
    yet, so the interval still counts the decode steps inside it; with two
    servers the interval runs from the first switch on to the last switch
    off."""
    monkeypatch.setattr(ME, "_counters", {})
    cfg = _cfg("deepseek_v2_lite_16b")
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    eng = ServeEngine(cfg, params, max_seq=32, num_servers=2, device="cpu")
    try:
        assert eng.admit(StreamSpec(name="s", priority=1, period_ms=8000.0,
                                    deadline_ms=8000.0, prefill_ms=50.0,
                                    decode_ms=5.0, decode_steps=4)).admitted
        prompt = (np.arange(1, 6, dtype=np.int32)[None] * 7) % 128
        eng._mark_experts(True)   # server 0 on: the interval starts
        eng._mark_experts(True)   # server 1 on
        eng.generate("s", prompt, steps=3)
        eng._mark_experts(False)  # server 0 off
        moe_layers = cfg.num_layers - cfg.first_dense_layers
        want = (3 * moe_layers * cfg.num_experts_per_tok,
                3 * moe_layers * cfg.num_experts)
        assert eng.experts_read() == want
        eng.generate("s", prompt, steps=1)
        eng._mark_experts(False)  # server 1 off: the interval ends here
        assert eng.experts_read() == (want[0] + moe_layers
                                      * cfg.num_experts_per_tok,
                                      want[1] + moe_layers * cfg.num_experts)
    finally:
        eng.close()
