"""The ``perf`` flag sites of the port against the reference's, under every
``perf.VARIANTS`` entry (``use_flags`` in both packages):

* ``split_ssm_proj``: ``init_mamba2`` builds ``z_proj`` / ``xbc_proj`` /
  ``dt_proj`` instead of ``in_proj`` -- the parameter key sets and shapes
  equal the reference's, natively and through the weight bridge;
* ``ssd_chunk``: the intra-chunk length of train and prefill, and
  ``mamba2_block(chunk=)``;
* ``cache_update``: the reference's dense-cache write, "where" (the
  whole-cache select) or "scatter"; the port scatters under either.

On reduced internlm2, mamba2, zamba2 and deepseek (fp32, bridged weights),
train, padded prefill, prefill and two dense decode steps give logits
within TOL of the reference's.  The SSM stacks' prompts are 128 tokens,
so chunks of 128 and 64 differ (256 is cut to 128).  Variants that set
the same model flags (the rest lay out a mesh, which the unsharded model
does not read) share one run.  "where" and "scatter" leave bit-identical
caches and logits in the port, also through rows that repeat a slot (the
masked-dense engine's padding rows duplicate row 0).

TOL is 1e-4 (rtol, and atol of the largest |logit|, floored at 1e-4), the
bar of the port's model tests (``tests/test_torch_ssm.py``,
``tests/test_torch_hybrid.py``) scaled to the logits: both sides compute
in fp32, but every matmul, reduction and cumulative sum runs in its own
order, and at 128 tokens through the hybrid stack the gap reaches 1.6e-4
on logits of 4.1.  The reference's functions are jitted with the flags set
while they trace, one jit per set of flags.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import model as JM
from repro.models import perf as jperf
from repro.models import ssm as JS
from repro_torch.configs.registry import get_config
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import perf as tperf
from repro_torch.models import ssm as TS
from repro_torch.params import params_from_numpy

TOL = 1e-4
ARCHS = ("internlm2_1_8b", "mamba2_780m", "zamba2_7b", "deepseek_v2_lite_16b")
# prompt lengths: 128 on the SSM stacks, so that chunks of 128 and 64
# differ (256 is cut to 128); 16 on the attention stacks
SEQ = {"mamba2_780m": 128, "zamba2_7b": 128}
BATCH = 2


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tests run many small torch ops, and a
    worker thread per core in each of several test processes at once spin
    against each other and starve the other tests on the host (the JAX
    package's 0.3 s heartbeat tests among them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch):
    return tuple(dataclasses.replace(get(arch).reduced(), dtype="float32")
                 for get in (jax_config, get_config))


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return {p for k, v in tree.items() for p in _paths(v, (*prefix, k))}
    if isinstance(tree, (list, tuple)):
        return {p for i, v in enumerate(tree)
                for p in _paths(v, (*prefix, str(i)))}
    return {("/".join(prefix), tuple(tree.shape))}


def _tokens(seed, *shape):
    return np.random.default_rng(seed).integers(0, 128, shape, dtype=np.int32)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL,
                               atol=TOL * max(1.0, float(np.abs(want).max())))


def _model_flags(arch, variant):
    """The flags a variant sets that the unsharded model reads: the cache
    write, and on the SSM stacks the split projections and the chunk."""
    f = tperf.VARIANTS[variant]
    ssm = arch in SEQ
    return (f.cache_update, ssm and f.split_ssm_proj, f.ssd_chunk if ssm else 0)


@functools.lru_cache(maxsize=None)
def _forward(arch, model_flags):
    """(param paths of the reference, of the bridged and of the native
    port params; the reference's and the port's logits of each call) under
    the variants that set ``model_flags``."""
    jcfg, tcfg = _configs(arch)
    cache_update, split, chunk = model_flags
    flags = dict(cache_update=cache_update, split_ssm_proj=split,
                 ssd_chunk=chunk or 256)
    jflags, tflags = jperf.PerfFlags(**flags), tperf.PerfFlags(**flags)
    seq = SEQ.get(arch, 16)
    max_seq = seq + 8
    toks = _tokens(1, BATCH, seq)
    lengths = np.array([seq, seq - 28 if seq > 32 else seq - 5], np.int32)
    steps = [_tokens(10 + i, BATCH, 1) for i in range(2)]

    def jit(fn, **static):
        def traced(*args):
            with jperf.use_flags(jflags):
                return fn(*args)
        return jax.jit(traced, **static)

    with jperf.use_flags(jflags):
        jp = jit(lambda k: JM.init_params(jcfg, k))(jax.random.PRNGKey(0))
    train = jit(lambda p, t: JM.apply(jcfg, p, {"tokens": t}, mode="train")[0])
    padded = jit(lambda p, t, n: JM.apply(
        jcfg, p, {"tokens": t, "max_seq": max_seq, "lengths": n},
        mode="prefill")[0])
    prefill = jit(lambda p, t: JM.apply(
        jcfg, p, {"tokens": t, "max_seq": max_seq}, mode="prefill")[:2])
    decode = jit(lambda p, t, c: JM.apply(jcfg, p, {"tokens": t},
                                          mode="decode", cache=c)[:2])
    want = [train(jp, toks), padded(jp, toks, lengths)]
    jl, jc = prefill(jp, toks)
    want.append(jl)
    for t in steps:
        jl, jc = decode(jp, t, jc)
        want.append(jl)

    with tperf.use_flags(tflags), torch.inference_mode():
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        native = TM.init_params(
            tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
        tt = torch.from_numpy(toks)
        got = [TM.apply(tcfg, tp, {"tokens": tt}, mode="train")[0],
               TM.apply(tcfg, tp, {"tokens": tt, "max_seq": max_seq,
                                   "lengths": torch.from_numpy(lengths)},
                        mode="prefill")[0]]
        tl, tc, _ = TM.apply(tcfg, tp, {"tokens": tt, "max_seq": max_seq},
                             mode="prefill")
        got.append(tl)
        for t in steps:
            tl, tc, _ = TM.apply(tcfg, tp, {"tokens": torch.from_numpy(t)},
                                 mode="decode", cache=tc)
            got.append(tl)
    return ((_paths(jax.tree.map(np.asarray, jp)), _paths(tp), _paths(native)),
            [np.asarray(w) for w in want], [g.numpy() for g in got])


def test_variants_are_the_references():
    assert tperf.VARIANTS == {k: tperf.PerfFlags(**dataclasses.asdict(v))
                              for k, v in jperf.VARIANTS.items()}


@pytest.mark.parametrize("variant", sorted(tperf.VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_under_variant(arch, variant):
    """Train, padded prefill, exact prefill and two dense decode steps;
    variants that set the same model flags share one run."""
    (want, bridged, native), jl, tl = _forward(arch, _model_flags(arch,
                                                                  variant))
    assert bridged == want and native == want
    split = tperf.VARIANTS[variant].split_ssm_proj and arch in SEQ
    assert any("xbc_proj" in p for p, _ in want) == split
    assert any("in_proj" in p for p, _ in want) == (arch in SEQ and not split)
    for got, ref in zip(tl, jl, strict=True):
        _close(got, ref)


def _decode_run(tcfg, tp, variant, toks, steps=3):
    with tperf.use_flags(tperf.VARIANTS[variant]), torch.inference_mode():
        logits, cache, _ = TM.apply(tcfg, tp, {"tokens": toks,
                                               "max_seq": 48},
                                    mode="prefill")
        out = [logits]
        for step in range(steps):
            nxt = torch.from_numpy(_tokens(20 + step, toks.shape[0], 1))
            logits, cache, _ = TM.apply(tcfg, tp, {"tokens": nxt},
                                        mode="decode", cache=cache)
            out.append(logits)
    return out, jax.tree.leaves(cache, is_leaf=torch.is_tensor)


@pytest.mark.parametrize("arch", ARCHS)
def test_where_and_scatter_are_bit_identical(arch):
    _, tcfg = _configs(arch)
    tp = TM.init_params(tcfg, generator=torch.Generator().manual_seed(3),
                        device="cpu")
    toks = torch.from_numpy(_tokens(4, 3, 40))
    (lw, cw), (ls, cs) = (_decode_run(tcfg, tp, v, toks)
                          for v in ("baseline", "opt_cache"))
    assert all(torch.equal(a, b) for a, b in zip(lw, ls))
    assert len(cw) == len(cs) and all(torch.equal(a, b)
                                      for a, b in zip(cw, cs))


@pytest.mark.parametrize("shape", [(5, 12, 2, 4), (4, 9, 3)])
def test_write_token_with_repeated_slots(shape):
    """Rows 3 and 4 repeat slot 0's (slot, position, value), as the
    masked-dense engine's padding rows do; a slot no row names keeps its
    bits."""
    g = torch.Generator().manual_seed(5)
    cache = torch.randn(shape, generator=g)
    rows = torch.tensor([0, 1, 3, 0, 0])
    pos = torch.tensor([7, 0, shape[1] - 1, 7, 7])
    val = torch.randn((5, *shape[2:]), generator=g)
    val[3:] = val[0]
    got = {}
    for variant in ("baseline", "opt_cache"):
        c = cache.clone()
        with tperf.use_flags(tperf.VARIANTS[variant]):
            TL.write_token(c, rows, pos, val)
        got[variant] = c
    assert torch.equal(got["baseline"], got["opt_cache"])
    want = cache.clone()
    want[rows, pos] = val
    assert torch.equal(got["baseline"], want)
    assert torch.equal(got["baseline"][2], cache[2])


@pytest.mark.parametrize("split", [(1, 1), (2, 1), (1, 3), (2, 3)])
def test_write_token_into_blocks(split):
    """``_write_local`` -- the write into one rank's block of a cache
    sharded over slots and positions -- writes, block by block, what one
    scatter into the whole cache writes, with repeated slots and
    positions that fall in another block."""
    g = torch.Generator().manual_seed(6)
    cache = torch.randn((4, 12, 2, 3), generator=g)
    rows = torch.tensor([0, 1, 3, 0, 0])
    pos = torch.tensor([7, 0, 11, 7, 7])
    val = torch.randn((5, 2, 3), generator=g)
    val[3:] = val[0]
    want = cache.clone()
    want[rows, pos] = val
    got = cache.clone()
    n0, n1 = 4 // split[0], 12 // split[1]
    for i in range(split[0]):
        for j in range(split[1]):
            block = got[i * n0:(i + 1) * n0, j * n1:(j + 1) * n1]
            TL._write_local(block, i * n0, j * n1, 4, rows, pos, val)
    assert torch.equal(got, want)


@pytest.mark.parametrize("chunk", [None, 128, 64, 32])
def test_mamba2_block_chunk(chunk):
    jcfg, tcfg = _configs("mamba2_780m")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jl0 = jax.tree.map(lambda a: a[0], jp["layers"]["mamba"])
    tl0 = {k: v[0] for k, v in params_from_numpy(
        jax.tree.map(np.asarray, jp), device="cpu")["layers"]["mamba"].items()}
    x = np.random.default_rng(6).standard_normal(
        (2, 128, jcfg.d_model)).astype(np.float32)
    jo, _ = JS.mamba2_block(jcfg, jl0, jnp.asarray(x), chunk=chunk)
    with torch.inference_mode():
        to, _ = TS.mamba2_block(tcfg, tl0, torch.from_numpy(x), chunk=chunk)
    _close(to, jo)
    assert TS._chunk(128, chunk) == min(chunk or 256, 128)
