"""The plain references against the port's plain path on the CPU, at a
small size of each configuration file: the same weights (drawn by the
benchmark), the same tokens, logits within fp32 rounding.  This test may
import the port; the references may not."""

import pytest
import torch

import small
from harness import spec as S
from harness import weights as W

CONFIGS = ("internlm2-1.8b", "deepseek-v2-lite-16b")


def _conf(name):
    return small.small_conf(S.read_json(S.BENCH / "configs" / f"{name}.json"))


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("seed", [0, 2**31 + 7])
def test_reference_matches_port_forward(name, seed):
    from repro_torch.models import model as M

    conf = _conf(name)
    cfg = small.port_cfg(conf)
    params = W.make(cfg, seed, torch.device("cpu"))
    gen = torch.Generator().manual_seed(seed % 1000)
    tokens = torch.randint(0, conf["vocab_size"], (2, 37), generator=gen)
    with torch.no_grad():
        want, _, _ = M.apply(cfg, params, {"tokens": tokens}, mode="train")
    ref = S.load_module("reference", conf["reference"])
    got = ref.logits(conf, params, list(tokens), [3, 0])
    for row, start, g in zip(want, (3, 0), got):
        assert g.shape == (37 - start, conf["vocab_size"])
        torch.testing.assert_close(g, row[start:].float(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_sees_every_layer(name):
    """Changing one weight of the last layer changes the reference's
    logits: no layer is skipped."""
    conf = _conf(name)
    cfg = small.port_cfg(conf)
    params = W.make(cfg, 5, torch.device("cpu"))
    ref = S.load_module("reference", conf["reference"])
    seq = [torch.arange(9) % conf["vocab_size"]]
    before = ref.logits(conf, params, seq, [0])[0]
    params["layers"]["attn"]["wo"][-1].mul_(2.0)
    after = ref.logits(conf, params, seq, [0])[0]
    assert (after - before).abs().max() > 1e-3


@pytest.mark.parametrize("change", [
    {"rope_scaling": {"type": "yarn", "factor": 40, "mscale": 0.707,
                      "mscale_all_dim": 0.707}},
    {"kv_a_layernorm": True},
])
def test_mla_reference_refuses_what_it_does_not_compute(change):
    """The served file's YaRN group at factor 1 is plain rotary; at the
    published factor 40, or with the latent's norm, the reference
    refuses rather than computing plain rotary under that name."""
    conf = _conf("deepseek-v2-lite-16b")
    assert conf["rope_scaling"]["factor"] == 1
    conf.update(change)
    cfg = small.port_cfg(conf)
    params = W.make(cfg, 3, torch.device("cpu"))
    ref = S.load_module("reference", conf["reference"])
    with pytest.raises(NotImplementedError):
        ref.logits(conf, params, [torch.arange(5)], [0])


def test_reference_sets_tf32_off_and_restores():
    from reference import plain as P

    torch.backends.cuda.matmul.allow_tf32 = True
    with P.fp32_exact():
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
