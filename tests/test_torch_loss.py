"""The port's loss (repro_torch.models.model.cross_entropy / loss_fn)
against repro.models.model's on the same inputs and weights.

* ``cross_entropy``: value and logits gradient, with masked labels (< 0)
  and with ``z_loss``, within 1e-6 relative (both in fp32).
* ``input_specs``: the reference's stand-ins' shapes and dtypes, as
  meta-device tensors, for every family and shape kind.
* ``loss_fn``: value within 1e-5 relative and every gradient leaf within
  1e-4 of the leaf's max |.| against ``jax.value_and_grad(loss_fn)``, on one
  reduced config per family in fp32 -- internlm2 (dense GQA),
  deepseek-v2-lite (MLA + MoE, with the router's aux loss), mamba2 (SSM),
  zamba2 (hybrid), whisper (enc-dec, with frames) and qwen2-vl (embedding
  inputs and M-RoPE positions).  The port's gradients come through its
  autograd Functions (flash attention and rmsnorm take their plain
  backward on the CPU) and the plain versions of the other kernels; both
  sides sum in their own orders, and the differences grow through the
  layers, hence 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import model as JM
from repro_torch.configs.registry import get_config
from repro_torch.models import model as TM
from repro_torch.params import params_from_numpy
from repro_torch.training.train_step import value_and_grad
from repro_torch.training.tree import leaves

FAMILIES = ["internlm2_1_8b", "deepseek_v2_lite_16b", "mamba2_780m",
            "zamba2_7b", "whisper_medium", "qwen2_vl_2b"]


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_cross_entropy_against_jax(z_loss):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 7, 33)) * 3).astype(np.float32)
    labels = rng.integers(0, 33, (2, 7)).astype(np.int32)
    labels[0, :3] = -1  # masked
    labels[1, 5] = -100

    def jloss(x):
        return JM.cross_entropy(x, jnp.asarray(labels), z_loss=z_loss)

    want, jgrad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = TM.cross_entropy(x, torch.from_numpy(labels), z_loss=z_loss)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-7)


def test_cross_entropy_all_masked_is_zero():
    labels = torch.full((1, 4), -1, dtype=torch.int32)
    assert TM.cross_entropy(torch.randn(1, 4, 5), labels).item() == 0.0


def _batch(cfg, seed, b=2, s=12):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)}
    batch["labels"][0, -2:] = -1
    if cfg.family == "vlm":
        batch["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (3, b, s)).copy()
        pos[1] //= 2  # distinct (t, h, w) streams
        pos[2] %= 5
        batch["mrope_positions"] = pos
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_fn_value_and_grads_against_jax(arch):
    jcfg = dataclasses.replace(jax_config(arch).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    batch = _batch(tcfg, 2)

    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, {k: jnp.asarray(v) for k, v in
                                       batch.items()}, remat=False),
        has_aux=True)(jp)
    (tloss, tmetrics), tgrads = value_and_grad(
        lambda p, b: TM.loss_fn(tcfg, p, b, remat=False), tp,
        {k: torch.from_numpy(v) for k, v in batch.items()})

    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(tmetrics["aux"].item(), float(jmetrics["aux"]),
                               rtol=1e-5, atol=1e-7)
    if tcfg.is_moe:
        assert tmetrics["aux"].item() > 0
    jl, tl = jax.tree_util.tree_leaves(jgrads), leaves(tgrads)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        j = np.asarray(j, np.float32)
        assert tuple(t.shape) == j.shape
        err = np.abs(t.float().numpy() - j).max()
        assert err <= 1e-4 * max(np.abs(j).max(), 1e-12), (arch, t.shape, err)


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_against_jax(arch, shape):
    from repro.configs.registry import SHAPES as JSHAPES
    from repro_torch.configs.registry import SHAPES

    want = JM.input_specs(jax_config(arch), JSHAPES[shape])
    got = TM.input_specs(get_config(arch), SHAPES[shape])
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == want[k].shape
        assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype)
