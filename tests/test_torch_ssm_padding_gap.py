"""The SSM path's padded-vs-exact prefill gap, in the port and in JAX,
arbitrated by a float64 evaluation.

The batched engine prefills a prompt padded to its length bucket (with its
true length); unbatched ``generate`` prefills it at its exact length.  The
first decode step reads the logits at the prompt's last position.  Here,
on reduced mamba2-780m in fp32 with the same (bridged) weights on both
sides, the gap between the two is taken in the port and in JAX, and each
of the four logit rows is held against the reference model evaluated in
float64 (its fp32 casts widened, as ``test_cumsum_order_float64_arbiter``
widens ``ref.ssd_intra_ref``).  The prompts cover one chunk of 5 to 200
tokens and one of 300 tokens padded to 512: two chunks of 256 padded, 75
chunks of 4 at the exact length (the model's chunk rule).

What it shows on the CPU: both gaps are fp32 noise (at most ~3.5e-7; the
port's is 0 at 40, 100 and 200 tokens), and every row lies within ~2e-6 of
float64, the port's distance within 1.5x of JAX's, closer at some prompts
and further at others -- so neither side is off, 20x below the 1e-4 logit
bar.  The bounds below leave room for other thread counts' summation
orders.
"""

import dataclasses
import unittest.mock as um

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch.configs.registry import get_config
from repro_torch.models import model as TM
from repro_torch.params import params_from_numpy

PROMPTS = [(5, 8), (40, 64), (100, 128), (200, 256), (300, 512)]  # (len, bucket)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_config("mamba2_780m").reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("mamba2_780m").reduced(),
                               dtype="float32")
    jp = jax.jit(JM.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(0))
    npp = jax.tree.map(np.asarray, jp)
    return jcfg, tcfg, jp, npp, params_from_numpy(npp, device="cpu")


class _Float64Numpy:  # jax.numpy whose float32 is float64
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _float64_logits(jcfg, npp, tokens):
    """The reference model in float64: weights widened, every module's
    ``jnp.float32`` read as float64, the config's dtype float64."""
    wide = _Float64Numpy()
    with jax.enable_x64(True), um.patch.object(JS, "jnp", wide), \
            um.patch.object(JL, "jnp", wide), um.patch.object(JT, "jnp", wide), \
            um.patch.object(JM, "jnp", wide):
        cfg = dataclasses.replace(jcfg, dtype="float64")
        params = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                              npp)
        logits, _, _ = JM.apply(cfg, params, {"tokens": jnp.asarray(tokens)},
                                mode="prefill")
        out = np.asarray(logits[0, -1])
    assert out.dtype == np.float64
    return out


@pytest.mark.parametrize("n,bucket", PROMPTS)
def test_padded_vs_exact_gap_against_float64(setup, n, bucket):
    jcfg, tcfg, jp, npp, tp = setup
    prompt = np.random.default_rng(n).integers(0, jcfg.vocab_size, (1, n),
                                               dtype=np.int32)
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :n] = prompt[0]
    lengths = np.array([n], np.int32)

    with torch.inference_mode():
        lp, _, _ = TM.apply(tcfg, tp, {"tokens": torch.from_numpy(padded),
                                       "lengths": torch.from_numpy(lengths)},
                            mode="prefill")
        le, _, _ = TM.apply(tcfg, tp, {"tokens": torch.from_numpy(prompt)},
                            mode="prefill")
    port = (lp[0, n - 1].double().numpy(), le[0, -1].double().numpy())
    japply = jax.jit(JM.apply, static_argnums=0, static_argnames="mode")
    jl_p, _, _ = japply(jcfg, jp, {"tokens": jnp.asarray(padded),
                                   "lengths": jnp.asarray(lengths)},
                        mode="prefill")
    jl_e, _, _ = japply(jcfg, jp, {"tokens": jnp.asarray(prompt)},
                        mode="prefill")
    ref = (np.asarray(jl_p[0, n - 1], np.float64),
           np.asarray(jl_e[0, -1], np.float64))
    exact = _float64_logits(jcfg, npp, prompt)

    def gap(a, b):
        return float(np.abs(a - b).max())

    port_gap, jax_gap = gap(*port), gap(*ref)
    assert port_gap <= 1e-6 and jax_gap <= 1e-6
    port_err = max(gap(row, exact) for row in port)
    jax_err = max(gap(row, exact) for row in ref)
    assert port_err <= 5e-6 and jax_err <= 5e-6
    assert port_err <= 2 * jax_err + 2e-7
