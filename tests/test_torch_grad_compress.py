"""The port's int8 gradient compression (repro_torch.training.
grad_compress) on one process: twins of ``tests/test_training.py``'s
``TestGradCompress`` (quantize bounds, error feedback), the quantizer
against the reference's on the same inputs, and the refusal past 257
shards.  The all-reduce across ranks is in ``tests/test_torch_distributed.py``
(4 gloo ranks against the scheme in numpy)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import grad_compress as jgc
from repro_torch.training import grad_compress as gc


class _Mesh:
    shape = {"pod": 16, "data": 17}


def test_quantize_bounds():
    x = torch.from_numpy(np.random.RandomState(0).randn(128, 64)
                         .astype(np.float32))
    q, s = gc.quantize_int8(x)
    assert q.dtype == torch.int8
    err = (gc.dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) / 2 + 1e-7


def test_error_feedback_accumulates():
    """With error feedback, the running sum of dequantized values tracks
    the true running sum (bias-free compression)."""
    rs = np.random.RandomState(1)
    g_true = torch.from_numpy(rs.randn(256).astype(np.float32) * 1e-3)
    err = torch.zeros_like(g_true)
    total_q = torch.zeros(256)
    for _ in range(50):
        corrected = g_true + err
        q, s = gc.quantize_int8(corrected)
        deq = gc.dequantize_int8(q, s)
        err = corrected - deq
        total_q += deq
    np.testing.assert_allclose(total_q.numpy(), g_true.numpy() * 50,
                               atol=2 * float(s))


@pytest.mark.parametrize("scale", [1e-6, 1.0, 3e4])
def test_quantize_equals_the_reference(scale):
    x = np.random.RandomState(2).randn(33, 17).astype(np.float32) * scale
    q, s = gc.quantize_int8(torch.from_numpy(x))
    jq, js = jgc.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(gc.dequantize_int8(q, s).numpy(),
                                  np.asarray(jgc.dequantize_int8(jq, js)))


def test_error_state_and_the_shard_limit():
    grads = {"a": torch.ones(3, 4, dtype=torch.bfloat16), "b": [torch.ones(2)]}
    err = gc.init_error_state(grads)
    assert err["a"].dtype == torch.float32 and not err["a"].any()
    assert tuple(err["b"][0].shape) == (2,)
    with pytest.raises(ValueError, match="257 shards"):
        gc.compressed_psum_mean(grads, err, _Mesh(), ("pod", "data"))
