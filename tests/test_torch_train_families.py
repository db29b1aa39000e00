"""Training of the SSM, hybrid, MLA + MoE and enc-dec families on the CPU
through the port's entry points (the card's counterpart is phase 10 of
``chip_smoke.py``; the gradients' parity with JAX is
``tests/test_torch_loss.py``).

* ``repro_torch.launch.train.main`` runs two steps of reduced mamba2-780m,
  zamba2-7b and deepseek-v2-lite-16b with finite losses, as it does for
  internlm2 (``tests/test_torch_training.py``).
* The reference's launcher feeds ``SyntheticLM`` tokens only, so whisper
  trains through ``training.train_step.build_train_step`` with a batch
  that holds ``frames`` (B, T_enc, D): two steps with finite losses, the
  frames read (other frames give another loss), and the update reaches
  the encoder's weights.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.launch import train as TL
from repro_torch.models import model as M
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import (TrainSettings, build_train_step,
                                             make_loss)


@pytest.mark.parametrize("arch", ["mamba2_780m", "zamba2_7b",
                                  "deepseek_v2_lite_16b"])
def test_launcher_trains_the_family_on_the_cpu(arch):
    out = TL.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps",
                   "2", "--global-batch", "2", "--seq-len", "32",
                   "--log-every", "1"])
    assert len(out["losses"]) == 2
    assert all(math.isfinite(x) for x in out["losses"])
    assert out["first_loss"] == out["losses"][0]


def _whisper_batch(cfg, seed, bsz=2, s=12):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (bsz, s + 1), dtype=np.int32)
    frames = rng.standard_normal((bsz, cfg.encoder_seq, cfg.d_model))
    return {"tokens": torch.from_numpy(tokens[:, :-1]),
            "labels": torch.from_numpy(tokens[:, 1:]),
            "frames": torch.from_numpy(frames.astype(np.float32))}


def test_build_train_step_takes_whisper_frames():
    cfg = dataclasses.replace(get_config("whisper_medium").reduced(),
                              dtype="float32")
    settings = TrainSettings(adamw=opt.AdamWConfig(warmup_steps=1))
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    enc_before = {k: v.clone() for k, v in params["encoder"]["attn"].items()}
    state = opt.init(params, settings.adamw)
    step = build_train_step(cfg, settings)
    batch = _whisper_batch(cfg, 0)
    loss_fn = make_loss(cfg, settings)
    with torch.no_grad():
        l0, _ = loss_fn(params, batch)
        other = dict(batch, frames=batch["frames"] + 1.0)
        l1, _ = loss_fn(params, other)
    assert float(l0) != float(l1)  # the loss reads the frames
    losses = []
    for i in range(2):
        params, state, metrics = step(params, state, _whisper_batch(cfg, i))
        losses.append(float(metrics["loss"]))
    assert all(math.isfinite(x) for x in losses)
    assert losses[0] == pytest.approx(float(l0), rel=1e-5)
    for k, w in params["encoder"]["attn"].items():
        assert not torch.equal(w, enc_before[k]), k
