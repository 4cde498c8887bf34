"""``--remat``, ``--debug_nans`` and ``--synthetic`` of the port's trainer.

``remat`` recomputes the step's model applies in the backward
(``torch.utils.checkpoint``, non-reentrant, through the penalty's double
backward): a step with it takes the same update as one without it, within
1e-6 of each tensor's largest update, on the datagen and critic kernel
routes' plain versions and on the reference routes (the generator update
on autograd's route on both sides: a remat step never takes the generator
kernel, which keeps no activations to recompute), for the mini pair and a reduced full
pair (L = 32, two levels, base 4); and it matches JAX's remat step
(``make_train_step(..., remat=True)``) at the tolerances of
``tests/test_torch_train_step.py``. ``debug_nans`` stops at a NaN;
``--synthetic`` is accepted as the default data source.
"""

import copy

import numpy as np
import pytest
import torch

from ofdmgan_tpu.models import MiniDiscriminator as JCritic
from ofdmgan_tpu.models import MiniGenerator as JGen
from ofdmgan_tpu.signal import DatagenConfig as JDatagenConfig
from ofdmgan_tpu.training import make_adam as j_make_adam
from ofdmgan_tpu.training import make_train_step
from ofdmgan_tpu.training.wgan_gp import LossConfig as JLossConfig
from ofdmgan_tpu_torch import train as train_cli
from ofdmgan_tpu_torch.config import Config
from ofdmgan_tpu_torch.models import MiniDiscriminator, MiniGenerator
from ofdmgan_tpu_torch.models.critic import compute_gradient_penalty
from ofdmgan_tpu_torch.models.full_unet import FullDiscriminator, FullUNetGenerator
from ofdmgan_tpu_torch.signal.datagen import DatagenConfig, make_draws, synthetic_batch_from_draws
from ofdmgan_tpu_torch.training.schedules import make_adam
from ofdmgan_tpu_torch.training.trainer import Trainer
from ofdmgan_tpu_torch.training.wgan_gp import LossConfig, TrainStep
from test_torch_train_step import B, DECAY_G, LR, Pair
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _step(family, L, remat, reference, precision="float32"):
    torch.manual_seed(3)
    if family == "full":
        g = FullUNetGenerator(frame_length=L, levels=2, base_channels=4)
        d = FullDiscriminator(frame_length=L, levels=2, base_channels=4)
    else:
        g, d = MiniGenerator(), MiniDiscriminator()
    return TrainStep(g, d, make_adam(g.parameters(), LR), make_adam(d.parameters(), LR),
                     DatagenConfig(frame_length=L), LossConfig(), 8, reference=reference,
                     matmul_precision=precision, remat=remat)


@pytest.mark.parametrize("family,L,reference,precision", [
    ("mini", 16, False, "float32"),
    ("mini", 16, True, "float32"),
    ("mini", 16, True, "bfloat16"),
    ("mini", 16, True, "bf16_f32gp"),
    ("full", 32, False, "float32"),
])
def test_a_remat_step_takes_the_same_update(family, L, reference, precision):
    steps = [_step(family, L, remat, reference, precision) for remat in (False, True)]
    assert steps[1].generator_route == steps[1].forward_route == "plain"
    # the recomputation is compared on autograd's route and the module's forward
    steps[0].generator_route = steps[0].forward_route = "plain"
    start = [p.detach().clone() for m in (steps[0].generator, steps[0].critic)
             for p in m.parameters()]
    # one warm-up step from the same draws first: Adam's first step is a sign
    for seed in (0, 1):
        gen = torch.Generator().manual_seed(seed)
        batch = synthetic_batch_from_draws(make_draws(gen, 8, L), DatagenConfig(frame_length=L))
        alphas = [torch.rand(8, generator=gen) for _ in range(5)]
        metrics = [s.run(batch, alphas) for s in steps]
    params = [[p.detach() for m in (s.generator, s.critic) for p in m.parameters()]
              for s in steps]
    scales = []
    for p0, plain, remat in zip(start, *params):
        scales.append(float((plain - p0).abs().max()))   # 0 for the critic's output bias
        assert float((remat - plain).abs().max()) <= 1e-6 * scales[-1]
    assert sum(s > 0 for s in scales) >= len(scales) - 1
    for k, v in metrics[0].items():
        np.testing.assert_allclose(float(metrics[1][k]), float(v), rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_remat_survives_the_penalty_double_backward():
    """The critic loss through checkpointed applies has a second-order
    gradient: the penalty's parameter gradient is not zero and equals the
    one without recomputation."""
    step = _step("mini", 16, True, True)
    gen = torch.Generator().manual_seed(5)
    batch = synthetic_batch_from_draws(make_draws(gen, 8, 16), step.dg_cfg)
    assert step.critic_apply() is not step.critic
    noisy, clean = batch["noisy"], batch["clean"]
    alpha = torch.rand(8, generator=gen)
    weights = [step.critic.conv1.weight, step.critic.conv2.weight]   # the biases' are 0
    grads = [torch.autograd.grad(compute_gradient_penalty(c, clean, noisy, noisy, alpha),
                                 weights) for c in (step.critic_apply(), step.critic)]
    for a, b in zip(*grads):
        assert float(a.abs().max()) > 0
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_a_remat_step_matches_the_jax_remat_step():
    p = Pair(n_critic=5)
    jdg = JDatagenConfig.make(frame_length=16, snr_range=(0, 30))
    tx_g = j_make_adam(LR, (0.0, 0.9), DECAY_G, 0.5)
    tx_d = j_make_adam(LR, (0.0, 0.9), DECAY_G * 5, 0.5)
    p.jstep = make_train_step(JGen().apply, JCritic().apply, tx_g, tx_d, jdg,
                              JLossConfig(n_critic=5), batch_size=B, donate=False, remat=True)
    p.tstep.remat = True
    p.jax_steps(3)
    p.load_jax_state()
    jm, tm = p.step(3)
    p.assert_params_close(2e-6)
    for name, ref in jm.items():
        np.testing.assert_allclose(float(tm[name]), float(ref), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def _trainer(tmp_path, **kw):
    cfg = Config(checkpoint_dir=str(tmp_path / "c"), log_dir=str(tmp_path / "l"),
                 export_after_training=False)
    return Trainer(cfg, samples_per_epoch=2 * cfg.training.batch_size, val_samples=64,
                   device="cpu", **kw)


def test_debug_nans_stops_at_the_first_nan(tmp_path):
    trainer = _trainer(tmp_path, debug_nans=True)
    clean = copy.deepcopy(trainer.generator.state_dict())
    trainer.train_epoch()   # finite: no stop
    trainer.generator.load_state_dict(clean)
    with torch.no_grad():
        trainer.generator.enc1.weight[0, 0, 0] = float("nan")
    with pytest.raises((FloatingPointError, RuntimeError), match="nan|non-finite"):
        trainer.train_epoch()


def test_without_debug_nans_a_nan_step_runs_on(tmp_path):
    trainer = _trainer(tmp_path)
    with torch.no_grad():
        trainer.generator.enc1.weight[0, 0, 0] = float("nan")
    metrics = trainer.train_epoch()
    assert not np.isfinite(metrics["g_loss"])


def test_cli_takes_synthetic_remat_and_debug_nans(tmp_path, capsys):
    trainer = train_cli.main(["--device", "cpu", "--synthetic", "--remat", "--debug_nans",
                              "--epochs", "1", "--samples_per_epoch", "128",
                              "--val_samples", "64", "--skip_export",
                              "--checkpoint_dir", str(tmp_path / "c"),
                              "--log_dir", str(tmp_path / "l")])
    assert trainer.step.remat and trainer.debug_nans
    assert trainer.step.datagen_route == "kernel" and trainer.global_step == 2
    assert "Epoch 0" in capsys.readouterr().out
