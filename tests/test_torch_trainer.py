"""The port's ``Trainer`` and CLI on the CPU, held to the JAX package through
the champions they save: a champion written by the port loads in the JAX
package and gives the port's forward there (atol 1e-5)."""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdmgan_tpu.models import MiniGenerator as JGen
from ofdmgan_tpu.utils.params_io import load_params_tree as j_load
from ofdmgan_tpu_torch import train as train_cli
from ofdmgan_tpu_torch.config import Config, TrainingSection
from ofdmgan_tpu_torch.training.trainer import Trainer
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _config(tmp_path, **training):
    return Config(training=TrainingSection(batch_size=32, **training),
                  checkpoint_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "logs"))


@pytest.mark.parametrize("kernels", [False, True])
def test_two_epochs_log_and_save_a_jax_loadable_champion(tmp_path, kernels):
    trainer = Trainer(_config(tmp_path, checkpoint_interval=1), samples_per_epoch=96,
                      val_samples=64, device="cpu")
    trainer.step.reference = not kernels  # False: the kernel-free reference step
    assert trainer.steps_per_epoch == 3 and trainer.val_batches == 2
    history = trainer.train(epochs=2, experiment_name="run")
    assert len(history) == 2
    assert all(math.isfinite(v) for rec in history for v in rec.values())
    assert trainer.global_step == 6
    lines = (tmp_path / "logs" / "run" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 4 and "train/d_loss" in json.loads(lines[0])
    ckpt = tmp_path / "ckpt"
    assert {p.name for p in ckpt.iterdir()} >= {"champion_params_g.npz", "final_params_g.npz",
                                                "params_g_epoch_1.npz", "params_g_epoch_2.npz"}
    x = np.random.default_rng(0).standard_normal((16, 16, 2)).astype(np.float32)
    with torch.no_grad():
        got = trainer.generator(torch.from_numpy(x)).numpy()
    ref = JGen().apply(j_load(str(ckpt / "final_params_g.npz")), jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=1e-5)

    fresh = Trainer(_config(tmp_path), device="cpu", seed=5)
    fresh.load_champion(ckpt / "final_params_g.npz")
    for a, b in zip(fresh.generator.parameters(), trainer.generator.parameters()):
        assert torch.equal(a, b)


def _poison(trainer, after):
    """Make every step after the first ``after`` report a NaN loss."""
    real = trainer.step
    calls = []

    def step(rng):
        calls.append(1)
        m = real(rng)
        if len(calls) > after:
            m = {**m, "d_loss": torch.tensor(float("nan"))}
        return m

    trainer.step = step


def test_nan_policy_raise(tmp_path):
    trainer = Trainer(_config(tmp_path), samples_per_epoch=32, val_samples=32, device="cpu")
    trainer.nan_policy = "raise"
    _poison(trainer, 0)
    with pytest.raises(FloatingPointError):
        trainer.train(epochs=2)


def test_nan_policy_restore_best_stops_on_the_best_parameters(tmp_path):
    trainer = Trainer(_config(tmp_path), samples_per_epoch=32, val_samples=32, device="cpu")
    _poison(trainer, 1)
    history = trainer.train(epochs=3)
    assert len(history) == 1 and trainer.current_epoch == 1
    best = trainer._best_state["generator"]
    for k, v in trainer.generator.state_dict().items():
        assert torch.equal(v, best[k])


def test_cli_runs_on_the_cpu(tmp_path, capsys):
    train_cli.main(["--device", "cpu", "--epochs", "1", "--batch_size", "16",
                    "--samples_per_epoch", "32", "--val_samples", "16", "--residual",
                    "--checkpoint_dir", str(tmp_path / "c"), "--log_dir", str(tmp_path / "l"),
                    "--experiment", "cli"])
    out = capsys.readouterr().out
    assert "Generator parameters: 258" in out and "Epoch 0:" in out
    assert (tmp_path / "c" / "final_params_g.npz").exists()
