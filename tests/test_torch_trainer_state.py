"""Full-state checkpoints, resume, warm start, the EMA, the profiling hook,
the logged keys and the CLI of the port's trainer, on the CPU.

Resume and warm start are held to the reference's contract
(ofdmgan_tpu/training/trainer.py:517-601): a resumed trainer takes exactly
the uninterrupted trainer's step on the same draws (both on the CPU, so
bit for bit); a warm start keeps only parameters, with fresh Adam states at
schedule position 0. The EMA is held to the reference's formula
(trainer.py:450-455: once per chunk, decay ** scan_steps, on the
chunk-boundary parameters) in float64, atol 1e-6. The
JSONL keys are held against a JAX ``Trainer`` run.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from ofdmgan_tpu.training.trainer import Trainer as JTrainer
from ofdmgan_tpu_torch import train as train_cli
from ofdmgan_tpu_torch.config import Config, TrainingSection
from ofdmgan_tpu_torch.signal.datagen import make_draws, synthetic_batch_from_draws
from ofdmgan_tpu_torch.training.trainer import TRAIN_LOG_KEYS, Trainer
from ofdmgan_tpu_torch.utils.params_io import load_params_tree, save_params_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _config(tmp_path, **training):
    return Config(training=TrainingSection(batch_size=16, **training),
                  checkpoint_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "logs"),
                  export_dir=str(tmp_path / "export"))


def _trainer(tmp_path, seed=0, **kw):
    return Trainer(_config(tmp_path, checkpoint_interval=1, scheduler_step=1),
                   samples_per_epoch=48, val_samples=32, device="cpu", seed=seed, **kw)


def _params(trainer):
    return {**{f"g.{k}": v.clone() for k, v in trainer.generator.state_dict().items()},
            **{f"d.{k}": v.clone() for k, v in trainer.critic.state_dict().items()}}


def _one_step(trainer, seed=5):
    """One outer step from fixed draws; returns the update of every tensor."""
    gen = torch.Generator().manual_seed(seed)
    batch = synthetic_batch_from_draws(make_draws(gen, 16, 16), trainer.dg_cfg)
    alphas = [torch.rand(16, generator=gen) for _ in range(trainer.loss_cfg.n_critic)]
    before = _params(trainer)
    trainer.step.run(batch, alphas)
    after = _params(trainer)
    return {k: after[k] - before[k] for k in before}


def _adam_state(opt):
    return [{k: v.clone() for k, v in s.items()} for s in opt.opt.state.values()]


def test_checkpoint_layout_and_round_trip(tmp_path):
    t = _trainer(tmp_path, ema_decay=0.9)
    t.train(epochs=2, experiment_name="a")
    ckpt = tmp_path / "ckpt"
    for name in ("checkpoint_epoch_1", "checkpoint_epoch_2", "final_model"):
        assert {p.name for p in (ckpt / name).iterdir()} == {
            "params_g.npz", "params_d.npz", "ema_params_g.npz", "optimizer.pt",
            "trainer_state.json"}
    assert (ckpt / "best_model" / "trainer_state.json").exists()
    side = json.loads((ckpt / "checkpoint_epoch_2" / "trainer_state.json").read_text())
    assert set(side) == {"epoch", "global_step", "best_val_loss", "config"}
    assert (side["epoch"], side["global_step"]) == (1, 6)
    assert side["config"]["training"]["batch_size"] == 16

    r = _trainer(tmp_path, seed=9, ema_decay=0.9)
    r.load_checkpoint(ckpt / "checkpoint_epoch_2")
    assert (r.current_epoch, r.global_step, r.best_val_loss) == (1, 6, t.best_val_loss)
    for k, v in _params(t).items():
        assert torch.equal(_params(r)[k], v), k
    for a, b in zip(r.ema_generator.parameters(), t.ema_generator.parameters()):
        assert torch.equal(a, b)
    for mine, theirs in ((r.opt_g, t.opt_g), (r.opt_d, t.opt_d)):
        assert mine.sched.last_epoch == theirs.sched.last_epoch > 0
        assert mine.opt.param_groups[0]["lr"] == theirs.opt.param_groups[0]["lr"]
        for s_mine, s_theirs in zip(_adam_state(mine), _adam_state(theirs)):
            for k in s_theirs:
                assert torch.equal(s_mine[k], s_theirs[k]), k
            assert s_mine["step"].device.type == "cpu"


def test_resumed_step_equals_the_uninterrupted_step(tmp_path):
    t = _trainer(tmp_path)
    t.train(epochs=2, experiment_name="a")
    r = _trainer(tmp_path, seed=3)
    r.load_checkpoint(tmp_path / "ckpt" / "final_model")
    want, got = _one_step(t), _one_step(r)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert any(float(v.abs().max()) > 0 for v in want.values())


def test_resume_without_a_saved_ema_seeds_it_from_the_generator(tmp_path):
    _trainer(tmp_path).train(epochs=1, experiment_name="a")
    r = _trainer(tmp_path, seed=3, ema_decay=0.99)
    r.load_checkpoint(tmp_path / "ckpt" / "final_model")
    for a, b in zip(r.ema_generator.parameters(), r.generator.parameters()):
        assert torch.equal(a, b)


def test_init_from_a_directory_keeps_only_the_parameters(tmp_path):
    t = _trainer(tmp_path)
    t.train(epochs=2, experiment_name="a")
    w = _trainer(tmp_path, seed=3, ema_decay=0.9)
    w.init_params_from(tmp_path / "ckpt" / "checkpoint_epoch_2")
    for k, v in _params(t).items():
        assert torch.equal(_params(w)[k], v), k
    for a, b in zip(w.ema_generator.parameters(), w.generator.parameters()):
        assert torch.equal(a, b)
    tr = w.config.training
    for opt, lr in ((w.opt_g, tr.lr_generator), (w.opt_d, tr.lr_discriminator)):
        assert opt.sched.last_epoch == 0 and opt.opt.state == {}
        assert opt.opt.param_groups[0]["lr"] == lr
    assert w.current_epoch == 0 and w.step.opt_g is w.opt_g and w.step.opt_d is w.opt_d
    _one_step(w)
    assert w.opt_g.sched.last_epoch == 1


def test_init_from_a_generator_npz_keeps_the_critic(tmp_path):
    t = _trainer(tmp_path)
    t.train(epochs=1, experiment_name="a")
    w = _trainer(tmp_path, seed=3)
    critic0 = {k: v.clone() for k, v in w.critic.state_dict().items()}
    _one_step(w)   # a used optimizer, to be replaced
    critic1 = {k: v.clone() for k, v in w.critic.state_dict().items()}
    w.init_generator_params(load_params_tree(str(tmp_path / "ckpt" / "final_params_g.npz")))
    for k, v in t.generator.state_dict().items():
        assert torch.equal(w.generator.state_dict()[k], v)
    for k, v in w.critic.state_dict().items():
        assert torch.equal(v, critic1[k])
    assert not torch.equal(critic1["conv1.weight"], critic0["conv1.weight"])
    assert w.opt_g.opt.state == {} and w.opt_d.opt.state == {}
    assert w.opt_g.sched.last_epoch == 0 and w.opt_d.sched.last_epoch == 0


def test_ema_follows_the_reference_formula(tmp_path):
    decay = 0.8
    t = _trainer(tmp_path, ema_decay=decay)
    snapshots = []
    real = t.step.run

    def run(*args, **kwargs):
        m = real(*args, **kwargs)
        snapshots.append([p.detach().double().clone() for p in t.generator.parameters()])
        return m

    t.step.run = run
    ema = [p.detach().double().clone() for p in t.generator.parameters()]
    t.train_epoch()
    assert len(snapshots) == t.steps_per_epoch == t.scan_steps == 3
    d = decay ** t.scan_steps   # one chunk
    ema = [d * e + (1.0 - d) * p for e, p in zip(ema, snapshots[-1])]
    for got, want in zip(t.ema_generator.parameters(), ema):
        np.testing.assert_allclose(got.detach().double().numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_ema_validation_is_paired_and_tracks_the_best(tmp_path):
    t = _trainer(tmp_path, ema_decay=0.5)
    vm = t.validate()   # the EMA still equals the generator: same batches, same numbers
    assert set(vm) == {"rec_loss", "mse", "rec_loss_ema", "mse_ema"}
    assert vm["rec_loss_ema"] == vm["rec_loss"] and vm["mse_ema"] == vm["mse"]
    history = t.train(epochs=2, experiment_name="a")
    best = min(min(h["val/rec_loss"], h["val/rec_loss_ema"]) for h in history)
    assert t.best_val_loss == pytest.approx(best, rel=1e-12)


def test_profile_steps_writes_a_chrome_trace(tmp_path):
    t = _trainer(tmp_path)
    out = Path(t.profile_steps(1, str(tmp_path / "prof")))
    trace = json.loads((out / "trace.json").read_text())
    assert trace["traceEvents"]


def test_logged_keys_are_the_jax_trainers(tmp_path):
    """The JSONL lines of one epoch: the reference's train/{d_loss, g_loss,
    wasserstein, rec_loss, gp} and val/{rec_loss, mse}, with and without the
    EMA's val/{rec_loss_ema, mse_ema}."""
    def keys(path):
        lines = [json.loads(x) for x in path.read_text().splitlines()]
        return [set(x) for x in lines]

    for ema in (0.0, 0.9):
        cfg = {"training": {"batch_size": 16, "epochs": 1},
               "paths": {"checkpoint_dir": str(tmp_path / f"j{ema}"),
                         "log_dir": str(tmp_path / "jl")},
               "logging": {"tensorboard": False}}
        JTrainer(cfg, samples_per_epoch=32, val_samples=16, ema_decay=ema,
                 data_parallel=1).train(experiment_name=f"j{ema}", export_after=False)
        t = Trainer(_config(tmp_path), samples_per_epoch=32, val_samples=16, device="cpu",
                    ema_decay=ema)
        t.train(epochs=1, experiment_name=f"t{ema}")
        assert keys(tmp_path / "logs" / f"t{ema}" / "metrics.jsonl") == \
            keys(tmp_path / "jl" / f"j{ema}" / "metrics.jsonl")
    assert set(TRAIN_LOG_KEYS) == {"d_loss", "g_loss", "wasserstein", "rec_loss", "gp"}


def test_cli_flags_set_the_config():
    args = train_cli.build_parser().parse_args([
        "--channel", "rician", "--frame_length", "32", "--lr", "3e-4", "--lr_d", "1e-4",
        "--rec_weight", "50", "--lr_step", "7", "--lr_gamma", "0.25", "--n_critic", "2",
        "--ema", "0.99", "--profile", "2", "--image_dir", "imgs", "--image_chunks"])
    cfg = train_cli.config_from_args(args)
    tr = cfg.training
    assert (cfg.channel_type, cfg.frame_length) == ("rician", 32)
    assert (tr.lr_generator, tr.lr_discriminator, tr.reconstruction_weight,
            tr.scheduler_step, tr.scheduler_gamma, tr.n_critic) == (3e-4, 1e-4, 50.0, 7, 0.25, 2)
    assert (args.ema, args.profile, args.image_dir, args.image_chunks) == (0.99, 2, "imgs", True)
    lr_only = train_cli.config_from_args(train_cli.build_parser().parse_args(["--lr", "3e-4"]))
    assert lr_only.training.lr_discriminator == 3e-4
    assert train_cli.config_from_args(train_cli.build_parser().parse_args([])) == Config()
    with pytest.raises(SystemExit):
        train_cli.build_parser().parse_args(["--channel", "awgn2"])


def _cli(tmp_path, *extra):
    train_cli.main(["--device", "cpu", "--batch_size", "16", "--samples_per_epoch", "32",
                    "--val_samples", "16", "--checkpoint_dir", str(tmp_path / "c"),
                    "--log_dir", str(tmp_path / "l"), "--export_dir", str(tmp_path / "e"),
                    *extra])


def test_cli_resume_init_from_ema_and_profile(tmp_path, capsys):
    _cli(tmp_path, "--epochs", "1", "--channel", "multipath", "--frame_length", "32",
         "--ema", "0.9", "--profile", "1", "--experiment", "first")
    out = capsys.readouterr().out
    assert "datagen plain | critic plain" in out and "EMA L1" in out
    assert (tmp_path / "l" / "profile" / "trace.json").exists()   # no run directory yet
    side = json.loads((tmp_path / "c" / "final_model" / "trainer_state.json").read_text())
    assert side["config"]["channel_type"] == "multipath"

    _cli(tmp_path, "--epochs", "2", "--resume", str(tmp_path / "c" / "final_model"),
         "--experiment", "resumed")
    out = capsys.readouterr().out
    assert "Resuming from" in out and "Epoch 0:" in out and "Epoch 1:" in out

    save_params_tree(str(tmp_path / "g.npz"),
                     load_params_tree(str(tmp_path / "c" / "final_params_g.npz")))
    for src in (str(tmp_path / "g.npz"), str(tmp_path / "c" / "best_model")):
        _cli(tmp_path, "--epochs", "1", "--init_from", src, "--experiment", "warm")
        out = capsys.readouterr().out
        assert "Warm-starting" in out and "Epoch 0:" in out
    history = [json.loads(x) for x in
               (tmp_path / "l" / "warm" / "metrics.jsonl").read_text().splitlines()]
    assert all(math.isfinite(v) for rec in history for v in rec.values())
