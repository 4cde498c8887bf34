"""Scan chunks, the EMA per chunk, the device-side StepLR and the layout
flags of the port's trainer and CLI, on the CPU.

* The chunk size is the JAX ``Trainer``'s for every epoch length and
  request tried (``trainer.py:99-104``).
* An eager chunk of K steps is K single steps, bit for bit.
* The EMA after each chunk is JAX's ``_ema_update`` with decay ``ema ** K``
  applied to the chunk-boundary parameters, within 1e-6 (float32 against
  XLA's float32); the EMA the parent computed (decay ``ema`` after every
  step) lies more than 100 times that far from it.
* The device-side StepLR rate equals optax's staircase schedule at every
  update across two decay boundaries; an ``AdamStepLR`` that holds its
  schedule on the device takes the host schedule's steps (float32 rate,
  within 1e-7 of each parameter) and saves the host form.
* Every flag of the reference ``train.py`` parses, the layout flags reach
  the trainer, and the reference's refusals hold. ``conv_expand``,
  ``critic_unroll`` and ``prng``, which the port accepts and ignores, leave
  a flat epoch's parameters equal bit for bit.
"""

import ast
import copy
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ofdmgan_tpu.training.schedules import step_lr
from ofdmgan_tpu.training.trainer import Trainer as JTrainer
from ofdmgan_tpu_torch import train as train_cli
from ofdmgan_tpu_torch.config import Config, TrainingSection
from ofdmgan_tpu_torch.training.chunks import EagerChunk, chunk_size
from ofdmgan_tpu_torch.training.schedules import AdamStepLR, step_lr_rate
from ofdmgan_tpu_torch.training.trainer import Trainer
from ofdmgan_tpu_torch.utils.jax_params import to_jax_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
B = 16


def _config(tmp_path, **training):
    return Config(training=TrainingSection(batch_size=B, **training),
                  checkpoint_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "logs"),
                  export_dir=str(tmp_path / "export"), export_after_training=False)


def _jax_config(batch=B):
    return {"training": {"batch_size": batch, "epochs": 1}, "logging": {"tensorboard": False}}


@pytest.mark.parametrize("steps,requested", [(1, 0), (7, 0), (20, 0), (32, 0), (33, 0), (64, 0),
                                             (156, 0), (20, 6), (20, 40), (156, 50)])
def test_chunk_size_is_the_jax_trainers(steps, requested):
    jt = JTrainer(config=_jax_config(), samples_per_epoch=steps * B, scan_steps=requested,
                  data_parallel=1)
    assert chunk_size(steps, requested) == jt.scan_steps


def _trainer(tmp_path, steps=8, scan=4, **kw):
    return Trainer(_config(tmp_path), samples_per_epoch=steps * B, val_samples=B, device="cpu",
                   seed=3, scan_steps=scan, **kw)


def _params(module):
    return [p.detach().clone() for p in module.parameters()]


def test_an_eager_chunk_is_k_single_steps(tmp_path):
    t = _trainer(tmp_path)
    assert not t.graphed and isinstance(t.chunk, EagerChunk) and t.scan_steps == 4
    g, d = copy.deepcopy(t.generator), copy.deepcopy(t.critic)
    twin = _trainer(tmp_path)
    twin.generator.load_state_dict(g.state_dict())
    twin.critic.load_state_dict(d.state_dict())
    m = t.chunk()
    for _ in range(4):
        m_twin = twin.step(twin.rng)
    for a, b in zip(_params(t.generator) + _params(t.critic),
                    _params(twin.generator) + _params(twin.critic)):
        assert torch.equal(a, b)
    assert {k: float(v) for k, v in m.items()} == {k: float(v) for k, v in m_twin.items()}


@pytest.mark.parametrize("scan", [4, 1])
def test_the_ema_is_updated_once_per_chunk_with_decay_to_the_k(tmp_path, scan):
    """Against the JAX trainer's own ``_ema_update`` (the same scan_steps and
    decay); with K = 4 the parent's per-step EMA fails the bound."""
    decay, steps = 0.9, 8
    t = _trainer(tmp_path, steps=steps, scan=scan, ema_decay=decay)
    jt = JTrainer(config=_jax_config(), samples_per_epoch=steps * B, scan_steps=scan,
                  data_parallel=1, ema_decay=decay)
    assert jt.scan_steps == t.scan_steps == scan
    snaps = []
    real = t.step.run

    def run(*args):
        m = real(*args)
        snaps.append(to_jax_params(t.generator))
        return m

    t.step.run = run
    ema = parent = to_jax_params(t.ema_generator)
    t.train_epoch()
    assert len(snaps) == steps
    for i in range(scan - 1, steps, scan):   # the chunk ends
        ema = jax.tree_util.tree_map(np.asarray, jt._ema_update(ema, snaps[i]))
    got = to_jax_params(t.ema_generator)
    for p in snaps:   # the parent's EMA: decay after every step
        parent = jax.tree_util.tree_map(lambda e, q: decay * e + (1 - decay) * q, parent, p)
    err = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ema)))
    assert err <= 1e-6, err
    off = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree_util.tree_leaves(parent), jax.tree_util.tree_leaves(ema)))
    assert (off > 100 * 1e-6) == (scan > 1), off


def test_the_device_steplr_rate_is_optaxs_schedule():
    lr0, k, gamma = 2e-4, 7, 0.5
    counts = torch.arange(0, 3 * k + 2)
    got = step_lr_rate(counts, lr0, k, gamma)
    ref = np.asarray([step_lr(lr0, k, gamma)(int(n)) for n in counts])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.float32))


def test_a_schedule_held_on_the_device_takes_the_host_schedules_steps():
    torch.manual_seed(0)
    host_p, dev_p = torch.nn.Parameter(torch.randn(6)), None
    dev_p = torch.nn.Parameter(host_p.detach().clone())
    host = AdamStepLR([host_p], 2e-4, (0.0, 0.9), 3, 0.5)
    dev = AdamStepLR([dev_p], 2e-4, (0.0, 0.9), 3, 0.5)
    grads = torch.randn(10, 6)
    for i in range(10):   # three decay boundaries; the device mode from the third update
        if i == 2:
            dev.hold_on_device()
            assert dev.on_device and int(dev.count) == 2
        host_p.grad, dev_p.grad = grads[i].clone(), grads[i].clone()
        host.step()
        dev.step()
        torch.testing.assert_close(dev_p, host_p, rtol=0, atol=1e-7)
    (h_opt, h_sched), (d_opt, d_sched) = host.state_dict(), dev.state_dict()
    assert d_sched["last_epoch"] == h_sched["last_epoch"] == 10
    assert d_opt["param_groups"][0]["lr"] == pytest.approx(h_opt["param_groups"][0]["lr"])
    assert d_opt["param_groups"][0]["capturable"] is False
    again = AdamStepLR([torch.nn.Parameter(dev_p.detach().clone())], 2e-4, (0.0, 0.9), 3, 0.5)
    again.hold_on_device()
    again.load_state_dict(*copy.deepcopy(dev.state_dict()))
    assert again.on_device and int(again.count) == 10


# ------------------------------------------------------------------ the CLI
def _reference_flags():
    """(flag, argv sample) of every add_argument of the reference train.py."""
    tree = ast.parse((REPO / "train.py").read_text())
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"):
            continue
        flag = node.args[0].value
        kw = {k.arg: k.value for k in node.keywords}
        if "action" in kw and getattr(kw["action"], "value", None) == "store_true":
            yield flag, []
        elif "choices" in kw:
            yield flag, [ast.literal_eval(kw["choices"])[-1]]
        elif "nargs" in kw:
            yield flag, ["8", "16"]
        else:
            typ = getattr(kw.get("type"), "id", "str")
            yield flag, [{"int": "2", "float": "0.5"}.get(typ, "cpu")]


@pytest.mark.parametrize("flag,values", list(_reference_flags()))
def test_every_reference_flag_parses(flag, values):
    args = train_cli.build_parser().parse_args([flag, *values])
    assert getattr(args, flag.lstrip("-")) is not None


def test_layout_flags_reach_the_trainer(tmp_path):
    from ofdmgan_tpu_torch.training.trainer import build_models
    t = train_cli.main([
        "--platform", "cpu", "--flat", "--premap", "--mm", "tf32x3_gp", "--conv_expand", "onehot",
        "--scan_steps", "3", "--critic_unroll", "5", "--prng", "rbg", "--pallas_datagen",
        "--samples_per_epoch", "96", "--batch_size", "16", "--epochs", "1", "--val_samples", "16",
        "--skip_export", "--checkpoint_dir", str(tmp_path / "ck"), "--log_dir",
        str(tmp_path / "logs")])
    assert t.device.type == "cpu" and t.scan_steps == 3
    flat = t.step.flat
    assert flat is not None and flat.gen_premap is not None and flat.critic_apply_gp is not None
    assert (t.step.datagen_route, t.step.critic_route) == ("kernel", "plain")
    g0, _ = build_models(t.config, "mini", 0)
    assert any(not torch.equal(a, b) for a, b in zip(g0.parameters(), t.generator.parameters()))
    assert all(np.isfinite(v) for rec in t.history for v in rec.values())


@pytest.mark.parametrize("kw", [dict(conv_expand="onehot"), dict(critic_unroll=5),
                                dict(prng="rbg")])
def test_accepted_flags_change_nothing(tmp_path, kw):
    ends = []
    for i, extra in enumerate(({}, kw)):
        t = _trainer(tmp_path / str(i), flat_step=True, premap=True, **extra)
        t.train_epoch()
        ends.append(_params(t.generator) + _params(t.critic))
    assert all(torch.equal(a, b) for a, b in zip(*ends))


@pytest.mark.parametrize("argv,error", [
    (["--platform", "gpu", "--device", "cpu"], "conflicts"),
    (["--platform", "tpu"], "invalid choice"),
    (["--mm", "tf32x4"], "invalid choice"),
    (["--prng", "philox"], "invalid choice"),
    (["--conv_expand", "gather"], "invalid choice")])
def test_cli_refusals(argv, error, capsys):
    parser = train_cli.build_parser()
    with pytest.raises(SystemExit):
        train_cli.check_args(parser, parser.parse_args(argv))
    assert error in capsys.readouterr().err


def test_platform_gpu_is_the_card():
    parser = train_cli.build_parser()
    args = parser.parse_args(["--platform", "gpu"])
    train_cli.check_args(parser, args)
    assert args.device == "cuda"


@pytest.mark.parametrize("kw,match", [
    (dict(mm="tf32x3"), "mm requires flat_step"),
    (dict(premap=True), "premap requires flat_step"),
    (dict(flat_step=True, model="qat"), "standard mini model family"),
    (dict(flat_step=True, model="full"), "standard mini model family"),
    (dict(flat_step=True, strategy="gspmd"), "does not support flat_step"),
    (dict(flat_step=True, strategy="pp"), "does not support flat_step"),
    (dict(critic_unroll=5, strategy="gspmd"), "does not support critic_unroll"),
    (dict(use_pallas_datagen=True, channel="rayleigh"), "pallas datagen kernel covers"),
    (dict(use_pallas_datagen=True, strategy="pp"), "does not support use_pallas_datagen"),
    (dict(critic_unroll=0), "critic_unroll"),
    (dict(prng="philox"), "prng must be one of"),
    (dict(conv_expand="gather"), "conv_expand must be one of")])
def test_trainer_refusals(tmp_path, kw, match):
    from ofdmgan_tpu_torch.training.trainer import build_models
    kw = dict(kw)
    model, channel = kw.pop("model", None), kw.pop("channel", "awgn")
    cfg = Config(channel_type=channel, training=TrainingSection(batch_size=B),
                 frame_length=64 if model == "full" else 16, export_after_training=False)
    if model:
        g, d = build_models(cfg, "full" if model == "full" else "mini", 0, qat=model == "qat")
        kw.update(generator=g, discriminator=d)
    with pytest.raises(ValueError, match=match):
        Trainer(cfg, samples_per_epoch=32, val_samples=B, device="cpu", **kw)
