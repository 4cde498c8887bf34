"""Run configuration with the defaults of ``config/config.yaml``.

Counterpart of ``ofdmgan_tpu/config.py:23-56``. The reference reads one YAML
file; here the defaults of that file are dataclasses, so a run needs no file
and no PyYAML. ``load_config(path)`` reads a YAML file with the reference's
keys and imports ``yaml`` only then.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from .signal.channel import ChannelConfig
from .signal.datagen import DatagenConfig
from .signal.impairments import ImpairmentConfig
from .training.wgan_gp import LossConfig


@dataclasses.dataclass(frozen=True)
class GeneratorSection:
    enc1_channels: int = 4
    bottleneck_channels: int = 8
    dec1_channels: int = 4
    leaky_slope: float = 0.2
    input_residual: bool = False


@dataclasses.dataclass(frozen=True)
class DiscriminatorSection:
    conv1_channels: int = 8
    conv2_channels: int = 16
    leaky_slope: float = 0.2


@dataclasses.dataclass(frozen=True)
class TrainingSection:
    batch_size: int = 64
    epochs: int = 500
    lr_generator: float = 2e-4
    lr_discriminator: float = 2e-4
    betas: Tuple[float, float] = (0.0, 0.9)
    n_critic: int = 5
    gp_weight: float = 10.0
    adversarial_weight: float = 1.0
    reconstruction_weight: float = 100.0
    scheduler_step: int = 100     # epochs per StepLR decay
    scheduler_gamma: float = 0.5
    checkpoint_interval: int = 50
    save_best: bool = True


@dataclasses.dataclass(frozen=True)
class Config:
    frame_length: int = 16
    snr_range: Tuple[float, float] = (0.0, 30.0)
    channel_type: str = "awgn"
    generator: GeneratorSection = GeneratorSection()
    discriminator: DiscriminatorSection = DiscriminatorSection()
    training: TrainingSection = TrainingSection()
    checkpoint_dir: str = "./checkpoints"
    log_dir: str = "./logs"
    samples_per_epoch: int = 10_000   # synthetic frames per epoch


def config_from_dict(d: Dict[str, Any]) -> Config:
    """Build a ``Config`` from a dict with the reference YAML's nesting;
    missing keys keep the defaults."""
    t = d.get("training", {})
    opt, loss, sched = t.get("optimizer", {}), t.get("loss", {}), t.get("scheduler", {})
    model = d.get("model", {})
    g, dc = model.get("generator", {}), model.get("discriminator", {})
    base = Config()
    tr = base.training
    return Config(
        frame_length=int(d.get("ofdm", {}).get("frame_length", base.frame_length)),
        snr_range=tuple(float(v) for v in d.get("channel", {}).get("snr_range", base.snr_range)),
        channel_type=str(d.get("channel", {}).get("channel_type", base.channel_type)).lower(),
        generator=GeneratorSection(
            enc1_channels=int(g.get("enc1_channels", 4)),
            bottleneck_channels=int(g.get("bottleneck_channels", 8)),
            dec1_channels=int(g.get("dec1_channels", 4)),
            leaky_slope=float(g.get("leaky_slope", 0.2)),
            input_residual=bool(g.get("input_residual", False)),
        ),
        discriminator=DiscriminatorSection(
            conv1_channels=int(dc.get("conv1_channels", 8)),
            conv2_channels=int(dc.get("conv2_channels", 16)),
            leaky_slope=float(dc.get("leaky_slope", 0.2)),
        ),
        training=TrainingSection(
            batch_size=int(t.get("batch_size", tr.batch_size)),
            epochs=int(t.get("epochs", tr.epochs)),
            lr_generator=float(opt.get("lr_generator", tr.lr_generator)),
            lr_discriminator=float(opt.get("lr_discriminator", tr.lr_discriminator)),
            betas=tuple(float(b) for b in opt.get("betas", tr.betas)),
            n_critic=int(t.get("n_critic", tr.n_critic)),
            gp_weight=float(t.get("gp_weight", tr.gp_weight)),
            adversarial_weight=float(loss.get("adversarial_weight", tr.adversarial_weight)),
            reconstruction_weight=float(loss.get("reconstruction_weight", tr.reconstruction_weight)),
            scheduler_step=int(sched.get("step_size", tr.scheduler_step)),
            scheduler_gamma=float(sched.get("gamma", tr.scheduler_gamma)),
            checkpoint_interval=int(t.get("checkpoint_interval", tr.checkpoint_interval)),
            save_best=bool(t.get("save_best", tr.save_best)),
        ),
        checkpoint_dir=d.get("paths", {}).get("checkpoint_dir", base.checkpoint_dir),
        log_dir=d.get("paths", {}).get("log_dir", base.log_dir),
        samples_per_epoch=int(d.get("tpu", {}).get("samples_per_epoch", base.samples_per_epoch)),
    )


def load_config(path: str) -> Config:
    """Read a YAML file with the reference's keys (needs PyYAML)."""
    import yaml

    with open(path) as f:
        return config_from_dict(yaml.safe_load(f) or {})


def datagen_config_from(cfg: Config, nonlinear: bool = False,
                        pa_saturation: float = 0.8) -> DatagenConfig:
    return DatagenConfig(
        frame_length=cfg.frame_length,
        snr_min=float(cfg.snr_range[0]),
        snr_max=float(cfg.snr_range[1]),
        channel=ChannelConfig(kind=cfg.channel_type),
        nonlinear=nonlinear,
        impairments=ImpairmentConfig(pa_saturation=pa_saturation),
    )


def loss_config_from(cfg: Config) -> LossConfig:
    t = cfg.training
    return LossConfig(n_critic=t.n_critic, gp_weight=t.gp_weight,
                      adv_weight=t.adversarial_weight,
                      rec_weight=t.reconstruction_weight)
