"""Run configuration with the defaults of ``config/config.yaml``.

Counterpart of ``ofdmgan_tpu/config.py:23-75``. The reference reads one YAML
file, ``config/config.yaml`` unless told otherwise; here the defaults of that
file are dataclasses, so a run needs no file and no PyYAML, and ``Config()``
equals that file. ``load_config(path)`` reads a YAML file with the
reference's keys and imports ``yaml`` only then; a key the file lacks takes
the reference's own default (``training_params_from`` and its siblings),
which for the training section differs from the YAML's value. The full
U-Net family's section ``model.full`` (levels, base_channels) is read where
the file has it; ``config/config.yaml`` has none, so the reference's
defaults of ``train.py:332-334`` hold (5 levels, 32 base channels).
``export_dir`` (``paths.export_dir``) is where a run writes its FPGA export
unless ``export_after_training`` (the reference's top-level key) is false.
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
class FullModelSection:
    """The full U-Net family (``--model full``)."""

    levels: int = 5
    base_channels: int = 32


FULL_FRAME_LENGTH = 1024   # --model full's frame length unless given (train.py:281-284)


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


# the reference's defaults for training keys a file lacks
# (ofdmgan_tpu/config.py:56-75); every other default equals the YAML's
MISSING_KEY_TRAINING = TrainingSection(batch_size=32, epochs=200, lr_generator=1e-4,
                                       lr_discriminator=1e-4, scheduler_step=50,
                                       checkpoint_interval=10)


@dataclasses.dataclass(frozen=True)
class Config:
    frame_length: int = 16
    modulation: str = "QPSK"          # the image datasets' OFDM codec
    num_subcarriers: int = 8
    cp_length: int = 2
    snr_range: Tuple[float, float] = (0.0, 30.0)
    channel_type: str = "awgn"
    generator: GeneratorSection = GeneratorSection()
    discriminator: DiscriminatorSection = DiscriminatorSection()
    full: FullModelSection = FullModelSection()
    training: TrainingSection = TrainingSection()
    checkpoint_dir: str = "./checkpoints"
    log_dir: str = "./logs"
    export_dir: str = "./export"
    export_after_training: bool = True
    samples_per_epoch: int = 10_000   # synthetic frames per epoch
    scan_steps: int = 0               # outer steps per dispatched chunk (0: the trainer's choice)


def config_from_dict(d: Dict[str, Any]) -> Config:
    """Build a ``Config`` from a dict with the reference YAML's nesting; a
    missing key takes the reference's default."""
    t = d.get("training", {})
    opt, loss, sched = t.get("optimizer", {}), t.get("loss", {}), t.get("scheduler", {})
    model = d.get("model", {})
    g, dc, full = model.get("generator", {}), model.get("discriminator", {}), model.get("full", {})
    base = Config()
    tr = MISSING_KEY_TRAINING
    ofdm = d.get("ofdm", {})
    return Config(
        frame_length=int(ofdm.get("frame_length", base.frame_length)),
        modulation=str(ofdm.get("modulation", base.modulation)),
        num_subcarriers=int(ofdm.get("num_subcarriers", base.num_subcarriers)),
        cp_length=int(ofdm.get("cp_length", base.cp_length)),
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
        full=FullModelSection(levels=int(full.get("levels", 5)),
                              base_channels=int(full.get("base_channels", 32))),
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
        export_dir=d.get("paths", {}).get("export_dir", base.export_dir),
        export_after_training=bool(d.get("export_after_training", True)),
        samples_per_epoch=int(d.get("tpu", {}).get("samples_per_epoch", base.samples_per_epoch)),
        scan_steps=int(d.get("tpu", {}).get("scan_steps", base.scan_steps)),
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
