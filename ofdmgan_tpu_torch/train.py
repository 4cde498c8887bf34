"""CWGAN-GP training CLI of the port: ``python -m ofdmgan_tpu_torch.train``.

Counterpart of the repository's ``train.py`` for the mini model, with its
flags and meanings: any channel (``--channel``), frame length
(``--frame_length``), the nonlinear impairments (``--nonlinear``), image
data (``--image_dir``, ``--image_chunks``), resume (``--resume``), warm start
(``--init_from``: a checkpoint directory, or a generator ``.npz``), an EMA
of the generator (``--ema``) and a profiler trace (``--profile N``). Runs on
the GPU unless ``--device cpu``. Without ``--config`` it uses the defaults
of ``config/config.yaml``; with it, the YAML file (needs PyYAML).
"""

from __future__ import annotations

import argparse
import dataclasses


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the mini CWGAN-GP (PyTorch/CUDA port)")
    p.add_argument("--config", default=None, help="reference-format YAML config")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None, help="learning rate of both nets")
    p.add_argument("--lr_d", type=float, default=None,
                   help="critic learning rate (after --lr)")
    p.add_argument("--n_critic", type=int, default=None)
    p.add_argument("--adv_weight", type=float, default=None)
    p.add_argument("--rec_weight", type=float, default=None, help="L1 reconstruction weight")
    p.add_argument("--lr_step", type=int, default=None, help="StepLR interval in epochs")
    p.add_argument("--lr_gamma", type=float, default=None, help="StepLR decay factor")
    p.add_argument("--channel", default=None, choices=["awgn", "rayleigh", "rician", "multipath"],
                   help="training channel (default: the config's channel_type)")
    p.add_argument("--frame_length", type=int, default=None, help="samples per frame")
    p.add_argument("--samples_per_epoch", type=int, default=None)
    p.add_argument("--val_samples", type=int, default=1000)
    p.add_argument("--residual", action="store_true", help="input-residual generator head")
    p.add_argument("--nonlinear", action="store_true", help="PA + IQ + phase-noise impairments")
    p.add_argument("--pa_saturation", type=float, default=0.8)
    p.add_argument("--image_dir", default=None,
                   help="train on image-derived OFDM frames from this directory")
    p.add_argument("--image_chunks", action="store_true",
                   help="with --image_dir: every aligned chunk of the whole transmissions, "
                        "normalised by the noisy chunk's maximum")
    p.add_argument("--resume", default=None, help="checkpoint directory to resume from")
    p.add_argument("--init_from", default=None,
                   help="warm start with fresh optimizers: a checkpoint directory (both "
                        "nets) or a generator .npz (the generator alone)")
    p.add_argument("--ema", type=float, default=0.0, metavar="DECAY",
                   help="keep an EMA of the generator with this decay per step (0: off)")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="trace N outer steps with torch.profiler before training")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--log_dir", default=None)
    p.add_argument("--experiment", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--nan_policy", choices=["restore_best", "raise", "ignore"],
                   default="restore_best")
    return p


def config_from_args(args):
    """The run's ``Config``: the file or the defaults, then the flags."""
    from .config import Config, load_config

    cfg = load_config(args.config) if args.config else Config()
    tr = cfg.training
    lr_d = args.lr_d if args.lr_d is not None else args.lr
    tr = dataclasses.replace(tr, **{k: v for k, v in dict(
        epochs=args.epochs, batch_size=args.batch_size, n_critic=args.n_critic,
        adversarial_weight=args.adv_weight, reconstruction_weight=args.rec_weight,
        scheduler_step=args.lr_step, scheduler_gamma=args.lr_gamma,
        lr_generator=args.lr, lr_discriminator=lr_d).items() if v is not None})
    cfg = dataclasses.replace(cfg, training=tr, **{k: v for k, v in dict(
        checkpoint_dir=args.checkpoint_dir, log_dir=args.log_dir, channel_type=args.channel,
        frame_length=args.frame_length).items() if v is not None})
    if args.residual:
        cfg = dataclasses.replace(
            cfg, generator=dataclasses.replace(cfg.generator, input_residual=True))
    return cfg


def main(argv=None):
    args = build_parser().parse_args(argv)

    from .models import count_parameters
    from .training.trainer import Trainer
    from .utils.params_io import load_params_tree

    trainer = Trainer(config_from_args(args), nonlinear=args.nonlinear,
                      pa_saturation=args.pa_saturation,
                      samples_per_epoch=args.samples_per_epoch, val_samples=args.val_samples,
                      seed=args.seed, device=args.device, ema_decay=args.ema,
                      image_dir=args.image_dir, image_chunks=args.image_chunks)
    trainer.nan_policy = args.nan_policy
    print(f"Generator parameters: {count_parameters(trainer.generator):,}")
    print(f"Discriminator parameters: {count_parameters(trainer.critic):,}")
    if args.resume:
        print(f"Resuming from {args.resume}")
        trainer.load_checkpoint(args.resume)
    elif args.init_from:
        if args.init_from.endswith(".npz"):
            print(f"Warm-starting the generator from {args.init_from} (fresh optimizers)")
            trainer.init_generator_params(load_params_tree(args.init_from))
        else:
            print(f"Warm-starting both nets from {args.init_from} (fresh optimizers)")
            trainer.init_params_from(args.init_from)
    if args.profile:
        print(f"Profiler trace written to {trainer.profile_steps(args.profile)}")
    trainer.train(experiment_name=args.experiment)


if __name__ == "__main__":
    main()
