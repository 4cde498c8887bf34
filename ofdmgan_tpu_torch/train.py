"""CWGAN-GP training CLI of the port: ``python -m ofdmgan_tpu_torch.train``.

Counterpart of the repository's ``train.py`` for the mini model on the
synthetic AWGN (or ``--nonlinear``) task. Runs on the GPU unless
``--device cpu``. Without ``--config`` it uses the defaults of
``config/config.yaml``; with it, the YAML file (needs PyYAML).
"""

from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    p = argparse.ArgumentParser(description="Train the mini CWGAN-GP (PyTorch/CUDA port)")
    p.add_argument("--config", default=None, help="reference-format YAML config")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None, help="learning rate of both nets")
    p.add_argument("--n_critic", type=int, default=None)
    p.add_argument("--adv_weight", type=float, default=None)
    p.add_argument("--samples_per_epoch", type=int, default=None)
    p.add_argument("--val_samples", type=int, default=1000)
    p.add_argument("--residual", action="store_true", help="input-residual generator head")
    p.add_argument("--nonlinear", action="store_true", help="PA + IQ + phase-noise impairments")
    p.add_argument("--pa_saturation", type=float, default=0.8)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--log_dir", default=None)
    p.add_argument("--experiment", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--nan_policy", choices=["restore_best", "raise", "ignore"],
                   default="restore_best")
    args = p.parse_args(argv)

    from .config import Config, load_config
    from .models import count_parameters
    from .training.trainer import Trainer

    cfg = load_config(args.config) if args.config else Config()
    tr = cfg.training
    tr = dataclasses.replace(tr, **{k: v for k, v in dict(
        epochs=args.epochs, batch_size=args.batch_size, n_critic=args.n_critic,
        adversarial_weight=args.adv_weight,
        lr_generator=args.lr, lr_discriminator=args.lr).items() if v is not None})
    cfg = dataclasses.replace(cfg, training=tr, **{k: v for k, v in dict(
        checkpoint_dir=args.checkpoint_dir, log_dir=args.log_dir).items() if v is not None})
    if args.residual:
        cfg = dataclasses.replace(
            cfg, generator=dataclasses.replace(cfg.generator, input_residual=True))

    trainer = Trainer(cfg, nonlinear=args.nonlinear, pa_saturation=args.pa_saturation,
                      samples_per_epoch=args.samples_per_epoch, val_samples=args.val_samples,
                      seed=args.seed, device=args.device)
    trainer.nan_policy = args.nan_policy
    print(f"Generator parameters: {count_parameters(trainer.generator):,}")
    print(f"Discriminator parameters: {count_parameters(trainer.critic):,}")
    trainer.train(experiment_name=args.experiment)


if __name__ == "__main__":
    main()
