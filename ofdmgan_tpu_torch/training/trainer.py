"""The minimal trainer: epochs, validation, the NaN policy, JSONL metrics and
``.npz`` generator champions.

Counterpart of ``ofdmgan_tpu/training/trainer.py:52-674``. An epoch is
``samples_per_epoch // batch_size`` outer steps. Champions are saved in the
JAX package's ``.npz`` format (flax layout, ``/``-joined keys), so either
package can load them. Not ported yet: Orbax-style resume, EMA,
``init_from``, image datasets, data/pipeline parallelism, profiling and the
post-training FPGA export.
"""

from __future__ import annotations

import copy
import math
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from ..config import Config, datagen_config_from, loss_config_from
from ..device import resolve_device
from ..models import MiniDiscriminator, MiniGenerator
from ..utils.jax_params import from_jax_params, to_jax_params
from ..utils.logging import MetricsLogger
from ..utils.params_io import load_params_tree, save_params_tree
from .schedules import make_adam
from .wgan_gp import TrainStep, make_eval_step

NAN_POLICIES = ("restore_best", "raise", "ignore")


class Trainer:
    def __init__(self, config: Optional[Config] = None, nonlinear: bool = False,
                 pa_saturation: float = 0.8, samples_per_epoch: Optional[int] = None,
                 val_samples: int = 1_000, seed: int = 0,
                 device: str | torch.device | None = None):
        """Runs on the GPU unless ``device`` says otherwise (``"cpu"``)."""
        self.device = resolve_device(device)
        self.config = config or Config()
        tr = self.config.training
        self.dg_cfg = datagen_config_from(self.config, nonlinear, pa_saturation)
        self.loss_cfg = loss_config_from(self.config)
        self.batch_size = tr.batch_size
        spe = samples_per_epoch or self.config.samples_per_epoch
        self.steps_per_epoch = max(1, spe // self.batch_size)
        self.val_batches = max(1, val_samples // self.batch_size)

        g, d = self.config.generator, self.config.discriminator
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.generator = MiniGenerator(
                enc1_channels=g.enc1_channels, bottleneck_channels=g.bottleneck_channels,
                dec1_channels=g.dec1_channels, leaky_slope=g.leaky_slope,
                input_residual=g.input_residual).to(self.device)
            self.critic = MiniDiscriminator(
                conv1_channels=d.conv1_channels, conv2_channels=d.conv2_channels,
                leaky_slope=d.leaky_slope).to(self.device)

        # StepLR in optimizer updates: G updates once per step, D n_critic times
        decay_g = tr.scheduler_step * self.steps_per_epoch
        decay_d = decay_g * max(self.loss_cfg.n_critic, 1)
        self.opt_g = make_adam(self.generator.parameters(), tr.lr_generator, tr.betas,
                               decay_g, tr.scheduler_gamma)
        self.opt_d = make_adam(self.critic.parameters(), tr.lr_discriminator, tr.betas,
                               decay_d, tr.scheduler_gamma)
        self.step = TrainStep(self.generator, self.critic, self.opt_g, self.opt_d,
                              self.dg_cfg, self.loss_cfg, self.batch_size)
        self._eval = make_eval_step(self.generator, self.dg_cfg, self.batch_size)
        self.rng = torch.Generator(device=self.device)
        self.rng.manual_seed(seed + 1)

        self.nan_policy = "restore_best"
        self.current_epoch = 0
        self.global_step = 0
        self.best_val_loss = math.inf
        self._best_state: Optional[Dict[str, dict]] = None

    def train_epoch(self) -> Dict[str, float]:
        """Run one epoch; the last step's metrics, read once at the end."""
        metrics: Dict[str, torch.Tensor] = {}
        for _ in range(self.steps_per_epoch):
            metrics = self.step(self.rng)
        self.global_step += self.steps_per_epoch
        return {k: float(v) for k, v in metrics.items()}

    def validate(self) -> Dict[str, float]:
        totals = {"rec_loss": 0.0, "mse": 0.0}
        for _ in range(self.val_batches):
            m = self._eval(self.rng)
            for k in totals:
                totals[k] += float(m[k])
        return {k: v / self.val_batches for k, v in totals.items()}

    def save_champion(self, path: str | Path) -> None:
        """The generator as a JAX-format ``.npz`` champion."""
        save_params_tree(str(path), to_jax_params(self.generator.state_dict()))

    def load_champion(self, path: str | Path) -> None:
        sd = from_jax_params(load_params_tree(str(path)))
        self.generator.load_state_dict({k: v.to(self.device) for k, v in sd.items()})

    def train(self, epochs: Optional[int] = None,
              experiment_name: Optional[str] = None) -> List[Dict[str, float]]:
        """Train and return one record of train and val metrics per epoch."""
        if self.nan_policy not in NAN_POLICIES:
            raise ValueError(f"nan_policy must be one of {NAN_POLICIES}")
        tr = self.config.training
        epochs = epochs or tr.epochs
        logger = MetricsLogger(self.config.log_dir, experiment_name)
        ckpt_dir = Path(self.config.checkpoint_dir)
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        history: List[Dict[str, float]] = []
        print(f"Training for {epochs} epochs | batch {self.batch_size} | "
              f"{self.steps_per_epoch} steps/epoch | n_critic {self.loss_cfg.n_critic} | "
              f"gp {self.loss_cfg.gp_weight} | rec {self.loss_cfg.rec_weight} | "
              f"device {self.device}", flush=True)
        t0 = time.time()
        try:
            for epoch in range(self.current_epoch, epochs):
                self.current_epoch = epoch
                tm = self.train_epoch()
                if not all(math.isfinite(v) for v in tm.values()):
                    msg = f"non-finite training metrics at epoch {epoch}: {tm}"
                    if self.nan_policy == "raise":
                        raise FloatingPointError(msg)
                    print(f"FAILURE DETECTED: {msg}", flush=True)
                    if self.nan_policy == "restore_best":
                        if self._best_state is not None:
                            self.generator.load_state_dict(self._best_state["generator"])
                            self.critic.load_state_dict(self._best_state["critic"])
                            print("Restored the best parameters; stopping.", flush=True)
                        else:
                            print("No best parameters yet; stopping.", flush=True)
                        break
                vm = self.validate()
                logger.log_scalars("train", tm, self.global_step)
                logger.log_scalars("val", vm, epoch)
                history.append({**{f"train/{k}": v for k, v in tm.items()},
                                **{f"val/{k}": v for k, v in vm.items()}})
                print(f"Epoch {epoch}: D {tm['d_loss']:.4f} G {tm['g_loss']:.4f} "
                      f"W {tm['wasserstein_distance']:.4f} L1 {tm['rec_loss']:.4f} | "
                      f"val L1 {vm['rec_loss']:.4f} MSE {vm['mse']:.4f}", flush=True)
                if (epoch + 1) % tr.checkpoint_interval == 0:
                    self.save_champion(ckpt_dir / f"params_g_epoch_{epoch + 1}.npz")
                if tr.save_best and vm["rec_loss"] < self.best_val_loss:
                    self.best_val_loss = vm["rec_loss"]
                    self.save_champion(ckpt_dir / "champion_params_g.npz")
                    self._best_state = {"generator": copy.deepcopy(self.generator.state_dict()),
                                        "critic": copy.deepcopy(self.critic.state_dict())}
            self.save_champion(ckpt_dir / "final_params_g.npz")
        finally:
            logger.close()
        print(f"Training complete in {time.time() - t0:.1f} s", flush=True)
        return history
