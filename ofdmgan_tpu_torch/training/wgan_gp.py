"""The CWGAN-GP outer step: datagen, n_critic critic updates, one generator
update.

Counterpart of ``ofdmgan_tpu/training/wgan_gp.py:39-479``. Per outer step:

    batch = synthetic datagen
    repeat n_critic times (on the same batch unless fresh_critic_batches):
        fake = G(noisy) (no gradient)
        L_D  = E[D(fake, c)] - E[D(real, c)] + gp_weight * GP(real, fake, c)
        Adam update of D
    L_G = -E[D(G(noisy), c)] + rec_weight * L1(G(noisy), clean)
    Adam update of G

The batch comes from ``ops/datagen_kernel`` and each critic update's gradient
from ``ops/critic_kernel``: the CUDA kernels for tensors on the GPU, their
plain versions on the CPU (the reference step with ``use_pallas_datagen`` and
``use_pallas_critic`` on). ``reference=True`` instead draws with the FFT
datagen of ``signal/datagen`` and takes the critic gradient by autograd (the
reference step with both off); tests and ``chip_smoke.py`` hold the two
against each other. ``n_critic == 0`` is the supervised path: no critic
update, no adversarial term.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
from torch import nn

from ..models.critic import compute_gradient_penalty
from ..ops import critic_kernel, datagen_kernel
from ..signal.datagen import DatagenConfig, synthetic_batch
from .schedules import AdamStepLR

METRIC_KEYS = ("d_loss", "wasserstein_distance", "gradient_penalty", "d_real_mean",
               "d_fake_mean", "g_loss", "adv_loss", "rec_loss")


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """WGAN-GP loss settings (reference config/config.yaml:75-82)."""

    n_critic: int = 5
    gp_weight: float = 10.0
    adv_weight: float = 1.0
    rec_weight: float = 100.0
    fresh_critic_batches: bool = False  # the reference reuses one batch per outer step


def critic_loss_fn(critic: nn.Module, generator: nn.Module, batch, alpha: torch.Tensor,
                   cfg: LossConfig):
    """L_D and its metrics; ``alpha`` ``[B]`` are the penalty's uniforms."""
    noisy, clean = batch["noisy"], batch["clean"]
    with torch.no_grad():
        fake = generator(noisy)
    d_real = critic(clean, noisy)
    d_fake = critic(fake, noisy)
    wasserstein = d_fake.mean() - d_real.mean()
    gp = compute_gradient_penalty(critic, clean, fake, noisy, alpha)
    loss = wasserstein + cfg.gp_weight * gp
    aux = {"d_loss": loss, "wasserstein_distance": -wasserstein, "gradient_penalty": gp,
           "d_real_mean": d_real.mean(), "d_fake_mean": d_fake.mean()}
    return loss, {k: v.detach() for k, v in aux.items()}


def generator_loss_fn(generator: nn.Module, critic: nn.Module, batch, cfg: LossConfig):
    """L_G and its metrics; ``n_critic == 0`` skips the critic entirely."""
    noisy, clean = batch["noisy"], batch["clean"]
    fake = generator(noisy)
    if cfg.n_critic == 0:
        adv = torch.zeros((), device=fake.device)
    else:
        adv = -critic(fake, noisy).mean()
    rec = (fake - clean).abs().mean()
    loss = cfg.adv_weight * adv + cfg.rec_weight * rec
    return loss, {"g_loss": loss.detach(), "adv_loss": adv.detach(), "rec_loss": rec.detach()}


def _apply_grads(module: nn.Module, opt: AdamStepLR, grads) -> None:
    for p, g in zip(module.parameters(), grads):
        p.grad = g
    opt.step()


class TrainStep:
    """One outer step on ``generator``/``critic`` in place; built by
    ``build_train_step``."""

    def __init__(self, generator: nn.Module, critic: nn.Module, opt_g: AdamStepLR,
                 opt_d: AdamStepLR, dg_cfg: DatagenConfig, loss_cfg: LossConfig,
                 batch_size: int, reference: bool = False):
        if loss_cfg.n_critic == 0 and loss_cfg.adv_weight != 0.0:
            raise ValueError("n_critic=0 (the supervised path) requires adv_weight=0: "
                             "with no critic updates an adversarial generator term "
                             "would train against a frozen random critic")
        if not reference:
            datagen_kernel.check_config(dg_cfg)
        self.generator, self.critic = generator, critic
        self.opt_g, self.opt_d = opt_g, opt_d
        self.dg_cfg, self.loss_cfg = dg_cfg, loss_cfg
        self.batch_size = batch_size
        self.reference = reference

    def draw_batch(self, rng: torch.Generator):
        if self.reference:
            return synthetic_batch(rng, self.batch_size, self.dg_cfg)
        return datagen_kernel.synthetic_batch(rng, self.batch_size, self.dg_cfg)

    def __call__(self, rng: torch.Generator) -> Dict[str, torch.Tensor]:
        """Draw the step's batch(es) and penalty uniforms from ``rng``, then run it."""
        batch0 = self.draw_batch(rng)
        critic_batches, alphas = [], []
        for _ in range(self.loss_cfg.n_critic):
            if self.loss_cfg.fresh_critic_batches:
                critic_batches.append(self.draw_batch(rng))
            alphas.append(torch.rand((self.batch_size,), generator=rng, device=rng.device))
        return self.run(batch0, alphas, critic_batches or None)

    def critic_update(self, batch, alpha: torch.Tensor) -> Dict[str, torch.Tensor]:
        if not self.reference:
            noisy, clean = batch["noisy"], batch["clean"]
            with torch.no_grad():
                fake = self.generator(noisy)
            grads, aux = critic_kernel.critic_grad(
                self.critic, critic_kernel.pack_h0(clean, noisy),
                critic_kernel.pack_h0(fake, noisy), alpha.contiguous(),
                self.loss_cfg.gp_weight, self.critic.leaky_slope)
            grads = [grads[name] for name, _ in self.critic.named_parameters()]
        else:
            loss, aux = critic_loss_fn(self.critic, self.generator, batch, alpha, self.loss_cfg)
            grads = torch.autograd.grad(loss, list(self.critic.parameters()))
        _apply_grads(self.critic, self.opt_d, grads)
        return aux

    def run(self, batch0, alphas: List[torch.Tensor],
            critic_batches: Optional[List[dict]] = None) -> Dict[str, torch.Tensor]:
        """The step from given draws: the outer batch, one ``alpha`` ``[B]``
        per critic update and, with ``fresh_critic_batches``, one batch per
        critic update. Returns the last critic update's metrics and the
        generator's, as 0-d tensors."""
        if len(alphas) != self.loss_cfg.n_critic:
            raise ValueError(f"expected {self.loss_cfg.n_critic} alphas, got {len(alphas)}")
        zero = torch.zeros((), device=batch0["noisy"].device)
        d_aux = {k: zero for k in METRIC_KEYS[:5]}
        for i, alpha in enumerate(alphas):
            d_aux = self.critic_update(critic_batches[i] if critic_batches else batch0, alpha)
        g_loss, g_aux = generator_loss_fn(self.generator, self.critic, batch0, self.loss_cfg)
        _apply_grads(self.generator, self.opt_g,
                     torch.autograd.grad(g_loss, list(self.generator.parameters())))
        return {**d_aux, **g_aux}


build_train_step = TrainStep  # the reference's name for the step builder


def make_eval_step(generator: nn.Module, dg_cfg: DatagenConfig, batch_size: int):
    """Validation metrics on a fresh batch (reference train.py:370-409)."""

    @torch.no_grad()
    def eval_step(rng: torch.Generator) -> Dict[str, torch.Tensor]:
        batch = synthetic_batch(rng, batch_size, dg_cfg)
        err = generator(batch["noisy"]) - batch["clean"]
        return {"rec_loss": err.abs().mean(), "mse": (err ** 2).mean()}

    return eval_step
