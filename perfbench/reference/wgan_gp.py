"""One CWGAN-GP outer step and Adam, in plain PyTorch.

A frozen copy of the reference recipe (the reference repository's
``train.py``: ``train_discriminator``, ``train_generator``):

    repeat n_critic times, on the step's one batch:
        fake = G(noisy), without gradient
        L_D  = mean D(fake, noisy) - mean D(clean, noisy) + gp_weight * GP
        GP   = mean over frames of (||d D(x, noisy) / d x||_2 - 1)^2,
               x = alpha clean + (1 - alpha) fake, one alpha a frame;
               the norm is sqrt(sum of squares + 1e-12), over the frame
        Adam update of D
    L_G = -adv_weight mean D(G(noisy), noisy) + rec_weight mean |G(noisy) - clean|
    Adam update of G

Adam: ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``, ``p -= lr
(m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)``.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from . import models

Params = Dict[str, torch.Tensor]


class Adam:
    """Adam over a dict of parameter tensors, updated in place, from the
    moments ``m``, ``v`` after ``t`` updates (``state``), or from zero."""

    def __init__(self, params: Params, lr: float, betas, eps: float = 1e-8,
                 state: dict | None = None):
        self.params, self.lr, self.eps = params, lr, eps
        self.b1, self.b2 = (float(b) for b in betas)
        state = state or {}
        self.t = int(state.get("t", 0))
        self.m = {k: state["m"][k].detach().clone() if "m" in state else torch.zeros_like(v)
                  for k, v in params.items()}
        self.v = {k: state["v"][k].detach().clone() if "v" in state else torch.zeros_like(v)
                  for k, v in params.items()}

    def step(self, grads: Params) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        with torch.no_grad():
            for k, p in self.params.items():
                g = grads[k]
                self.m[k] = self.b1 * self.m[k] + (1.0 - self.b1) * g
                self.v[k] = self.b2 * self.v[k] + (1.0 - self.b2) * g * g
                p -= self.lr * (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + self.eps)


def _grads(loss: torch.Tensor, params: Params) -> Params:
    names = list(params)
    with torch.enable_grad():
        gs = torch.autograd.grad(loss, [params[k] for k in names])
    return dict(zip(names, gs))


def gradient_penalty(config: dict, d: Params, clean, fake, noisy, alpha) -> torch.Tensor:
    a = alpha.reshape(-1, 1, 1)
    x = (a * clean + (1.0 - a) * fake).detach().requires_grad_(True)
    score = models.critic(config, d, x, noisy).sum()
    (gx,) = torch.autograd.grad(score, x, create_graph=True)
    norms = torch.sqrt((gx * gx).sum(dim=(1, 2)) + 1e-12)
    return ((norms - 1.0) ** 2).mean()


def critic_loss(config: dict, recipe: dict, g: Params, d: Params, batch, alpha):
    """``L_D`` and its terms' magnitude ``|mean D(fake)| + |mean D(real)| +
    gp_weight GP``."""
    noisy, clean = batch["noisy"], batch["clean"]
    with torch.no_grad():
        fake = models.generator(config, g, noisy)
    with torch.enable_grad():
        d_fake = models.critic(config, d, fake, noisy).mean()
        d_real = models.critic(config, d, clean, noisy).mean()
        gp = recipe["gp_weight"] * gradient_penalty(config, d, clean, fake, noisy, alpha)
        return d_fake - d_real + gp, float((d_fake.abs() + d_real.abs() + gp).detach())


def generator_loss(config: dict, recipe: dict, g: Params, d: Params, batch):
    """``L_G`` and its terms' magnitude ``adv_weight |adv| + rec_weight rec``."""
    noisy, clean = batch["noisy"], batch["clean"]
    with torch.enable_grad():
        fake = models.generator(config, g, noisy)
        adv = -recipe["adv_weight"] * models.critic(config, d, fake, noisy).mean()
        rec = recipe["rec_weight"] * (fake - clean).abs().mean()
        return adv + rec, float((adv.abs() + rec).detach())


class Trainer:
    """The model pair of ``config`` from the weights ``weights``
    (``{"generator": params, "critic": params}``, copied), each with its
    Adam (from ``adam[net]``'s state where it is given, else from zero),
    trained by ``recipe`` (``n_critic``, ``gp_weight``, ``adv_weight``,
    ``rec_weight``, ``lr``, ``betas``)."""

    def __init__(self, config: dict, recipe: dict, weights: Dict[str, Params],
                 adam: Dict[str, dict] | None = None):
        self.config, self.recipe = config, recipe
        self.g = {k: v.detach().clone().requires_grad_(True)
                  for k, v in weights["generator"].items()}
        self.d = {k: v.detach().clone().requires_grad_(True)
                  for k, v in weights["critic"].items()}
        adam = adam or {}
        self.opt_g = Adam(self.g, recipe["lr"], recipe["betas"], state=adam.get("generator"))
        self.opt_d = Adam(self.d, recipe["lr"], recipe["betas"], state=adam.get("critic"))

    def step(self, batch, alphas: List[torch.Tensor]) -> Dict[str, object]:
        """One outer step on ``batch`` (``noisy``, ``clean`` ``[B, L, 2]``)
        with one ``alpha`` ``[B]`` a critic update. Returns the last critic
        update's loss ``d_loss``, the generator's ``g_loss``, the magnitudes
        of their terms (``d_scale``, ``g_scale``), the gradients the two
        optimizers took first in the step (``d_grads``, ``g_grads``) and the
        last critic update's (``d_last``)."""
        if len(alphas) != self.recipe["n_critic"]:
            raise ValueError(f"expected {self.recipe['n_critic']} alphas, got {len(alphas)}")
        d_loss, d_scale, d_first, d_grads = None, None, {}, {}
        for i, alpha in enumerate(alphas):
            d_loss, d_scale = critic_loss(self.config, self.recipe, self.g, self.d, batch, alpha)
            d_grads = _grads(d_loss, self.d)
            self.opt_d.step(d_grads)
            if i == 0:
                d_first = d_grads
        g_loss, g_scale = generator_loss(self.config, self.recipe, self.g, self.d, batch)
        g_grads = _grads(g_loss, self.g)
        self.opt_g.step(g_grads)
        return {"d_loss": None if d_loss is None else float(d_loss.detach()), "d_scale": d_scale,
                "g_loss": float(g_loss.detach()), "g_scale": g_scale,
                "d_grads": d_first, "g_grads": g_grads, "d_last": d_grads}
