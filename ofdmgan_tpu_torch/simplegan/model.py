"""simpleGAN, the 3x3 circle/cross dense GAN of the LSI contest design
(counterpart of ``ofdmgan_tpu/simplegan/model.py``; reference
rtl/simpleGAN/model/LSI_Contest_simple_gan_3x3.m and the dense RTL modules
simple_generator.v, 2 -> 3 tanh -> 9 tanh, and simple_discriminator.v,
9 -> 3 tanh -> 1 sigmoid).

Training recipe (the .m script, lines 9-20, 63-180):

* data: the 3x3 "circle" and "cross" patterns in {-1, +1}, one random
  sample per step;
* losses: L_D = -(log(y_real) + log(1 - y_fake)), L_G = -log(y_fake);
* plain SGD, lr 0.001 for both nets; D updated every step, G every
  DGL = 2 steps (1-based: after steps 2, 4, ...), 30000 steps;
* init 0.1 * randn weights, zero biases.

``grad_mode="matlab"`` reproduces the script's hand-derived backprop, which
multiplies the output delta by an extra sigmoid' factor
(deltad3 = -(1-y)·y·(1-y) in place of -(1-y), .m lines 121-146);
``"exact"`` takes autograd's gradients of the stated losses.

Randomness is split from the arithmetic: ``make_train_draws`` draws every
step's pattern index and both latents at once, and ``train_from_draws`` is
deterministic, so a test can hand it the JAX package's per-step draws. The
loop is one step at a time of small tensor calls on the device of the
parameters: some hundred calls a step, bound by their launches on a GPU.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

LATENT_DIM = 2
HIDDEN = 3
IMG = 9  # 3x3


def patterns(device=None) -> torch.Tensor:
    """The two training patterns ``[2, 9]``, flattened the MATLAB way
    (transpose then column-major == row-major of the drawn matrix, .m lines
    23-31)."""
    circle = np.array([[1, 1, 1], [1, -1, 1], [1, 1, 1]], np.float32)
    cross = np.array([[-1, 1, -1], [1, 1, 1], [-1, 1, -1]], np.float32)
    return torch.as_tensor(np.stack([circle.flatten(), cross.flatten()]), device=device)


class SimpleGANParams(NamedTuple):
    wg2: torch.Tensor  # [3, 2]
    bg2: torch.Tensor  # [3]
    wg3: torch.Tensor  # [9, 3]
    bg3: torch.Tensor  # [9]
    wd2: torch.Tensor  # [3, 9]
    bd2: torch.Tensor  # [3]
    wd3: torch.Tensor  # [1, 3]
    bd3: torch.Tensor  # [1]


def init_params(gen: torch.Generator) -> SimpleGANParams:
    """0.1 * randn weights and zero biases, float32 on ``gen``'s device."""
    dev = gen.device

    def w(*shape):
        return 0.1 * torch.randn(*shape, generator=gen, device=dev)

    z = lambda n: torch.zeros(n, device=dev)  # noqa: E731
    return SimpleGANParams(wg2=w(HIDDEN, LATENT_DIM), bg2=z(HIDDEN), wg3=w(IMG, HIDDEN),
                           bg3=z(IMG), wd2=w(HIDDEN, IMG), bd2=z(HIDDEN), wd3=w(1, HIDDEN),
                           bd3=z(1))


def generator_forward(p: SimpleGANParams, ng: torch.Tensor):
    """latent [2] -> (hidden [3], image [9]) with tanh activations."""
    ag2 = torch.tanh(p.wg2 @ ng + p.bg2)
    x_fake = torch.tanh(p.wg3 @ ag2 + p.bg3)
    return ag2, x_fake


def discriminator_forward(p: SimpleGANParams, x: torch.Tensor):
    """image [9] -> (hidden [3], probability, a 0-d tensor)."""
    ad2 = torch.tanh(p.wd2 @ x + p.bd2)
    y = torch.sigmoid(p.wd3 @ ad2 + p.bd3)
    return ad2, y[0]


def _matlab_d_grads(p: SimpleGANParams, x_real, x_fake):
    """The .m script's hand-derived D gradients, extra-sigmoid' factor
    included (lines 121-146), and both D outputs."""
    ad2_r, y_r = discriminator_forward(p, x_real)
    ad2_f, y_f = discriminator_forward(p, x_fake)

    delta3_r = (-(1.0 - y_r)) * y_r * (1.0 - y_r)
    dwd3 = delta3_r * ad2_r[None, :]
    dbd3 = delta3_r[None]
    delta2_r = (p.wd3[0] * delta3_r) * (1.0 - ad2_r ** 2)
    dwd2 = torch.outer(delta2_r, x_real)
    dbd2 = delta2_r

    delta3_f = y_f * y_f * (1.0 - y_f)
    dwd3 = dwd3 + delta3_f * ad2_f[None, :]
    dbd3 = dbd3 + delta3_f[None]
    delta2_f = (p.wd3[0] * delta3_f) * (1.0 - ad2_f ** 2)
    dwd2 = dwd2 + torch.outer(delta2_f, x_fake)
    dbd2 = dbd2 + delta2_f
    return (dwd2, dbd2, dwd3, dbd3), y_r, y_f


def _matlab_g_grads(p: SimpleGANParams, ng):
    """Hand-derived G gradients (lines 151-170), and D's output on the fake."""
    ag2, x_fake = generator_forward(p, ng)
    ad2_f, y_f = discriminator_forward(p, x_fake)
    delta3 = (-(1.0 - y_f)) * y_f * (1.0 - y_f)
    delta2 = (p.wd3[0] * delta3) * (1.0 - ad2_f ** 2)
    deltag3 = (p.wd2.T @ delta2) * (1.0 - x_fake ** 2)
    dwg3 = torch.outer(deltag3, ag2)
    dbg3 = deltag3
    deltag2 = (p.wg3.T @ deltag3) * (1.0 - ag2 ** 2)
    dwg2 = torch.outer(deltag2, ng)
    dbg2 = deltag2
    return (dwg2, dbg2, dwg3, dbg3), y_f


def _d_loss(y_r, y_f):
    return -(torch.log(y_r + 1e-8) + torch.log(1.0 - y_f + 1e-8))


def _exact_d_grads(p: SimpleGANParams, x_real, x_fake):
    """Autograd's gradients of L_D for D's parameters, and both D outputs."""
    with torch.enable_grad():
        q = [t.detach().requires_grad_() for t in (p.wd2, p.bd2, p.wd3, p.bd3)]
        pq = p._replace(wd2=q[0], bd2=q[1], wd3=q[2], bd3=q[3])
        _, y_r = discriminator_forward(pq, x_real)
        _, y_f = discriminator_forward(pq, x_fake)
        grads = torch.autograd.grad(_d_loss(y_r, y_f), q)
    return grads, y_r.detach(), y_f.detach()


def _exact_g_grads(p: SimpleGANParams, ng):
    """Autograd's gradients of L_G for G's parameters (D held fixed), and
    D's output on the fake."""
    with torch.enable_grad():
        q = [t.detach().requires_grad_() for t in (p.wg2, p.bg2, p.wg3, p.bg3)]
        pq = p._replace(wg2=q[0], bg2=q[1], wg3=q[2], bg3=q[3])
        _, x_fake = generator_forward(pq, ng)
        _, y_f = discriminator_forward(pq, x_fake)
        grads = torch.autograd.grad(-torch.log(y_f + 1e-8), q)
    return grads, y_f.detach()


def make_train_draws(gen: torch.Generator, n_steps: int) -> Dict[str, torch.Tensor]:
    """Every step's draws on ``gen``'s device, one call each: ``idx`` [n]
    (the real pattern), ``ng1`` [n, 2] (the latent of D's step) and ``ng2``
    [n, 2] (the latent of G's step)."""
    dev = gen.device
    return {"idx": torch.randint(0, 2, (n_steps,), generator=gen, device=dev),
            "ng1": torch.randn(n_steps, LATENT_DIM, generator=gen, device=dev),
            "ng2": torch.randn(n_steps, LATENT_DIM, generator=gen, device=dev)}


def train_from_draws(
    params: SimpleGANParams,
    idx: torch.Tensor,
    ng1: torch.Tensor,
    ng2: torch.Tensor,
    eta_d: float = 0.001,
    eta_g: float = 0.001,
    dgl: int = 2,
    grad_mode: str = "matlab",
) -> Tuple[SimpleGANParams, Dict[str, torch.Tensor]]:
    """The training loop (.m lines 63-180) on the draws of
    ``make_train_draws``, on the device of ``params``; returns the trained
    parameters and the per-step losses ``loss_d``, ``loss_g`` ([n])."""
    if grad_mode not in ("matlab", "exact"):
        raise ValueError(f"grad_mode must be 'matlab' or 'exact', not {grad_mode!r}")
    dev = params.wg2.device
    d_grads = _matlab_d_grads if grad_mode == "matlab" else _exact_d_grads
    g_grads = _matlab_g_grads if grad_mode == "matlab" else _exact_g_grads
    x_reals = patterns(dev)[idx.to(dev)]   # [n, 9]
    ng1, ng2 = ng1.to(dev), ng2.to(dev)
    p = SimpleGANParams(*(t.detach() for t in params))
    loss_d, loss_g = [], []
    with torch.no_grad():
        for i in range(idx.shape[0]):
            _, x_fake = generator_forward(p, ng1[i])
            (dwd2, dbd2, dwd3, dbd3), y_r, y_f = d_grads(p, x_reals[i], x_fake)
            loss_d.append(_d_loss(y_r, y_f))
            p = p._replace(wd3=p.wd3 - eta_d * dwd3, bd3=p.bd3 - eta_d * dbd3,
                           wd2=p.wd2 - eta_d * dwd2, bd2=p.bd2 - eta_d * dbd2)

            (dwg2, dbg2, dwg3, dbg3), yf2 = g_grads(p, ng2[i])
            loss_g.append(-torch.log(yf2 + 1e-8))
            if (i + 1) % dgl == 0:   # MATLAB: rem(epoch, DGL) == 0, 1-based
                p = p._replace(wg3=p.wg3 - eta_g * dwg3, bg3=p.bg3 - eta_g * dbg3,
                               wg2=p.wg2 - eta_g * dwg2, bg2=p.bg2 - eta_g * dbg2)
    return p, {"loss_d": torch.stack(loss_d), "loss_g": torch.stack(loss_g)}


def train(gen: torch.Generator, params: SimpleGANParams, n_steps: int = 30_000,
          eta_d: float = 0.001, eta_g: float = 0.001, dgl: int = 2,
          grad_mode: str = "matlab") -> Tuple[SimpleGANParams, Dict[str, torch.Tensor]]:
    """``train_from_draws`` on ``n_steps`` steps drawn from ``gen``."""
    return train_from_draws(params, **make_train_draws(gen, n_steps), eta_d=eta_d,
                            eta_g=eta_g, dgl=dgl, grad_mode=grad_mode)


def generate_samples(p: SimpleGANParams, gen: Optional[torch.Generator] = None,
                     n: int = 9, ngs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``n`` generated 3x3 images in [-1, 1] (.m lines 196-210), from
    latents ``ngs`` [n, 2] or drawn from ``gen``."""
    if ngs is None:
        ngs = torch.randn(n, LATENT_DIM, generator=gen, device=gen.device)
    ngs = ngs.to(p.wg2.device)
    ag2 = torch.tanh(ngs @ p.wg2.T + p.bg2)
    return torch.tanh(ag2 @ p.wg3.T + p.bg3).reshape(-1, 3, 3)


def pattern_score(p: SimpleGANParams) -> Dict[str, float]:
    """How close the canonical test latents come to the two patterns
    (.m verification section, ng=[-1;1] and [-3;3])."""
    data = patterns().numpy()
    out = {}
    for name, z in (("cross", (-1.0, 1.0)), ("circle", (-3.0, 3.0))):
        _, img = generator_forward(p, torch.tensor(z, device=p.wg2.device))
        d = np.mean((img.cpu().numpy()[None] - data) ** 2, axis=1)
        out[f"{name}_latent_best_match"] = ["circle", "cross"][int(np.argmin(d))]
        out[f"{name}_latent_best_mse"] = float(d.min())
    return out
