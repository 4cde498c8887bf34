"""The lane-packed CWGAN-GP step of the mini pair (counterpart of
``ofdmgan_tpu/ops/packed_step.py``).

Layout: ``p`` frames a row. A packed tensor ``[B/p, p*L*C]`` holds frame
``r*p + j`` in row ``r``, lanes ``[j*L*C, (j+1)*L*C)``, each frame flattened
time-major and channel-minor as the flat step flattens it
(``ops/dense_conv.py``). Every layer is one product against
``kron(I_p, A)``, ``A`` the layer's dense conv matrix: the block-diagonal
matrix applies ``A`` to each of a row's ``p`` frames. On a TPU this fills
the 128-lane tiles that a ``[B, 32]`` activation leaves three quarters
empty; on the GPU the layout has no such role, and the step is ported
because it is the reference's third layout of the same function (its
``bench.py --packed``), held against the module step on the same batch.

The packed batch is a view of the ``[B, L, 2]`` batch: the datagen
kernel's output (or the FFT datagen's) is ``[B, L, 2]`` contiguous, so
``packed_synthetic_batch`` reshapes it with no copy, and its frames and
the penalty's uniforms are those the module step draws from the same
generator, as the reference's packed datagen draws the same stream as its
unpacked one. ``*_from_draws`` takes given draws (parity tests).

``pmatmul`` is an ordinary matrix product with the block-diagonal matrix
(the reference computes it outside any Pallas kernel; ``torch.block_diag``
builds ``kron(I_p, A)``, as ``torch.kron`` fails on a transposed column),
differentiated by autograd in every order (the penalty's double backward). ``act_dtype``
stores each activation in that format, read upcast to float32 by the next
product (fp8 through bf16, exact), as the module and flat steps do.
``matmul_precision`` is the module step's (``training/wgan_gp.py``): the
mixed modes run the penalty chain on unrounded operands.
``critic_unroll`` (the reference's unroll of its critic scan, the same
numbers) is accepted and changes nothing.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.generator import FP8_DTYPES, as_dtype, read_stored, storage_dtype
from ..signal.datagen import DatagenConfig, synthetic_batch, synthetic_batch_from_draws
from ..training.schedules import AdamStepLR
from ..training.wgan_gp import (METRIC_KEYS, MATMUL_PRECISIONS, LossConfig, _apply_grads,
                                gp_precision, matmul_precision)
from . import datagen_kernel
from .dense_conv import conv1d_dense_matrix, conv1d_output_length


# --------------------------------------------------------------- primitives
def pmatmul(xp: torch.Tensor, a: torch.Tensor, p: int) -> torch.Tensor:
    """``[R, p*fin] @ kron(I_p, a) -> [R, p*fout]`` in ``a``'s float32: a
    stored activation is read upcast (fp8 through bf16, exact)."""
    a_bd = torch.block_diag(*([a] * p))   # kron(I_p, a)
    return torch.matmul(read_stored(xp, a.dtype), a_bd)


def _packed_conv(xp: torch.Tensor, conv: nn.Conv1d, l_in: int, p: int) -> torch.Tensor:
    """A conv layer (k = 3, padding 1) on packed rows: its dense matrix, then
    its bias tiled over time and frames."""
    stride = conv.stride[0]
    a = conv1d_dense_matrix(conv.weight, l_in, stride, conv.padding[0])
    l_out = conv1d_output_length(l_in, conv.kernel_size[0], stride, conv.padding[0])
    return pmatmul(xp, a, p) + conv.bias.repeat(l_out * p)


def _upsample2(xp: torch.Tensor, p: int, length: int, c: int) -> torch.Tensor:
    r = xp.shape[0]
    return xp.reshape(r, p, length, c).repeat_interleave(2, dim=2).reshape(r, -1)


def _storer(act_dtype) -> Callable[[torch.Tensor], torch.Tensor]:
    """Store an activation in ``act_dtype`` and read it back as float32 (one
    read: torch adds no fp8 gradients)."""
    dtype = storage_dtype(act_dtype)
    if dtype is None:
        return lambda h: h
    return lambda h: read_stored(h.to(dtype), torch.float32)


# ------------------------------------------------------------------- models
def packed_gen_forward(generator: nn.Module, xp: torch.Tensor, p: int, frame_length: int = 16,
                       leaky_slope: float = 0.2, input_residual: bool = False,
                       act_dtype=None) -> torch.Tensor:
    """``MiniGenerator``'s forward on packed rows ``[R, p*L*2]`` from its
    parameters (the reference's ``packed_gen_forward``)."""
    L, g = frame_length, generator
    store = _storer(act_dtype)
    lrelu = functools.partial(F.leaky_relu, negative_slope=leaky_slope)
    enc1 = store(lrelu(_packed_conv(xp, g.enc1, L, p)))
    bneck = store(lrelu(_packed_conv(enc1, g.bottleneck, L // 2, p)))
    up1 = _upsample2(bneck, p, L // 4, g.bottleneck.out_channels)
    dec1 = store(lrelu(_packed_conv(up1, g.dec1, L // 2, p)))
    skip = store(dec1 + enc1)
    up2 = _upsample2(skip, p, L // 2, g.dec1.out_channels)
    out = _packed_conv(up2, g.out_conv, L, p)
    if input_residual:
        return read_stored(xp, out.dtype) + out
    return torch.tanh(out)


def packed_critic_forward(critic: nn.Module, cand: torch.Tensor, cond: torch.Tensor, p: int,
                          frame_length: int = 16, leaky_slope: float = 0.2,
                          act_dtype=None) -> torch.Tensor:
    """``MiniDiscriminator``'s scores ``[R, p]`` on packed rows."""
    L, c, r = frame_length, critic, cand.shape[0]
    store = _storer(act_dtype)
    lrelu = functools.partial(F.leaky_relu, negative_slope=leaky_slope)
    x = torch.cat([read_stored(cand, torch.float32).reshape(r, p, L, 2),
                   read_stored(cond, torch.float32).reshape(r, p, L, 2)], -1).reshape(r, -1)
    h = store(lrelu(_packed_conv(x, c.conv1, L, p)))
    h = lrelu(_packed_conv(h, c.conv2, L // 2, p))
    c2 = c.conv2.out_channels
    pooled = h.reshape(r, p, L // 4, c2).sum(dim=2).reshape(r, -1)
    return pmatmul(pooled, c.dense.weight.T, p) + c.dense.bias[0]


# ------------------------------------------------------------------ datagen
def pack(batch: Dict[str, torch.Tensor], p: int) -> Dict[str, torch.Tensor]:
    """A ``[B, L, 2]`` batch as packed rows, ``[B]`` entries as ``[B/p, p]``:
    views, never copies."""
    return {k: v.view(v.shape[0] // p, -1) if v.dim() == 3 else v.view(v.shape[0] // p, p)
            for k, v in batch.items()}


def packed_synthetic_batch(gen: torch.Generator, batch_size: int, p: int, cfg: DatagenConfig,
                           kernel: Optional[bool] = None) -> Dict[str, torch.Tensor]:
    """The batch the module step draws from ``gen``, packed: the datagen
    kernel's where it covers ``cfg`` (``kernel``: ``None`` by scope, else
    forced), else the FFT datagen's."""
    if kernel is None:
        kernel = datagen_kernel.covers(cfg)
    if kernel:
        return pack(datagen_kernel.synthetic_batch(gen, batch_size, cfg), p)
    return pack(synthetic_batch(gen, batch_size, cfg), p)


def packed_synthetic_batch_from_draws(draws: Dict[str, torch.Tensor], p: int,
                                      cfg: DatagenConfig) -> Dict[str, torch.Tensor]:
    return pack(synthetic_batch_from_draws(draws, cfg), p)


# --------------------------------------------------------------------- step
def packed_gradient_penalty(critic: nn.Module, real: torch.Tensor, fake: torch.Tensor,
                            cond: torch.Tensor, alpha: torch.Tensor, p: int,
                            frame_length: int = 16, act_dtype=None,
                            leaky_slope: float = 0.2) -> torch.Tensor:
    """``compute_gradient_penalty`` on packed rows; ``alpha`` holds one
    uniform per frame (``[B]`` or ``[B/p, p]``). The interpolate is kept in
    ``real``'s storage dtype, as there."""
    r = real.shape[0]
    a = alpha.reshape(r, p, 1)
    f32 = torch.float32
    interp = a * read_stored(real, f32).reshape(r, p, -1) + (1.0 - a) * read_stored(
        fake, f32).reshape(r, p, -1)
    interp = as_dtype(interp, real.dtype).reshape(r, -1).detach().requires_grad_(True)
    score = packed_critic_forward(critic, interp, cond, p, frame_length, leaky_slope,
                                  act_dtype).sum()
    (grads,) = torch.autograd.grad(score, interp, create_graph=True)
    if grads.dtype in FP8_DTYPES:
        grads = grads.float()
    norms = torch.sqrt((grads.reshape(r, p, -1) ** 2).sum(dim=-1) + 1e-12)
    return ((norms - 1.0) ** 2).mean()


class PackedTrainStep:
    """One outer step of the mini pair in the packed layout, in place:
    ``step(rng)`` draws and takes ``scan_steps`` steps (returning the last
    one's metrics), ``run(batch0, alphas)`` takes one on a packed batch and
    the penalty's uniforms (one ``[B]`` per critic update), as
    ``TrainStep.run``. ``datagen_route`` is ``"kernel"`` where the datagen
    kernel covers the configuration. The slope and the head are the
    modules' (the reference passes them separately)."""

    def __init__(self, generator: nn.Module, critic: nn.Module, opt_g: AdamStepLR,
                 opt_d: AdamStepLR, dg_cfg: DatagenConfig, loss_cfg: LossConfig,
                 batch_size: int, p: int = 4, scan_steps: int = 1,
                 matmul_precision: str = "tensorfloat32", act_dtype=None,
                 critic_unroll: int = 1):
        if batch_size % p:
            raise ValueError(f"batch {batch_size} is not a multiple of p={p}")
        if getattr(generator, "qat", False) or getattr(generator, "rtl_faithful", False):
            raise ValueError("the packed step trains the standard mini pair (float, "
                             "tanh/residual head)")
        if matmul_precision not in MATMUL_PRECISIONS:
            raise ValueError(f"matmul_precision must be one of {MATMUL_PRECISIONS}")
        if critic_unroll < 1:
            raise ValueError(f"critic_unroll must be at least 1, not {critic_unroll}")
        self.generator, self.critic, self.opt_g, self.opt_d = generator, critic, opt_g, opt_d
        self.dg_cfg, self.loss_cfg = dg_cfg, loss_cfg
        self.batch_size, self.p, self.scan_steps = batch_size, p, scan_steps
        self.matmul_precision = matmul_precision
        self.act_dtype = storage_dtype(act_dtype)
        L = dg_cfg.frame_length
        slope, residual = generator.leaky_slope, generator.input_residual
        self.gen_fwd = functools.partial(packed_gen_forward, generator, p=p, frame_length=L,
                                         leaky_slope=slope, input_residual=residual,
                                         act_dtype=self.act_dtype)
        self.critic_fwd = functools.partial(packed_critic_forward, critic, p=p,
                                            frame_length=L, leaky_slope=slope,
                                            act_dtype=self.act_dtype)
        self.gp = functools.partial(packed_gradient_penalty, critic, p=p, frame_length=L,
                                    act_dtype=self.act_dtype, leaky_slope=slope)
        self.datagen_route = "kernel" if datagen_kernel.covers(dg_cfg) else "plain"

    def draw(self, rng: torch.Generator):
        """The packed batch and the penalty uniforms, as ``TrainStep.draw``
        draws them from ``rng``."""
        batch = packed_synthetic_batch(rng, self.batch_size, self.p, self.dg_cfg,
                                       self.datagen_route == "kernel")
        alphas = [torch.rand((self.batch_size,), generator=rng, device=rng.device)
                  for _ in range(self.loss_cfg.n_critic)]
        return batch, alphas

    def __call__(self, rng: torch.Generator) -> Dict[str, torch.Tensor]:
        for _ in range(self.scan_steps):
            metrics = self.run(*self.draw(rng))
        return metrics

    def critic_loss(self, batch, alpha: torch.Tensor, fake: Optional[torch.Tensor] = None):
        """L_D and its metrics; ``fake`` is the generator's no-grad forward
        of ``batch``'s noisy rows, computed here when not given."""
        noisy, clean = batch["noisy"], batch["clean"]
        if fake is None:
            with torch.no_grad():
                fake = self.gen_fwd(noisy)
        fake = as_dtype(fake, noisy.dtype)
        d_real, d_fake = self.critic_fwd(clean, noisy), self.critic_fwd(fake, noisy)
        wasserstein = d_fake.mean() - d_real.mean()
        with gp_precision(self.matmul_precision):
            gp = self.gp(clean, fake, noisy, alpha)
        loss = wasserstein + self.loss_cfg.gp_weight * as_dtype(gp, torch.float32)
        aux = {"d_loss": loss, "wasserstein_distance": -wasserstein, "gradient_penalty": gp,
               "d_real_mean": d_real.mean(), "d_fake_mean": d_fake.mean()}
        return loss, {k: v.detach() for k, v in aux.items()}

    def generator_loss(self, batch):
        noisy, clean = batch["noisy"], batch["clean"]
        fake = self.gen_fwd(noisy)
        adv = -self.critic_fwd(fake, noisy).mean()
        rec = (fake - read_stored(clean, fake.dtype)).abs().mean()
        loss = self.loss_cfg.adv_weight * adv + self.loss_cfg.rec_weight * rec
        return loss, {"g_loss": loss.detach(), "adv_loss": adv.detach(),
                      "rec_loss": rec.detach()}

    def run(self, batch0, alphas: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The step on given draws; its critic updates share one generator
        forward, as ``TrainStep.run``'s do on one batch."""
        if len(alphas) != self.loss_cfg.n_critic:
            raise ValueError(f"expected {self.loss_cfg.n_critic} alphas, got {len(alphas)}")
        if self.act_dtype is not None:
            batch0 = {**batch0, "noisy": batch0["noisy"].to(self.act_dtype),
                      "clean": batch0["clean"].to(self.act_dtype)}
        zero = torch.zeros((), device=batch0["noisy"].device)
        d_aux = {k: zero for k in METRIC_KEYS[:5]}
        with matmul_precision(self.matmul_precision):
            if alphas:
                with torch.no_grad():
                    fake = self.gen_fwd(batch0["noisy"])
                for alpha in alphas:
                    loss, d_aux = self.critic_loss(batch0, alpha, fake)
                    _apply_grads(self.critic, self.opt_d,
                                 torch.autograd.grad(loss, list(self.critic.parameters())))
                del fake
            g_loss, g_aux = self.generator_loss(batch0)
            _apply_grads(self.generator, self.opt_g,
                         torch.autograd.grad(g_loss, list(self.generator.parameters())))
        return {**d_aux, **g_aux}


build_packed_train_step = PackedTrainStep   # the reference's name for the builder
