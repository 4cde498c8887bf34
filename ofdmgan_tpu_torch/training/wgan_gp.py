"""The CWGAN-GP outer step: datagen, n_critic critic updates, one generator
update.

Counterpart of ``ofdmgan_tpu/training/wgan_gp.py:39-479``. Per outer step:

    batch = synthetic datagen
    fake = G(noisy) (no gradient), once, unless fresh_critic_batches
    repeat n_critic times (on the same batch unless fresh_critic_batches):
        with fresh_critic_batches: fake = G(noisy) of this update's batch
        L_D  = E[D(fake, c)] - E[D(real, c)] + gp_weight * GP(real, fake, c)
        Adam update of D
    L_G = -E[D(G(noisy), c)] + rec_weight * L1(G(noisy), clean)
    Adam update of G

The reference computes the fake inside each critic update
(``ofdmgan_tpu/training/wgan_gp.py:337-341``). Where the updates share the
outer batch, those fakes are one value: the same generator weights (they
change only after the loop) on the same frames, through a forward that holds
no state and draws nothing. So the step computes it once, in the first
update, and hands it to the rest: the same operation on the same inputs.

Each kernel takes its part of the step where it covers the configuration,
as the reference's ``use_pallas_datagen``/``use_pallas_critic`` flags do:
``TrainStep`` chooses once, at construction, from the configuration alone,
and exposes the choice as ``datagen_route``, ``critic_route``,
``generator_route`` and ``forward_route`` (``"kernel"`` or ``"plain"``):

* the batch comes from ``ops/datagen_kernel`` when ``datagen_kernel.covers``
  the ``DatagenConfig`` (AWGN, linear or the default nonlinear chain, a
  kernel length), else from the FFT datagen ``signal/datagen.synthetic_batch``;
  a ``batch_fn`` (the image datasets) takes the place of both;
* each critic update's gradient comes from ``ops/critic_kernel`` when
  ``critic_kernel.covers`` the critic at the frame length (the mini critic at
  16 samples), else from ``critic_loss_fn`` and autograd;
* the generator update's gradient and metrics come from
  ``ops/generator_kernel`` where ``generator_kernel.covers`` the pair (the
  deployed mini generator, no QAT, RTL or storage modes, against the mini
  critic at 16 samples) on the critic kernel's route, at ``float32``, with
  ``n_critic > 0`` and none of ``gen_forward``, ``critic_forward``,
  ``flat``, ``shard``, ``remat`` or ``act_dtype``; else from
  ``generator_loss_fn`` and autograd;
* the critic updates' no-grad fake comes from
  ``generator_kernel.generator_forward`` where
  ``generator_kernel.covers_forward`` the generator (the deployed mini
  generator at 16 samples, no QAT, RTL or storage modes), at ``float32``,
  with none of ``gen_forward``, ``flat``, ``shard``, ``remat`` or
  ``act_dtype``, whatever the critic's route; else from the generator's
  training forward (``TrainStep.forward``). The generator update's forward,
  which needs a gradient, is never this route's.

A kernel route runs the CUDA kernel for tensors on the GPU and its plain
version on the CPU; a kernel that fails to build or launch raises, it is
never replaced by the plain route. ``reference=True`` makes every route
plain (the reference step with both flags off); tests and ``chip_smoke.py``
hold the two against each other. ``n_critic == 0`` is the supervised path:
no critic update, no adversarial term.

Three settings follow the reference's ``build_train_step``:

* ``gen_forward(generator, noisy)`` replaces the generator module's forward
  inside the step (the trainer's ``train_gen_apply``, reference
  ``trainer.py:274-280``: the full U-Net's fused decoder); validation and
  checkpoints keep the module;
* ``act_dtype`` casts the step's batch to a storage format (reference
  ``wgan_gp.py:317-326``; the mini pair stores its activations in it too);
* ``matmul_precision`` (``MATMUL_PRECISIONS``) is scoped to the step
  (``matmul_precision``): ``float32``, the default, keeps TF32 off for
  matrix products and cuDNN convolutions; ``tensorfloat32`` turns both on,
  which on Hopper is TF32 (10 mantissa bits), not the TPU's bf16x3 that the
  reference's mode means there (the flat step's ``mm="tf32x3"`` computes
  that, ``models/flat.tf32_matmul``); ``bfloat16`` rounds the operands of every
  conv and linear of the step, and of their derivatives, to bf16 and
  computes in float32 with TF32 off (``ops/bf16_dots.py``): the TPU's
  one-pass bf16 with float32 accumulation, as the reference's
  ``jax.default_matmul_precision("bfloat16")`` computes there. Outputs,
  bias adds, activations and the score stay float32. ``bf16_tf32gp`` and
  ``bf16_f32gp`` run the gradient-penalty chain (its forward, the nested
  gradient and their parameter gradients) on unrounded operands, at TF32
  or float32 (reference ``wgan_gp.py:119-133, 213-218``). The flags are
  restored when the step returns. The reference's datagen is a DFT matmul,
  which its bf16 mode rounds too on a TPU; the port's datagen (the FFT or
  the datagen kernel) stays float32.

``remat`` recomputes the model applies in the backward instead of keeping
their activations (reference ``wgan_gp.py:220-224``): the generator's
training forward and every critic apply of the step, the penalty's too, run
under ``torch.utils.checkpoint`` (non-reentrant, so the penalty's double
backward goes through it). It computes the same function. With the critic
kernel, the generator's applies and the generator step's critic apply are
the ones recomputed, as there.

``flat`` (``models/flat.FlatStep``) trains the mini pair through its flat
``[B, F]`` applies (reference ``trainer.py:193-252``): the training forward,
the critic applies, the gradient-penalty chain's own critic
(``critic_apply_gp``, reference ``wgan_gp.py:76-129``) and, with premaps,
the dense matrices built once per parameter value per loss and shared by
every apply of that loss (reference ``wgan_gp.py:153-175``). It draws its
batches as the module step does (the flat applies read ``[B, L, 2]``
frames as ``[B, 2L]``), and its critic keeps the kernel route where its
applies compute the module's function (``FlatStep.module_critic``).

``fuse_realfake`` evaluates the Wasserstein term's critic once, on the
real and fake candidates stacked into ``2B`` frames against the condition
stacked twice, and splits the scores (reference ``wgan_gp.py:112-124``):
each frame's score is the same function of its inputs, and only the
parameter gradient's batch sum is taken in another order. The penalty
chain stays apart, as there. The critic kernel's route computes the whole
critic gradient, so the setting changes nothing on it, as the reference's
``use_pallas_critic`` replaces the whole ``value_and_grad``.

``flat_params`` (with a premapped flat step, reference ``bench.py:237-246,
411-418``) trains each net through one float32 parameter tensor: the
optimizers each hold the one tensor of ``models/flat.flatten_parameters``,
whose views are the module's parameters (so the premaps read them), and
each update's gradients are concatenated into it before the optimizer
steps. Adam is elementwise, so the step computes the per-parameter step's
numbers.

Spans (``utils/spans.py``, off by default) mark the step's phases: ``step``
around a call (or a ``run`` from given draws), ``step.datagen`` around the
draws, ``step.critic`` around each critic update, ``step.generator``
around the generator's loss, gradient and update, and ``optim`` around
each Adam update.

Two settings serve the parallel strategies (``parallel/``):
``critic_forward(critic, candidate, condition)`` replaces the critic
module's forward as ``gen_forward`` does the generator's, and ``shard``
holds this process's part of a step that several processes take together:
``shard.reduce(module, grads, metrics)`` runs just before each optimizer
update (the data-parallel mean of the gradients and metrics);
``shard.frame_sum`` and ``shard.mean`` take the penalty's per-frame sums
and the L1 term's mean where each process holds a piece of every frame
(sequence parallelism).

The critic kernel computes the mini critic at ``float32`` or ``bfloat16``
precision, the latter with the rounding of this step's autograd route (the
reference's Pallas critic takes ``bfloat16`` too, and refuses the mixed
modes), so its route is ``kernel`` by scope only with no ``act_dtype`` (the
step's or the critic's own storage format) and one of those two precisions:
there the two routes compute the same function.

``use_pallas_critic`` (the reference's ``build_train_step`` flag) requires
the kernel's route and widens it to where the reference runs its kernel
though autograd would compute another function: ``tensorfloat32`` (the
kernel computes float32, as the reference's Mosaic dots round TF32 up,
``pallas_critic.py:52-57``; the rest of the step stays under TF32) and
bf16 storage. There, as in the reference (``wgan_gp.py:317-344``), the
kernel reads the stored ``clean`` and ``noisy`` and the generator's
float32 output uncast, and each penalty uniform is drawn in bf16, on the
grid k/128 for k uniform in 0..127, as ``jax.random.uniform`` draws in
that dtype; fresh critic batches are not cast, so theirs stay float32
uniforms. It refuses the mixed modes (as the reference), fp8 storage
(the reference's kernel raises there), a critic the kernel does not cover,
``critic_forward``, ``shard`` and a flat step whose critic is not the
module's. Without it the routes are chosen by scope as above: the
reference's ``Trainer`` never sets the flag.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..models.critic import compute_gradient_penalty
from ..models.flat import FlatStep
from ..models.generator import FP8_DTYPES, as_dtype, storage_dtype
from ..ops import bf16_dots, critic_kernel, datagen_kernel, generator_kernel
from ..signal.datagen import DatagenConfig, synthetic_batch
from ..utils import spans
from .schedules import AdamStepLR

MATMUL_PRECISIONS = ("float32", "tensorfloat32", "bfloat16", "bf16_tf32gp", "bf16_f32gp")
MIXED_PRECISIONS = ("bf16_tf32gp", "bf16_f32gp")
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


@contextlib.contextmanager
def matmul_precision(mode: str):
    """The step's numerics ``mode`` (``MATMUL_PRECISIONS``) while the block
    runs; the TF32 flags are restored after it."""
    if mode not in MATMUL_PRECISIONS:
        raise ValueError(f"matmul_precision must be one of {MATMUL_PRECISIONS}, not {mode!r}")
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tf32 = mode in ("tensorfloat32", "bf16_tf32gp")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        with bf16_dots.bf16_operands(mode.startswith("bf")):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def gp_precision(mode: str):
    """The gradient-penalty chain's context inside the step: unrounded
    operands in the mixed modes (its TF32 flags are the step's)."""
    if mode in MIXED_PRECISIONS:
        return bf16_dots.full_operands()
    return contextlib.nullcontext()


def critic_loss_fn(critic: Callable, generator: Callable, batch, alpha: torch.Tensor,
                   cfg: LossConfig, gp_context=contextlib.nullcontext, frame_sum=None,
                   critic_gp: Optional[Callable] = None, fuse_realfake: bool = False):
    """L_D and its metrics; ``alpha`` ``[B]`` are the penalty's uniforms.
    ``generator`` is the module or any training forward ``noisy -> fake``,
    ``critic`` the module or any apply of it, ``critic_gp`` (default
    ``critic``) the critic of the penalty chain; the penalty runs inside
    ``gp_context()``, its per-frame sums through ``frame_sum`` (see
    ``compute_gradient_penalty``). ``fuse_realfake`` scores the real and
    fake candidates in one critic call (see the module's docstring)."""
    noisy, clean = batch["noisy"], batch["clean"]
    with torch.no_grad():
        # stored in the batch's format, as the reference does (wgan_gp.py:108)
        fake = as_dtype(generator(noisy), noisy.dtype)
    if fuse_realfake:
        n = clean.shape[0]
        d_all = critic(torch.cat([clean, fake]), torch.cat([noisy, noisy]))
        d_real, d_fake = d_all[:n], d_all[n:]
    else:
        d_real = critic(clean, noisy)
        d_fake = critic(fake, noisy)
    wasserstein = d_fake.mean() - d_real.mean()
    with gp_context():
        gp = compute_gradient_penalty(critic_gp or critic, clean, fake, noisy, alpha, frame_sum)
    # the penalty is summed into the loss in float32 (a bf16 penalty too),
    # as XLA's fused arithmetic does in the reference
    loss = wasserstein + cfg.gp_weight * as_dtype(gp, torch.float32)
    aux = {"d_loss": loss, "wasserstein_distance": -wasserstein, "gradient_penalty": gp,
           "d_real_mean": d_real.mean(), "d_fake_mean": d_fake.mean()}
    return loss, {k: v.detach() for k, v in aux.items()}


def generator_loss_fn(generator: Callable, critic: Callable, batch, cfg: LossConfig,
                      mean: Callable = torch.mean):
    """L_G and its metrics; ``n_critic == 0`` skips the critic entirely.
    ``mean`` takes the L1 term's mean over the frames (a frame split across
    processes needs a collective)."""
    noisy, clean = batch["noisy"], batch["clean"]
    fake = generator(noisy)
    if cfg.n_critic == 0:
        adv = torch.zeros((), device=fake.device)
    else:
        adv = -critic(fake, noisy).mean()
    if clean.dtype in FP8_DTYPES:   # fp8 takes part in no promotion
        clean = clean.to(fake.dtype)
    rec = mean((fake - clean).abs())
    loss = cfg.adv_weight * adv + cfg.rec_weight * rec
    return loss, {"g_loss": loss.detach(), "adv_loss": adv.detach(), "rec_loss": rec.detach()}


def require_datagen_kernel(dg_cfg: DatagenConfig, batch_fn=None) -> None:
    """The reference's ``use_pallas_datagen``: raise unless the datagen
    kernel's route covers the configuration (its refusal, ``wgan_gp.py:281-292``)."""
    if batch_fn is not None or not datagen_kernel.covers(dg_cfg):
        raise ValueError("pallas datagen kernel covers the AWGN channel with the default "
                         "nonlinear chain (Rapp PA + IQ + phase noise); use the XLA path "
                         "for other configurations")


def _apply_grads(module: nn.Module, opt: AdamStepLR, grads, flat_params: bool = False) -> None:
    """One update of ``module`` with ``grads`` (one a parameter, in
    ``parameters()`` order); with ``flat_params`` the optimizer holds the
    module's one flat tensor, whose gradient is their concatenation."""
    with spans.span("optim"):
        if flat_params:
            opt.opt.param_groups[0]["params"][0].grad = torch.cat([g.reshape(-1) for g in grads])
        else:
            for p, g in zip(module.parameters(), grads):
                p.grad = g
        opt.step()


def _recomputed(fn: Callable) -> Callable:
    """``fn`` whose activations are recomputed in the backward, with the
    operand rounding of its first run."""
    def apply(*args):
        rounded = bf16_dots.rounding()

        def run(*a):
            with bf16_dots.operands(rounded):
                return fn(*a)
        return checkpoint(run, *args, use_reentrant=False)
    return apply


class TrainStep:
    """One outer step on ``generator``/``critic`` in place; built by
    ``build_train_step``. ``batch_fn(rng, n)`` replaces the synthetic datagen
    (reference ``wgan_gp.py:279-280``); ``gen_forward``, ``critic_forward``,
    ``shard``, ``act_dtype``, ``matmul_precision``, ``remat``, ``flat``,
    ``fuse_realfake``, ``flat_params`` and ``use_pallas_critic`` as in the
    module's docstring."""

    def __init__(self, generator: nn.Module, critic: nn.Module, opt_g: AdamStepLR,
                 opt_d: AdamStepLR, dg_cfg: DatagenConfig, loss_cfg: LossConfig,
                 batch_size: int, reference: bool = False,
                 batch_fn: Optional[Callable[[torch.Generator, int], dict]] = None,
                 gen_forward: Optional[Callable[[nn.Module, torch.Tensor], torch.Tensor]] = None,
                 act_dtype=None, matmul_precision: str = "float32", remat: bool = False,
                 critic_forward: Optional[Callable] = None, shard=None,
                 flat: Optional[FlatStep] = None, fuse_realfake: bool = False,
                 flat_params: bool = False, use_pallas_critic: bool = False):
        if loss_cfg.n_critic == 0 and loss_cfg.adv_weight != 0.0:
            raise ValueError("n_critic=0 (the supervised path) requires adv_weight=0: "
                             "with no critic updates an adversarial generator term "
                             "would train against a frozen random critic")
        if matmul_precision not in MATMUL_PRECISIONS:
            raise ValueError(f"matmul_precision must be one of {MATMUL_PRECISIONS}")
        self.generator, self.critic = generator, critic
        self.gen_forward, self.critic_forward = gen_forward, critic_forward
        self.shard = shard
        self.act_dtype = storage_dtype(act_dtype)
        self.matmul_precision = matmul_precision
        self.remat = remat
        self.opt_g, self.opt_d = opt_g, opt_d
        self.dg_cfg, self.loss_cfg = dg_cfg, loss_cfg
        self.batch_size = batch_size
        self.batch_fn = batch_fn
        self.flat = flat
        self.fuse_realfake = fuse_realfake
        self.flat_params = flat_params
        if flat_params:
            if flat is None or flat.gen_premap is None:
                raise ValueError("flat_params requires the flat premapped step (flat with premap)")
            for module, opt in ((generator, opt_g), (critic, opt_d)):
                held = opt.opt.param_groups[0]["params"]
                # each parameter a view of the held tensor: a module moved or
                # copied after flattening would train a detached tensor
                if len(held) != 1 or held[0].numel() != sum(
                        p.numel() for p in module.parameters()) or any(
                        p.untyped_storage().data_ptr() != held[0].untyped_storage().data_ptr()
                        for p in module.parameters()):
                    raise ValueError("flat_params needs optimizers that each hold their net's one "
                                     "flat tensor (models/flat.flatten_parameters)")
        self.use_pallas_critic = use_pallas_critic
        if use_pallas_critic:
            self._require_critic_kernel()
        self.reference = reference

    def _require_critic_kernel(self) -> None:
        """``use_pallas_critic``'s refusals (see the module's docstring)."""
        if self.matmul_precision in MIXED_PRECISIONS:   # reference wgan_gp.py:264-266
            raise ValueError("mixed GP precision is not supported by the Pallas critic kernel "
                             "path")
        if self.act_dtype in FP8_DTYPES or getattr(self.critic, "act_dtype", None) in FP8_DTYPES:
            raise ValueError("the critic kernel reads frames stored in float32 or bfloat16, "
                             "not fp8")
        if not critic_kernel.covers(self.critic, self.dg_cfg.frame_length):
            raise ValueError("the critic kernel covers the mini 16-sample critic")
        if self.critic_forward is not None or self.shard is not None:
            raise ValueError("the critic kernel computes the critic module's gradient on one "
                             "process: no critic_forward or shard")
        if self.flat is not None and not self.flat.module_critic:
            raise ValueError("the critic kernel computes the module's critic: the flat step's "
                             "critic must be it (mm ambient, no storage format)")

    def set_optimizers(self, opt_g: AdamStepLR, opt_d: AdamStepLR) -> None:
        """The optimizers the step updates with (a resume or a warm start)."""
        self.opt_g, self.opt_d = opt_g, opt_d

    @property
    def reference(self) -> bool:
        return self._reference

    @reference.setter
    def reference(self, value: bool) -> None:
        """Set the routes: all plain for the reference step, else each
        kernel where it covers the configuration (the critic's always with
        ``use_pallas_critic``; the generator update's only beside the
        critic kernel's; the no-grad forward's at ``float32``, see the
        module's docstring)."""
        self._reference = bool(value)
        kernel_data = not value and self.batch_fn is None and datagen_kernel.covers(self.dg_cfg)
        kernel_critic = not value and (self.use_pallas_critic or (
            self.act_dtype is None and self.critic_forward is None
            and getattr(self.critic, "act_dtype", None) is None
            and (self.flat is None or self.flat.module_critic)
            and self.matmul_precision in ("float32", "bfloat16")
            and critic_kernel.covers(self.critic, self.dg_cfg.frame_length)))
        self.datagen_route = "kernel" if kernel_data else "plain"
        self.critic_route = "kernel" if kernel_critic else "plain"
        kernel_gen = (kernel_critic and self.loss_cfg.n_critic > 0 and self.act_dtype is None
                      and self.matmul_precision == "float32" and not self.remat
                      and self.gen_forward is None and self.critic_forward is None
                      and self.flat is None and self.shard is None
                      and generator_kernel.covers(self.generator, self.critic,
                                                  self.dg_cfg.frame_length))
        self.generator_route = "kernel" if kernel_gen else "plain"
        kernel_fwd = (not value and self.matmul_precision == "float32"
                      and self.act_dtype is None and self.flat is None and not self.remat
                      and self.gen_forward is None and self.shard is None
                      and generator_kernel.covers_forward(self.generator,
                                                          self.dg_cfg.frame_length))
        self.forward_route = "kernel" if kernel_fwd else "plain"

    def draw_batch(self, rng: torch.Generator):
        if self.batch_fn is not None:
            return self.batch_fn(rng, self.batch_size)
        if self.datagen_route == "kernel":
            return datagen_kernel.synthetic_batch(rng, self.batch_size, self.dg_cfg)
        return synthetic_batch(rng, self.batch_size, self.dg_cfg)

    def draw(self, rng: torch.Generator):
        """The step's draws from ``rng``: the outer batch, the penalty
        uniforms (float32, with bf16's values on the kernel route under bf16
        storage) and, with ``fresh_critic_batches``, the critic batches (else
        ``None``), as ``run`` takes them."""
        with spans.span("step.datagen"):
            batch0 = self.draw_batch(rng)
            critic_batches, alphas = [], []
            for _ in range(self.loss_cfg.n_critic):
                if self.loss_cfg.fresh_critic_batches:
                    critic_batches.append(self.draw_batch(rng))
                alphas.append(self._draw_alpha(rng))
        return batch0, alphas, critic_batches or None

    def _draw_alpha(self, rng: torch.Generator) -> torch.Tensor:
        """One penalty uniform a frame: float32, or on the grid k/128 that
        ``jax.random.uniform`` draws in bfloat16 (its 7 mantissa bits): the
        kernel route's for the outer batch cast to bf16, as the reference's
        ε takes the stored batch's dtype."""
        if (self.critic_route == "kernel" and self.act_dtype == torch.bfloat16
                and not self.loss_cfg.fresh_critic_batches):
            k = torch.randint(0, 128, (self.batch_size,), generator=rng, device=rng.device,
                              dtype=torch.float32)
            return k.mul_(1.0 / 128)
        return torch.rand((self.batch_size,), generator=rng, device=rng.device)

    def __call__(self, rng: torch.Generator) -> Dict[str, torch.Tensor]:
        """Draw the step's batch(es) and penalty uniforms from ``rng``, then run it."""
        with spans.step():
            return self.run(*self.draw(rng))

    def forward(self, noisy: torch.Tensor) -> torch.Tensor:
        """The generator's training forward (with a flat premap, the dense
        matrices are built at each call: once per loss)."""
        if self.flat is not None:
            pre = self.flat.gen_premap
            fwd = functools.partial(self.flat.gen_apply,
                                    self.generator if pre is None else pre(self.generator))
        elif self.gen_forward is None:
            fwd = self.generator
        else:
            fwd = functools.partial(self.gen_forward, self.generator)
        return _recomputed(fwd)(noisy) if self.remat else fwd(noisy)

    def critic_applies(self):
        """The critic as the step applies it, and the penalty chain's critic
        (``None``: the same); a flat premap is built here, once per loss."""
        gp = None
        if self.flat is not None:
            pre = self.flat.critic_premap
            d = self.critic if pre is None else pre(self.critic)
            fwd = functools.partial(self.flat.critic_apply, d)
            if self.flat.critic_apply_gp is not None:
                gp = functools.partial(self.flat.critic_apply_gp, d)
        elif self.critic_forward is None:
            fwd = self.critic
        else:
            fwd = functools.partial(self.critic_forward, self.critic)
        if self.remat:
            return _recomputed(fwd), gp and _recomputed(gp)
        return fwd, gp

    def critic_apply(self) -> Callable:
        """The critic as the step applies it."""
        return self.critic_applies()[0]

    def critic_update(self, batch, alpha: torch.Tensor, fake: Optional[torch.Tensor] = None):
        """One critic update on ``batch``; returns its metrics and the fake
        it read. ``fake`` is the generator's no-grad forward of the batch's
        noisy frames, computed here when not given (on ``forward_route``)."""
        with spans.span("step.critic"):
            if fake is None and self.forward_route == "kernel":
                fake = generator_kernel.generator_forward(self.generator, batch["noisy"])
            elif fake is None:
                with torch.no_grad():
                    fake = self.forward(batch["noisy"])
            if self.critic_route == "kernel":
                # the stored batch and the generator's float32 output, uncast
                # (reference wgan_gp.py:340-349); critic_loss_fn's cast of fake
                # to the batch's format is the autograd route's
                noisy, clean = batch["noisy"], batch["clean"]
                if self.flat is not None:   # the kernel reads [B, L, 2] frames
                    noisy, clean, fake = (t.reshape(t.shape[0], -1, 2)
                                          for t in (noisy, clean, fake))
                grads, aux = critic_kernel.critic_grad(
                    self.critic, clean, fake, noisy, alpha, self.loss_cfg.gp_weight,
                    self.critic.leaky_slope, bf16=self.matmul_precision == "bfloat16")
                grads = [grads[name] for name, _ in self.critic.named_parameters()]
            else:
                critic, critic_gp = self.critic_applies()
                # a penalty chain of its own takes precedence over the mixed
                # modes' context (reference wgan_gp.py:92-98)
                gp_context = (contextlib.nullcontext if critic_gp is not None
                              else functools.partial(gp_precision, self.matmul_precision))
                loss, aux = critic_loss_fn(critic, lambda _: fake, batch, alpha, self.loss_cfg,
                                           gp_context, self.shard.frame_sum if self.shard else None,
                                           critic_gp, self.fuse_realfake)
                grads = torch.autograd.grad(loss, list(self.critic.parameters()))
            if self.shard is not None:
                grads, aux = self.shard.reduce(self.critic, grads, aux)
            _apply_grads(self.critic, self.opt_d, grads, self.flat_params)
            return aux, fake

    def run(self, batch0, alphas: List[torch.Tensor],
            critic_batches: Optional[List[dict]] = None) -> Dict[str, torch.Tensor]:
        """The step from given draws: the outer batch, one ``alpha`` ``[B]``
        per critic update and, with ``fresh_critic_batches``, one batch per
        critic update. Returns the last critic update's metrics and the
        generator's, as 0-d tensors. ``act_dtype`` casts the outer batch
        alone, as the reference does. Without critic batches the first
        update's fake serves every update (see the module's docstring)."""
        if len(alphas) != self.loss_cfg.n_critic:
            raise ValueError(f"expected {self.loss_cfg.n_critic} alphas, got {len(alphas)}")
        device = batch0["noisy"].device
        if self.act_dtype is not None:
            batch0 = {**batch0, "noisy": batch0["noisy"].to(self.act_dtype),
                      "clean": batch0["clean"].to(self.act_dtype)}
        zero = torch.zeros((), device=device)
        d_aux = {k: zero for k in METRIC_KEYS[:5]}
        with spans.step(), matmul_precision(self.matmul_precision):
            fake = None
            for i, alpha in enumerate(alphas):
                if critic_batches:
                    d_aux, _ = self.critic_update(critic_batches[i], alpha)
                else:
                    d_aux, fake = self.critic_update(batch0, alpha, fake)
            del fake   # not held beside the generator update's allocations
            with spans.span("step.generator"):
                if self.generator_route == "kernel":
                    grads, g_aux = generator_kernel.generator_grad(
                        self.generator, self.critic, batch0["clean"], batch0["noisy"],
                        self.loss_cfg.adv_weight, self.loss_cfg.rec_weight)
                    g_grads = [grads[name] for name, _ in self.generator.named_parameters()]
                else:
                    g_loss, g_aux = generator_loss_fn(
                        self.forward, self.critic_apply(), batch0, self.loss_cfg,
                        self.shard.mean if self.shard else torch.mean)
                    g_grads = torch.autograd.grad(g_loss, list(self.generator.parameters()))
                if self.shard is not None:
                    g_grads, g_aux = self.shard.reduce(self.generator, g_grads, g_aux)
                _apply_grads(self.generator, self.opt_g, g_grads, self.flat_params)
        return {**d_aux, **g_aux}


build_train_step = TrainStep  # the reference's name for the step builder


def _rec_metrics(generator: nn.Module, batch) -> Dict[str, torch.Tensor]:
    err = generator(batch["noisy"]) - batch["clean"]
    return {"rec_loss": err.abs().mean(), "mse": (err ** 2).mean()}


def make_eval_step(generator: nn.Module, dg_cfg: DatagenConfig, batch_size: int,
                   batch_fn: Optional[Callable[[torch.Generator, int], dict]] = None):
    """Validation metrics on a fresh batch (reference train.py:370-409), from
    the FFT datagen or ``batch_fn``. ``eval_step(rng, ema)`` also evaluates
    the generator ``ema`` on the same batch, as ``rec_loss_ema``/``mse_ema``
    (reference trainer.py:502-515)."""

    @torch.no_grad()
    def eval_step(rng: torch.Generator, ema: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
        batch = (batch_fn(rng, batch_size) if batch_fn is not None
                 else synthetic_batch(rng, batch_size, dg_cfg))
        out = _rec_metrics(generator, batch)
        if ema is not None:
            out.update({f"{k}_ema": v for k, v in _rec_metrics(ema, batch).items()})
        return out

    return eval_step
