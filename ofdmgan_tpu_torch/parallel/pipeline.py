"""Pipeline parallelism over the ``pp`` axis: the GPipe schedule of the full
U-Net in two stages.

Counterpart of ``ofdmgan_tpu/parallel/pipeline.py:53-272``. The generator
splits at its natural seam, ``FullUNetGenerator.encode`` (the strided
encoder, stage 0) | ``decode`` (the bottleneck and the decoder, stage 1);
the payload between them is the skip pyramid (the bottleneck's input is the
last skip), flattened into one ``[mb, P]`` buffer per microbatch. The JAX
package runs the schedule as a scan of ``ppermute``s and gets the backward
schedule from ``jax.grad``; here it is written out with ``send``/``recv``:

* forward: stage 0 encodes microbatch 0, 1, ..., M - 1 and sends each
  payload on; stage 1 receives each, decodes it and keeps the microbatch's
  L1 loss over M;
* backward, mirrored (M - 1 down to 0): stage 1 backpropagates each loss
  into its decoder's gradients and into the payload, and sends the
  payload's gradient back; stage 0 backpropagates it through its encoder;
* the per-stage gradients are summed over ``pp`` (each stage holds only its
  own layers' gradients; the reference's ``psum``, ``pipeline.py:160-167``),
  as is the loss, so both stages apply the same update and stay replicated.

``remat`` recomputes each stage's forward in the backward
(``torch.utils.checkpoint``) instead of keeping every microbatch's
activations, the GPipe memory trade. Both stages draw the same global batch
(from generators seeded alike), through the datagen kernel where it covers
the configuration.

Scope, as the reference's: the supervised path (``n_critic 0``,
``adv_weight 0``) of the full U-Net; ``make_pp_trainstate_step`` raises for
an adversarial configuration.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import distributed
from .mesh import axis_group, axis_index, axis_size
from ..ops import datagen_kernel
from ..signal.datagen import DatagenConfig, synthetic_batch
from ..training.wgan_gp import METRIC_KEYS, LossConfig


def unet_stage_fns(gen: nn.Module, frame_length: int) -> Tuple[List[Callable], int]:
    """The two stage functions ``f(buf [mb, P]) -> buf [mb, P]`` of a
    ``FullUNetGenerator`` and the buffers' width ``P``. Stage 0's input holds
    the flattened ``[L, 2]`` noisy frame, the payload the flattened skip
    pyramid (channels-first), stage 1's output the flattened ``[L, 2]``
    reconstruction; each padded to ``P``."""
    L = frame_length
    widths = [gen.enc1_1.out_channels * 2 ** i for i in range(gen.levels)]
    skip_shapes = [(widths[i], L // 2 ** (i + 1)) for i in range(gen.levels)]
    sizes = [c * n for c, n in skip_shapes]
    io = L * 2
    width = max(sum(sizes), io)

    def pad(flat):
        return torch.nn.functional.pad(flat, (0, width - flat.shape[1]))

    def stage_encode(buf):
        _, skips = gen.encode(buf[:, :io].reshape(buf.shape[0], L, 2))
        return pad(torch.cat([s.reshape(s.shape[0], -1) for s in skips], 1))

    def stage_decode(buf):
        skips, off = [], 0
        for (c, n), size in zip(skip_shapes, sizes):
            skips.append(buf[:, off:off + size].reshape(buf.shape[0], c, n))
            off += size
        y = gen.decode(skips[-1], skips)
        return pad(y.reshape(y.shape[0], -1))

    return [stage_encode, stage_decode], width


class PipelineStep:
    """One pipelined supervised update of ``make_pp_supervised_train_step``:
    ``step(rng)`` draws the global batch from ``rng`` (seeded alike on both
    stages), ``run(batch)`` takes the update on a given one; both return
    ``{"rec_loss"}``, the global L1, on every stage."""

    def __init__(self, gen: nn.Module, opt, dg_cfg: DatagenConfig, global_batch_size: int,
                 microbatches: int, mesh, remat: bool = False, grad_scale: float = 1.0):
        S, M, L = axis_size(mesh, "pp"), microbatches, dg_cfg.frame_length
        if global_batch_size % M:
            raise ValueError(f"global_batch_size {global_batch_size} not divisible "
                             f"by microbatches {M}")
        stages, self.width = unet_stage_fns(gen, L)
        if len(stages) != S:
            raise ValueError(f"pp={S} but the U-Net splits into {len(stages)} stages "
                             f"(pp mesh axis must match)")
        self.gen, self.opt, self.dg_cfg = gen, opt, dg_cfg
        self.batch_size, self.microbatches, self.grad_scale = global_batch_size, M, grad_scale
        self.stage = axis_index(mesh, "pp")
        self.group = axis_group(mesh, "pp")
        self.peer = dist.get_global_rank(self.group, 1 - self.stage)
        fn = stages[self.stage]
        self.fn = (lambda x: checkpoint(fn, x, use_reentrant=False)) if remat else fn
        self.datagen_route = "kernel" if datagen_kernel.covers(dg_cfg) else "plain"

    def draw_batch(self, rng: torch.Generator) -> Dict[str, torch.Tensor]:
        if self.datagen_route == "kernel":
            return datagen_kernel.synthetic_batch(rng, self.batch_size, self.dg_cfg)
        return synthetic_batch(rng, self.batch_size, self.dg_cfg)

    def __call__(self, rng: torch.Generator) -> Dict[str, torch.Tensor]:
        return self.run(self.draw_batch(rng))

    def run(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        noisy, clean = batch["noisy"], batch["clean"]
        M, L = self.microbatches, self.dg_cfg.frame_length
        mb = self.batch_size // M
        params = list(self.gen.parameters())
        for p in params:
            p.grad = None
        device = noisy.device
        loss = torch.zeros((), device=device)
        if self.stage == 0:
            outs = []
            for x in noisy.chunk(M):
                out = self.fn(torch.nn.functional.pad(x.reshape(mb, 2 * L),
                                                      (0, self.width - 2 * L)))
                distributed.send(out, self.peer, self.group)
                outs.append(out)
            for m in reversed(range(M)):
                grad = distributed.recv((mb, self.width), outs[m].dtype, device, self.peer,
                                        self.group)
                torch.autograd.backward(outs[m], grad)
        else:
            payloads, losses = [], []
            for c in clean.chunk(M):
                buf = distributed.recv((mb, self.width), noisy.dtype, device, self.peer,
                                       self.group).requires_grad_(True)
                y = self.fn(buf)[:, :2 * L].reshape(mb, L, 2)
                payloads.append(buf)
                losses.append((y - c).abs().mean() / M)
            for m in reversed(range(M)):
                losses[m].backward()
                distributed.send(payloads[m].grad, self.peer, self.group)
            loss = torch.stack(losses).detach().sum()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
        distributed.all_reduce(flat, self.group)
        if self.grad_scale != 1.0:
            flat[:-1].mul_(self.grad_scale)
        off = 0
        for p in params:
            p.grad = flat[off:off + p.numel()].view(p.shape)
            off += p.numel()
        self.opt.step()
        return {"rec_loss": flat[-1]}


def make_pp_supervised_train_step(gen: nn.Module, opt, dg_cfg: DatagenConfig,
                                  global_batch_size: int, microbatches: int, mesh,
                                  remat: bool = False) -> PipelineStep:
    """One pipelined supervised (L1) update of ``gen`` with ``opt`` (any
    optimizer over ``gen``'s parameters) over the mesh's ``pp`` axis; every
    stage holds the whole generator and updates all of it."""
    return PipelineStep(gen, opt, dg_cfg, global_batch_size, microbatches, mesh, remat)


class PipelineTrainStep:
    """The trainer's pipeline step (``--strategy pp``): optimizes
    ``rec_weight * L1`` and returns the adversarial metric schema with the
    critic's entries zero, as the single-device ``n_critic = 0`` step."""

    critic_route, generator_route, forward_route = "plain", "plain", "plain"
    matmul_precision = "float32"

    def __init__(self, pipe: PipelineStep, loss_cfg: LossConfig):
        self.pipe, self.loss_cfg = pipe, loss_cfg
        self.datagen_route = pipe.datagen_route

    def set_optimizers(self, opt_g, opt_d) -> None:
        self.pipe.opt = opt_g

    def __call__(self, rng: torch.Generator) -> Dict[str, torch.Tensor]:
        rec = self.pipe(rng)["rec_loss"]
        zero = torch.zeros((), device=rec.device)
        return {**{k: zero for k in METRIC_KEYS[:5]}, "g_loss": self.loss_cfg.rec_weight * rec,
                "adv_loss": zero, "rec_loss": rec}


def make_pp_trainstate_step(gen: nn.Module, opt_g, dg_cfg: DatagenConfig, loss_cfg: LossConfig,
                            global_batch_size: int, microbatches: int, mesh,
                            remat: bool = False) -> PipelineTrainStep:
    """The trainer's pipelined step. Supervised only, as the reference's
    (``pipeline.py:233-240``): an adversarial configuration raises."""
    if loss_cfg.n_critic != 0 or loss_cfg.adv_weight != 0.0:
        raise ValueError(
            "strategy='pp' trains the SUPERVISED path only (--n_critic 0 --adv_weight 0): "
            "adversarial WGAN-GP training is not pipelined; use --strategy shard_map (dp) or "
            f"gspmd (dp/tp/sp) for GAN recipes (got n_critic={loss_cfg.n_critic}, "
            f"adv_weight={loss_cfg.adv_weight})")
    pipe = PipelineStep(gen, opt_g, dg_cfg, global_batch_size, microbatches, mesh, remat,
                        grad_scale=float(loss_cfg.rec_weight))
    return PipelineTrainStep(pipe, loss_cfg)
