"""One global CWGAN-GP step over a ``dp`` x ``tp`` x ``sp`` mesh.

Counterpart of ``ofdmgan_tpu/parallel/gspmd.py:48-191``. There, parameters
carry shardings, the batch is constrained to ``P("dp", sp)``, and XLA's
GSPMD partitioner inserts every collective into one jitted global function.
Torch has no partitioner, so this module writes the collectives the
partitioner would insert, and the step computes the same global function as
the single-device step on the same draws, on any layout:

* **data**: every rank draws the *global* batch (and the penalty's
  uniforms) from one generator seeded alike on every rank, and keeps its
  shard: the ``dp`` slice of the frames and, under ``sp``, its ``sp`` slice
  of their length. The gradients and metrics are averaged over ``dp`` before
  each update (``mesh.MeshShard``).
* **dp**: replicated parameters; with the mini pair the routes stay by
  scope, so each rank runs the datagen kernel on the global batch and the
  critic-gradient kernel on its shard.
* **tp**: Megatron channel sharding of the full U-Net generator by the
  reference's rule (``models/full_unet.unet_param_shardings``): each rank
  holds its shard of the sharded parameters and their Adam moments.
  Column-parallel convolutions take a replicated input through ``f``
  (identity forward, sum over ``tp`` backward); row-parallel ones sum their
  partial outputs through ``g`` (sum forward, identity backward) and add the
  replicated bias after it. ``f``'s backward is ``g`` and ``g``'s is ``f``,
  so the penalty's double backward goes through them too. The critic is
  replicated, as the reference's trainer leaves it. The fused decoder's
  ``dec*_1`` (two k = 2 convolutions of the un-upsampled input,
  ``models/unet_infer.py``) is column-parallel like the layer it fuses:
  both halves are built from the rank's output channels of the kernel and
  each takes its input through ``f``.
* **sp**: the length axis of every ``[B, C, L]`` activation of both models
  (the full pair or the mini pair) is sharded. Each convolution first
  takes its halo from the neighbouring ranks (its left padding in samples
  on the left and ``kernel - stride - left`` on the right: one and one at
  k = 3, stride 1; the left one alone for the stride-2 convolutions; one
  on the left or the right for the fused decoder's k = 2 halves), zeros at
  the frame's ends; the upsamplers and the fused decoder's interleave are
  local. The critic's sum over length, the penalty's per-frame sum of
  squares and the L1 term's mean are summed over ``sp`` through ``g``.
  The halo exchange's backward is its adjoint (each halo's gradient
  returned to its owner and added), whose backward is the exchange again,
  so every backward is itself differentiable. Every convolution parameter
  then holds a partial gradient, summed over ``sp`` before the ``dp`` mean.
  The critic kernel needs whole frames, and the reference's GSPMD step
  never calls it: under ``sp`` the critic's gradient is autograd's.

Quantization (``--quant_bits``): the reference's step is one global
program, so the per-tensor activation scale of its quantized U-Net
(``fake_quantize_auto``) is the largest magnitude over the global batch
and the whole frame, and a row-parallel kernel's per-output-channel weight
scale is taken over all its input channels. Each rank here holds a shard,
so the generator's ``amax`` hook all-reduces each local maximum (MAX,
``distributed.all_reduce``): an activation's over ``dp`` and ``sp`` always,
and over ``tp`` after a column-parallel layer (whose output is sharded by
channel); a row-parallel kernel's over ``tp``. The Q1.7/Q8.8 steps of the
mini pair's ``qat`` are fixed and need no collective. The data-parallel
step of ``parallel/mesh.py`` keeps its per-replica scales, as the
reference's ``shard_map`` step does.

``act_dtype``: the reference's trainer builds its GSPMD step without the
setting (``trainer.py:323-330``), so its batch is never cast to the
storage format. The trainer here passes none either: the full U-Net's
GSPMD step computes the same function with and without the flag, the mini
pair keeps the storage of its own modules, and the fused decoder the
storage of its apply, as there.

The reference's refusals are kept: a tensor-sharded kernel under ``sp``
raises (``gspmd.py:89-116``): the JAX package refuses sp x tp because XLA's
SPMD partitioner miscompiles those convolutions; torch has no such
partitioner, and the port refuses it only because the JAX package does,
adding no feature the JAX package lacks; ``tp`` needs the full U-Net (its
rule keys on the U-Net's layer names). The trainer's refusals
(``trainer.py:291-320``) are in ``training/trainer.py``.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from . import distributed
from .distributed import CopyToGroup, ReduceFromGroup
from .mesh import MeshShard, axis_group, axis_index, axis_size
from ..models.full_unet import TP_COLUMN, TP_ROW, FullUNetGenerator
from ..models.generator import conv1d_padded
from ..signal.datagen import DatagenConfig
from ..training.schedules import AdamStepLR
from ..training.wgan_gp import LossConfig, TrainStep

SP_TP_REFUSAL = ("sp x tp training is disabled: the JAX package refuses tp-sharded conv "
                 "kernels under an sp axis (XLA's SPMD partitioner miscompiles them), and the "
                 "port keeps its refusals. Use dp x sp or dp x tp")


def _neighbours(group):
    return dist.get_rank(group), dist.get_world_size(group)


def halo_exchange(h: torch.Tensor, left: int, right: int, group) -> torch.Tensor:
    """``[..., left + L + right]``: the local ``[..., L]`` piece of a length
    axis split in order over ``group``, with the left neighbour's last
    ``left`` samples before it and the right neighbour's first ``right``
    after it (zeros at the ends of the whole axis)."""
    r, n = _neighbours(group)
    L = h.shape[-1]
    got = distributed.all_gather(torch.cat([h[..., L - left:], h[..., :right]], -1), group)
    lh = got[r - 1][..., :left] if r > 0 else h.new_zeros(*h.shape[:-1], left)
    rh = got[r + 1][..., left:] if r < n - 1 else h.new_zeros(*h.shape[:-1], right)
    return torch.cat([lh, h, rh], -1)


def halo_adjoint(g: torch.Tensor, left: int, right: int, group) -> torch.Tensor:
    """The adjoint of ``halo_exchange``: each halo's gradient returned to the
    rank whose samples it was and added to theirs."""
    r, n = _neighbours(group)
    L = g.shape[-1] - left - right
    got = distributed.all_gather(torch.cat([g[..., :left], g[..., left + L:]], -1), group)
    out = g[..., left:left + L].clone()
    if r < n - 1:
        out[..., L - left:] += got[r + 1][..., :left]
    if r > 0:
        out[..., :right] += got[r - 1][..., left:]
    return out


class HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, left, right, group):
        ctx.args = (left, right, group)
        return halo_exchange(h, left, right, group)

    @staticmethod
    def backward(ctx, grad):
        return HaloAdjoint.apply(grad, *ctx.args), None, None, None


class HaloAdjoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, left, right, group):
        ctx.args = (left, right, group)
        return halo_adjoint(g, left, right, group)

    @staticmethod
    def backward(ctx, grad):
        return HaloExchange.apply(grad, *ctx.args), None, None, None


# ------------------------------------------------------------ sharded layers
def tp_conv(spec: Dict[str, Optional[int]], group, name: str, h: torch.Tensor,
            w: torch.Tensor, b: torch.Tensor, stride: int, pads) -> torch.Tensor:
    """Layer ``name``'s convolution (this rank's shard ``w``, ``b`` of its
    parameters, ``pads`` its (left, right) zero padding) under ``spec``:
    column-parallel (a replicated input, a channel-sharded output),
    row-parallel (a channel-sharded or replicated input, a replicated
    output) or replicated."""
    mode = spec.get(f"{name}.weight")
    if mode == TP_COLUMN:
        if h.shape[1] != w.shape[1]:
            raise ValueError(f"{name}: a column-parallel layer needs a replicated input")
        return conv1d_padded(CopyToGroup.apply(h, group), w, b, stride, pads)
    if mode == TP_ROW:
        if h.shape[1] != w.shape[1]:   # a replicated input: this rank's channels of it
            rank, size = _neighbours(group)
            h = CopyToGroup.apply(h, group).chunk(size, 1)[rank]
        return ReduceFromGroup.apply(conv1d_padded(h, w, None, stride, pads), group) + b[:, None]
    if h.shape[1] != w.shape[1]:
        raise ValueError(f"{name}: a replicated layer needs a replicated input")
    return conv1d_padded(h, w, b, stride, pads)


def sp_conv(group, name: str, h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int,
            pads) -> torch.Tensor:
    """Layer ``name``'s convolution on this rank's piece of the length
    axis, its halo first."""
    if h.shape[-1] % stride:
        raise ValueError(f"{name}: a piece of {h.shape[-1]} samples at stride {stride}")
    left = pads[0]
    ext = HaloExchange.apply(h, left, max(0, w.shape[-1] - stride - left), group)
    return F.conv1d(ext, w, b, stride, 0)


def _set_param(module: nn.Module, name: str, value: torch.Tensor) -> None:
    owner, leaf = name.rsplit(".", 1)
    setattr(module.get_submodule(owner), leaf, nn.Parameter(value))


def _shard(t: torch.Tensor, dim: Optional[int], index: int, size: int) -> torch.Tensor:
    return t if dim is None else t.chunk(size, dim)[index]


def shard_module(module: nn.Module, spec: Dict[str, Optional[int]], index: int,
                 size: int) -> nn.Module:
    """A copy of ``module`` holding shard ``index`` of ``size`` of each
    parameter ``spec`` shards."""
    local = copy.deepcopy(module)
    for name, p in list(local.named_parameters()):
        if spec.get(name) is not None:
            _set_param(local, name, _shard(p.detach(), spec[name], index, size).clone())
    return local


def _adam_like(opt: AdamStepLR, params) -> AdamStepLR:
    """An empty ``AdamStepLR`` over ``params`` with ``opt``'s settings and
    schedule position."""
    new = AdamStepLR(params, opt.opt.param_groups[0]["lr"], opt.opt.param_groups[0]["betas"],
                     opt.sched.step_size if opt.sched else None,
                     opt.sched.gamma if opt.sched else 0.5)
    if opt.sched is not None:
        new.sched.load_state_dict(opt.sched.state_dict())
    new.opt.param_groups[0].update({k: v for k, v in opt.opt.param_groups[0].items()
                                    if k != "params"})
    return new


def _copy_state(src_opt, dst_opt, pairs, fn) -> None:
    """Adam's state of each ``(src, dst)`` parameter pair, each tensor
    through ``fn(tensor, name)``."""
    for name, p_src, p_dst in pairs:
        st = src_opt.state.get(p_src)
        if st:
            dst_opt.state[p_dst] = {k: (fn(v, name) if isinstance(v, torch.Tensor) and v.ndim
                                        else (v.clone() if isinstance(v, torch.Tensor) else v))
                                    for k, v in st.items()}


class GSPMDTrainStep:
    """The global step of ``make_gspmd_train_step``: ``step(rng)`` draws the
    global batch and uniforms from ``rng`` (seeded alike on every rank) and
    takes the step on this rank's shard; ``run(batch, alphas, ...)`` takes
    it on given global draws. ``local_generator`` is this rank's generator
    (shards under ``tp``), ``gather_into`` writes the full
    state back into full modules and optimizers, and ``place`` re-shards a
    full state (a resume or warm start). Other attributes are the inner
    ``TrainStep``'s."""

    def __init__(self, generator: nn.Module, critic: nn.Module, opt_g: AdamStepLR,
                 opt_d: AdamStepLR, dg_cfg: DatagenConfig, loss_cfg: LossConfig,
                 global_batch_size: int, mesh, gen_tp_rule: Optional[Callable] = None,
                 **step_kw):
        self.mesh = mesh
        self.dp, self.tp, self.sp = (axis_size(mesh, a) for a in ("dp", "tp", "sp"))
        self.dp_index, self.tp_index, self.sp_index = (axis_index(mesh, a)
                                                       for a in ("dp", "tp", "sp"))
        if global_batch_size % self.dp:
            raise ValueError(f"global batch {global_batch_size} not divisible by dp={self.dp}")
        if dg_cfg.frame_length % self.sp:
            raise ValueError(f"frame length {dg_cfg.frame_length} not divisible by sp={self.sp}")
        self.spec = (gen_tp_rule(generator, self.tp)
                     if gen_tp_rule is not None and self.tp > 1 else {})
        sharded = any(d is not None for d in self.spec.values())
        if sharded and self.sp > 1:
            raise ValueError(SP_TP_REFUSAL)
        if self.tp > 1 and not isinstance(generator, FullUNetGenerator):
            raise ValueError("tensor_parallel > 1 requires the full U-Net family (--model full): "
                             "the Megatron sharding rule keys on its layer names")
        self.tp_group, self.sp_group = axis_group(mesh, "tp"), axis_group(mesh, "sp")
        self.dp_group = axis_group(mesh, "dp")
        if sharded:
            self.local_generator = shard_module(generator, self.spec, self.tp_index, self.tp)
            opt_g_local = _adam_like(opt_g, self.local_generator.parameters())
        else:
            self.local_generator, opt_g_local = generator, opt_g
        self.full_generator = generator
        conv_fn = self._tp_conv if sharded else self._sp_conv if self.sp > 1 else None
        gen_kw = {} if conv_fn is None else {"conv_fn": conv_fn}
        if getattr(generator, "weight_bits", 0) or getattr(generator, "act_bits", 0):
            gen_kw["amax"] = self._amax
        forward = step_kw.get("gen_forward")
        if gen_kw:
            step_kw["gen_forward"] = (lambda g, x: forward(g, x, **gen_kw)) if forward else \
                (lambda g, x: g(x, **gen_kw))
        if self.sp > 1:
            step_kw["critic_forward"] = lambda c, a, b: c(a, b, conv_fn=self._sp_conv,
                                                          pool=self._sp_pool)
        self.step = TrainStep(self.local_generator, critic, opt_g_local, opt_d, dg_cfg,
                              loss_cfg, global_batch_size,
                              shard=MeshShard(mesh, (self.local_generator, critic)),
                              **step_kw)
        if sharded:
            self.place(generator, opt_g)

    def set_optimizers(self, opt_g: AdamStepLR, opt_d: AdamStepLR) -> None:
        """Train with these optimizers' states (re-sharded under ``tp``, with
        the full generator's current parameters)."""
        self.step.opt_d = opt_d
        if self.local_generator is self.full_generator:
            self.step.opt_g = opt_g
        else:
            self.place(self.full_generator, opt_g)

    def _tp_conv(self, name, h, w, b, stride, pads):
        return tp_conv(self.spec, self.tp_group, name, h, w, b, stride, pads)

    def _sp_conv(self, name, h, w, b, stride, pads):
        return sp_conv(self.sp_group, name, h, w, b, stride, pads)

    def _sp_pool(self, pooled):
        return ReduceFromGroup.apply(pooled, self.sp_group)

    def _amax(self, m: torch.Tensor, name: str) -> torch.Tensor:
        """The global maximum of the quantized generator's local maximum
        ``m`` of ``name`` (see the module's docstring)."""
        if name.endswith(".weight"):
            groups = [self.tp_group] if self.spec.get(name) == TP_ROW else []
        else:
            groups = [self.dp_group, self.sp_group]
            if self.spec.get(f"{name}.weight") == TP_COLUMN:
                groups.append(self.tp_group)
        for group in groups:
            if group is not None and dist.get_world_size(group) > 1:
                distributed.all_reduce(m, group, op="max")
        return m

    def local(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's shard of a global batch: its ``dp`` slice of the
        frames and, under ``sp``, its ``sp`` slice of their length."""
        out = {}
        for k, v in batch.items():
            v = v.chunk(self.dp, 0)[self.dp_index]
            if v.ndim == 3 and self.sp > 1:
                v = v.chunk(self.sp, 1)[self.sp_index]
            out[k] = v.contiguous()
        return out

    def __call__(self, rng: torch.Generator) -> Dict[str, torch.Tensor]:
        return self.run(*self.step.draw(rng))

    def run(self, batch0, alphas, critic_batches=None) -> Dict[str, torch.Tensor]:
        alphas = [a.chunk(self.dp)[self.dp_index].contiguous() for a in alphas]
        return self.step.run(self.local(batch0), alphas,
                             [self.local(b) for b in critic_batches] if critic_batches else None)

    def place(self, generator: nn.Module, opt_g: AdamStepLR) -> None:
        """This rank's shards of ``generator``'s parameters and of
        ``opt_g``'s state and schedule position (no-op without tensor
        sharding: the step trains ``generator`` itself)."""
        if self.local_generator is generator:
            return
        local_opt = self.step.opt_g
        with torch.no_grad():
            full = dict(generator.named_parameters())
            for name, p in self.local_generator.named_parameters():
                p.copy_(_shard(full[name].detach(), self.spec.get(name), self.tp_index, self.tp))
        local_opt.opt.state.clear()
        _copy_state(opt_g.opt, local_opt.opt, self._pairs(generator, full_first=True),
                    lambda v, n: _shard(v, self.spec.get(n), self.tp_index, self.tp).clone())
        if opt_g.sched is not None:
            local_opt.sched.load_state_dict(opt_g.sched.state_dict())
        local_opt.opt.param_groups[0]["lr"] = opt_g.opt.param_groups[0]["lr"]

    def gather_into(self, generator: nn.Module, opt_g: AdamStepLR) -> None:
        """The full parameters, Adam state and schedule position of the
        tensor-sharded generator into ``generator`` and ``opt_g`` on every
        rank (no-op without tensor sharding)."""
        if self.local_generator is generator:
            return

        def gather(v, name):
            dim = self.spec.get(name)
            if dim is None:
                return v.clone()
            return torch.cat(list(distributed.all_gather(v, self.tp_group).unbind(0)), dim)

        with torch.no_grad():
            full = dict(generator.named_parameters())
            for name, p in self.local_generator.named_parameters():
                full[name].copy_(gather(p.detach(), name))
        _copy_state(self.step.opt_g.opt, opt_g.opt, self._pairs(generator, full_first=False),
                    gather)
        if opt_g.sched is not None:
            opt_g.sched.load_state_dict(self.step.opt_g.sched.state_dict())
        opt_g.opt.param_groups[0]["lr"] = self.step.opt_g.opt.param_groups[0]["lr"]

    def _pairs(self, generator, full_first: bool):
        full = dict(generator.named_parameters())
        return [(n, full[n], p) if full_first else (n, p, full[n])
                for n, p in self.local_generator.named_parameters()]

    def __getattr__(self, name):
        if "step" not in self.__dict__:   # while unpickling or copying
            raise AttributeError(name)
        return getattr(self.step, name)


def make_gspmd_train_step(generator: nn.Module, critic: nn.Module, opt_g: AdamStepLR,
                          opt_d: AdamStepLR, dg_cfg: DatagenConfig, loss_cfg: LossConfig,
                          global_batch_size: int, mesh,
                          gen_tp_rule: Optional[Callable] = None, **step_kw) -> GSPMDTrainStep:
    """The global step over ``mesh`` (axes ``dp``, ``tp``, ``sp``): every rank
    passes the same full ``generator``/``critic`` and optimizers;
    ``gen_tp_rule`` (e.g. ``unet_param_shardings``) shards the generator over
    ``tp``. ``step_kw`` are ``TrainStep``'s other settings. Raises for sp x
    tp as the reference does."""
    return GSPMDTrainStep(generator, critic, opt_g, opt_d, dg_cfg, loss_cfg, global_batch_size,
                          mesh, gen_tp_rule, **step_kw)
