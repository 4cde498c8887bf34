"""Rank functions of the port's parallel CPU tests.

Each function runs on every rank that ``parallel.distributed.launch`` spawns
(gloo on the CPU, one torch thread) and returns what its test compares. The
tests hand them the JAX side's weights, optimizer states and draws as numpy
arrays. Nothing here imports JAX: the spawned ranks import this module.
"""

import dataclasses
import functools
from unittest import mock

import numpy as np
import torch

from ofdmgan_tpu_torch.config import (Config, FullModelSection, GeneratorSection,
                                      TrainingSection)
from ofdmgan_tpu_torch.models import MiniDiscriminator, MiniGenerator
from ofdmgan_tpu_torch.models.full_unet import (FullDiscriminator, FullUNetGenerator,
                                                unet_param_shardings)
from ofdmgan_tpu_torch.parallel import (make_gspmd_train_step, make_mesh,
                                        make_pp_supervised_train_step, make_sharded_train_step)
from ofdmgan_tpu_torch.parallel import distributed
from ofdmgan_tpu_torch.parallel.distributed import ReduceFromGroup
from ofdmgan_tpu_torch.parallel import gspmd
from ofdmgan_tpu_torch.parallel.gspmd import halo_adjoint, halo_exchange, sp_conv
from ofdmgan_tpu_torch.parallel.mesh import MeshShard, axis_group, axis_index
from ofdmgan_tpu_torch.signal.datagen import DatagenConfig
from ofdmgan_tpu_torch.training.schedules import make_adam
from ofdmgan_tpu_torch.training.trainer import Trainer, build_models
from ofdmgan_tpu_torch.training.wgan_gp import LossConfig, critic_loss_fn
from ofdmgan_tpu_torch.utils.jax_params import from_jax_params, to_jax_params
from ofdmgan_tpu_torch.utils.params_io import flatten_tree

SMALL = dict(frame_length=64, levels=3, base_channels=8)
SMALL_FULL = dict(levels=3, base_channels=8)


def _t(tree):
    """numpy leaves -> tensors (a batch dict or a list of arrays)."""
    if isinstance(tree, dict):
        return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    return [torch.from_numpy(np.array(v)) for v in tree]


def _module(cls, tree, **kw):
    m = cls(**kw)
    m.load_state_dict(from_jax_params(tree))
    return m


def _adam(module, lr, state=None, into=None):
    """Adam over ``module`` (no schedule), or the optimizer ``into``, with
    the JAX side's moments and count where ``state = (mu, nu, count)`` is
    given."""
    opt = make_adam(module.parameters(), lr, (0.0, 0.9)) if into is None else into
    if state is not None:
        mu, nu, count = state
        mu, nu = from_jax_params(mu), from_jax_params(nu)
        for name, p in module.named_parameters():
            opt.opt.state[p] = {"step": torch.tensor(float(count)),
                                "exp_avg": mu[name].clone(), "exp_avg_sq": nu[name].clone()}
    return opt


def _result(g, d, opt_g, opt_d, metrics):
    moments = {}
    for tag, mod, opt in (("g", g, opt_g), ("d", d, opt_d)):
        for name, p in mod.named_parameters():
            st = opt.opt.state[p]
            moments[f"{tag}.{name}"] = (st["exp_avg"].numpy().copy(),
                                        st["exp_avg_sq"].numpy().copy())
    return {"params_g": flatten_tree(to_jax_params(g)), "params_d": flatten_tree(to_jax_params(d)),
            "metrics": {k: float(v) for k, v in metrics.items()}, "moments": moments}


def dp_and_pp(dp: dict, pp: dict) -> dict:
    """Rank 0's scalar read on every rank; the data-parallel mini step on
    ``{dp: 2}``, each replica on its own JAX draws, on the kernel route and
    the reference route; the pipelined supervised update on ``{pp: 2}``
    with and without remat; the pipeline's refusal of a mesh without two
    stages."""
    out = {"scalar": distributed.process_local_scalar(distributed.rank() + 0.5)}
    mesh = make_mesh({"dp": 2})
    batch, alphas = dp["draws"][axis_index(mesh, "dp")]
    for reference in (False, True):
        g, d = _module(MiniGenerator, dp["pg"]), _module(MiniDiscriminator, dp["pd"])
        opt_g, opt_d = _adam(g, dp["lr"]), _adam(d, dp["lr"])
        step = make_sharded_train_step(g, d, opt_g, opt_d, DatagenConfig(),
                                       LossConfig(n_critic=dp["n_critic"]), dp["batch"], mesh,
                                       reference=reference)
        m = step.run(_t(batch), _t(alphas))
        out[("dp", reference)] = {**_result(g, d, opt_g, opt_d, m),
                                  "routes": (step.datagen_route, step.critic_route),
                                  "local_batch": step.batch_size}

    pp_mesh = make_mesh({"pp": 2})
    cfg = DatagenConfig(frame_length=64, nonlinear=True)
    for remat in (False, True):
        g = _module(FullUNetGenerator, pp["pg"], **SMALL)
        step = make_pp_supervised_train_step(g, torch.optim.SGD(g.parameters(), pp["lr"]), cfg,
                                             pp["batch"], pp["microbatches"], pp_mesh,
                                             remat=remat)
        m = step.run(_t(pp["draws"]))
        out[("pp", remat)] = {"params_g": flatten_tree(to_jax_params(g)),
                              "rec_loss": float(m["rec_loss"])}
    g = _module(FullUNetGenerator, pp["pg"], **SMALL)
    try:
        make_pp_supervised_train_step(g, torch.optim.SGD(g.parameters(), 1e-2), cfg, 16, 4,
                                      make_mesh({"dp": 2}))
    except ValueError as e:
        out["pp_refusal"] = str(e)
    return out


class _Identity(torch.autograd.Function):
    """A collective left out: identity forward and backward."""

    @staticmethod
    def forward(ctx, x, group):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _zero_halos(h, left, right, group):
    return torch.nn.functional.pad(h, (left, right))


def _no_sp_grad_sum(reduce):
    def without(self, module, grads, metrics):
        sp, self.sp = self.sp, 1
        try:
            return reduce(self, module, grads, metrics)
        finally:
            self.sp = sp
    return without


# each: (the leg it breaks, the attribute it replaces, its stand-in)
MUTATIONS = {
    "tp_without_f": ("full_tp", (gspmd, "CopyToGroup"), _Identity),
    "sp_without_halos": ("full_sp", (gspmd, "halo_exchange"), _zero_halos),
    "sp_without_grad_sum": ("full_sp", (MeshShard, "reduce"), _no_sp_grad_sum(MeshShard.reduce)),
}


def _gspmd_step(leg: dict, mesh) -> dict:
    """One global step from ``leg``'s warmed state on this rank's shard,
    the full state gathered back."""
    if leg["family"] == "mini":
        g, d = _module(MiniGenerator, leg["pg"]), _module(MiniDiscriminator, leg["pd"])
    else:
        g = _module(FullUNetGenerator, leg["pg"], **SMALL)
        d = _module(FullDiscriminator, leg["pd"], **SMALL)
    opt_g, opt_d = _adam(g, leg["lr"], leg["opt_g"]), _adam(d, leg["lr"], leg["opt_d"])
    step = make_gspmd_train_step(g, d, opt_g, opt_d,
                                 DatagenConfig(frame_length=leg["frame_length"]),
                                 LossConfig(n_critic=leg["n_critic"]), leg["batch"], mesh,
                                 gen_tp_rule=unet_param_shardings)
    batch, alphas = leg["draws"]
    m = step.run(_t(batch), _t(alphas))
    step.gather_into(g, opt_g)
    return {**_result(g, d, opt_g, opt_d, m),
            "local_shapes": {n: tuple(p.shape) for n, p in step.local_generator.named_parameters()},
            "routes": (step.datagen_route, step.critic_route)}


def gspmd_legs(legs: dict) -> dict:
    """Each leg of ``legs`` (name -> its mesh, family, warmed state and
    global draws): one global step from that state on this rank's shard,
    the full state gathered back; the ``gp`` leg holds the penalty's double
    backward under ``sp`` (the critic's gradient, summed over ``sp``). Then
    the tp and sp legs again, each with one collective left out
    (``MUTATIONS``)."""
    out = {}
    for name, leg in legs.items():
        mesh = make_mesh(leg["mesh"])
        out[name] = _sp_critic_grads(mesh, leg) if name == "gp" else _gspmd_step(leg, mesh)
    for name, (leg_name, (owner, attr), stand_in) in MUTATIONS.items():
        leg = legs[leg_name]
        with mock.patch.object(owner, attr, stand_in):
            out[name] = _gspmd_step(leg, make_mesh(leg["mesh"]))
    out["halo_adjoint"] = _halo_adjoint_identity()
    return out


def _sp_critic_grads(mesh, leg) -> dict:
    """The critic's loss and parameter gradients on this rank's piece of
    every frame (penalty through the halo exchanges and the sums over
    ``sp``), the convolutions' gradients summed over ``sp``."""
    d = _module(FullDiscriminator, leg["pd"], **SMALL)
    group, n = axis_group(mesh, "sp"), 2
    i = axis_index(mesh, "sp")
    batch = {k: v.chunk(n, 1)[i].contiguous() for k, v in _t(leg["batch"]).items()}
    fake = torch.from_numpy(leg["fake"]).chunk(n, 1)[i].contiguous()
    shard = MeshShard(mesh, (d,))

    def critic(a, b):
        return d(a, b, conv_fn=functools.partial(sp_conv, group),
                 pool=lambda t: ReduceFromGroup.apply(t, group))

    loss, aux = critic_loss_fn(critic, lambda x: fake, batch, torch.from_numpy(leg["alpha"]),
                               LossConfig(), frame_sum=shard.frame_sum)
    grads = torch.autograd.grad(loss, list(d.parameters()))
    grads, aux = shard.reduce(d, grads, aux)
    return {"grads": {n: g.numpy().copy() for (n, _), g in zip(d.named_parameters(), grads)},
            "loss": loss.item(), "metrics": {k: float(v) for k, v in aux.items()}}


def _halo_adjoint_identity() -> float:
    """<halo(x), y> - <x, adjoint(y)> summed over the ranks (zero where the
    adjoint is the exchange's transpose), at stride-1 and stride-2 halos."""
    world = distributed.world_size()
    group = None
    gen = torch.Generator().manual_seed(distributed.rank())
    worst = 0.0
    for left, right in ((1, 1), (1, 0), (2, 3)):
        x = torch.randn(3, 4, 8, generator=gen, dtype=torch.float64)
        y = torch.randn(3, 4, 8 + left + right, generator=gen, dtype=torch.float64)
        lhs = (halo_exchange(x, left, right, group) * y).sum()
        rhs = (x * halo_adjoint(y, left, right, group)).sum()
        diff = torch.stack([lhs - rhs])
        distributed.all_reduce(diff, group)
        worst = max(worst, abs(float(diff)) / world)
    return worst


# ------------------------------------------------------- trainer legs
def _trainer(leg: dict, **override):
    """A CPU trainer of ``leg``'s family under ``leg``'s mesh, its models
    built as the CLI builds them (``build_models``) with ``leg``'s warmed
    JAX parameters and Adam state; ``override`` replaces trainer settings."""
    kw = {**leg["trainer"], **override}
    L, mesh, gen = leg["frame_length"], leg["mesh"], dict(leg["gen"])
    residual = GeneratorSection(input_residual=gen.pop("input_residual", False))
    cfg = Config(frame_length=L, full=FullModelSection(**SMALL_FULL), generator=residual,
                 training=dataclasses.replace(TrainingSection(), batch_size=leg["batch"],
                                              n_critic=leg["n_critic"]),
                 export_after_training=False)
    g, d = build_models(cfg, leg["family"], 0, kw["act_dtype"], **gen)
    g.load_state_dict(from_jax_params(leg["pg"]))
    d.load_state_dict(from_jax_params(leg["pd"]))
    t = Trainer(cfg, samples_per_epoch=leg["batch"], val_samples=leg["batch"], device="cpu",
                generator=g, discriminator=d, strategy="gspmd",
                data_parallel=mesh.get("dp", 1), tensor_parallel=mesh.get("tp", 1),
                seq_parallel=mesh.get("sp", 1), **kw)
    for module, opt, state in ((t.generator, t.opt_g, leg["opt_g"]),
                               (t.critic, t.opt_d, leg["opt_d"])):
        _adam(module, leg["lr"], state, into=opt)
    t.step.set_optimizers(t.opt_g, t.opt_d)   # re-sharded under tp
    return t


def _trainer_step(leg: dict, **override) -> dict:
    """One global step of ``leg``'s trainer on its JAX draws, the full
    state gathered back; with the collectives' bytes and the routes."""
    t = _trainer(leg, **override)
    batch, alphas = leg["draws"]
    distributed.reset_traffic()
    m = t.step.run(_t(batch), _t(alphas))
    traffic = dict(distributed.traffic)
    t._gather_state()
    return {**_result(t.generator, t.critic, t.opt_g, t.opt_d, m),
            "routes": (t.step.datagen_route, t.step.critic_route),
            "step_act_dtype": t.step.act_dtype, "traffic": traffic}


def _local_max(self, m, name):
    return m


# each: (the leg it breaks, the attribute it replaces, its stand-in)
TRAINER_MUTATIONS = {
    "quant_local_max": ("full_dp_quant", (gspmd.GSPMDTrainStep, "_amax"), _local_max),
}


def _pp_updates(leg: dict) -> dict:
    """The pipelined supervised update from one state and seed, with and
    without ``act_dtype`` and ``matmul_precision``."""
    out = {}
    for name, kw in (("plain", {}), ("flags", dict(act_dtype="bfloat16",
                                                   matmul_precision="bfloat16"))):
        cfg = Config(frame_length=leg["frame_length"], full=FullModelSection(**SMALL_FULL),
                     training=dataclasses.replace(TrainingSection(), batch_size=leg["batch"],
                                                  n_critic=0, adversarial_weight=0.0),
                     export_after_training=False)
        g, d = build_models(cfg, "full", 0)
        g.load_state_dict(from_jax_params(leg["pg"]))
        t = Trainer(cfg, samples_per_epoch=leg["batch"], val_samples=leg["batch"],
                    device="cpu", generator=g, discriminator=d, strategy="pp",
                    pipeline_parallel=2, microbatches=4, **kw)
        m = t.step(torch.Generator().manual_seed(5))
        out[name] = {"params_g": flatten_tree(to_jax_params(t.generator)),
                     "rec_loss": float(m["rec_loss"])}
    return out


def _recorded_scales(leg: dict, amax) -> list:
    """``(name, maximum)`` of every quantization point of the GSPMD step's
    generator forward on this rank's shard of ``leg``'s batch, the maxima
    from ``amax(step, local_max, name)``."""
    seen = []

    def record(self, m, name):
        out = amax(self, m, name)
        seen.append((name, out.detach().reshape(-1).numpy().copy()))
        return out

    with mock.patch.object(gspmd.GSPMDTrainStep, "_amax", record):
        t = _trainer(leg)
    batch, _ = leg["draws"]
    with torch.no_grad():
        t.step.forward(t.step.local(_t(batch))["noisy"])
    return seen


def trainer_legs(legs: dict) -> dict:
    """Each GSPMD leg of ``legs`` through the trainer (one global step from
    its warmed state on this rank's shard), each with its trainer settings
    and, where a leg names ``also``, again with those settings replaced;
    then the legs ``TRAINER_MUTATIONS`` break; ``pp`` legs give the
    pipeline's update with and without the flags it ignores; a leg with
    ``scales`` also gives its quantized generator's maxima on this rank's
    shard (``_recorded_scales``), those of the mutations too."""
    out = {}
    for name, leg in legs.items():
        if leg.get("pp"):
            out[name] = _pp_updates(leg)
            continue
        out[name] = _trainer_step(leg)
        for alt, override in leg.get("also", {}).items():
            out[alt] = _trainer_step(leg, **override)
        if leg.get("scales"):
            out[f"{name}_scales"] = _recorded_scales(leg, gspmd.GSPMDTrainStep._amax)
    for name, (leg_name, (owner, attr), stand_in) in TRAINER_MUTATIONS.items():
        if leg_name in legs:
            with mock.patch.object(owner, attr, stand_in):
                out[name] = _trainer_step(legs[leg_name])
            if legs[leg_name].get("scales"):
                out[f"{name}_scales"] = _recorded_scales(legs[leg_name], stand_in)
    return out
