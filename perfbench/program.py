"""The system under test: the training step of ``ofdmgan_tpu_torch``, built
from its public entries as a cell's files say, and the draws it takes.

``Program`` makes the model pair of ``training.trainer.build_models``,
loads into it the weights the benchmark made from the seed, and builds
``training.schedules.make_adam`` for each net, ``training.wgan_gp.TrainStep``
with the cell's recipe and numerics, its generator (seeded from the run's
seed) and the chunk that the window calls: ``training.chunks.GraphedChunk``
(the optimizers holding their schedule on the device) or ``EagerChunk``.
It checks that the step takes the routes the cell names: a cell never times
another path than the one it states.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import torch

from .reference.models import param_shapes

RNG_OFFSET = 0x9E3779B97F4A7C15   # the step's generator's seed is the run's plus this


def make_weights(config: dict, seed: int,
                 device: torch.device) -> Dict[str, Dict[str, torch.Tensor]]:
    """The initial weights of a configuration's pair from ``seed``, on the
    device in one draw: every weight Xavier-uniform
    (``bound = sqrt(6 / (fan_in + fan_out))``, a conv's fans times its
    kernel size), every bias zero: the models' own initialisation."""
    shapes = param_shapes(config)
    weights = [(net, name, shape) for net in ("generator", "critic")
               for name, shape in shapes[net].items() if name.endswith(".weight")]
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(math.prod(s) for _, _, s in weights), generator=gen, device=device)
    out = {"generator": {}, "critic": {}}
    off = 0
    for net, name, shape in weights:
        n = math.prod(shape)
        k = shape[2] if len(shape) == 3 else 1
        bound = math.sqrt(6.0 / ((shape[0] + shape[1]) * k))
        out[net][name] = u[off:off + n].view(shape).mul(2.0).sub(1.0).mul(bound)
        off += n
    for net in out:
        for name, shape in shapes[net].items():
            if name.endswith(".bias"):
                out[net][name] = torch.zeros(shape, device=device)
    return {net: {name: out[net][name] for name in shapes[net]} for net in out}


def _port_config(config: dict):
    from ofdmgan_tpu_torch.config import (Config, DiscriminatorSection, FullModelSection,
                                          GeneratorSection)
    if config["family"] == "mini":
        g, d = config["generator"], config["critic"]
        return Config(frame_length=config["frame_length"],
                      generator=GeneratorSection(g["enc1_channels"], g["bottleneck_channels"],
                                                 g["dec1_channels"], g["leaky_slope"], False),
                      discriminator=DiscriminatorSection(d["conv1_channels"],
                                                         d["conv2_channels"], d["leaky_slope"]))
    return Config(frame_length=config["frame_length"],
                  full=FullModelSection(config["levels"], config["base_channels"]))


def datagen_config(config: dict, cell: dict):
    """The port's ``DatagenConfig`` for the cell's traffic, checked to hold
    every parameter the cell states."""
    from ofdmgan_tpu_torch.signal.datagen import DatagenConfig
    dg = cell["datagen"]
    kw = {}
    if dg["nonlinear"]:
        kw = dict(pa_saturation=dg["pa_saturation"], iq_imbalance_db=dg["iq_amplitude_db"],
                  iq_phase_deg=dg["iq_phase_deg"], phase_noise_dbchz=dg["phase_noise_dbchz"])
    cfg = DatagenConfig.make(frame_length=config["frame_length"], snr_range=tuple(dg["snr_db"]),
                             channel_type=dg["channel"], nonlinear=dg["nonlinear"], **kw)
    if dg["nonlinear"]:
        imp = cfg.impairments
        for key in ("pa_smoothness", "sample_rate"):
            if getattr(imp, key) != dg[key]:
                raise ValueError(f"the port's {key} is {getattr(imp, key)}, the cell's {dg[key]}")
    return cfg


class Program:
    """The port's model pair, optimizers, step, generator and chunk for
    ``cell`` on ``device``, from the weights ``weights``. ``precision``
    replaces the cell's ``matmul_precision`` (the lower-precision control)."""

    def __init__(self, config: dict, cell: dict, weights, seed: int, device: torch.device,
                 precision: str | None = None):
        from ofdmgan_tpu_torch.training.schedules import make_adam
        from ofdmgan_tpu_torch.training.trainer import build_models
        from ofdmgan_tpu_torch.training.wgan_gp import LossConfig, TrainStep

        self.config, self.cell = config, cell
        g, d = build_models(_port_config(config), config["family"], 0)
        self.generator, self.critic = g.to(device), d.to(device)
        for net, module in (("generator", self.generator), ("critic", self.critic)):
            params = dict(module.named_parameters())
            if {k: tuple(v.shape) for k, v in params.items()} != \
                    {k: tuple(v.shape) for k, v in weights[net].items()}:
                raise ValueError(f"the port's {net} does not have the configuration's parameters")
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(weights[net][name])
        r = cell["recipe"]
        self.opt_g, self.opt_d = (make_adam(m.parameters(), r["lr"], betas=tuple(r["betas"]))
                                  for m in (self.generator, self.critic))
        loss = LossConfig(n_critic=r["n_critic"], gp_weight=r["gp_weight"],
                          adv_weight=r["adv_weight"], rec_weight=r["rec_weight"])
        self.step = TrainStep(self.generator, self.critic, self.opt_g, self.opt_d,
                              datagen_config(config, cell), loss, cell["batch"],
                              matmul_precision=precision or cell["matmul_precision"],
                              use_pallas_critic=cell["critic_route"] == "kernel")
        routes = (self.step.datagen_route, self.step.critic_route)
        if routes != (cell["datagen"]["route"], cell["critic_route"]):
            raise RuntimeError(f"the step takes the routes {routes}, the cell names "
                               f"{(cell['datagen']['route'], cell['critic_route'])}")
        self.rng = torch.Generator(device=device).manual_seed((seed + RNG_OFFSET) % 2 ** 63)
        self.graphed = cell["chunk"]["kind"] == "graphed" and device.type == "cuda"
        if self.graphed:   # the trainer's graphed chunks: Adam capturable from the first step
            self.opt_g.hold_on_device()
            self.opt_d.hold_on_device()

    def make_chunk(self):
        """The chunk the window calls: K steps as one CUDA graph, or one by one."""
        from ofdmgan_tpu_torch.training.chunks import EagerChunk, GraphedChunk
        kind = GraphedChunk if self.graphed else EagerChunk
        return kind(self.step, self.rng, self.steps_per_chunk)

    @property
    def steps_per_chunk(self) -> int:
        return self.cell["chunk"]["steps"]

    def draws_ahead(self, n: int) -> List[dict]:
        """The draws the next ``n`` outer steps take from the step's
        generator, taken again from a copy of its state: each step's, on
        the card, the datagen kernel's 64-bit Philox seed, on the CPU the
        normals its plain version draws, then one penalty uniform ``[B]`` a
        critic update."""
        B, L = self.cell["batch"], self.config["frame_length"]
        dev = self.rng.device
        g2 = torch.Generator(device=dev)
        g2.set_state(self.rng.get_state())
        out = []
        for _ in range(n):
            if dev.type == "cuda":
                seed = torch.randint(0, 2 ** 62, (1,), dtype=torch.int64, generator=g2,
                                     device=dev)
                data = {"seed": int(seed)}
            else:
                kw = dict(generator=g2, dtype=torch.float32)
                data = {"normals": {k: torch.randn((B, L), **kw)
                                    for k in ("zr", "zi", "pn", "nr", "ni")}}
                data["normals"]["u"] = torch.rand((B,), **kw)
            data["alphas"] = [torch.rand((B,), generator=g2, device=dev)
                              for _ in range(self.cell["recipe"]["n_critic"])]
            out.append(data)
        return out

    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {"generator": dict(self.generator.named_parameters()),
                "critic": dict(self.critic.named_parameters())}

    def adam_state(self) -> Dict[str, dict]:
        """A copy of each net's Adam state: by leaf, the moments ``m`` and
        ``v``, and the updates done ``t`` (empty before a net's first)."""
        out = {}
        for net, opt in (("generator", self.opt_g), ("critic", self.opt_d)):
            state = opt.opt.state
            ps = self.params()[net]
            if not all("exp_avg" in state.get(p, {}) for p in ps.values()):
                out[net] = {}
                continue
            out[net] = {"m": {k: state[p]["exp_avg"].detach().clone() for k, p in ps.items()},
                        "v": {k: state[p]["exp_avg_sq"].detach().clone() for k, p in ps.items()},
                        "t": int(float(state[next(iter(ps.values()))]["step"]))}
        return out


@contextlib.contextmanager
def first_gradients(program: Program):
    """While the block runs, a copy of the gradient each optimizer takes at
    its first update, by net and leaf: Adam's first moment after that
    update over ``1 - beta1``, read by a post-step hook. A net whose
    optimizer never updates stays out."""
    first: Dict[str, Dict[str, torch.Tensor]] = {}
    hooks = []
    for net, module, opt in (("generator", program.generator, program.opt_g),
                             ("critic", program.critic, program.opt_d)):
        names = {p: name for name, p in module.named_parameters()}

        def hook(optimizer, args, kwargs, net=net, names=names):
            if net not in first:
                b1 = optimizer.param_groups[0]["betas"][0]
                first[net] = {names[p]: st["exp_avg"].detach() / (1.0 - b1)
                              for p, st in optimizer.state.items() if "exp_avg" in st}
        hooks.append(opt.opt.register_step_post_hook(hook))
    try:
        yield first
    finally:
        for h in hooks:
            h.remove()


def checked_steps(program: Program, weights, n: int) -> dict:
    """The program's first ``n`` outer steps, through the step's own call
    and generator: each step's draws (taken again beside it), ``d_loss``
    and ``g_loss``; each net's first gradient, by leaf norm; after the
    last step, each leaf's change from ``weights``, by norm."""
    draws: List[dict] = []
    losses: List[Dict[str, float]] = []
    with first_gradients(program) as first:
        for _ in range(n):
            draws.extend(program.draws_ahead(1))
            m = program.step(program.rng)
            losses.append({"d_loss": float(m["d_loss"]), "g_loss": float(m["g_loss"])})
    norm = lambda t: float(torch.linalg.vector_norm(t.double()))  # noqa: E731
    params = program.params()
    with torch.no_grad():
        grads = {net: {k: norm(first[net][k]) if k in first.get(net, {}) else 0.0 for k in ps}
                 for net, ps in params.items()}
        change = {net: {k: norm(p - weights[net][k]) for k, p in ps.items()}
                  for net, ps in params.items()}
    return {"draws": draws, "losses": losses, "grads": grads, "change": change}


def checked_chunk(program: Program, chunk) -> dict:
    """One call of the window's own chunk (a graphed chunk's replay), from a
    copy of the program's state before it (``start``: each net's
    parameters and Adam state): the draws of its K steps (taken again
    beside it), its last step's ``d_loss`` and ``g_loss``, the last
    gradient each optimizer took (worked out from Adam's first moments
    before and after), by leaf norm, and each leaf's change over the call,
    by norm."""
    params = program.params()
    start = {"params": {net: {k: p.detach().clone() for k, p in ps.items()}
                        for net, ps in params.items()},
             "adam": program.adam_state()}
    draws = program.draws_ahead(program.steps_per_chunk)
    m = chunk()
    losses = [{"d_loss": float(m["d_loss"]), "g_loss": float(m["g_loss"])}]
    end = program.adam_state()
    norm = lambda t: float(torch.linalg.vector_norm(t.double()))  # noqa: E731
    b1 = program.cell["recipe"]["betas"][0]
    grads = {}
    with torch.no_grad():
        for net, ps in params.items():
            m0, m1 = start["adam"][net].get("m"), end[net].get("m")
            grads[net] = {k: norm((m1[k] - b1 * (m0[k] if m0 else 0.0)) / (1.0 - b1))
                          if m1 else 0.0 for k in ps}
        change = {net: {k: norm(p - start["params"][net][k]) for k, p in ps.items()}
                  for net, ps in params.items()}
    return {"start": start, "draws": draws, "losses": losses, "grads": grads, "change": change}
