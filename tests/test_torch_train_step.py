"""The port's outer train step against the JAX step.

Both start from the same flax-initialised weights. Each step's batch and
gradient-penalty uniforms are rebuilt from the JAX key splits
(wgan_gp.py:315,333, critic.py:95) and handed to the port's
``TrainStep.run``. Tolerances, in float32 with Adam steps of lr = 2e-4:
one step 2e-6 on parameters and 1e-5 relative on moments and metrics; a
20-step trajectory 2e-5 on parameters (a tenth of one update).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdmgan_tpu.models import MiniDiscriminator as JCritic
from ofdmgan_tpu.models import MiniGenerator as JGen
from ofdmgan_tpu.signal import DatagenConfig as JDatagenConfig
from ofdmgan_tpu.signal import synthetic_batch as j_synthetic_batch
from ofdmgan_tpu.training import TrainState
from ofdmgan_tpu.training import make_adam as j_make_adam
from ofdmgan_tpu.training import make_train_step
from ofdmgan_tpu.training.wgan_gp import LossConfig as JLossConfig
from ofdmgan_tpu_torch.models import MiniDiscriminator, MiniGenerator
from ofdmgan_tpu_torch.ops import critic_kernel, datagen_kernel
from ofdmgan_tpu_torch.ops import generator_kernel
from ofdmgan_tpu_torch.signal.channel import ChannelConfig
from ofdmgan_tpu_torch.signal.impairments import ImpairmentConfig
from ofdmgan_tpu_torch.signal.datagen import DatagenConfig, make_draws, synthetic_batch_from_draws
from ofdmgan_tpu_torch.training.schedules import make_adam
from ofdmgan_tpu_torch.training.wgan_gp import LossConfig, TrainStep
from ofdmgan_tpu_torch.utils.jax_params import from_jax_params, to_jax_params
from ofdmgan_tpu_torch.utils.params_io import flatten_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

B, LR, DECAY_G = 32, 2e-4, 4   # StepLR every 4 generator updates: the trajectory crosses it
KEY = jax.random.PRNGKey(0)


class Pair:
    """A JAX step and a port step on the same weights. ``reference=False``
    builds the port's step with its routes chosen by scope, as ``Trainer``
    does; ``gen_kw`` are the mini generator's modes on both sides."""

    def __init__(self, n_critic, adv_weight=1.0, frame_length=16, conv1_channels=8,
                 reference=True, gen_kw=None):
        gen_kw = gen_kw or {}
        self.n_critic = n_critic
        L = frame_length
        jdg = JDatagenConfig.make(frame_length=L, snr_range=(0, 30))
        x0 = jnp.zeros((1, L, 2))
        jg = JGen(frame_length=L, **gen_kw)
        jc = JCritic(frame_length=L, conv1_channels=conv1_channels)
        pg, pd = jg.init(KEY, x0), jc.init(KEY, x0, x0)
        decay_d = DECAY_G * max(n_critic, 1)
        tx_g = j_make_adam(LR, (0.0, 0.9), DECAY_G, 0.5)
        tx_d = j_make_adam(LR, (0.0, 0.9), decay_d, 0.5)
        self.jstate = TrainState.create(pg, pd, tx_g, tx_d)
        self.jstep = make_train_step(jg.apply, jc.apply, tx_g, tx_d, jdg,
                                     JLossConfig(n_critic=n_critic, adv_weight=adv_weight),
                                     batch_size=B, donate=False)
        np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        self.g = MiniGenerator(**gen_kw)
        self.d = MiniDiscriminator(conv1_channels=conv1_channels)
        self.g.load_state_dict(from_jax_params(np_tree(pg)))
        self.d.load_state_dict(from_jax_params(np_tree(pd)))
        self.opt_g = make_adam(self.g.parameters(), LR, (0.0, 0.9), DECAY_G, 0.5)
        self.opt_d = make_adam(self.d.parameters(), LR, (0.0, 0.9), decay_d, 0.5)
        self.tstep = TrainStep(self.g, self.d, self.opt_g, self.opt_d,
                               DatagenConfig(frame_length=L),
                               LossConfig(n_critic=n_critic, adv_weight=adv_weight), B,
                               reference=reference)

        @jax.jit
        def draws(key):
            k_data, k_crit, _ = jax.random.split(key, 3)
            batch = j_synthetic_batch(k_data, B, jdg)
            alphas = [jax.random.uniform(k, (B, 1, 1), jnp.float32)[:, 0, 0]
                      for k in jax.random.split(k_crit, max(n_critic, 1))]
            return batch, alphas

        self.draws = draws

    def step(self, i):
        key = jax.random.fold_in(KEY, 100 + i)
        self.jstate, jm = self.jstep(self.jstate, key)
        batch, alphas = self.draws(key)
        batch = {k: torch.from_numpy(np.array(batch[k])) for k in ("noisy", "clean")}
        alphas = [torch.from_numpy(np.array(a)) for a in alphas[:self.n_critic]]
        tm = self.tstep.run(batch, alphas)
        return jm, tm

    def jax_steps(self, n):
        """``n`` steps of the JAX side alone."""
        for i in range(n):
            self.jstate, _ = self.jstep(self.jstate, jax.random.fold_in(KEY, 100 + i))

    def load_jax_state(self):
        """The port's parameters, Adam moments, step counts and schedule
        positions set to the JAX side's."""
        count = int(self.jstate.step)
        np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        for mod, opt, params, jopt, updates in (
                (self.g, self.opt_g, self.jstate.params_g, self.jstate.opt_g, count),
                (self.d, self.opt_d, self.jstate.params_d, self.jstate.opt_d,
                 count * self.n_critic)):
            mod.load_state_dict(from_jax_params(np_tree(params)))
            mu, nu = from_jax_params(np_tree(jopt[0].mu)), from_jax_params(np_tree(jopt[0].nu))
            assert int(jopt[0].count) == updates
            for name, param in mod.named_parameters():
                opt.opt.state[param] = {"step": torch.tensor(float(updates)),
                                        "exp_avg": mu[name].clone(),
                                        "exp_avg_sq": nu[name].clone()}
            opt.sched.last_epoch = updates
            base = opt.sched.base_lrs[0]
            opt.opt.param_groups[0]["lr"] = base * 0.5 ** (updates // opt.sched.step_size)

    def assert_params_close(self, atol):
        for mod, jp in ((self.g, self.jstate.params_g), (self.d, self.jstate.params_d)):
            ref = flatten_tree(jax.tree_util.tree_map(np.asarray, jp))
            got = flatten_tree(to_jax_params(mod))
            for k in ref:
                np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def adversarial():
    return Pair(n_critic=5)


def test_one_outer_step_matches_jax(adversarial):
    p = adversarial
    jm, tm = p.step(0)
    p.assert_params_close(2e-6)
    for name, ref in jm.items():
        np.testing.assert_allclose(float(tm[name]), float(ref), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    # Adam moments (optax scale_by_adam state: mu, nu)
    for mod, opt, jopt in ((p.g, p.opt_g, p.jstate.opt_g), (p.d, p.opt_d, p.jstate.opt_d)):
        for slot, jtree in (("exp_avg", jopt[0].mu), ("exp_avg_sq", jopt[0].nu)):
            ref = from_jax_params(jax.tree_util.tree_map(np.asarray, jtree))
            for name, param in mod.named_parameters():
                np.testing.assert_allclose(opt.opt.state[param][slot].numpy(),
                                           ref[name].numpy(), rtol=1e-5,
                                           atol=1e-5 * float(ref[name].abs().max()) + 1e-12,
                                           err_msg=f"{name} {slot}")


def test_twenty_step_trajectory_tracks_jax(adversarial):
    p = adversarial
    start = int(p.jstate.step)
    for i in range(start, 20):
        p.step(i)
    assert int(p.jstate.step) == 20
    assert p.opt_g.opt.param_groups[0]["lr"] == pytest.approx(LR * 0.5 ** 5)
    p.assert_params_close(2e-5)


@pytest.mark.parametrize("frame_length,conv1_channels", [(32, 8), (16, 4)])
def test_step_outside_the_critic_kernels_scope_matches_jax(frame_length, conv1_channels):
    """At L = 32 and with a 4-channel critic the step takes the autograd
    critic by scope (the datagen kernel still covers both configurations).
    From a state warmed by three JAX steps and copied into the port, one
    step of each: the tolerances of the one-step test above."""
    p = Pair(n_critic=5, frame_length=frame_length, conv1_channels=conv1_channels,
             reference=False)
    assert (p.tstep.datagen_route, p.tstep.critic_route) == ("kernel", "plain")
    p.jax_steps(3)
    p.load_jax_state()
    jm, tm = p.step(3)
    p.assert_params_close(2e-6)
    for name, ref in jm.items():
        np.testing.assert_allclose(float(tm[name]), float(ref), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    for mod, opt, jopt in ((p.g, p.opt_g, p.jstate.opt_g), (p.d, p.opt_d, p.jstate.opt_d)):
        for slot, jtree in (("exp_avg", jopt[0].mu), ("exp_avg_sq", jopt[0].nu)):
            ref = from_jax_params(jax.tree_util.tree_map(np.asarray, jtree))
            for name, param in mod.named_parameters():
                np.testing.assert_allclose(opt.opt.state[param][slot].numpy(),
                                           ref[name].numpy(), rtol=1e-5,
                                           atol=1e-5 * float(ref[name].abs().max()) + 1e-12,
                                           err_msg=f"{name} {slot}")


def test_supervised_path_matches_jax():
    p = Pair(n_critic=0, adv_weight=0.0)
    d0 = {k: v.clone() for k, v in p.d.state_dict().items()}
    for i in range(3):
        jm, tm = p.step(i)
    assert float(tm["d_loss"]) == 0.0 and float(tm["adv_loss"]) == 0.0
    np.testing.assert_allclose(float(tm["rec_loss"]), float(jm["rec_loss"]), rtol=1e-5)
    p.assert_params_close(2e-6)
    for k, v in p.d.state_dict().items():
        assert torch.equal(v, d0[k])


def test_supervised_path_needs_zero_adv_weight():
    g, d = MiniGenerator(), MiniDiscriminator()
    with pytest.raises(ValueError):
        TrainStep(g, d, make_adam(g.parameters(), LR), make_adam(d.parameters(), LR),
                  DatagenConfig(), LossConfig(n_critic=0), B)


def _fresh_pair(reference):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        g, d = MiniGenerator(), MiniDiscriminator()
    return TrainStep(g, d, make_adam(g.parameters(), LR), make_adam(d.parameters(), LR),
                     DatagenConfig(), LossConfig(), B, reference=reference)


def test_kernel_flags_take_the_same_step_on_cpu():
    """On the CPU the kernel path runs the kernels' plain versions; from the
    same state and draws it takes the reference step (FFT datagen, autograd
    critic). The state is warmed up by three steps first: from a fresh Adam
    state, a gradient that is zero up to rounding turns into a full step of
    either sign."""
    plain = _fresh_pair(True)
    gen = torch.Generator().manual_seed(1)
    for _ in range(3):
        plain(gen)
    kern = copy.deepcopy(plain)
    kern.reference = False
    draws = make_draws(gen, B, 16)
    alphas = [torch.rand(B, generator=gen) for _ in range(5)]
    m_p = plain.run(synthetic_batch_from_draws(draws, DatagenConfig()), alphas)
    m_k = kern.run(datagen_kernel.synthetic_batch_from_draws(draws, DatagenConfig()), alphas)
    for name in m_p:
        torch.testing.assert_close(m_k[name], m_p[name], rtol=1e-5, atol=1e-6)
    for mod_p, mod_k in ((plain.generator, kern.generator), (plain.critic, kern.critic)):
        for a, b in zip(mod_p.parameters(), mod_k.parameters()):
            torch.testing.assert_close(b, a, rtol=0, atol=2e-6)


@pytest.mark.parametrize("fresh", [False, True])
def test_step_draws_one_batch_or_one_per_critic_update(fresh, monkeypatch):
    step = _fresh_pair(False)
    step.loss_cfg = LossConfig(fresh_critic_batches=fresh)
    calls = []
    real_draw = step.draw_batch
    monkeypatch.setattr(step, "draw_batch", lambda rng: calls.append(1) or real_draw(rng))
    metrics = step(torch.Generator().manual_seed(2))
    assert len(calls) == (6 if fresh else 1)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


@pytest.mark.parametrize("dg,conv1,routes", [
    (DatagenConfig(), 8, ("kernel", "kernel")),
    (DatagenConfig(nonlinear=True), 8, ("kernel", "kernel")),
    (DatagenConfig(frame_length=32), 8, ("kernel", "plain")),
    (DatagenConfig(frame_length=12), 8, ("plain", "plain")),
    (DatagenConfig(channel=ChannelConfig("multipath"), nonlinear=True), 8, ("plain", "kernel")),
    (DatagenConfig(nonlinear=True, impairments=ImpairmentConfig(cfo_enabled=True)), 8,
     ("plain", "kernel")),
    (DatagenConfig(), 4, ("kernel", "plain")),
])
def test_routes_follow_the_configuration(dg, conv1, routes):
    """Each kernel where it covers the configuration, the plain route
    elsewhere; ``reference=True`` and a ``batch_fn`` as documented."""
    g, d = MiniGenerator(), MiniDiscriminator(conv1_channels=conv1)
    args = (g, d, make_adam(g.parameters(), LR), make_adam(d.parameters(), LR), dg, LossConfig(), B)
    step = TrainStep(*args)
    assert (step.datagen_route, step.critic_route) == routes
    assert routes == ("kernel" if datagen_kernel.covers(dg) else "plain",
                      "kernel" if critic_kernel.covers(d, dg.frame_length) else "plain")
    step.reference = True
    assert (step.datagen_route, step.critic_route) == ("plain", "plain")
    step.reference = False
    assert (step.datagen_route, step.critic_route) == routes
    with_fn = TrainStep(*args, batch_fn=lambda rng, n: None)
    assert (with_fn.datagen_route, with_fn.critic_route) == ("plain", routes[1])


@pytest.mark.parametrize("kernel", ["datagen", "critic"])
def test_a_failing_kernel_raises(kernel, monkeypatch):
    """A kernel route that fails is not replaced by the plain route."""
    def broken(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    if kernel == "datagen":
        monkeypatch.setattr(datagen_kernel, "synthetic_batch", broken)
    else:
        monkeypatch.setattr(critic_kernel, "critic_grad", broken)
    step = _fresh_pair(False)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        step(torch.Generator().manual_seed(0))


def _step_in_form(form):
    """A mini step in one of the forms whose critic updates share the
    outer batch's fake: the plain route, the kernel route (its plain
    versions on the CPU), ``fuse_realfake``, ``remat`` and the flat step
    on either route."""
    from ofdmgan_tpu_torch.models import flat
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        g, d = MiniGenerator(), MiniDiscriminator()
    kw = {"plain": dict(reference=True), "kernel": dict(reference=False),
          "fuse_realfake": dict(reference=True, fuse_realfake=True),
          "remat": dict(reference=True, remat=True),
          "flat_plain": dict(reference=True, flat=flat.make_flat_step(g, d, 16, premap=True)),
          "flat_kernel": dict(reference=False, flat=flat.make_flat_step(g, d, 16))}[form]
    return TrainStep(g, d, make_adam(g.parameters(), LR), make_adam(d.parameters(), LR),
                     DatagenConfig(), LossConfig(), B, **kw)


@pytest.mark.parametrize("form", ["plain", "kernel", "fuse_realfake", "remat", "flat_plain",
                                  "flat_kernel"])
def test_one_generator_forward_for_the_critic_updates_takes_the_per_update_step(form):
    """The step's critic updates on the outer batch share one generator
    forward; the same step given that batch once for each update computes
    the fake in each. From the same state and draws both take the same
    step bit for bit: metrics, parameters and Adam's moments."""
    once = _step_in_form(form)
    assert once.critic_route == ("kernel" if form.endswith("kernel") else "plain")
    gen = torch.Generator().manual_seed(1)
    once(gen)
    each = copy.deepcopy(once)
    batch0, alphas, _ = once.draw(gen)
    m_once = once.run(batch0, alphas)
    m_each = each.run(batch0, alphas, [batch0] * len(alphas))
    assert {k: float(v) for k, v in m_once.items()} == {k: float(v) for k, v in m_each.items()}
    for a, b in ((once.generator, each.generator), (once.critic, each.critic)):
        for p, q in zip(a.parameters(), b.parameters()):
            assert torch.equal(p, q)
    for a, b in ((once.opt_g, each.opt_g), (once.opt_d, each.opt_d)):
        for sa, sb in zip(a.opt.state.values(), b.opt.state.values()):
            assert all(torch.equal(sa[k], sb[k]) for k in ("exp_avg", "exp_avg_sq"))


@pytest.mark.parametrize("reference", [True, False], ids=["plain_route", "kernel_route"])
@pytest.mark.parametrize("loss,forwards", [
    (LossConfig(), 1),
    (LossConfig(fresh_critic_batches=True), 5),
    (LossConfig(n_critic=0, adv_weight=0.0), 0),
], ids=["one_batch", "fresh_batches", "supervised"])
def test_no_grad_generator_forwards_a_step(reference, loss, forwards, monkeypatch):
    """One no-grad generator forward a step where the critic updates share
    the outer batch, one an update with fresh batches, none on the
    supervised path: the module's on the plain forward route, the forward
    kernel's (its plain version here) on the kernel route; the generator
    update's own forward runs with grad."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        g, d = MiniGenerator(), MiniDiscriminator()
    step = TrainStep(g, d, make_adam(g.parameters(), LR), make_adam(d.parameters(), LR),
                     DatagenConfig(), loss, B, reference=reference)
    assert step.forward_route == ("plain" if reference else "kernel")
    grad_modes, kernel_forwards = [], []
    g.register_forward_hook(lambda module, args, out: grad_modes.append(torch.is_grad_enabled()))
    real = generator_kernel.generator_forward
    monkeypatch.setattr(generator_kernel, "generator_forward",
                        lambda *a: kernel_forwards.append(1) or real(*a))
    metrics = step(torch.Generator().manual_seed(3))
    no_grad = kernel_forwards if step.forward_route == "kernel" else \
        [m for m in grad_modes if not m]
    assert len(no_grad) == forwards
    assert grad_modes.count(False) == (0 if step.forward_route == "kernel" else forwards)
    assert grad_modes.count(True) == (step.generator_route == "plain")
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


def _forward_route_step(case):
    """A mini step (or another) in one configuration of
    ``test_forward_route_follows_the_configuration``."""
    from ofdmgan_tpu_torch.models import flat
    from ofdmgan_tpu_torch.models.full_unet import FullDiscriminator, FullUNetGenerator
    g, d, L, kw = MiniGenerator(), MiniDiscriminator(), 16, {}
    if case == "image_batches":
        kw["batch_fn"] = lambda rng, n: None
    elif case == "fresh_batches":
        kw["loss"] = LossConfig(fresh_critic_batches=True)
    elif case == "narrow_critic":   # the critic's route is autograd's
        d = MiniDiscriminator(conv1_channels=4)
    elif case == "reference":
        kw["reference"] = True
    elif case in ("tensorfloat32", "bfloat16"):
        kw["matmul_precision"] = case
    elif case == "act_dtype":
        kw["act_dtype"] = "bfloat16"
    elif case == "generator_act_dtype":
        g = MiniGenerator(act_dtype="bfloat16")
    elif case in ("qat", "rtl_faithful", "input_residual"):
        g = MiniGenerator(**{case: True})
    elif case == "flat":
        kw["flat"] = flat.make_flat_step(g, d, 16)
    elif case == "remat":
        kw["remat"] = True
    elif case == "gen_forward":
        kw["gen_forward"] = lambda module, x: module(x)
    elif case == "shard":
        kw["shard"] = object()
    elif case == "full_unet":
        g, d, L = (FullUNetGenerator(frame_length=64, levels=3, base_channels=8),
                   FullDiscriminator(frame_length=64, levels=3, base_channels=8), 64)
    elif case == "frame_length_32":
        L = 32
    loss = kw.pop("loss", LossConfig())
    return TrainStep(g, d, make_adam(g.parameters(), LR), make_adam(d.parameters(), LR),
                     DatagenConfig(frame_length=L), loss, B, **kw)


@pytest.mark.parametrize("case", [
    "mini", "image_batches", "fresh_batches", "narrow_critic", "reference", "tensorfloat32",
    "bfloat16", "act_dtype", "generator_act_dtype", "qat", "rtl_faithful", "input_residual",
    "flat", "remat", "gen_forward", "shard", "full_unet", "frame_length_32"])
def test_forward_route_follows_the_configuration(case):
    """``kernel`` where the step is not the reference, at ``float32``, with
    no ``act_dtype``, ``flat``, ``remat``, ``gen_forward`` or ``shard``, and
    ``covers_forward`` holds, whatever the critic's route; ``plain``
    elsewhere, and again after ``reference`` is set and cleared."""
    step = _forward_route_step(case)
    want = "kernel" if case in ("mini", "image_batches", "fresh_batches",
                                "narrow_critic") else "plain"
    assert step.forward_route == want
    if case == "narrow_critic":
        assert step.critic_route == "plain"
    step.reference = True
    assert step.forward_route == "plain"
    step.reference = case == "reference"
    assert step.forward_route == want


@pytest.mark.parametrize("conv1", [8, 4], ids=["critic_kernel", "critic_autograd"])
def test_kernel_forward_route_gives_the_first_updates_fake(conv1):
    """A CPU step on the forward kernel's route hands its first critic
    update the plain forward's fake (the kernel's plain version here), bit
    for bit, and the module's forward within the kernel's tolerance, on
    either critic route."""
    from ofdmgan_tpu_torch.utils.kernel_checks import assert_forward_close
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        g, d = MiniGenerator(), MiniDiscriminator(conv1_channels=conv1)
    step = TrainStep(g, d, make_adam(g.parameters(), LR), make_adam(d.parameters(), LR),
                     DatagenConfig(), LossConfig(), B)
    assert step.forward_route == "kernel"
    gen = torch.Generator().manual_seed(4)
    batch0, alphas, _ = step.draw(gen)
    _, fake = step.critic_update(batch0, alphas[0])
    assert torch.equal(fake, generator_kernel.generator_forward_plain(g, batch0["noisy"]))
    with torch.no_grad():
        assert_forward_close(fake, g(batch0["noisy"]))
