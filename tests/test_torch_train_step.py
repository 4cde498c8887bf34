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
from ofdmgan_tpu_torch.ops import datagen_kernel
from ofdmgan_tpu_torch.signal.datagen import DatagenConfig, make_draws, synthetic_batch_from_draws
from ofdmgan_tpu_torch.training.schedules import make_adam
from ofdmgan_tpu_torch.training.wgan_gp import LossConfig, TrainStep
from ofdmgan_tpu_torch.utils.jax_params import from_jax_params, to_jax_params
from ofdmgan_tpu_torch.utils.params_io import flatten_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

B, LR, DECAY_G = 32, 2e-4, 4   # StepLR every 4 generator updates: the trajectory crosses it
KEY = jax.random.PRNGKey(0)
JDG = JDatagenConfig.make(frame_length=16, snr_range=(0, 30))


class Pair:
    """A JAX step and a port step on the same weights."""

    def __init__(self, n_critic, adv_weight=1.0):
        self.n_critic = n_critic
        x0 = jnp.zeros((1, 16, 2))
        jg, jc = JGen(), JCritic()
        pg, pd = jg.init(KEY, x0), jc.init(KEY, x0, x0)
        decay_d = DECAY_G * max(n_critic, 1)
        tx_g = j_make_adam(LR, (0.0, 0.9), DECAY_G, 0.5)
        tx_d = j_make_adam(LR, (0.0, 0.9), decay_d, 0.5)
        self.jstate = TrainState.create(pg, pd, tx_g, tx_d)
        self.jstep = make_train_step(jg.apply, jc.apply, tx_g, tx_d, JDG,
                                     JLossConfig(n_critic=n_critic, adv_weight=adv_weight),
                                     batch_size=B, donate=False)
        np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        self.g, self.d = MiniGenerator(), MiniDiscriminator()
        self.g.load_state_dict(from_jax_params(np_tree(pg)))
        self.d.load_state_dict(from_jax_params(np_tree(pd)))
        self.opt_g = make_adam(self.g.parameters(), LR, (0.0, 0.9), DECAY_G, 0.5)
        self.opt_d = make_adam(self.d.parameters(), LR, (0.0, 0.9), decay_d, 0.5)
        self.tstep = TrainStep(self.g, self.d, self.opt_g, self.opt_d, DatagenConfig(),
                               LossConfig(n_critic=n_critic, adv_weight=adv_weight), B,
                               reference=True)

        @jax.jit
        def draws(key):
            k_data, k_crit, _ = jax.random.split(key, 3)
            batch = j_synthetic_batch(k_data, B, JDG)
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

    def assert_params_close(self, atol):
        for mod, jp in ((self.g, self.jstate.params_g), (self.d, self.jstate.params_d)):
            ref = flatten_tree(jax.tree_util.tree_map(np.asarray, jp))
            got = flatten_tree(to_jax_params(mod.state_dict()))
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
