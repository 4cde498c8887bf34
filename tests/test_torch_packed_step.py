"""The port's lane-packed step (``ops/packed_step.py``) against the JAX
package's (``ofdmgan_tpu/ops/packed_step.py``) and against the port's own
module step, at the tolerances of the reference's
``tests/test_packed_step.py``: forwards atol 2e-6 (generator) and 2e-5
(critic), the penalty rtol 2e-4; three lockstep steps (datagen, five critic
updates with the penalty, the generator update, Adam) on the same draws,
the metrics rtol 2e-3 atol 2e-5 and the parameters rtol 1e-3 atol 2e-5;
the bf16-storage step in the mixed mode ``bf16_tf32gp`` within 5 % of the
loss scale (its rounding and summation order differ), as there.

The JAX side draws from keys, the port from ``torch.Generator``s: the
lockstep tests hand JAX's own draws (its batch and the penalty's uniforms,
rebuilt from its key splits) to ``PackedTrainStep.run``. The packed batch
is the module step's batch viewed ``[B/p, p*L*2]``: the same frames from the
same generator, with no copy.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdmgan_tpu.models import MiniDiscriminator as JCritic
from ofdmgan_tpu.models import MiniGenerator as JGen
from ofdmgan_tpu.ops import packed_step as jps
from ofdmgan_tpu.signal import DatagenConfig as JDatagenConfig
from ofdmgan_tpu.training import LossConfig as JLossConfig
from ofdmgan_tpu.training import TrainState, make_adam as j_make_adam
from ofdmgan_tpu_torch.models import MiniDiscriminator, MiniGenerator
from ofdmgan_tpu_torch.ops import datagen_kernel, packed_step as ps
from ofdmgan_tpu_torch.signal.datagen import (DatagenConfig, make_draws, synthetic_batch,
                                              synthetic_batch_from_draws)
from ofdmgan_tpu_torch.signal.impairments import ImpairmentConfig
from ofdmgan_tpu_torch.training.schedules import make_adam
from ofdmgan_tpu_torch.training.wgan_gp import LossConfig, TrainStep
from ofdmgan_tpu_torch.utils.jax_params import from_jax_params, to_jax_params
from ofdmgan_tpu_torch.utils.params_io import flatten_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

B, P, L = 32, 4, 16
LR = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _packed(x):
    return np.array(x).reshape(B // P, -1)


def _params(residual=False):
    key = jax.random.PRNGKey(0)
    jg, jc = JGen(input_residual=residual), JCritic()
    x0 = jnp.zeros((1, L, 2), jnp.float32)
    pg, pd = jg.init(key, x0), jc.init(key, x0, x0)
    tg, tc = MiniGenerator(input_residual=residual), MiniDiscriminator()
    tg.load_state_dict(from_jax_params(_np(pg)))
    tc.load_state_dict(from_jax_params(_np(pd)))
    return jg, jc, pg, pd, tg, tc


def _cfgs(nonlinear=False):
    return (JDatagenConfig.make(frame_length=L, snr_range=(0, 30), nonlinear=nonlinear,
                                pa_saturation=0.8),
            DatagenConfig(frame_length=L, nonlinear=nonlinear,
                          impairments=ImpairmentConfig(pa_saturation=0.8)))


@pytest.mark.parametrize("nonlinear", [False, True])
def test_packed_batch_is_the_module_batch_viewed(nonlinear):
    """The same frames as the module step's from the same generator, and a
    view of them (no copy)."""
    _, cfg = _cfgs(nonlinear)
    draws = make_draws(torch.Generator().manual_seed(3), B, L)
    ref = synthetic_batch_from_draws(draws, cfg)
    got = ps.packed_synthetic_batch_from_draws(draws, P, cfg)
    view = ps.pack(ref, P)
    for k in ("noisy", "clean"):
        assert got[k].shape == (B // P, P * L * 2)
        assert view[k].data_ptr() == ref[k].data_ptr()
        assert torch.equal(got[k], ref[k].reshape(B // P, -1))
    assert torch.equal(got["snr"], ref["snr"].reshape(B // P, P))
    for kernel, draw in ((True, datagen_kernel.synthetic_batch), (False, synthetic_batch)):
        drawn = ps.packed_synthetic_batch(torch.Generator().manual_seed(4), B, P, cfg, kernel)
        module = draw(torch.Generator().manual_seed(4), B, cfg)
        assert torch.equal(drawn["noisy"], module["noisy"].reshape(B // P, -1))


@pytest.mark.parametrize("residual", [False, True])
def test_generator_forward(residual):
    jg, _, pg, _, tg, _ = _params(residual)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (B, L, 2)))
    ref = jps.packed_gen_forward(pg, jnp.asarray(_packed(x)), P, input_residual=residual)
    with torch.no_grad():
        got = ps.packed_gen_forward(tg, torch.from_numpy(_packed(x)), P,
                                    input_residual=residual)
        module = tg(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-6)
    np.testing.assert_allclose(got.numpy(), _packed(module.numpy()), atol=2e-6)


def test_critic_forward():
    _, jc, _, pd, _, tc = _params()
    k1, k2 = jax.random.split(jax.random.PRNGKey(2))
    cand = np.asarray(jax.random.normal(k1, (B, L, 2)))
    cond = np.asarray(jax.random.normal(k2, (B, L, 2)))
    ref = jps.packed_critic_forward(pd, jnp.asarray(_packed(cand)), jnp.asarray(_packed(cond)), P)
    with torch.no_grad():
        got = ps.packed_critic_forward(tc, torch.from_numpy(_packed(cand)),
                                       torch.from_numpy(_packed(cond)), P)
    assert got.shape == (B // P, P)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jc.apply(pd, cand, cond)).reshape(B // P, P),
                               atol=2e-5)


def test_gradient_penalty():
    jg, _, pg, pd, tg, tc = _params()
    k1, k2, kgp = jax.random.split(jax.random.PRNGKey(4), 3)
    real = np.asarray(jax.random.normal(k1, (B, L, 2)))
    cond = np.asarray(jax.random.normal(k2, (B, L, 2)))
    fake = np.asarray(jg.apply(pg, cond))
    ref = jps.packed_gradient_penalty(pd, *(jnp.asarray(_packed(a)) for a in (real, fake, cond)),
                                      kgp, P, L)
    alpha = np.asarray(jax.random.uniform(kgp, (B // P, P, 1), jnp.float32))
    frames = (torch.from_numpy(_packed(a)) for a in (real, fake, cond))
    got = ps.packed_gradient_penalty(tc, *frames, torch.from_numpy(alpha), P, L)
    np.testing.assert_allclose(float(got), float(ref), rtol=2e-4)


def _jax_draws(key, jdg, n_critic):
    k_data, k_crit, _ = jax.random.split(key, 3)
    batch = jps.packed_synthetic_batch(k_data, B, P, jdg)
    alphas = [torch.from_numpy(np.array(jax.random.uniform(k, (B // P, P, 1), jnp.float32))
                               .reshape(-1)) for k in jax.random.split(k_crit, n_critic)]
    return {k: torch.from_numpy(np.array(batch[k])) for k in ("noisy", "clean")}, alphas


def _assert_state(got_g, got_d, jstate, rtol=1e-3, atol=2e-5):
    for mod, jp in ((got_g, jstate.params_g), (got_d, jstate.params_d)):
        ref, got = flatten_tree(_np(jp)), flatten_tree(to_jax_params(mod))
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("nonlinear", [False, True])
def test_train_step_lockstep(nonlinear):
    """Three packed steps against JAX's packed step and the port's module
    step, on JAX's draws."""
    jg, jc, pg, pd, tg, tc = _params()
    mg, mc = _params()[4:]
    jdg, cfg = _cfgs(nonlinear)
    tx_g, tx_d = j_make_adam(LR), j_make_adam(LR)
    jstep = jax.jit(jps.build_packed_train_step(tx_g, tx_d, jdg, JLossConfig(n_critic=5), B, p=P,
                                                matmul_precision="float32"))
    jstate = TrainState.create(pg, pd, tx_g, tx_d)
    step = ps.build_packed_train_step(tg, tc, make_adam(tg.parameters(), LR, (0.0, 0.9)),
                                      make_adam(tc.parameters(), LR, (0.0, 0.9)), cfg,
                                      LossConfig(n_critic=5), B, p=P, matmul_precision="float32")
    module = TrainStep(mg, mc, make_adam(mg.parameters(), LR, (0.0, 0.9)),
                       make_adam(mc.parameters(), LR, (0.0, 0.9)), cfg, LossConfig(n_critic=5), B)
    for i in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(7), i)
        batch, alphas = _jax_draws(key, jdg, 5)
        jstate, jm = jstep(jstate, key)
        m = step.run(batch, alphas)
        mm = module.run({k: v.reshape(B, L, 2) for k, v in batch.items()}, alphas)
    for name in ("d_loss", "g_loss", "rec_loss", "gradient_penalty", "wasserstein_distance"):
        np.testing.assert_allclose(float(m[name]), float(jm[name]), rtol=2e-3, atol=2e-5)
        np.testing.assert_allclose(float(m[name]), float(mm[name]), rtol=2e-3, atol=2e-5)
    _assert_state(tg, tc, jstate)
    for a, b in ((tg, mg), (tc, mc)):
        for (n, x), y in zip(a.named_parameters(), b.parameters()):
            np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(), rtol=1e-3,
                                       atol=2e-5, err_msg=n)


def test_bf16_storage_mixed_precision():
    """``act_dtype="bfloat16"`` with ``bf16_tf32gp`` (and ``critic_unroll``
    5, accepted): three steps track JAX's packed step and the port's module
    step in the same mode within 5 % of the loss scale."""
    jg, jc, pg, pd, tg, tc = _params()
    mg, mc = MiniGenerator(act_dtype="bfloat16"), MiniDiscriminator(act_dtype="bfloat16")
    mg.load_state_dict(tg.state_dict())
    mc.load_state_dict(tc.state_dict())
    jdg, cfg = _cfgs()
    tx_g, tx_d = j_make_adam(LR), j_make_adam(LR)
    jstep = jax.jit(jps.build_packed_train_step(
        tx_g, tx_d, jdg, JLossConfig(n_critic=5), B, p=P, matmul_precision="bf16_tf32gp",
        act_dtype="bfloat16", critic_unroll=5))
    jstate = TrainState.create(pg, pd, tx_g, tx_d)
    adam = lambda m: make_adam(m.parameters(), LR, (0.0, 0.9))  # noqa: E731
    step = ps.build_packed_train_step(tg, tc, adam(tg), adam(tc), cfg, LossConfig(n_critic=5), B,
                                      p=P, matmul_precision="bf16_tf32gp", act_dtype="bfloat16",
                                      critic_unroll=5)
    module = TrainStep(mg, mc, adam(mg), adam(mc), cfg, LossConfig(n_critic=5), B,
                       act_dtype="bfloat16", matmul_precision="bf16_tf32gp")
    for i in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(7), i)
        batch, alphas = _jax_draws(key, jdg, 5)
        jstate, jm = jstep(jstate, key)
        m = step.run(batch, alphas)
        mm = module.run({k: v.reshape(B, L, 2) for k, v in batch.items()}, alphas)
    for name in ("d_loss", "g_loss", "rec_loss", "gradient_penalty"):
        for ref in (float(jm[name]), float(mm[name])):
            assert abs(float(m[name]) - ref) <= 0.05 * max(1.0, abs(ref)), (name, m[name], ref)


def test_scan_steps_and_p2():
    _, _, _, _, tg, tc = _params()
    _, cfg = _cfgs()
    step = ps.build_packed_train_step(tg, tc, make_adam(tg.parameters(), LR, (0.0, 0.9)),
                                      make_adam(tc.parameters(), LR, (0.0, 0.9)), cfg,
                                      LossConfig(n_critic=2), B, p=2, scan_steps=3,
                                      matmul_precision="float32")
    assert step.datagen_route == "kernel"   # its plain version on the CPU
    m = step(torch.Generator().manual_seed(0))
    assert step.opt_g.opt.state[tg.enc1.weight]["step"] == 3
    assert all(np.isfinite(float(v)) for v in m.values())
    with pytest.raises(ValueError):
        ps.build_packed_train_step(MiniGenerator(qat=True), tc, None, None, cfg, LossConfig(),
                                   B, p=P)


def test_critic_updates_share_one_generator_forward(monkeypatch):
    """``run`` computes the generator's packed forward once for its critic
    updates; the per-update form, each ``critic_loss`` computing its own,
    takes the same step from the same state and draws, bit for bit."""
    _, _, _, _, tg, tc = _params()
    _, cfg = _cfgs()

    def build():
        g, c = copy.deepcopy(tg), copy.deepcopy(tc)
        return ps.build_packed_train_step(g, c, make_adam(g.parameters(), LR, (0.0, 0.9)),
                                          make_adam(c.parameters(), LR, (0.0, 0.9)), cfg,
                                          LossConfig(), B, p=P, matmul_precision="float32")

    once, each = build(), build()
    forwards = []
    for step in (once, each):
        fwd = step.gen_fwd
        step.gen_fwd = lambda x, fwd=fwd, step=step: (
            forwards.append((step, torch.is_grad_enabled())) or fwd(x))
    monkeypatch.setattr(each, "critic_loss", lambda batch, alpha, fake=None:
                        ps.PackedTrainStep.critic_loss(each, batch, alpha))
    batch, alphas = once.draw(torch.Generator().manual_seed(4))
    m_once, m_each = once.run(batch, alphas), each.run(batch, alphas)
    # the per-update form: run's forward, unread, and one an update
    assert forwards.count((once, False)) == 1 and forwards.count((each, False)) == 1 + 5
    assert {k: float(v) for k, v in m_once.items()} == {k: float(v) for k, v in m_each.items()}
    for a, b in ((once.generator, each.generator), (once.critic, each.critic)):
        for p, q in zip(a.parameters(), b.parameters()):
            assert torch.equal(p, q)
