"""Activation storage formats (``act_dtype``) of the port's mini pair and
step against the JAX package's.

bf16 and both fp8 formats: each activation is rounded to the format where
the reference rounds it, and every conv reads its input upcast to float32
(fp8 through bf16, exact either way). Both packages then compute the same
float32 function of the same rounded values, so the forwards agree to
float32 rounding unless a value lands on a rounding boundary of the
format. Tolerances: forwards atol 1e-5, rtol 1e-5 (tanh outputs and critic
scores of order one); the gradient penalty rtol 1e-4 and its parameter
gradients rtol 1e-3 and atol 1e-4 of each tensor's largest entry, 1e-2 at
bf16: there the penalty's norm is bf16 arithmetic on the bf16 input
gradient in both packages, and its second-order backward rounds each
elementwise product to bf16 in another order (a few bf16 steps, 2^-8
each). One outer step from a warmed-up state: the metrics rtol 1e-4; at
bf16 every parameter within a tenth of one update (lr / 10, from the
penalty's bf16 backward above); at fp8 the critic's parameters atol 2e-6
and the generator's within half an update (lr / 2): the reference sums the
generator's fp8 gradients in fp8 where an activation fans out (the skip)
and where the upsample is transposed, and torch has no fp8 addition, so
the port sums them in float32 and rounds once. Beside that, each tensor's
update (after minus before) is held to the reference's in norm: the norm
of the difference within 0.02 of the reference update's norm, 0.25 for
the fp8 generator, so that a skipped or misdirected update fails (the
worst readings, seed as here: 8.2e-3 at bf16; 0.092 at e4m3 and 0.114 at
e5m2 in the fp8 generator, where an entry's update is off by up to 0.32
of the tensor's largest).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdmgan_tpu.models import MiniDiscriminator as JCritic
from ofdmgan_tpu.models import MiniGenerator as JGen
from ofdmgan_tpu.models.critic import compute_gradient_penalty as j_gp
from ofdmgan_tpu.signal import DatagenConfig as JDatagenConfig
from ofdmgan_tpu.signal import synthetic_batch as j_synthetic_batch
from ofdmgan_tpu.training import TrainState
from ofdmgan_tpu.training import make_adam as j_make_adam
from ofdmgan_tpu.training import make_train_step
from ofdmgan_tpu.training.wgan_gp import LossConfig as JLossConfig
from ofdmgan_tpu_torch.models import MiniDiscriminator, MiniGenerator
from ofdmgan_tpu_torch.models.critic import compute_gradient_penalty
from ofdmgan_tpu_torch.models.generator import storage_dtype
from ofdmgan_tpu_torch.signal.datagen import DatagenConfig
from ofdmgan_tpu_torch.training.schedules import make_adam
from ofdmgan_tpu_torch.training.wgan_gp import LossConfig, TrainStep
from ofdmgan_tpu_torch.utils.jax_params import from_jax_params, to_jax_params
from ofdmgan_tpu_torch.utils.params_io import flatten_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ACT = ["bfloat16", "float8_e4m3fn", "float8_e5m2"]
KEY = jax.random.PRNGKey(0)
B, LR = 32, 2e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _frames(seed, b=B):
    return np.random.default_rng(seed).standard_normal((b, 16, 2)).astype(np.float32) * 0.5


def _stored(x, act):
    """``x`` rounded to ``act`` on both sides: (JAX array, torch tensor)."""
    return jnp.asarray(x).astype(act), torch.from_numpy(x).to(storage_dtype(act))


def _models(act, seed=1):
    x0 = jnp.zeros((1, 16, 2))
    jg, jc = JGen(act_dtype=act), JCritic(act_dtype=act)
    pg, pd = jg.init(jax.random.PRNGKey(seed), x0), jc.init(jax.random.PRNGKey(seed + 1), x0, x0)
    tg, tc = MiniGenerator(act_dtype=act), MiniDiscriminator(act_dtype=act)
    tg.load_state_dict(from_jax_params(_np(pg)))
    tc.load_state_dict(from_jax_params(_np(pd)))
    return jg, pg, tg, jc, pd, tc


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", ACT)
def test_generator_forward(act, residual):
    x0 = jnp.zeros((1, 16, 2))
    jg = JGen(act_dtype=act, input_residual=residual)
    pg = jg.init(jax.random.PRNGKey(3), x0)
    tg = MiniGenerator(act_dtype=act, input_residual=residual)
    tg.load_state_dict(from_jax_params(_np(pg)))
    jx, tx = _stored(_frames(4), act)
    ref = np.asarray(jax.jit(jg.apply)(pg, jx)).astype(np.float32)
    with torch.no_grad():
        got = tg(tx)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("act", ACT)
def test_critic_forward(act, mixed):
    """Both inputs stored, or a float32 candidate beside a stored condition
    (the generator loss's call)."""
    *_, jc, pd, tc = _models(act)
    ja, ta = _stored(_frames(5), act)
    jb, tb = _stored(_frames(6), act)
    if mixed:
        ja, ta = jnp.asarray(np.tanh(_frames(5))), torch.from_numpy(np.tanh(_frames(5)))
    ref = np.asarray(jax.jit(jc.apply)(pd, ja, jb))
    with torch.no_grad():
        got = tc(ta, tb).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ACT)
def test_gradient_penalty_and_its_parameter_gradients(act):
    *_, jc, pd, tc = _models(act, seed=7)
    (jr, tr), (jf, tf), (jn, tn) = (_stored(x, act) for x in
                                    (_frames(8), np.tanh(_frames(9)), _frames(10)))
    k_gp = jax.random.PRNGKey(11)
    alpha = np.array(jax.random.uniform(k_gp, (B, 1, 1), jnp.float32))[:, 0, 0]
    gp_ref, g_ref = jax.jit(jax.value_and_grad(
        lambda p: j_gp(jc.apply, p, jr, jf, jn, k_gp)))(pd)
    gp = compute_gradient_penalty(tc, tr, tf, tn, torch.from_numpy(alpha))
    np.testing.assert_allclose(float(gp), float(gp_ref), rtol=1e-4)
    grads = torch.autograd.grad(gp, list(tc.parameters()), materialize_grads=True)
    ref = from_jax_params(_np(g_ref))
    scale = 1e-2 if act == "bfloat16" else 1e-4
    for (name, _), g in zip(tc.named_parameters(), grads):
        r = ref[name].numpy()
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-3, atol=scale * np.abs(r).max(),
                                   err_msg=name)


@pytest.mark.parametrize("act", ACT)
def test_one_outer_step_matches_jax(act):
    """The step casts its batch to ``act`` and the pair stores its
    activations in it (reference wgan_gp.py:317-326); from a state warmed
    up by three JAX steps, one step on each side."""
    n_critic = 5
    jdg = JDatagenConfig.make(frame_length=16, snr_range=(0, 30))
    jg, pg, tg, jc, pd, tc = _models(act, seed=13)
    tx_g, tx_d = j_make_adam(LR, (0.0, 0.9)), j_make_adam(LR, (0.0, 0.9))
    jstate = TrainState.create(pg, pd, tx_g, tx_d)
    jstep = make_train_step(jg.apply, jc.apply, tx_g, tx_d, jdg, JLossConfig(), batch_size=B,
                            donate=False, act_dtype=act)
    for i in range(3):
        jstate, _ = jstep(jstate, jax.random.fold_in(KEY, i))
    opt_g, opt_d = make_adam(tg.parameters(), LR, (0.0, 0.9)), make_adam(tc.parameters(), LR,
                                                                         (0.0, 0.9))
    for mod, opt, params, jopt, updates in ((tg, opt_g, jstate.params_g, jstate.opt_g, 3),
                                            (tc, opt_d, jstate.params_d, jstate.opt_d, 15)):
        mod.load_state_dict(from_jax_params(_np(params)))
        mu, nu = from_jax_params(_np(jopt[0].mu)), from_jax_params(_np(jopt[0].nu))
        for name, param in mod.named_parameters():
            opt.opt.state[param] = {"step": torch.tensor(float(updates)),
                                    "exp_avg": mu[name].clone(), "exp_avg_sq": nu[name].clone()}
    step = TrainStep(tg, tc, opt_g, opt_d, DatagenConfig(), LossConfig(), B, act_dtype=act)
    assert step.critic_route == "plain"

    key = jax.random.fold_in(KEY, 3)
    before = [flatten_tree(_np(p)) for p in (jstate.params_g, jstate.params_d)]
    jstate, jm = jstep(jstate, key)
    k_data, k_crit, _ = jax.random.split(key, 3)
    batch = j_synthetic_batch(k_data, B, jdg)
    alphas = [torch.from_numpy(np.array(jax.random.uniform(k, (B, 1, 1), jnp.float32))[:, 0, 0])
              for k in jax.random.split(k_crit, n_critic)]
    tm = step.run({k: torch.from_numpy(np.array(batch[k])) for k in ("noisy", "clean")}, alphas)
    for name, ref in jm.items():
        np.testing.assert_allclose(float(tm[name]), float(ref), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    fp8 = act != "bfloat16"
    for mod, jp, p0, atol, norm_rtol in (
            (tg, jstate.params_g, before[0], LR / 2 if fp8 else LR / 10, 0.25 if fp8 else 0.02),
            (tc, jstate.params_d, before[1], 2e-6 if fp8 else LR / 10, 0.02)):
        ref, got = flatten_tree(_np(jp)), flatten_tree(to_jax_params(mod))
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=atol, err_msg=k)
            upd_ref, upd_got = ref[k] - p0[k], got[k] - p0[k]
            off = float(np.linalg.norm(upd_got - upd_ref))
            assert off <= norm_rtol * float(np.linalg.norm(upd_ref)) + 1e-12, (k, off)


def test_an_unknown_storage_format_raises():
    with pytest.raises(ValueError):
        MiniGenerator(act_dtype="float16")
