"""The port's flat ``[B, F]`` mini step against the JAX package's.

Every input is made from a numpy seed or from the JAX package's own key
splits, and the parameters are JAX's, bridged with ``utils/jax_params``.

* The flat applies (``models/flat.py``) against JAX's
  ``make_*_flat_apply`` and against the port's modules: rtol 1e-5, atol
  1e-6 (float32 sums in another order), 1e-5 at bf16 storage (a value on a
  bf16 rounding boundary may round to the other neighbour in one package).
* ``tf32_matmul`` against JAX's as a TPU computes it: XLA's CPU ignores the
  precision of a dot, so the JAX side runs through ``with_bf16_operands(...,
  only_default=True)`` (``tests/jax_bf16_dots.py``), which rounds the
  operands of the dots a TPU runs as one bf16 pass. The forward within 5e-7
  of its largest entry (measured 5.2e-8; 5.8e-6 from float64, 2.7e-3 for
  one-pass bf16), its first derivatives equal (1e-6), the penalty's
  gradients with respect to the critic's parameters (its grad-of-grad)
  within 1e-4 of each tensor's largest (measured: 0 to 6.2e-6). Each lies
  at least ten times as far from float64 and from one-pass bf16 as the
  bound (measured: the penalty's gradients 1.9e-3 to 6.2e-3 from float64,
  1.1e-2 to 2.0e-2 from one-pass bf16), so the gate tells them apart.
* The port's dense matrices (its one expansion, the reference's
  ``onehot``) equal JAX's under both of JAX's ``CONV_EXPAND`` values, bit
  for bit, at every layer of the mini pair; their weight gradients lie
  within 1e-6 of the largest entry (float32 sums in another order).
* ``synthetic_batch_flat_from_draws`` from JAX's draws against JAX's
  ``synthetic_batch_flat``: rtol 1e-5, atol 1e-6.
* One premapped flat step from a state warmed up by three JAX steps,
  against JAX's ``build_train_step`` with the same premaps and the same
  batch and penalty draws: at float32 (both expansions, ``mm`` ambient and
  ``tf32x3_gp``) the parameters within 2e-6 and the metrics rtol 1e-5, as
  ``tests/test_torch_train_step.py`` holds the module step; the reference
  bench's headline (``bf16_tf32gp``, bf16 storage, ``tf32x3_gp``,
  ``onehot``) within a tenth of one update (lr / 10) and the metrics rtol
  1e-4, as ``tests/test_torch_act_dtype.py`` holds bf16 steps (the
  penalty's bf16 backward rounds in another order); ``d_loss`` also within
  one bf16 rounding of ``gp_weight * gp``, which the op-by-op JAX of the
  rounding interpreter takes and XLA's fused arithmetic, like the port,
  does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_bf16_dots import with_bf16_operands
from ofdmgan_tpu.models import MiniDiscriminator as JCritic
from ofdmgan_tpu.models import MiniGenerator as JGen
from ofdmgan_tpu.models import flat as jflat
from ofdmgan_tpu.models.critic import compute_gradient_penalty as j_gp
from ofdmgan_tpu.ops import dense_conv as j_dense_conv
from ofdmgan_tpu.signal import DatagenConfig as JDatagenConfig
from ofdmgan_tpu.signal import synthetic_batch as j_synthetic_batch
from ofdmgan_tpu.signal.datagen import synthetic_batch_flat as j_synthetic_batch_flat
from ofdmgan_tpu.training import TrainState
from ofdmgan_tpu.training import make_adam as j_make_adam
from ofdmgan_tpu.training.wgan_gp import LossConfig as JLossConfig
from ofdmgan_tpu.training.wgan_gp import build_train_step
from ofdmgan_tpu_torch.models import MiniDiscriminator, MiniGenerator
from ofdmgan_tpu_torch.models import flat
from ofdmgan_tpu_torch.models.critic import compute_gradient_penalty
from ofdmgan_tpu_torch.ops import bf16_dots
from ofdmgan_tpu_torch.ops.dense_conv import conv1d_dense_matrix
from ofdmgan_tpu_torch.signal.datagen import (DatagenConfig, synthetic_batch_flat,
                                              synthetic_batch_flat_from_draws)
from ofdmgan_tpu_torch.training.schedules import make_adam
from ofdmgan_tpu_torch.training.wgan_gp import LossConfig, TrainStep
from ofdmgan_tpu_torch.utils.jax_params import from_jax_params, to_jax_params
from ofdmgan_tpu_torch.utils.params_io import flatten_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

B, LR, KEY = 32, 2e-4, jax.random.PRNGKey(0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _frames(seed, b=B):
    return np.random.default_rng(seed).standard_normal((b, 16, 2)).astype(np.float32) * 0.5


def _pair(seed=1, act=None, residual=False):
    """JAX's mini pair initialised from ``seed`` and the port's with the same
    parameters."""
    x0 = jnp.zeros((1, 16, 2))
    jg, jc = JGen(act_dtype=act, input_residual=residual), JCritic(act_dtype=act)
    pg, pd = jg.init(jax.random.PRNGKey(seed), x0), jc.init(jax.random.PRNGKey(seed + 1), x0, x0)
    g = MiniGenerator(act_dtype=act, input_residual=residual)
    c = MiniDiscriminator(act_dtype=act)
    g.load_state_dict(from_jax_params(_np(pg)))
    c.load_state_dict(from_jax_params(_np(pd)))
    return pg, pd, g, c


def _stored(x, act):
    return ((jnp.asarray(x), torch.from_numpy(x)) if act is None else
            (jnp.asarray(x).astype(act), torch.from_numpy(x).to(getattr(torch, act))))


@pytest.mark.parametrize("act", [None, "bfloat16"])
@pytest.mark.parametrize("layout", ["frames", "flat"])
@pytest.mark.parametrize("residual", [False, True])
def test_flat_generator_matches_jax_and_the_module(residual, layout, act):
    pg, _, g, _ = _pair(act=act, residual=residual)
    x = _frames(3)
    if layout == "flat":
        x = x.reshape(B, 32)
    jx, tx = _stored(x, act)
    ref = np.asarray(jflat.make_generator_flat_apply(act_dtype=act, input_residual=residual)(
        pg, jx), np.float32)
    with torch.no_grad():
        got = flat.make_generator_flat_apply(act_dtype=act, input_residual=residual)(g, tx)
        module = g(tx.reshape(B, 16, 2)).reshape(got.shape)
    assert got.shape == x.shape
    atol = 1e-6 if act is None else 1e-5
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(got.float().numpy(), module.float().numpy(), rtol=1e-5, atol=atol)


@pytest.mark.parametrize("act", [None, "bfloat16"])
@pytest.mark.parametrize("expand", ["dus", "onehot"])
def test_flat_critic_matches_jax_and_the_module(expand, act):
    """(``expand``: JAX's ``CONV_EXPAND``; the port has one form.)"""
    _, pd, _, c = _pair(act=act)
    cand, cond = (_stored(_frames(s), act) for s in (4, 5))
    saved = j_dense_conv.CONV_EXPAND
    j_dense_conv.CONV_EXPAND = expand
    try:
        ref = np.asarray(jflat.make_critic_flat_apply(act_dtype=act)(pd, cand[0], cond[0]))
    finally:
        j_dense_conv.CONV_EXPAND = saved
    with torch.no_grad():
        got = flat.make_critic_flat_apply(act_dtype=act)(c, cand[1], cond[1])
        module = c(cand[1], cond[1])
    atol = 1e-6 if act is None else 1e-5
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(got.numpy(), module.numpy(), rtol=1e-5, atol=atol)


# ------------------------------------------------------------- tf32_matmul
def _operands():
    r = np.random.default_rng(0)
    return (r.standard_normal((64, 32)).astype(np.float32),
            r.standard_normal((32, 16)).astype(np.float32),
            r.standard_normal((64, 16)).astype(np.float32))


def _rel(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()
                 / np.abs(np.asarray(b, np.float64)).max())


def test_tf32_matmul_forward_matches_jax_and_lies_between_bf16_and_float32():
    x, a, _ = _operands()
    ref = np.asarray(with_bf16_operands(jflat.tf32_matmul, only_default=True)(
        jnp.asarray(x), jnp.asarray(a)))
    got = flat.tf32_matmul(torch.from_numpy(x), torch.from_numpy(a)).numpy()
    exact = x.astype(np.float64) @ a.astype(np.float64)
    one_pass = bf16_dots.matmul(torch.from_numpy(x), torch.from_numpy(a)).numpy()
    err = _rel(got, ref)
    assert err <= 5e-7, err
    assert _rel(got, exact) >= 10 * 5e-7 and _rel(one_pass, exact) >= 10 * _rel(got, exact)


def test_tf32_matmul_first_derivatives_match_jax():
    """The reference's first derivatives are transposes of the decomposition
    (bf16-rounded cotangents): the port computes them equal, and they lie
    as far from exact as one-pass bf16's."""
    x, a, w = _operands()
    jx, ja, jw = map(jnp.asarray, (x, a, w))
    loss = lambda x_, a_: jnp.sum(jw * jflat.tf32_matmul(x_, a_))  # noqa: E731
    refs = with_bf16_operands(jax.grad(loss, argnums=(0, 1)), only_default=True)(jx, ja)
    tx, ta = (torch.from_numpy(t).requires_grad_() for t in (x, a))
    gots = torch.autograd.grad((torch.from_numpy(w) * flat.tf32_matmul(tx, ta)).sum(), (tx, ta))
    exact = (w.astype(np.float64) @ a.T.astype(np.float64), x.T.astype(np.float64) @ w)
    for got, ref, ex in zip(gots, refs, exact):
        assert _rel(got.numpy(), ref) <= 1e-6
        assert _rel(ref, ex) >= 1e-3   # bf16-level, not bf16x3-level


def _gp_param_grads(critic, apply, real, fake, cond, alpha):
    gp = compute_gradient_penalty(lambda a_, b_: apply(critic, a_, b_), real, fake, cond, alpha)
    grads = torch.autograd.grad(gp, list(critic.parameters()), allow_unused=True)
    return {n: (torch.zeros_like(p) if g is None else g).double().numpy()
            for (n, p), g in zip(critic.named_parameters(), grads)}


def test_tf32_matmul_penalty_grad_of_grad_matches_jax():
    """The gradient penalty of the flat critic with every product on
    ``tf32_matmul`` (``--mm tf32x3``), differentiated with respect to the
    critic's parameters: the port against JAX's on the TPU's rounding,
    beside float64 and one-pass bf16."""
    _, pd, _, c = _pair(seed=2)
    real, fake, cond = (_frames(s, 64) for s in (6, 7, 8))
    key = jax.random.PRNGKey(4)
    alpha = np.asarray(jax.random.uniform(key, (64, 1, 1), jnp.float32))[:, 0, 0]
    japply = jflat.make_critic_flat_apply(mm="tf32x3")
    jgrad = jax.grad(lambda p: j_gp(japply, p, jnp.asarray(real), jnp.asarray(fake),
                                    jnp.asarray(cond), key))
    ref = {k: v.double().numpy() for k, v in from_jax_params(_np(
        with_bf16_operands(jgrad, only_default=True)(pd))).items()}
    inputs = [torch.from_numpy(t) for t in (real, fake, cond, alpha)]
    got = _gp_param_grads(c, flat.make_critic_flat_apply(mm="tf32x3"), *inputs)
    c64 = MiniDiscriminator().double()
    c64.load_state_dict(c.state_dict())
    exact = _gp_param_grads(c64, flat.make_critic_flat_apply(), *(t.double() for t in inputs))
    with bf16_dots.bf16_operands():
        one_pass = _gp_param_grads(c, flat.make_critic_flat_apply(), *inputs)
    for k, r in ref.items():
        if not np.abs(r).max():
            continue   # the biases' penalty gradients are 0 in every form
        err = _rel(got[k], r)
        assert err <= 1e-4, (k, err)
        assert _rel(exact[k], r) >= 10 * 1e-4 and _rel(one_pass[k], r) >= 10 * 1e-4, k


# ------------------------------------------------------------- expansions
LAYERS = [((4, 2, 3), 16, 2), ((8, 4, 3), 8, 2), ((4, 8, 3), 8, 1), ((2, 4, 3), 16, 1),
          ((8, 2, 3), 16, 2), ((16, 8, 3), 8, 2)]   # the mini pair's convs and conv1's slices


@pytest.mark.parametrize("shape,l_in,stride", LAYERS)
def test_dus_and_onehot_are_bit_identical(shape, l_in, stride):
    """The port's matrix against JAX's in each of JAX's two expansions, bit
    for bit; its weight gradient within 1e-6 of the largest entry (each is
    a float32 sum over the output positions, taken in another order:
    measured at most 2.3e-7)."""
    r = np.random.default_rng(sum(shape) + l_in)
    w = torch.from_numpy(r.standard_normal(shape).astype(np.float32))
    l_out = (l_in + 2 - 3) // stride + 1
    cot = r.standard_normal((l_in * shape[1], l_out * shape[0])).astype(np.float32)
    wr = w.clone().requires_grad_(True)
    m = conv1d_dense_matrix(wr, l_in, stride, 1)
    grad = torch.autograd.grad(m, wr, torch.from_numpy(cot))[0].permute(2, 1, 0).numpy()
    saved = j_dense_conv.CONV_EXPAND
    try:
        for expand in ("dus", "onehot"):
            j_dense_conv.CONV_EXPAND = expand
            jm, vjp = jax.vjp(lambda jw: j_dense_conv.conv1d_dense_matrix(jw, l_in, stride, 1),
                              jnp.asarray(w.permute(2, 1, 0).numpy()))
            np.testing.assert_array_equal(m.detach().numpy(), np.asarray(jm), err_msg=expand)
            ref = np.asarray(vjp(jnp.asarray(cot))[0])
            np.testing.assert_allclose(grad, ref, rtol=0, atol=1e-6 * np.abs(ref).max(),
                                       err_msg=expand)
    finally:
        j_dense_conv.CONV_EXPAND = saved


# ------------------------------------------------------------- flat datagen
@pytest.mark.parametrize("L,snr", [(16, (0.0, 30.0)), (64, (5.0, 15.0))])
def test_flat_datagen_matches_jax_from_its_draws(L, snr):
    key = jax.random.PRNGKey(11)
    n = 256
    k_sym, _, k_snr, k_ch = jax.random.split(key, 4)   # datagen.py:144-167
    kr, ki = jax.random.split(k_sym)
    kr2, ki2 = jax.random.split(k_ch)
    draws = {"zr": jax.random.normal(kr, (n, L)), "zi": jax.random.normal(ki, (n, L)),
             "u": jax.random.uniform(k_snr, (n,), jnp.float32),
             "nr": jax.random.normal(kr2, (n, L)), "ni": jax.random.normal(ki2, (n, L))}
    jdg = JDatagenConfig.make(frame_length=L, snr_range=snr)
    ref = j_synthetic_batch_flat(key, n, jdg)
    cfg = DatagenConfig(frame_length=L, snr_min=snr[0], snr_max=snr[1])
    got = synthetic_batch_flat_from_draws({k: torch.from_numpy(np.array(v))
                                           for k, v in draws.items()}, cfg)
    for name in ("noisy", "clean", "snr"):
        assert got[name].shape == ref[name].shape
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_flat_datagen_refuses_what_it_does_not_cover():
    gen = torch.Generator().manual_seed(0)
    for cfg in (DatagenConfig(nonlinear=True), DatagenConfig.make(channel_type="rayleigh")):
        with pytest.raises(ValueError, match="linear AWGN"):
            synthetic_batch_flat(gen, 8, cfg)


# ------------------------------------------------------------- the step
STEPS = {"float32": dict(act=None, precision="float32"),
         "headline": dict(act="bfloat16", precision="bf16_tf32gp")}


@pytest.mark.parametrize("expand,mm,mode,premap", [("dus", "ambient", "float32", True),
                                                   ("onehot", "ambient", "float32", True),
                                                   ("dus", "tf32x3_gp", "float32", True),
                                                   ("onehot", "tf32x3_gp", "float32", True),
                                                   ("onehot", "tf32x3_gp", "headline", True),
                                                   ("dus", "tf32x3_gp", "float32", False)])
def test_one_premapped_flat_step_matches_jax(expand, mm, mode, premap):
    """(The last case: the flat step without premaps, the matrices built at
    every apply, against the reference's ``make_*_flat_apply``.)"""
    act, precision = STEPS[mode]["act"], STEPS[mode]["precision"]
    n_critic = 5
    pg, pd, g, c = _pair(seed=13, act=act)
    if premap:
        jg_pre, jg_apply = jflat.make_generator_flat_parts(act_dtype=act)
        jc_pre, jc_apply = jflat.make_critic_flat_parts(act_dtype=act)
        jc_gp = (jflat.make_critic_flat_parts(act_dtype=act, mm="tf32x3")[1]
                 if mm != "ambient" else None)
    else:
        jg_pre = jc_pre = None
        jg_apply = jflat.make_generator_flat_apply(act_dtype=act)
        jc_apply = jflat.make_critic_flat_apply(act_dtype=act)
        jc_gp = (jflat.make_critic_flat_apply(act_dtype=act, mm="tf32x3")
                 if mm != "ambient" else None)
    jdg = JDatagenConfig.make(frame_length=16, snr_range=(0, 30))
    batches = [j_synthetic_batch(jax.random.fold_in(KEY, i), B, jdg) for i in range(4)]
    tx_g, tx_d = j_make_adam(LR, (0.0, 0.9)), j_make_adam(LR, (0.0, 0.9))

    def jstep(i):
        return build_train_step(jg_apply, jc_apply, tx_g, tx_d, jdg,
                                JLossConfig(n_critic=n_critic), B,
                                matmul_precision=precision, act_dtype=act,
                                batch_fn=lambda k, n: batches[i], critic_apply_gp=jc_gp,
                                gen_premap=jg_pre, critic_premap=jc_pre)

    saved = j_dense_conv.CONV_EXPAND
    j_dense_conv.CONV_EXPAND = expand
    try:
        jstate = TrainState.create(pg, pd, tx_g, tx_d)
        for i in range(3):   # warm up (ROADMAP trap 1), at XLA's CPU rounding
            jstate, _ = jax.jit(jstep(i))(jstate, jax.random.fold_in(KEY, 100 + i))
        warm = jstate
        key = jax.random.fold_in(KEY, 103)
        # the compared step at the TPU's rounding of one-pass dots
        run = with_bf16_operands(jstep(3), only_default=True) if (mm != "ambient" or act) \
            else jax.jit(jstep(3))
        jstate, jm = run(jstate, key)
    finally:
        j_dense_conv.CONV_EXPAND = saved

    opt_g = make_adam(g.parameters(), LR, (0.0, 0.9))
    opt_d = make_adam(c.parameters(), LR, (0.0, 0.9))
    for mod, opt, params, jopt in ((g, opt_g, warm.params_g, warm.opt_g),
                                   (c, opt_d, warm.params_d, warm.opt_d)):
        mod.load_state_dict(from_jax_params(_np(params)))
        mu, nu = from_jax_params(_np(jopt[0].mu)), from_jax_params(_np(jopt[0].nu))
        for name, param in mod.named_parameters():
            opt.opt.state[param] = {"step": torch.tensor(float(jopt[0].count)),
                                    "exp_avg": mu[name].clone(), "exp_avg_sq": nu[name].clone()}
    step = TrainStep(g, c, opt_g, opt_d, DatagenConfig(), LossConfig(n_critic=n_critic), B,
                     reference=True, act_dtype=act, matmul_precision=precision,
                     flat=flat.make_flat_step(g, c, 16, act, mm, premap=premap))
    _, k_crit, _ = jax.random.split(key, 3)
    alphas = [torch.from_numpy(np.array(jax.random.uniform(k, (B, 1, 1), jnp.float32))[:, 0, 0])
              for k in jax.random.split(k_crit, n_critic)]
    tm = step.run({k: torch.from_numpy(np.array(batches[3][k])) for k in ("noisy", "clean")},
                  alphas)
    rtol, atol = (1e-5, 2e-6) if act is None else (1e-4, LR / 10)
    for name, ref in jm.items():
        # the interpreter's op-by-op JAX rounds the bf16 penalty's gp_weight * gp
        # to bf16 before the float32 sum, where XLA's fused arithmetic (and the
        # port) does not: one bf16 rounding of that term
        slack = 10.0 * float(jm["gradient_penalty"]) * 2.0 ** -8 if (act and name in (
            "d_loss",)) else 1e-6
        np.testing.assert_allclose(float(tm[name]), float(ref), rtol=rtol, atol=slack,
                                   err_msg=name)
    for mod, jp in ((g, jstate.params_g), (c, jstate.params_d)):
        ref, got = flatten_tree(_np(jp)), flatten_tree(to_jax_params(mod))
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=atol, err_msg=k)
