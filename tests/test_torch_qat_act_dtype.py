"""Quantization-aware training with an activation storage format
(``qat``/``rtl_faithful`` with ``act_dtype``) against the JAX package's,
and the refusals of the combinations the reference cannot run.

The reference applies its Q8.8 rounding (``q88_ste``) to the stored value
in its storage format. In bf16 and e5m2 each of its operations is exact on
such values, so both packages' forwards compute the same float32 function
of the same rounded values: atol 1e-5 and rtol 1e-5, as
``tests/test_torch_act_dtype.py`` (measured: 1.2e-7 at most). In e4m3fn
the clip's bounds (-32768, 32767) lie outside the format and are NaN, so
every output of a ``qat`` forward is NaN in both; ``rtl_faithful`` alone is
finite: the tests hold the NaN pattern and the finite entries. Parameter
gradients at bf16 within 3e-2 of each tensor's largest entry (the
reference sums the bf16 cotangents where an activation fans out and
where the upsample is transposed in bf16, the port in float32; measured
1.7e-2 at most); in fp8 those sums round in fp8 there, and the tests hold
one outer step at ``tests/test_torch_act_dtype.py``'s tolerances instead,
but for the bf16 penalty, a bf16 value whose norm may round to the
neighbouring step in either package (measured: one step, 2^-12, 2.4e-3 of the critic loss,
in the ``rtl_qat_residual`` step): it and the critic loss are held within
one bf16 step of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdmgan_tpu.models import MiniDiscriminator as JCritic
from ofdmgan_tpu.models import MiniGenerator as JGen
from ofdmgan_tpu.models.full_unet import FullUNetGenerator as JFullGen
from ofdmgan_tpu.signal import DatagenConfig as JDatagenConfig
from ofdmgan_tpu.signal import synthetic_batch as j_synthetic_batch
from ofdmgan_tpu.training import TrainState
from ofdmgan_tpu.training import make_adam as j_make_adam
from ofdmgan_tpu.training import make_train_step
from ofdmgan_tpu.training.wgan_gp import LossConfig as JLossConfig
from ofdmgan_tpu_torch import train as train_cli
from ofdmgan_tpu_torch.config import Config
from ofdmgan_tpu_torch.models import MiniDiscriminator, MiniGenerator
from ofdmgan_tpu_torch.models.generator import q88_stored, round_stored, storage_dtype
from ofdmgan_tpu_torch.signal.datagen import DatagenConfig
from ofdmgan_tpu_torch.training.schedules import make_adam
from ofdmgan_tpu_torch.training.trainer import Trainer, build_models
from ofdmgan_tpu_torch.training.wgan_gp import LossConfig, TrainStep
from ofdmgan_tpu_torch.utils.jax_params import from_jax_params, to_jax_params
from ofdmgan_tpu_torch.utils.params_io import flatten_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ACT = ["bfloat16", "float8_e4m3fn", "float8_e5m2"]
MODES = {"qat": dict(qat=True), "rtl": dict(rtl_faithful=True),
         "rtl_qat_residual": dict(qat=True, rtl_faithful=True, input_residual=True)}
KEY = jax.random.PRNGKey(0)
B, LR = 32, 2e-4
GRAD_BF16 = 3e-2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _frames(seed, b=B):
    return np.random.default_rng(seed).standard_normal((b, 16, 2)).astype(np.float32) * 0.5


def _generators(act, mode, seed=3):
    jg = JGen(act_dtype=act, **MODES[mode])
    pg = jg.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16, 2)))
    tg = MiniGenerator(act_dtype=act, **MODES[mode])
    tg.load_state_dict(from_jax_params(_np(pg)))
    return jg, pg, tg


def _bf16_penalty_atol(name, act, jm):
    """At bf16 the penalty is a bf16 value in both packages, and its norm's
    bf16 arithmetic may round to the neighbouring step: the penalty is held
    within one bf16 step (2^-7 of its value, at least one unit in the last
    place) and the critic loss within gp_weight times that."""
    if act != "bfloat16" or name not in ("gradient_penalty", "d_loss"):
        return 1e-6
    step = 2.0 ** -7 * abs(float(jm["gradient_penalty"]))
    return step * (JLossConfig().gp_weight if name == "d_loss" else 1.0) + 1e-6


def _same_nans_and_close(got, ref, atol, what=""):
    assert np.array_equal(np.isnan(got), np.isnan(ref)), what
    fin = ~np.isnan(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=atol, atol=atol, err_msg=what)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("act", ACT)
def test_forward_matches_jax(act, mode):
    """A stored batch through the QAT generator; e4m3fn ``qat`` is NaN
    everywhere in both packages, ``rtl`` finite in every format."""
    jg, pg, tg = _generators(act, mode)
    x = _frames(4)
    ref = np.asarray(jax.jit(jg.apply)(pg, jnp.asarray(x).astype(act))).astype(np.float32)
    with torch.no_grad():
        got = tg(torch.from_numpy(x).to(storage_dtype(act))).numpy()
    _same_nans_and_close(got, ref, 1e-5)
    all_nan = act == "float8_e4m3fn" and MODES[mode].get("qat", False)
    assert np.isnan(ref).all() if all_nan else np.isfinite(ref).all()


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("act", ACT)
def test_parameter_gradients(act, mode):
    """The gradient of a fixed projection of the output: NaN where the
    reference's is, within GRAD_BF16 at bf16 (fp8: see the module's
    docstring)."""
    jg, pg, tg = _generators(act, mode, seed=5)
    x, r = _frames(6), np.random.default_rng(7).standard_normal((B, 16, 2)).astype(np.float32)
    jx = jnp.asarray(x).astype(act)
    jgrads = jax.jit(jax.grad(lambda p: jnp.sum(jg.apply(p, jx).astype(jnp.float32) * r)))(pg)
    out = tg(torch.from_numpy(x).to(storage_dtype(act)))
    grads = torch.autograd.grad((out * torch.from_numpy(r)).sum(), list(tg.parameters()))
    ref = from_jax_params(_np(jgrads))
    for (name, _), g in zip(tg.named_parameters(), grads):
        got, want = g.numpy(), ref[name].numpy()
        assert np.array_equal(np.isnan(got), np.isnan(want)), name
        if act == "bfloat16":
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=GRAD_BF16 * np.abs(want).max() + 1e-12, err_msg=name)


@pytest.mark.parametrize("mode", ["qat", "rtl_qat_residual"])
@pytest.mark.parametrize("act", ACT)
def test_one_outer_step_matches_jax(act, mode):
    """The step casts its batch to ``act``; the QAT generator stores its
    activations in it and rounds them to Q8.8 there. From a state warmed up
    by three JAX steps, one step on each side, held as
    ``tests/test_torch_act_dtype.py`` holds the float pair's (e4m3fn
    ``qat``: the NaN patterns)."""
    jdg = JDatagenConfig.make(frame_length=16, snr_range=(0, 30))
    jg, pg, tg = _generators(act, mode, seed=13)
    jc = JCritic(act_dtype=act)
    pd = jc.init(jax.random.PRNGKey(14), jnp.zeros((1, 16, 2)), jnp.zeros((1, 16, 2)))
    tc = MiniDiscriminator(act_dtype=act)
    tc.load_state_dict(from_jax_params(_np(pd)))
    tx_g, tx_d = j_make_adam(LR, (0.0, 0.9)), j_make_adam(LR, (0.0, 0.9))
    jstate = TrainState.create(pg, pd, tx_g, tx_d)
    jstep = make_train_step(jg.apply, jc.apply, tx_g, tx_d, jdg, JLossConfig(), batch_size=B,
                            donate=False, act_dtype=act)
    for i in range(3):
        jstate, _ = jstep(jstate, jax.random.fold_in(KEY, i))
    opt_g, opt_d = (make_adam(m.parameters(), LR, (0.0, 0.9)) for m in (tg, tc))
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
              for k in jax.random.split(k_crit, 5)]
    tm = step.run({k: torch.from_numpy(np.array(batch[k])) for k in ("noisy", "clean")}, alphas)
    nan_step = act == "float8_e4m3fn"
    for name, ref in jm.items():
        if nan_step:
            assert np.isnan(float(ref)) == np.isnan(float(tm[name])), name
        else:
            np.testing.assert_allclose(float(tm[name]), float(ref), rtol=1e-4,
                                       atol=_bf16_penalty_atol(name, act, jm), err_msg=name)
    fp8 = act != "bfloat16"
    for mod, jp, p0, atol, norm_rtol in (
            (tg, jstate.params_g, before[0], LR / 2 if fp8 else LR / 10, 0.25 if fp8 else 0.02),
            (tc, jstate.params_d, before[1], 2e-6 if fp8 else LR / 10, 0.02)):
        ref, got = flatten_tree(_np(jp)), flatten_tree(to_jax_params(mod))
        for k in ref:
            if nan_step:
                assert np.array_equal(np.isnan(got[k]), np.isnan(ref[k])), k
                continue
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=atol, err_msg=k)
            upd_ref, upd_got = ref[k] - p0[k], got[k] - p0[k]
            off = float(np.linalg.norm(upd_got - upd_ref))
            assert off <= norm_rtol * float(np.linalg.norm(upd_ref)) + 1e-12, (k, off)


def test_e4m3fn_converts_as_xla():
    """Past e4m3fn's range a value converts to NaN, as XLA converts it
    (torch's cast saturates to 448); e5m2 and bf16 round as torch does."""
    x = np.array([1.0, 449.0, 463.0, 464.0, 465.0, 500.0, -1e6, 7e4], np.float32)
    for act in ACT:
        ref = np.asarray(jnp.asarray(x).astype(act).astype(jnp.float32))
        got = round_stored(torch.from_numpy(x), storage_dtype(act)).numpy()
        np.testing.assert_array_equal(got, ref, err_msg=act)


@pytest.mark.parametrize("act", ACT)
def test_q88_on_a_stored_value_is_the_reference_ste(act):
    """``q88_stored`` against ``q88_ste`` on stored values, forward and
    backward (the identity, NaN-free even where the forward is NaN)."""
    from ofdmgan_tpu.models.generator import q88_ste

    x = np.concatenate([_frames(21, 64).reshape(-1) * 4, [0.001, 1.8, -3.0, 200.0]])
    jx = jnp.asarray(x.astype(np.float32)).astype(act)
    ref = np.asarray(q88_ste(jx).astype(jnp.float32))
    t = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).requires_grad_(True)
    got = q88_stored(t, storage_dtype(act))
    _same_nans_and_close(got.detach().numpy(), ref, 0.0)
    (g,) = torch.autograd.grad(got.sum(), t)
    assert torch.equal(g, torch.ones_like(g))


def test_cli_trains_qat_with_a_storage_format(tmp_path):
    """``--qat --act_dtype bfloat16`` (once refused) trains a short run."""
    args = ["--device", "cpu", "--qat", "--act_dtype", "bfloat16", "--epochs", "1",
            "--samples_per_epoch", "128", "--val_samples", "64", "--skip_export",
            "--checkpoint_dir", str(tmp_path / "ck"), "--log_dir", str(tmp_path / "logs")]
    trainer = train_cli.main(args)
    assert trainer.generator.qat and trainer.generator.act_dtype == torch.bfloat16
    assert trainer.global_step == 2 and np.isfinite(trainer.best_val_loss)


def test_quantized_full_unet_with_a_storage_format_is_refused_by_both():
    """The quantized full U-Net on a step that casts its batch: the
    reference's ``_QuantConv`` raises on the bf16 input, and the port
    refuses it at construction with the reference's reason; under ``gspmd``
    and ``pp`` no batch is cast and the port accepts it."""
    jg = JFullGen(frame_length=64, levels=3, base_channels=4, weight_bits=8, act_bits=16)
    x = jnp.zeros((2, 64, 2))
    pg = jax.jit(jg.init)(KEY, x)
    with pytest.raises(TypeError, match="same dtypes"):
        jax.jit(jg.apply)(pg, x.astype(jnp.bfloat16))
    g, d = build_models(Config(frame_length=64), "full", 0, quant_bits=(8, 16))
    with pytest.raises(ValueError, match="the reference cannot run it either"):
        Trainer(device="cpu", generator=g, discriminator=d, act_dtype="bfloat16")
