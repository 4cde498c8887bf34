"""Quantization-aware training in the port against the JAX package.

Mini generator, modes ``qat``, ``rtl_faithful`` and both with
``input_residual``, from the same flax weights (scaled so that clamps,
saturations and the tanh clamp are reached): forward values within
atol 1e-5, gradients (of a random projection of the output, to every
parameter and to the input) within 1e-4 of each tensor's largest entry.
Under ``qat`` each conv's operands lie on the 2^-8 and 2^-7 grids, so its
products and partial sums are exact in float32 and the summation order
(cuDNN/ATen against XLA's dense matmul) cannot move a value across a Q8.8
rounding boundary: the number of elements off by one Q8.8 step is 0 by
construction, and the tests hold it there.

Full U-Net at levels 3, base 8, L = 64. With ``weight_bits=8`` alone
nothing is rounded after a conv: forward atol 1e-5, gradients 1e-4 of each
tensor's largest entry. With ``act_bits=16`` each of the 17 quantization
points rounds its activation per tensor to steps of max|h| / 32767 after
convolutions that sum in another order than XLA's, so an activation
within ~1e-7 of a half step rounds the other way, and the scale of every
later point moves with it: run freely, a large share of the output's
elements differ by a few output steps, about as many as when a
quantization point is missing. So each point is held on its own: the
port's modules run on JAX's quantized activations (captured from the
flax model), and each point's result equals JAX's within atol 1e-5 except
at most FULL_FLIPS elements, each off by one step (± 1e-5). Measured at
seeds 0-3, 16 and 64 frames: 0 to 22 such elements (18 for ``a16`` and 12
for ``w8a16`` at this test's seed and 64 frames), none beyond one step;
the output then agrees within 1.2e-7. FULL_FLIPS = 40 leaves room for
another CPU's conv kernels. Planted faults (the input's or a skip sum's
quantization left out, a per-channel scale in place of the per-tensor
one) put 5,652 to 89,026 elements beyond atol 1e-5 at this seed and 64
frames (as few as 39 at 16 frames, hence 64 here), and
the test holds that they fail it. Run freely, the output is held within
FULL_ATOL = 5e-4 (largest difference measured 5.5e-5 to 1.3e-4) with a
median under 2e-5. A flip can also move one pre-activation across zero,
which changes its LeakyReLU derivative from 1 to 0.2: at seeds 1-3
exactly one element of the last decoder level crossed, and the whole
parameter gradient then differed by up to 2.1e-2 of its norm (2e-5 to
5e-5 where none crossed). The gradient is held within FULL_GRAD_RTOL =
5e-2 of its norm.

One outer QAT step of the port (the critic kernel's route, its plain
version here) from a state warmed by three JAX steps, against JAX's step
on the same draws: each tensor's update within 1e-3 of its largest entry.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdmgan_tpu.models import MiniGenerator as JGen
from ofdmgan_tpu.models.full_unet import FullUNetGenerator as JFull
from ofdmgan_tpu_torch import train as train_cli
from ofdmgan_tpu_torch.models import MiniGenerator
from ofdmgan_tpu_torch.models.full_unet import FullUNetGenerator
from ofdmgan_tpu_torch.config import Config
from ofdmgan_tpu_torch.quant.fakequant import fake_quantize_auto
from ofdmgan_tpu_torch.training.trainer import Trainer, build_models
from ofdmgan_tpu_torch.utils.jax_params import from_jax_params, to_jax_params
from ofdmgan_tpu_torch.utils.params_io import flatten_tree
from test_torch_train_step import Pair
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

MINI_MODES = [dict(qat=True), dict(rtl_faithful=True), dict(rtl_faithful=True, qat=True),
              dict(rtl_faithful=True, qat=True, input_residual=True),
              dict(qat=True, input_residual=True)]
FULL_ATOL = 5e-4
FULL_FLIPS = 40
FULL_GRAD_RTOL = 5e-2
STEP_RTOL = 1e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _grads_as_tree(module):
    """The parameter gradients of a port model as a flat flax-layout dict."""
    holder = copy.deepcopy(module)
    for p, g in zip(holder.parameters(), module.parameters()):
        p.data = g.grad.clone()
    return flatten_tree(to_jax_params(holder))


def _forward_and_grads(jmod, tmod, params, x, r):
    """(JAX output, port output, JAX and port parameter gradients, JAX and
    port input gradients) of sum(model(x) * r)."""
    jloss = lambda p, v: jnp.sum(jmod.apply(p, v) * r)  # noqa: E731
    jp_grad, jx_grad = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tmod(xt)
    (out * torch.from_numpy(r)).sum().backward()
    return (np.asarray(jmod.apply(params, x)), out.detach().numpy(),
            flatten_tree(_np(jp_grad)), _grads_as_tree(tmod), np.asarray(jx_grad),
            xt.grad.numpy())


def _assert_grads(ref, got, rtol):
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                   atol=rtol * float(np.abs(ref[k]).max()) + 1e-12, err_msg=k)


@pytest.mark.parametrize("kw", MINI_MODES, ids=lambda kw: "+".join(kw))
def test_mini_modes_match_jax(kw):
    jg = JGen(**kw)
    params = _np(jg.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 2))))
    params = jax.tree_util.tree_map(lambda a: a * 3.0 + 0.01, params)
    tg = MiniGenerator(**kw)
    tg.load_state_dict(from_jax_params(params))
    assert sum(p.numel() for p in tg.parameters()) == 258
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((1024, 16, 2)) * 0.7).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)
    ref, got, jpg, tpg, jxg, txg = _forward_and_grads(jg, tg, params, x, r)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    if kw.get("rtl_faithful") and not kw.get("input_residual"):   # the clamp is reached
        assert np.abs(got).max() <= 1.0 and (np.abs(got) == 255 / 256).sum() > 100
    _assert_grads(jpg, tpg, 1e-4)
    np.testing.assert_allclose(txg, jxg, rtol=0, atol=1e-4 * np.abs(jxg).max())
    if kw.get("rtl_faithful"):   # the masked output taps get no gradient
        assert float(tg.out_conv.weight.grad[:, :, [0, 2]].abs().max()) == 0.0


@pytest.mark.parametrize("kw", [dict(weight_bits=8), dict(act_bits=16),
                                dict(weight_bits=8, act_bits=16)], ids=["w8", "a16", "w8a16"])
def test_full_unet_quantized_forward_matches_jax(kw):
    jf = JFull(frame_length=64, levels=3, base_channels=8, **kw)
    params = _np(jf.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 2))))
    tf = FullUNetGenerator(frame_length=64, levels=3, base_channels=8, **kw)
    tf.load_state_dict(from_jax_params(params))
    float_model = FullUNetGenerator(frame_length=64, levels=3, base_channels=8)
    float_model.load_state_dict(tf.state_dict())   # the same parameters, by name
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((16, 64, 2)) * 0.7).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)
    ref, got, jpg, tpg, jxg, txg = _forward_and_grads(jf, tf, params, x, r)
    if kw.get("act_bits"):
        np.testing.assert_allclose(got, ref, rtol=0, atol=FULL_ATOL)
        assert np.median(np.abs(got - ref)) < 2e-5
        diff = np.sqrt(sum(((tpg[k] - jpg[k]) ** 2).sum() for k in jpg))
        assert diff <= FULL_GRAD_RTOL * np.sqrt(sum((v ** 2).sum() for v in jpg.values()))
        np.testing.assert_allclose(txg, jxg, rtol=0, atol=FULL_GRAD_RTOL * np.abs(jxg).max())
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
        _assert_grads(jpg, tpg, 1e-4)
    with torch.no_grad():
        assert float((float_model(torch.from_numpy(x)) - torch.from_numpy(got)).abs().max()) > 0


def _points_on_jax_activations(kw, frames, seed, fault=None):
    """The port's quantization points, each computed from JAX's quantized
    activations (the flax model's ``_maybe_quant_act`` outputs), beside
    JAX's, channels-last; and both outputs. ``fault`` plants one: the
    input's (``"input"``) or the first skip sum's (``"skip"``) quantization
    left out, or a per-channel scale (``"per_channel"``)."""
    jf = JFull(frame_length=64, levels=3, base_channels=8, **kw)
    params = _np(jf.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 2))))
    tf = FullUNetGenerator(frame_length=64, levels=3, base_channels=8, **kw)
    tf.load_state_dict(from_jax_params(params))
    x = (np.random.default_rng(seed).standard_normal((frames, 64, 2)) * 0.7).astype(np.float32)
    ref, state = jf.apply(params, x, mutable=["intermediates"],
                          capture_intermediates=lambda _, name: name == "_maybe_quant_act")
    jpoints = [np.array(a) for a in state["intermediates"]["_maybe_quant_act"]]
    points, quant = [], tf._quant_act

    def teacher_forced(h, *where):
        i = len(points)
        if (fault, i) in (("input", 0), ("skip", 11)):
            q = h
        elif fault == "per_channel":
            q = fake_quantize_auto(h, tf.act_bits, per_channel=True, channel_axis=1)
        else:
            q = quant(h, *where)
        points.append(q.transpose(1, 2).numpy())
        return torch.from_numpy(jpoints[i]).transpose(1, 2)

    tf._quant_act = teacher_forced
    with torch.no_grad():
        out = tf(torch.from_numpy(x)).numpy()
    return points, jpoints, out, np.asarray(ref)


def _assert_points(points, jpoints):
    """Every point within atol 1e-5 of JAX's except at most FULL_FLIPS
    elements in all, each off by one step of its tensor (± 1e-5)."""
    assert len(points) == len(jpoints) == 17
    flips = 0
    for i, (got, ref) in enumerate(zip(points, jpoints)):
        diff = np.abs(got - ref)
        off = diff > 1e-5
        flips += int(off.sum())
        step = float(np.abs(ref).max()) / 32767
        assert np.all(diff[off] <= step + 1e-5), (i, float(diff.max()), step)
    assert flips <= FULL_FLIPS, flips


@pytest.mark.parametrize("kw", [dict(act_bits=16), dict(weight_bits=8, act_bits=16)],
                         ids=["a16", "w8a16"])
def test_full_unet_each_quantization_point_matches_jax(kw):
    points, jpoints, out, ref = _points_on_jax_activations(kw, frames=64, seed=1)
    _assert_points(points, jpoints)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("fault", ["input", "skip", "per_channel"])
def test_full_unet_point_check_fails_a_planted_fault(fault):
    """The limits of ``_assert_points`` hold a misplaced quantization."""
    points, jpoints, _, _ = _points_on_jax_activations(dict(weight_bits=8, act_bits=16),
                                                       frames=64, seed=1, fault=fault)
    with pytest.raises(AssertionError):
        _assert_points(points, jpoints)


@pytest.mark.parametrize("kw", MINI_MODES[2:4] + MINI_MODES[:1], ids=lambda kw: "+".join(kw))
def test_one_qat_step_matches_jax(kw):
    """From a state warmed by three JAX steps and copied into the port; the
    port's step on the critic kernel's route (its plain version here)."""
    p = Pair(n_critic=5, reference=False, gen_kw=kw)
    assert (p.tstep.datagen_route, p.tstep.critic_route) == ("kernel", "kernel")
    p.jax_steps(3)
    p.load_jax_state()
    start = {**flatten_tree(to_jax_params(p.g)), **flatten_tree(to_jax_params(p.d))}
    jm, tm = p.step(3)
    ref = {**flatten_tree(_np(p.jstate.params_g)), **flatten_tree(_np(p.jstate.params_d))}
    got = {**flatten_tree(to_jax_params(p.g)), **flatten_tree(to_jax_params(p.d))}
    for k in ref:
        upd_ref, upd = ref[k] - start[k], got[k] - start[k]
        np.testing.assert_allclose(upd, upd_ref, rtol=0,
                                   atol=STEP_RTOL * float(np.abs(upd_ref).max()) + 1e-12,
                                   err_msg=k)
    for name, v in jm.items():
        np.testing.assert_allclose(float(tm[name]), float(v), rtol=1e-4, atol=1e-6, err_msg=name)


def _cli(tmp_path, *extra):
    return train_cli.main(["--device", "cpu", "--epochs", "1", "--batch_size", "16",
                           "--samples_per_epoch", "32", "--val_samples", "16",
                           "--checkpoint_dir", str(tmp_path / "c"), "--log_dir",
                           str(tmp_path / "l"), "--export_dir", str(tmp_path / "e"), *extra])


@pytest.mark.parametrize("flags,mode", [(["--qat"], dict(qat=True, rtl_faithful=False)),
                                        (["--rtl_qat"], dict(qat=True, rtl_faithful=True)),
                                        (["--rtl_qat", "--residual"],
                                         dict(qat=True, rtl_faithful=True, input_residual=True))])
def test_cli_trains_the_mini_modes(tmp_path, capsys, flags, mode):
    trainer = _cli(tmp_path, *flags)
    out = capsys.readouterr().out
    assert "Generator parameters: 258" in out and "datagen kernel | critic kernel" in out
    for k, v in mode.items():
        assert getattr(trainer.generator, k) == v
    assert trainer.generator.leaky_slope == (0.3125 if mode["rtl_faithful"] else 0.2)
    assert (tmp_path / "e" / "generator" / "metadata.json").exists()


def test_cli_trains_the_full_unet_under_quant_bits(tmp_path, capsys):
    trainer = _cli(tmp_path, "--model", "full", "--frame_length", "64", "--batch_size", "4",
                   "--samples_per_epoch", "8", "--val_samples", "4", "--quant_bits", "8", "16")
    out = capsys.readouterr().out
    assert "Generator parameters: 3,936,578" in out and "datagen kernel | critic plain" in out
    g = trainer.generator
    assert (g.weight_bits, g.act_bits) == (8, 16)
    assert len(list((tmp_path / "e" / "generator").glob("*_weights.bin"))) == 23


def test_build_models_makes_the_quantized_generators():
    """``build_models`` gives the mini generator its QAT modes and the full
    U-Net its bits; the trainer takes either injected, the mini one on both
    kernels' routes."""
    g, d = build_models(Config(), "mini", 0, rtl_faithful=True)
    assert g.rtl_faithful and not g.qat and g.leaky_slope == 0.3125
    t = Trainer(device="cpu", generator=g, discriminator=d)
    assert t.generator is g and (t.step.datagen_route, t.step.critic_route) == ("kernel", "kernel")
    fg, fd = build_models(Config(frame_length=64), "full", 0, quant_bits=(8, 16))
    assert (fg.weight_bits, fg.act_bits) == (8, 16)
    with pytest.raises(ValueError, match="act_dtype"):
        Trainer(device="cpu", generator=fg, discriminator=fd, act_dtype="bfloat16")
