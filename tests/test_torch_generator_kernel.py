"""The generator-gradient kernel's plain version against autograd of
``generator_loss_fn`` on the modules, and the step's ``generator_route``;
the forward kernel's plain version against the module's forward and the
JAX generator's, and where it covers a generator.

The plain version is the kernel's hand-derived math (``ops/generator_kernel``);
autograd differentiates the modules. Tolerances: each gradient within rtol
1e-5 and 1e-5 of its tensor's largest entry, the metrics within rtol 1e-5
and atol 1e-6 (float32 sums in another order on each side). The step on the
kernel route (its plain version on the CPU) is held against the JAX step at
the tolerances of ``tests/test_torch_train_step.py``. The forward's plain
version is held to the module's forward at the card's tolerance of the
forward kernel (``utils/kernel_checks.assert_forward_close``: rtol 1e-5,
atol 1e-6 of the output's scale) and to the JAX generator at the models'
(atol and rtol 1e-5, ``tests/test_torch_models.py``).
"""

import numpy as np
import pytest
import torch

from ofdmgan_tpu_torch.models import MiniDiscriminator, MiniGenerator
from ofdmgan_tpu_torch.models.flat import make_flat_step
from ofdmgan_tpu_torch.models.full_unet import FullDiscriminator, FullUNetGenerator
from ofdmgan_tpu_torch.ops import generator_kernel as gk
from ofdmgan_tpu_torch.signal.datagen import DatagenConfig
from ofdmgan_tpu_torch.training.schedules import make_adam
from ofdmgan_tpu_torch.training.wgan_gp import LossConfig, TrainStep, generator_loss_fn
from ofdmgan_tpu_torch.utils.kernel_checks import assert_forward_close
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _pair(seed, conv1_channels=8, **gen_kw):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        g, d = MiniGenerator(**gen_kw), MiniDiscriminator(conv1_channels=conv1_channels)
        with torch.no_grad():   # biases off zero, weights off their initial scale
            for p in [*g.parameters(), *d.parameters()]:
                p.add_(0.1 * torch.randn_like(p))
    return g, d


def _frames(b, seed):
    gen = torch.Generator().manual_seed(seed + 100)
    clean = 0.5 * torch.randn(b, 16, 2, generator=gen)
    return clean, clean + 0.3 * torch.randn(b, 16, 2, generator=gen)


def _autograd(g, d, clean, noisy, adv_weight, rec_weight):
    cfg = LossConfig(adv_weight=adv_weight, rec_weight=rec_weight)
    loss, aux = generator_loss_fn(g, d, {"noisy": noisy, "clean": clean}, cfg)
    grads = torch.autograd.grad(loss, list(g.parameters()))
    return dict(zip((n for n, _ in g.named_parameters()), grads)), aux


def _assert_matches_autograd(g, d, clean, noisy, adv_weight=1.0, rec_weight=100.0):
    grads, aux = gk.generator_grad_plain(g, d, clean, noisy, adv_weight, rec_weight)
    ref, ref_aux = _autograd(g, d, clean, noisy, adv_weight, rec_weight)
    assert list(grads) == list(ref) == [n for n, _ in gk.PARAM_SHAPES]
    for name, r in ref.items():
        torch.testing.assert_close(grads[name], r, rtol=1e-5,
                                   atol=1e-5 * float(r.abs().max()) + 1e-12, msg=name)
    assert set(aux) == set(ref_aux) == set(gk.METRICS)
    for name, r in ref_aux.items():
        torch.testing.assert_close(aux[name], r, rtol=1e-5, atol=1e-6, msg=name)
    return grads, ref


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("b", [1, 7, 64, 1024])
def test_plain_version_matches_autograd(b, seed):
    g, d = _pair(seed)
    _assert_matches_autograd(g, d, *_frames(b, seed))


def test_ties_take_no_l1_gradient():
    """Where ``fake == clean`` the L1 term's derivative is 0, as abs's
    backward gives. A tie depends on the forward's last bit, so the pair
    computes exactly here: weights and frames on the grid k/4, slopes 1/4,
    so every sum is exact in float32 in any order, and both sides see the
    same ties. With the adversarial term off and every entry tied, every
    gradient is 0."""
    g, d = _pair(3, leaky_slope=0.25)
    d.leaky_slope = 0.25
    with torch.no_grad():
        for p in [*g.parameters(), *d.parameters()]:
            p.copy_(torch.randint(-2, 3, p.shape) / 4.0)
    noisy = torch.randint(-4, 5, (16, 16, 2)) / 4.0
    with torch.no_grad():
        fake = g(noisy)
    clean = fake.clone()
    clean[::2] += 0.25   # half the frames off the tie
    _assert_matches_autograd(g, d, clean, noisy)
    grads, _ = gk.generator_grad_plain(g, d, fake.clone(), noisy, 0.0, 100.0)
    assert all(bool((t == 0).all()) for t in grads.values())


def test_zero_pre_activations_take_the_slope():
    """Zero frames through zero biases give pre-activations of exactly 0 in
    every layer of both nets: each LeakyReLU passes its slope there."""
    g, d = _pair(4)
    with torch.no_grad():
        for m in (g, d):
            for name, p in m.named_parameters():
                if name.endswith("bias"):
                    p.zero_()
    clean, noisy = _frames(32, 4)
    noisy[:8] = 0.0
    clean[:4] = 0.0   # and ties of fake = tanh(0) = 0 with clean
    _assert_matches_autograd(g, d, clean, noisy)


@pytest.mark.parametrize("adv_weight,rec_weight", [(0.3, 7.5), (2.0, 0.0), (0.0, 100.0)])
def test_loss_weights_other_than_the_recipes(adv_weight, rec_weight):
    g, d = _pair(5)
    _assert_matches_autograd(g, d, *_frames(64, 5), adv_weight, rec_weight)


def test_the_slopes_are_the_modules():
    g, d = _pair(6, leaky_slope=0.1)
    d.leaky_slope = 0.3
    _assert_matches_autograd(g, d, *_frames(64, 6))


def test_cpu_wrapper_takes_the_plain_version():
    g, d = _pair(7)
    clean, noisy = _frames(33, 7)
    before = gk.launches
    grads, aux = gk.generator_grad(g, d, clean, noisy, 1.0, 100.0)
    plain, plain_aux = gk.generator_grad_plain(g, d, clean, noisy, 1.0, 100.0)
    assert gk.launches == before
    assert all(torch.equal(grads[n], plain[n]) for n in plain)
    assert all(torch.equal(aux[n], plain_aux[n]) for n in plain_aux)


@pytest.mark.parametrize("kw,L,covered", [
    ({}, 16, True),
    ({}, 32, False),
    ({"input_residual": True}, 16, False),
    ({"rtl_faithful": True}, 16, False),
    ({"qat": True}, 16, False),
    ({"act_dtype": "bfloat16"}, 16, False),
    ({"enc1_channels": 8}, 16, False),
    ({"conv1_channels": 4}, 16, False),
    ({"critic_act_dtype": "bfloat16"}, 16, False),
])
def test_covers_the_deployed_mini_generator_with_the_mini_critic(kw, L, covered):
    kw = dict(kw)
    critic_kw = {"conv1_channels": kw.pop("conv1_channels", 8),
                 "act_dtype": kw.pop("critic_act_dtype", None)}
    g, d = MiniGenerator(**kw), MiniDiscriminator(**critic_kw)
    assert gk.covers(g, d, L) is covered
    if not covered and L == 16:
        clean, noisy = _frames(4, 0)
        with pytest.raises(ValueError, match="generator-gradient kernel covers"):
            gk.generator_grad(g, d, clean, noisy, 1.0, 100.0)


def test_other_frames_raise():
    g, d = MiniGenerator(), MiniDiscriminator()
    clean, noisy = _frames(4, 0)
    with pytest.raises(ValueError, match="clean must be float32"):
        gk.generator_grad(g, d, clean.double(), noisy, 1.0, 100.0)
    with pytest.raises(ValueError, match="noisy must be float32"):
        gk.generator_grad(g, d, clean, noisy[:, :8], 1.0, 100.0)
    assert not gk.covers(FullUNetGenerator(frame_length=16, levels=2, base_channels=4),
                         d, 16)


def _step(g=None, d=None, L=16, loss=None, **kw):
    if g is None:
        g, d = MiniGenerator(), MiniDiscriminator()
    return TrainStep(g, d, make_adam(g.parameters(), 2e-4), make_adam(d.parameters(), 2e-4),
                     DatagenConfig(frame_length=L), loss or LossConfig(), 8, **kw)


def _full_pair():
    return (FullUNetGenerator(frame_length=64, levels=3, base_channels=8),
            FullDiscriminator(frame_length=64, levels=3, base_channels=8))


@pytest.mark.parametrize("case", [
    "mini", "image_batches", "reference", "full_unet", "qat", "rtl_faithful", "input_residual",
    "generator_act_dtype", "act_dtype", "flat", "shard", "remat", "bfloat16",
    "tensorfloat32", "supervised", "gen_forward", "narrow_critic", "frame_length_32"])
def test_generator_route_follows_the_configuration(case):
    """``kernel`` for the mini step on the critic kernel's route at float32,
    ``plain`` for every configuration the kernel does not compute."""
    kw, g, d, L, loss = {}, None, None, 16, None
    if case == "image_batches":
        kw["batch_fn"] = lambda rng, n: None
    elif case == "reference":
        kw["reference"] = True
    elif case == "full_unet":
        (g, d), L = _full_pair(), 64
    elif case in ("qat", "rtl_faithful", "input_residual"):
        g, d = MiniGenerator(**{case: True}), MiniDiscriminator()
    elif case == "generator_act_dtype":
        g, d = MiniGenerator(act_dtype="bfloat16"), MiniDiscriminator()
    elif case == "act_dtype":
        kw["act_dtype"] = "bfloat16"
    elif case == "flat":
        g, d = MiniGenerator(), MiniDiscriminator()
        kw["flat"] = make_flat_step(g, d, 16)
    elif case == "shard":
        kw["shard"] = object()
    elif case == "remat":
        kw["remat"] = True
    elif case == "bfloat16":
        kw["matmul_precision"] = "bfloat16"
    elif case == "tensorfloat32":
        kw.update(matmul_precision="tensorfloat32", use_pallas_critic=True)
    elif case == "supervised":
        loss = LossConfig(n_critic=0, adv_weight=0.0)
    elif case == "gen_forward":
        kw["gen_forward"] = lambda module, x: module(x)
    elif case == "narrow_critic":
        g, d = MiniGenerator(), MiniDiscriminator(conv1_channels=4)
    elif case == "frame_length_32":
        L = 32
    step = _step(g, d, L, loss, **kw)
    want = "kernel" if case in ("mini", "image_batches") else "plain"
    assert step.generator_route == want
    if case in ("flat", "shard", "remat", "bfloat16", "tensorfloat32", "gen_forward"):
        assert step.critic_route == "kernel"   # the critic kernel's scope is wider
    if want == "kernel":
        step.reference = True
        assert step.generator_route == "plain"
        step.reference = False
        assert step.generator_route == "kernel"


def test_the_kernel_route_calls_the_kernel_and_never_falls_back(monkeypatch):
    """On the CPU the route runs the wrapper (and so the plain version); a
    failing wrapper raises out of the step."""
    step = _step()
    calls = []
    real = gk.generator_grad
    monkeypatch.setattr(gk, "generator_grad", lambda *a: calls.append(1) or real(*a))
    metrics = step(torch.Generator().manual_seed(0))
    assert calls == [1] and all(bool(torch.isfinite(v)) for v in metrics.values())

    def broken(*args):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(gk, "generator_grad", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        step(torch.Generator().manual_seed(0))


def test_kernel_route_step_matches_jax():
    """The step with every route chosen by scope (both kernels' and the
    generator kernel's plain versions here) against the JAX step, from a
    state warmed by three JAX steps and copied into the port: the
    tolerances of the one-step test of ``tests/test_torch_train_step.py``."""
    import jax

    from ofdmgan_tpu_torch.utils.jax_params import from_jax_params
    from test_torch_train_step import Pair

    p = Pair(n_critic=5, reference=False)
    assert (p.tstep.datagen_route, p.tstep.critic_route, p.tstep.generator_route) == \
        ("kernel", "kernel", "kernel")
    p.jax_steps(3)
    p.load_jax_state()
    jm, tm = p.step(3)
    p.assert_params_close(2e-6)
    for name, ref in jm.items():
        np.testing.assert_allclose(float(tm[name]), float(ref), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    mu = from_jax_params(jax.tree_util.tree_map(np.asarray, p.jstate.opt_g[0].mu))
    for name, param in p.g.named_parameters():
        ref = mu[name].numpy()
        np.testing.assert_allclose(p.opt_g.opt.state[param]["exp_avg"].numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref).max()) + 1e-12, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("b", [1, 3, 64])
def test_forward_plain_version_matches_the_module_and_jax(b, seed):
    """``generator_forward_plain`` against ``MiniGenerator.forward`` and
    against the JAX package's mini generator on the same weights."""
    import jax

    from ofdmgan_tpu.models import MiniGenerator as JGen
    from ofdmgan_tpu_torch.utils.jax_params import to_jax_params

    g, _ = _pair(seed)
    _, noisy = _frames(b, seed)
    got = gk.generator_forward_plain(g, noisy)
    assert got.shape == (b, 16, 2) and got.dtype == torch.float32 and not got.requires_grad
    with torch.no_grad():
        assert_forward_close(got, g(noisy))
    jparams = jax.tree_util.tree_map(np.asarray, to_jax_params(g))
    ref = np.asarray(JGen().apply(jparams, noisy.numpy()))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_the_forward_plain_version_is_the_gradient_plain_versions_forward():
    """Both plain versions read one forward: the fake that
    ``generator_grad_plain``'s L1 term sees is ``generator_forward_plain``'s,
    bit for bit (a zero adversarial weight leaves the L1 term alone)."""
    g, d = _pair(8)
    clean, noisy = _frames(16, 8)
    fake = gk.generator_forward_plain(g, noisy)
    _, aux = gk.generator_grad_plain(g, d, clean, noisy, 0.0, 1.0)
    assert torch.equal(aux["rec_loss"], (fake - clean).transpose(1, 2).abs().sum() / (32 * 16))


@pytest.mark.parametrize("kw,L,covered", [
    ({}, 16, True),
    ({"leaky_slope": 0.1}, 16, True),
    ({}, 32, False),
    ({"input_residual": True}, 16, False),
    ({"rtl_faithful": True}, 16, False),
    ({"qat": True}, 16, False),
    ({"act_dtype": "bfloat16"}, 16, False),
    ({"enc1_channels": 8}, 16, False),
    ({"bottleneck_channels": 16}, 16, False),
])
def test_covers_forward_the_deployed_mini_generator(kw, L, covered):
    """The forward kernel covers the deployed generator at 16 samples,
    whatever its slope, and no other; it asks nothing of a critic."""
    g = MiniGenerator(**kw)
    assert gk.covers_forward(g, L) is covered
    if not covered and L == 16:
        with pytest.raises(ValueError, match="generator forward kernel covers"):
            gk.generator_forward(g, _frames(4, 0)[1])


def test_covers_forward_refuses_the_full_unet():
    assert not gk.covers_forward(FullUNetGenerator(frame_length=16, levels=2, base_channels=4),
                                 16)


@pytest.mark.parametrize("bad", ["float64", "short_frames", "no_frames", "flat"])
def test_forward_of_other_frames_raises(bad):
    g = MiniGenerator()
    noisy = {"float64": torch.zeros(4, 16, 2, dtype=torch.float64),
             "short_frames": torch.zeros(4, 8, 2), "no_frames": torch.zeros(0, 16, 2),
             "flat": torch.zeros(4, 32)}[bad]
    with pytest.raises(ValueError, match="noisy must be float32"):
        gk.generator_forward(g, noisy)


def test_cpu_forward_takes_the_plain_version():
    g, _ = _pair(9)
    _, noisy = _frames(33, 9)
    before = (gk.forward_launches, gk.launches)
    got = gk.generator_forward(g, noisy)
    assert (gk.forward_launches, gk.launches) == before
    assert torch.equal(got, gk.generator_forward_plain(g, noisy))


@pytest.mark.parametrize("b,by", [(1, "bytes"), (64, "bytes"), (65536, "bytes")])
def test_forward_bound(b, by):
    """1,608 multiply-adds a frame at an H100's 67 TFLOP/s against 256 bytes
    a frame and the 258 parameters at its 3.35 TB/s: the bytes bound at
    every batch."""
    ms, what = gk.forward_bound_ms(b, 67e12, 3.35e12)
    assert what == by
    assert ms == pytest.approx((256 * b + 258 * 4) / 3.35e12 * 1e3)
    assert 2 * 1608 * b / 67e12 * 1e3 < ms
