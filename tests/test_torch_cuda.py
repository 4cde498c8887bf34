"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q

(``--noconftest`` because ``tests/conftest.py`` sets JAX up.)

The kernels' tolerances are ``ofdmgan_tpu_torch/utils/kernel_checks.py``'s,
which ``chip_smoke.py`` also holds them to at the main path's shapes; the
tests here take every shape, form and precision.

Tolerances: the datagen kernel rtol 1e-5, atol 1e-6 at every frame length
(the same float32 arithmetic; fused multiply-adds round differently, and the
phase scan and the frame reductions sum in another order), at L = 16 up to
2^20 frames. The
critic-gradient kernel rtol 1e-4, atol 1e-4 of each tensor's largest entry:
it sums the batch in another order; at one and at two frames a warp, on
batches that leave a block's or a warp's last frame slots empty; under
``tensorfloat32`` precision bit for bit its float32 output (the kernel reads
no TF32 flag). The generator-gradient kernel the
same, against its plain version and against autograd of
``generator_loss_fn``, and bit for bit against itself. The generator forward
kernel against its plain version at rtol 1e-5, atol 1e-6 of the output's
scale (as the datagen kernel: the same float32 forward, each conv's taps
summed in another order) at both mappings, on contiguous, strided and
sliced frames, each launch counted, bit for bit against itself and
independent of the batch around a frame; the mini step's first critic
update reads its fake, within that tolerance of the module's forward with
TF32 off. The full U-Net family: the fused
decoder within atol 1e-5 of the module's tanh output at float32; a full
step on the kernel route and the reference step, each tensor's update
within 1e-3 of its largest entry, as for the mini step. Quantization: the
integer datapath on the card equals the same call on the CPU and the
native engine ``native/fixsim.cpp`` bit for bit; a QAT step on the kernel
routes and the reference step on one batch (the datagen kernel's, so both
see the same Q8.8 rounding boundaries) within 1e-3 of each tensor's
largest update. Evaluation: the equalizers, one SNR batch of the sweep and
the distributional report on the card against the CPU on the same draws
(drawn on the CPU, or on the card and copied): by element within atol
2e-5 (float32 rounding of complex products and of the FFT), DFE and RLS
at L = 256 by mean MSE within rtol 1e-3 (a decision or the P recursion
amplifies rounding), GAN-Q bit for bit against the CPU's integer
datapath on the card's own noisy frames (the two devices' frames differ by
rounding, which can move a Q8.8 truncation), the report's statistics within
rtol 1e-4. Verification: the golden vectors' floats within atol 1e-6 and
their Q8.8 files equal but where the two floats straddle a step (1 LSB);
the proof's integer MSEs equal (its means are summed in float64 and its
noise scaled on the host), its float MSEs within rtol 1e-5; the simpleGAN
integer path bit for bit; selfcheck's training step launches each kernel
(1 datagen, 2 critic-gradient). The critic kernel's bf16 form at the same
tolerances as its float32 form, against its plain version and autograd
under bf16 matmul precision; its storage form (bf16 ``clean`` and
``noisy``) at the same tolerances against its plain version and against
autograd on the widened frames, and bit for bit the kernel on the frames
widened to float32. Serving: a mini program exported on the
card reloads and agrees with the CPU's forward within atol 1e-6; the
inference bench launches the datagen kernel once per apply in the loop and
never when resident; the ``bfloat16`` mode's critic forward within rtol
1e-5 of the CPU's (bf16 products are exact in float32) but where an
intermediate activation straddles a bf16 step (at most 1 in 1,000 scores,
within one bf16 step of the scale); a ``--remat`` mini
step equals the plain step within 1e-6 of each tensor's largest update.
Parallelism: the data-parallel mini step on a world of one over NCCL equals
the plain step on its routes (a sharded step's generator update is
autograd's) bit for bit (a mean over one rank is exact), with one
datagen and five critic launches a step; two ranks sharing the card over
gloo stay bit for bit in lockstep and take, from a warmed-up state, a step
within 1e-3 of each tensor's largest update of one process's step on both
ranks' draws. Asking for NCCL without a GPU raises (this one runs on the
CPU too). Graphed chunks: a replayed chunk of the mini step equals the same
chunk run eagerly from the same state and generator state, bit for bit
(deterministic cuDNN; the same kernels on the same inputs), and so does a
second replay from that state; a replay after the generator moved on draws
other batches; neither the capture nor a replay moves a wrapper's launch
count, and a replay runs, by its profiler trace, one datagen launch,
five critic launches, one generator-gradient launch (each gradient
launch a per-block kernel and its sum) and one generator-forward launch a
step. The
flat step's ``tf32_matmul`` on the card against the CPU: the critic's
scores within 1e-6 and the penalty's parameter gradients within 1e-3 of
each tensor's largest entry (both are sums of exact products of bf16
parts, summed in another order; a cotangent summed apart may round to the
other bf16 neighbour). QAT with a storage format: an e4m3fn ``qat``
forward NaN everywhere on the card as on the CPU, ``rtl_faithful`` alone
finite and within atol 1e-5. The packed step: one step against the module
step on its batch's ``[B, L, 2]`` view, within 1e-3 of each tensor's
largest update. The critic updates' one generator forward an outer step:
the mini step on its kernel routes and the full step on the autograd critic
against the same step handed the outer batch once for each update (a
forward each), bit for bit (deterministic cuDNN: the same calls on the
same inputs).
"""

import copy
import re

import numpy as np
import pytest
import torch

from ofdmgan_tpu_torch.models import MiniDiscriminator, MiniGenerator
from ofdmgan_tpu_torch.ops import critic_kernel as ck
from ofdmgan_tpu_torch.ops import datagen_kernel as dk
from ofdmgan_tpu_torch.ops import generator_kernel as gk
from ofdmgan_tpu_torch.signal import datagen as sdg
from ofdmgan_tpu_torch.signal.impairments import ImpairmentConfig
from ofdmgan_tpu_torch.training.schedules import make_adam
from ofdmgan_tpu_torch.parallel import distributed
from ofdmgan_tpu_torch.parallel.mesh import draw_seed, make_mesh, make_sharded_train_step
from ofdmgan_tpu_torch.parallel.mesh import replica_generator
from ofdmgan_tpu_torch.training.wgan_gp import LossConfig, TrainStep, critic_loss_fn
from ofdmgan_tpu_torch.training.wgan_gp import generator_loss_fn
from ofdmgan_tpu_torch.utils.kernel_checks import (assert_datagen_close, assert_forward_close,
                                                   assert_grads_close, assert_metrics_close)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from ofdmgan_tpu_torch.device import resolve_device
    return resolve_device("cuda")


# the critic kernel's batches: ragged against 4-warp blocks (1000); on an
# H100 (132 SMs, 1,056 resident warps) odd and below two frames for every
# warp (2001: one frame a warp), odd just above it (2113: two frames a warp,
# the first warp takes a second pair whose second slot is empty); the mini
# cell's (65536) and one past it (65537)
CRITIC_BATCHES = [1, 64, 1000, 2001, 2113, 65536, 65537]


@pytest.mark.parametrize("nonlinear", [False, True])
@pytest.mark.parametrize("b", [64, 1000, 1 << 20])
def test_datagen_kernel_matches_plain_version(cuda, b, nonlinear):
    gen = torch.Generator(device=cuda).manual_seed(2)
    draws = sdg.make_draws(gen, b, 16)
    cfg = sdg.DatagenConfig(nonlinear=nonlinear, impairments=ImpairmentConfig(pa_saturation=0.8))
    before = dk.launches
    got = dk.synthetic_batch_from_draws(draws, cfg)
    assert dk.launches == before + 1
    ref = dk.synthetic_batch_plain(draws, cfg)
    assert_datagen_close(got, ref)


@pytest.mark.parametrize("nonlinear", [False, True])
@pytest.mark.parametrize("L", [2, 4, 8, 32, 64, 128, 384, 1024])
def test_datagen_kernel_matches_plain_version_at_length(cuda, L, nonlinear):
    b = 1000 if L <= 128 else 64
    draws = sdg.make_draws(torch.Generator(device=cuda).manual_seed(L), b, L)
    cfg = sdg.DatagenConfig(frame_length=L, nonlinear=nonlinear,
                            impairments=ImpairmentConfig(pa_saturation=0.8))
    got = dk.synthetic_batch_from_draws(draws, cfg)
    ref = dk.synthetic_batch_plain(draws, cfg)
    assert_datagen_close(got, ref)
    out = dk.synthetic_batch(torch.Generator(device=cuda).manual_seed(9), b, cfg)
    assert all(bool(torch.isfinite(v).all()) for v in out.values())
    assert float(out["noisy"].abs().max()) <= 1.0 and float(out["clean"].abs().max()) <= 1.0


def test_datagen_kernel_statistics(cuda):
    b = 1 << 18
    out = dk.synthetic_batch(torch.Generator(device=cuda).manual_seed(3), b, sdg.DatagenConfig())
    snr = out["snr"]
    p_clean = (out["clean"] ** 2).sum((1, 2)) / 16
    p_noise = ((out["noisy"] - out["clean"]) ** 2).sum((1, 2)) / 16
    assert float(snr.min()) >= 0.0 and float(snr.max()) <= 30.0
    assert abs(float(snr.mean()) - 15.0) < 0.1                        # std of the mean 0.017
    assert abs(float((p_clean * out["scale"] ** 2).mean()) - 1.0) < 0.01
    assert abs(float((p_noise / p_clean / 10 ** (-snr / 10)).mean()) - 1.0) < 0.01


def test_box_muller_is_finite_at_the_extreme_uniforms(cuda):
    """The kernel's Box-Muller against its float64 version at chosen random
    words. At the top uniform level, 1 - 2^-24, |log2 u| is below the
    hardware log2's absolute error, so the radius (3.5e-4) may come out 0
    but never NaN; atol 5e-4 covers that error near u = 1."""
    words = [0xFFFFFFFF, 0xFFFFFE00, 0xFFFFFC00, 0x80000000, 0x000001FF, 0]
    pairs = [(a, b) for a in words for b in words]
    pairs += np.random.default_rng(0).integers(0, 2 ** 32, (4096, 2)).tolist()
    bits = torch.from_numpy(np.array(pairs, dtype=np.uint32).view(np.int32))
    got = dk.box_muller(bits.to(cuda)).cpu()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, dk.box_muller_plain(bits), rtol=1e-5, atol=5e-4)


def _critic_inputs(cuda, b, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        critic, generator = MiniDiscriminator().to(cuda), MiniGenerator().to(cuda)
    clean = torch.randn(b, 16, 2, generator=gen, device=cuda)
    noisy = clean + 0.3 * torch.randn(b, 16, 2, generator=gen, device=cuda)
    alpha = torch.rand(b, generator=gen, device=cuda)
    with torch.no_grad():
        fake = generator(noisy)   # strided: the generator's output is a transposed view
    return critic, generator, clean, fake, noisy, alpha


@pytest.mark.parametrize("precision", ["float32", "bfloat16", "tensorfloat32"])
@pytest.mark.parametrize("b", CRITIC_BATCHES)
def test_critic_kernel_matches_plain_version(cuda, b, precision):
    """Against the plain version; the mini cell's batch takes two frames a
    warp, the recipe's one (by the wrapper's counts by mapping). Under
    ``tensorfloat32`` precision the step calls the float32 kernel, which
    reads no TF32 flag: bit for bit the float32 call's output."""
    from ofdmgan_tpu_torch.training.wgan_gp import matmul_precision

    bf16 = precision == "bfloat16"
    critic, _, clean, fake, noisy, alpha = _critic_inputs(cuda, b, 3)
    before = (ck.launches, ck.launches_one_frame, ck.launches_two_frames)
    # the TF32 flags on or off; the bf16 form is chosen by its argument
    with matmul_precision("tensorfloat32" if precision == "tensorfloat32" else "float32"):
        grads, aux = ck.critic_grad(critic, clean, fake, noisy, alpha, 10.0, bf16=bf16)
    counts = (ck.launches, ck.launches_one_frame, ck.launches_two_frames)
    assert counts[0] == before[0] + 1 and counts[1] + counts[2] == sum(before[1:]) + 1
    if b == 65536:
        assert counts[2] == before[2] + 1
    if b == 64:
        assert counts[1] == before[1] + 1
    ref, ref_aux = ck.critic_grad_packed(critic, clean, fake, noisy, alpha, 10.0, bf16=bf16)
    assert_grads_close(grads, ref)
    assert_metrics_close(aux, ref_aux)
    if precision == "tensorfloat32":
        f32, f32_aux = ck.critic_grad(critic, clean, fake, noisy, alpha, 10.0)
        for name in grads:
            assert torch.equal(grads[name], f32[name]), name
        for name in aux:
            assert torch.equal(aux[name], f32_aux[name]), name


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("b", CRITIC_BATCHES)
def test_critic_kernel_matches_autograd(cuda, b, bf16):
    """At float32 and at bfloat16 matmul precision (autograd's operands
    rounded by ``ops/bf16_dots.py``)."""
    from ofdmgan_tpu_torch.training.wgan_gp import matmul_precision

    critic, generator, clean, fake, noisy, alpha = _critic_inputs(cuda, b, 4)
    grads, aux = ck.critic_grad(critic, clean, fake, noisy, alpha, 10.0, bf16=bf16)
    with matmul_precision("bfloat16" if bf16 else "float32"):
        loss, ref_aux = critic_loss_fn(critic, lambda x: fake, {"noisy": noisy, "clean": clean},
                                       alpha, LossConfig())
        ref = torch.autograd.grad(loss, list(critic.parameters()))
    assert_grads_close(grads, dict(zip((n for n, _ in critic.named_parameters()), ref)))
    assert_metrics_close(aux, ref_aux)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("b", CRITIC_BATCHES)
def test_critic_kernel_storage_form_matches_plain_version(cuda, b, bf16):
    """bf16 ``clean`` and ``noisy`` (the reference's bf16 storage), float32
    ``fake`` and ``alpha``: widened where the kernel loads them, so its
    result is the float32 kernel's on the widened frames, and autograd's
    on them."""
    from ofdmgan_tpu_torch.training.wgan_gp import matmul_precision

    critic, _, clean, fake, noisy, alpha = _critic_inputs(cuda, b, 5)
    clean, noisy = clean.bfloat16(), noisy.bfloat16()
    before = ck.launches
    grads, aux = ck.critic_grad(critic, clean, fake, noisy, alpha, 10.0, bf16=bf16)
    assert ck.launches == before + 1
    ref, ref_aux = ck.critic_grad_packed(critic, clean, fake, noisy, alpha, 10.0, bf16=bf16)
    assert_grads_close(grads, ref)
    assert_metrics_close(aux, ref_aux)
    wide, wide_aux = ck.critic_grad(critic, clean.float(), fake, noisy.float(), alpha, 10.0,
                                    bf16=bf16)
    for name in grads:
        assert torch.equal(grads[name], wide[name]), name
    for name in aux:
        assert torch.equal(aux[name], wide_aux[name]), name
    with matmul_precision("bfloat16" if bf16 else "float32"):
        loss, auto_aux = critic_loss_fn(critic, lambda x: fake,
                                        {"noisy": noisy.float(), "clean": clean.float()}, alpha,
                                        LossConfig())
        auto = torch.autograd.grad(loss, list(critic.parameters()))
    assert_grads_close(grads, dict(zip((n for n, _ in critic.named_parameters()), auto)))
    assert_metrics_close(aux, auto_aux)


def test_kernels_are_deterministic(cuda):
    """Two calls on the same inputs give bit-identical outputs: the critic
    kernel in its four forms (float32 or bf16 precision, float32 or bf16
    storage) at both mappings, and the datagen kernel."""
    for b in (1000, 65536):
        critic, _, clean, fake, noisy, alpha = _critic_inputs(cuda, b, 6)
        for bf16 in (False, True):
            for c_in, n_in in ((clean, noisy), (clean.bfloat16(), noisy.bfloat16())):
                one, one_aux = ck.critic_grad(critic, c_in, fake, n_in, alpha, 10.0, bf16=bf16)
                two, two_aux = ck.critic_grad(critic, c_in, fake, n_in, alpha, 10.0, bf16=bf16)
                for name in one:
                    assert torch.equal(one[name], two[name]), (b, bf16, c_in.dtype, name)
                for name in one_aux:
                    assert torch.equal(one_aux[name], two_aux[name]), (b, bf16, c_in.dtype, name)
    for L in (16, 1024):
        cfg = sdg.DatagenConfig(frame_length=L, nonlinear=True)
        draws = sdg.make_draws(torch.Generator(device=cuda).manual_seed(7), 256, L)
        a, b = dk.synthetic_batch_from_draws(draws, cfg), dk.synthetic_batch_from_draws(draws, cfg)
        c = dk.synthetic_batch(torch.Generator(device=cuda).manual_seed(8), 4096, cfg)
        d = dk.synthetic_batch(torch.Generator(device=cuda).manual_seed(8), 4096, cfg)
        for k in a:
            assert torch.equal(a[k], b[k]) and torch.equal(c[k], d[k]), (L, k)


@pytest.mark.parametrize("b", [1, 63, 64, 65536])
def test_generator_kernel_matches_plain_version_and_autograd(cuda, b):
    """The generator-gradient kernel against its plain version and against
    autograd of ``generator_loss_fn`` (float32, TF32 off), with weights
    other than 1; each launch counted."""
    from ofdmgan_tpu_torch.training.wgan_gp import matmul_precision

    critic, generator, clean, _, noisy, _ = _critic_inputs(cuda, b, 11)
    before = gk.launches
    grads, aux = gk.generator_grad(generator, critic, clean, noisy, 0.7, 80.0)
    assert gk.launches == before + 1
    plain, plain_aux = gk.generator_grad_plain(generator, critic, clean, noisy, 0.7, 80.0)
    with matmul_precision("float32"):
        loss, ref_aux = generator_loss_fn(generator, critic, {"noisy": noisy, "clean": clean},
                                          LossConfig(adv_weight=0.7, rec_weight=80.0))
        ref = torch.autograd.grad(loss, list(generator.parameters()))
    assert_grads_close(grads, plain, floor=1e-8)
    assert_grads_close(grads, dict(zip((n for n, _ in generator.named_parameters()), ref)),
                       floor=1e-8)
    assert_metrics_close(aux, plain_aux)
    assert_metrics_close(aux, ref_aux)


def test_generator_kernel_is_deterministic(cuda):
    """Two calls on the same inputs give bit-identical outputs."""
    critic, generator, clean, _, noisy, _ = _critic_inputs(cuda, 65536, 12)
    one, one_aux = gk.generator_grad(generator, critic, clean, noisy, 1.0, 100.0)
    two, two_aux = gk.generator_grad(generator, critic, clean, noisy, 1.0, 100.0)
    for name in one:
        assert torch.equal(one[name], two[name]), name
    for name in one_aux:
        assert torch.equal(one_aux[name], two_aux[name]), name


def test_a_refused_generator_kernel_launch_raises(cuda, monkeypatch):
    """A launch the entry point refuses (here a batch of 0 frames) raises
    and is not counted."""
    critic, generator, clean, _, noisy, _ = _critic_inputs(cuda, 64, 13)
    prepare = gk.prepare

    def refused(*args):
        fn, launch_args, out, keep = prepare(*args)
        return fn, (0, *launch_args[1:]), out, keep

    monkeypatch.setattr(gk, "prepare", refused)
    before = gk.launches
    with pytest.raises(RuntimeError, match="generator-gradient kernel launch failed"):
        gk.generator_grad(generator, critic, clean, noisy, 1.0, 100.0)
    assert gk.launches == before


# the forward kernel's batches: one frame, a block of 128 threads under
# half full (63) and half full (64), a ragged last block (2112), the mini
# cell's batch (65536: one wave of blocks on an H100)
FORWARD_BATCHES = [1, 63, 64, 2112, 65536]


def _forward_inputs(cuda, b, layout, seed=21):
    """A mini generator off its initial weights and ``noisy`` ``[b, 16, 2]``
    contiguous, strided (a ``[b, 2, 16]`` tensor transposed) or the first
    half of a batch of ``2 b``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        g = MiniGenerator().to(cuda)
        with torch.no_grad():
            for p in g.parameters():
                p.add_(0.1 * torch.randn_like(p))
    gen = torch.Generator(device=cuda).manual_seed(seed + b)
    if layout == "strided":
        return g, torch.randn(b, 2, 16, generator=gen, device=cuda).transpose(1, 2)
    if layout == "half":
        return g, torch.randn(2 * b, 16, 2, generator=gen, device=cuda)[:b]
    return g, torch.randn(b, 16, 2, generator=gen, device=cuda)


@pytest.mark.parametrize("layout", ["contiguous", "strided", "half"])
@pytest.mark.parametrize("b", FORWARD_BATCHES)
def test_generator_forward_kernel_matches_plain_version(cuda, b, layout):
    """The forward kernel against its plain version, one launch counted,
    the fake contiguous."""
    g, noisy = _forward_inputs(cuda, b, layout)
    before = (gk.forward_launches, gk.launches)
    got = gk.generator_forward(g, noisy)
    assert (gk.forward_launches, gk.launches) == (before[0] + 1, before[1])
    assert got.is_contiguous() and got.shape == (b, 16, 2)
    assert_forward_close(got, gk.generator_forward_plain(g, noisy))


def test_generator_forward_kernel_is_deterministic_frame_by_frame(cuda):
    """Two calls give the same bits, and a frame's fake does not depend on
    the batch around it: the first frames alone, and one frame alone, give
    the whole batch's bits."""
    g, noisy = _forward_inputs(cuda, 65536, "contiguous")
    one, two = gk.generator_forward(g, noisy), gk.generator_forward(g, noisy)
    assert torch.equal(one, two)
    assert torch.equal(gk.generator_forward(g, noisy[:64]), one[:64])
    assert torch.equal(gk.generator_forward(g, noisy[1000:1001]), one[1000:1001])


def test_a_refused_generator_forward_launch_raises(cuda, monkeypatch):
    """A launch the entry point refuses (here a batch of 0 frames) raises
    and is not counted."""
    g, noisy = _forward_inputs(cuda, 64, "contiguous")
    prepare = gk.prepare_forward

    def refused(*args):
        fn, launch_args, out, keep = prepare(*args)
        return fn, (0, *launch_args[1:]), out, keep

    monkeypatch.setattr(gk, "prepare_forward", refused)
    before = gk.forward_launches
    with pytest.raises(RuntimeError, match="generator forward kernel launch failed"):
        gk.generator_forward(g, noisy)
    assert gk.forward_launches == before


@pytest.mark.parametrize("b", [64, 65536])
def test_the_mini_steps_first_critic_update_reads_the_forward_kernels_fake(cuda, b):
    """The mini step on its kernel routes computes the critic updates' fake
    with one forward launch, within the kernel's tolerance of
    ``MiniGenerator.forward`` with TF32 off."""
    from ofdmgan_tpu_torch.training.wgan_gp import matmul_precision
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        g, d = MiniGenerator().to(cuda), MiniDiscriminator().to(cuda)
    step = TrainStep(g, d, make_adam(g.parameters(), 2e-4), make_adam(d.parameters(), 2e-4),
                     sdg.DatagenConfig(), LossConfig(), b)
    assert (step.critic_route, step.forward_route) == ("kernel", "kernel")
    batch0, alphas, _ = step.draw(torch.Generator(device=cuda).manual_seed(2))
    before = gk.forward_launches
    _, fake = step.critic_update(batch0, alphas[0])
    assert gk.forward_launches == before + 1
    with torch.no_grad(), matmul_precision("float32"):
        ref = g(batch0["noisy"])
    assert_forward_close(fake, ref)


def test_kernel_step_matches_plain_step(cuda):
    """One outer step through both kernels and through the plain path, from
    the same warmed-up state and the same draws (see
    test_torch_train_step.py for why the state is warmed up first)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        g, d = MiniGenerator().to(cuda), MiniDiscriminator().to(cuda)
    plain = TrainStep(g, d, make_adam(g.parameters(), 2e-4), make_adam(d.parameters(), 2e-4),
                      sdg.DatagenConfig(), LossConfig(), 64, reference=True)
    gen = torch.Generator(device=cuda).manual_seed(5)
    for _ in range(3):
        plain(gen)
    kern = copy.deepcopy(plain)
    kern.reference = False
    start = [p.detach().clone() for m in (g, d) for p in m.parameters()]
    draws = sdg.make_draws(gen, 64, 16)
    alphas = [torch.rand(64, generator=gen, device=cuda) for _ in range(5)]
    before = (dk.launches, ck.launches, gk.launches, gk.forward_launches)
    m_k = kern.run(dk.synthetic_batch_from_draws(draws, sdg.DatagenConfig()), alphas)
    assert (dk.launches, ck.launches, gk.launches, gk.forward_launches) == (
        before[0] + 1, before[1] + 5, before[2] + 1, before[3] + 1)
    m_p = plain.run(sdg.synthetic_batch_from_draws(draws, sdg.DatagenConfig()), alphas)
    assert_metrics_close(m_k, m_p)
    # each tensor's update agrees within 1e-3 of that update's largest entry
    after_p = [p for m in (plain.generator, plain.critic) for p in m.parameters()]
    after_k = [p for m in (kern.generator, kern.critic) for p in m.parameters()]
    for p0, a, b in zip(start, after_p, after_k):
        step_p, step_k = (a - p0).detach(), (b - p0).detach()
        torch.testing.assert_close(step_k, step_p, rtol=0,
                                   atol=1e-3 * float(step_p.abs().max()) + 1e-9)


@pytest.mark.parametrize("dg,conv1,launched", [
    (sdg.DatagenConfig(), 8, (1, 5)),
    (sdg.DatagenConfig.make(channel_type="multipath", nonlinear=True), 8, (0, 5)),
    (sdg.DatagenConfig.make(frame_length=32, channel_type="rician"), 8, (0, 0)),
    (sdg.DatagenConfig(), 4, (1, 0)),
])
def test_routes_by_scope_on_the_card(cuda, dg, conv1, launched):
    """Each kernel launches where it covers the configuration and nowhere
    else; the step is finite either way."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        g, d = MiniGenerator().to(cuda), MiniDiscriminator(conv1_channels=conv1).to(cuda)
    step = TrainStep(g, d, make_adam(g.parameters(), 2e-4), make_adam(d.parameters(), 2e-4),
                     dg, LossConfig(), 64)
    before = (dk.launches, ck.launches)
    metrics = step(torch.Generator(device=cuda).manual_seed(1))
    torch.cuda.synchronize()
    assert (dk.launches - before[0], ck.launches - before[1]) == launched
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


def _full_step(cuda, reference=False, fused=False, precision="float32", L=64):
    from ofdmgan_tpu_torch.models.full_unet import FullDiscriminator, FullUNetGenerator
    from ofdmgan_tpu_torch.models.unet_infer import make_unet_infer_apply
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        g = FullUNetGenerator(frame_length=L, levels=3, base_channels=8).to(cuda)
        d = FullDiscriminator(frame_length=L, levels=3, base_channels=8).to(cuda)
    fwd = make_unet_infer_apply(levels=3, act_dtype=torch.float32) if fused else None
    return TrainStep(g, d, make_adam(g.parameters(), 2e-4), make_adam(d.parameters(), 2e-4),
                     sdg.DatagenConfig(frame_length=L), LossConfig(), 32, reference=reference,
                     gen_forward=fwd, matmul_precision=precision)


@pytest.mark.parametrize("model", ["mini", "full"])
def test_one_generator_forward_for_the_critic_updates_takes_the_per_update_step(cuda, model):
    """One no-grad generator forward a step where the critic updates share
    the outer batch, five where each is handed it; from the same state and
    draws the two take the same step bit for bit: metrics, parameters and
    Adam's moments. The mini at the benchmark's batch through the four
    kernels (its forwards the forward kernel's launches), the full pair at
    a small size through the autograd critic (its forwards the module's)."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        if model == "mini":
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)
                g, d = MiniGenerator().to(cuda), MiniDiscriminator().to(cuda)
            once = TrainStep(g, d, make_adam(g.parameters(), 2e-4),
                             make_adam(d.parameters(), 2e-4), sdg.DatagenConfig(), LossConfig(),
                             65536)
            routes = ("kernel", "kernel", "kernel", "kernel")
        else:
            once = _full_step(cuda)
            routes = ("kernel", "plain", "plain", "plain")
        assert (once.datagen_route, once.critic_route, once.generator_route,
                once.forward_route) == routes
        gen = torch.Generator(device=cuda).manual_seed(7)
        once(gen)
        each = copy.deepcopy(once)
        batch0, alphas, _ = once.draw(gen)
        no_grad = {}
        for step in (once, each):
            no_grad[step] = 0
            step.generator.register_forward_hook(
                lambda module, args, out, step=step: no_grad.__setitem__(
                    step, no_grad[step] + (not torch.is_grad_enabled())))
        start = gk.forward_launches
        m_once = once.run(batch0, alphas)
        mid = gk.forward_launches
        m_each = each.run(batch0, alphas, [batch0] * len(alphas))
        torch.cuda.synchronize()
        if model == "mini":   # the forward kernel's route: the module's forward never runs
            assert (no_grad[once], no_grad[each]) == (0, 0)
            no_grad = {once: mid - start, each: gk.forward_launches - mid}
        assert (no_grad[once], no_grad[each]) == (1, 5)
        assert {k: float(v) for k, v in m_once.items()} == \
            {k: float(v) for k, v in m_each.items()}
        for a, b in ((once.generator, each.generator), (once.critic, each.critic)):
            assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
        for a, b in ((once.opt_g, each.opt_g), (once.opt_d, each.opt_d)):
            for sa, sb in zip(a.opt.state.values(), b.opt.state.values()):
                assert all(torch.equal(sa[k], sb[k]) for k in ("exp_avg", "exp_avg_sq"))
    finally:
        torch.backends.cudnn.deterministic = saved


@pytest.mark.parametrize("fused", [False, True])
def test_full_step_routes_and_matches_the_reference_step(cuda, fused):
    """The full pair at a small size (levels 3, base 8, L = 64): one datagen
    launch and no critic launch per outer step; from a warmed-up state the
    kernel route's step and the reference step on the same draws agree
    within 1e-3 of each tensor's largest update (cuDNN may sum the weight
    gradients in another order)."""
    plain = _full_step(cuda, reference=True, fused=fused)
    gen = torch.Generator(device=cuda).manual_seed(5)
    for _ in range(3):
        plain(gen)
    kern = copy.deepcopy(plain)
    kern.reference = False
    assert (kern.datagen_route, kern.critic_route) == ("kernel", "plain")
    before = (dk.launches, ck.launches)
    metrics = kern(gen)
    torch.cuda.synchronize()
    assert (dk.launches - before[0], ck.launches - before[1]) == (1, 0)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    plain = copy.deepcopy(kern)
    plain.reference = True
    start = [p.detach().clone() for m in (kern.generator, kern.critic) for p in m.parameters()]
    draws = sdg.make_draws(gen, 32, 64)
    alphas = [torch.rand(32, generator=gen, device=cuda) for _ in range(5)]
    cfg = sdg.DatagenConfig(frame_length=64)
    kern.run(dk.synthetic_batch_from_draws(draws, cfg), alphas)
    plain.run(sdg.synthetic_batch_from_draws(draws, cfg), alphas)
    after_k = [p for m in (kern.generator, kern.critic) for p in m.parameters()]
    after_p = [p for m in (plain.generator, plain.critic) for p in m.parameters()]
    for p0, a, b in zip(start, after_p, after_k):
        step_p, step_k = (a - p0).detach(), (b - p0).detach()
        torch.testing.assert_close(step_k, step_p, rtol=0,
                                   atol=1e-3 * float(step_p.abs().max()) + 1e-9)


@pytest.mark.parametrize("L,levels,base,b", [(64, 3, 8, 32), (1024, 5, 32, 8)])
def test_fused_decoder_matches_the_unfused_forward_on_the_card(cuda, L, levels, base, b):
    """Float32 with TF32 off: the fused k = 2-pair decoder within atol 1e-5
    of the module's tanh output (tests/test_unet_infer.py:42-43)."""
    from ofdmgan_tpu_torch.models.full_unet import FullUNetGenerator
    from ofdmgan_tpu_torch.models.unet_infer import make_unet_infer_apply
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        g = FullUNetGenerator(frame_length=L, levels=levels, base_channels=base).to(cuda)
    x = torch.randn(b, L, 2, generator=torch.Generator(device=cuda).manual_seed(2), device=cuda)
    with torch.no_grad():
        fused = make_unet_infer_apply(levels=levels, act_dtype=torch.float32)(g, x)
        torch.testing.assert_close(fused, g(x), rtol=0, atol=1e-5)
        bf16 = make_unet_infer_apply(levels=levels, act_dtype=torch.bfloat16)(g, x)
    assert bf16.dtype == torch.bfloat16 and float((bf16.float() - fused).abs().max()) < 0.05


@pytest.mark.parametrize("precision", ["tensorfloat32", "bfloat16", "bf16_tf32gp", "bf16_f32gp"])
def test_precision_modes_on_the_card_restore_the_flags(cuda, precision):
    step = _full_step(cuda, precision=precision)
    assert step.critic_route == "plain"
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    assert flags == (False, False)
    metrics = step(torch.Generator(device=cuda).manual_seed(3))
    torch.cuda.synchronize()
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == flags
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


def _int_params(seed):
    from ofdmgan_tpu_torch.quant import intsim
    rng = np.random.default_rng(seed)
    layer = lambda s, b: intsim.IntLayer(rng.integers(-128, 128, s).astype(np.int32),  # noqa: E731
                                         rng.integers(-b, b, s[0]).astype(np.int32))
    gen = intsim.IntGenParams(*(layer(s, 2048) for s in
                                ((4, 2, 3), (8, 4, 3), (4, 8, 3), (2, 4, 3))))
    disc = intsim.IntDiscParams(*(layer(s, 16384) for s in ((8, 4, 3), (16, 8, 3), (1, 16))))
    return gen, disc


def test_int_datapath_on_the_card_matches_the_cpu_and_fixsim(cuda):
    """2^17 frames (two chunks) in every mode; the first 4,096 also through
    the native engine."""
    from ofdmgan_tpu_torch.quant import intsim
    from ofdmgan_tpu_torch.quant.rom_codegen import pack_rom_arrays
    from ofdmgan_tpu_torch.verify import cosim
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = intsim.float_to_q88(torch.randn(1 << 17, 16, 2, generator=gen, device=cuda) * 1.5)
    c = intsim.float_to_q88(torch.randn(1 << 17, 16, 2, generator=gen, device=cuda) * 3.0)
    ip, dp = _int_params(0)
    for mode in ("rtl", "rtl_residual", "float_ref"):
        got = intsim.generator_int_forward(ip, x, mode)
        assert got.device == x.device and got.dtype == torch.int32
        assert torch.equal(got.cpu(), intsim.generator_int_forward(ip, x.cpu(), mode)), mode
    for mode in ("rtl", "float_ref"):
        got = intsim.discriminator_int_forward(dp, x, c, mode)
        assert torch.equal(got.cpu(), intsim.discriminator_int_forward(dp, x.cpu(), c.cpu(), mode))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        g = MiniGenerator(rtl_faithful=True, qat=True, input_residual=True)
        d = MiniDiscriminator()
    rom_w, rom_b = pack_rom_arrays(g, d)
    n = 4096
    x_ncl = x[:n].transpose(1, 2).cpu().numpy().astype(np.int16)
    c_ncl = c[:n].transpose(1, 2).cpu().numpy().astype(np.int16)
    y = intsim.generator_int_forward(intsim.quantize_weights_rtl(g), x[:n], "rtl_residual")
    np.testing.assert_array_equal(cosim.generator_forward(rom_w, rom_b, x_ncl, residual=True),
                                  y.transpose(1, 2).cpu().numpy().astype(np.int16))
    s = intsim.discriminator_int_forward(intsim.quantize_weights_rtl(d, "discriminator"),
                                         x[:n], c[:n])
    np.testing.assert_array_equal(cosim.discriminator_forward(rom_w, rom_b, x_ncl, c_ncl),
                                  s[:, 0].cpu().numpy().astype(np.int16))


@pytest.mark.parametrize("kw", [dict(qat=True), dict(qat=True, rtl_faithful=True),
                                dict(qat=True, rtl_faithful=True, input_residual=True)])
def test_qat_step_routes_and_matches_the_reference_step(cuda, kw):
    """QAT changes only the generator: both kernels stay on the path."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        g, d = MiniGenerator(**kw).to(cuda), MiniDiscriminator().to(cuda)
    plain = TrainStep(g, d, make_adam(g.parameters(), 2e-4), make_adam(d.parameters(), 2e-4),
                      sdg.DatagenConfig(), LossConfig(), 64, reference=True)
    gen = torch.Generator(device=cuda).manual_seed(5)
    for _ in range(3):
        plain(gen)
    kern = copy.deepcopy(plain)
    kern.reference = False
    assert (kern.datagen_route, kern.critic_route) == ("kernel", "kernel")
    before = (dk.launches, ck.launches)
    assert all(bool(torch.isfinite(v)) for v in kern(gen).values())
    torch.cuda.synchronize()
    assert (dk.launches - before[0], ck.launches - before[1]) == (1, 5)
    plain = copy.deepcopy(kern)
    plain.reference = True
    start = [p.detach().clone() for m in (kern.generator, kern.critic) for p in m.parameters()]
    batch = dk.synthetic_batch_from_draws(sdg.make_draws(gen, 64, 16), sdg.DatagenConfig())
    alphas = [torch.rand(64, generator=gen, device=cuda) for _ in range(5)]
    kern.run(batch, alphas)
    plain.run(batch, alphas)
    after_k = [p for m in (kern.generator, kern.critic) for p in m.parameters()]
    after_p = [p for m in (plain.generator, plain.critic) for p in m.parameters()]
    for p0, a, b in zip(start, after_p, after_k):
        step_p, step_k = (a - p0).detach(), (b - p0).detach()
        torch.testing.assert_close(step_k, step_p, rtol=0,
                                   atol=1e-3 * float(step_p.abs().max()) + 1e-9)


def _snr_draws(n, L, protocol, channel="awgn", seed=6):
    from ofdmgan_tpu_torch.eval import benchmark as bm
    return bm.make_snr_draws(torch.Generator().manual_seed(seed), n, L, channel, protocol)


@pytest.mark.parametrize("L", [16, 256])
def test_equalizers_on_the_card_match_the_cpu(cuda, L):
    """The same draws on both devices: at L = 16 every equalizer by
    element; at L = 256 ZF, MMSE and LMS by element and DFE (hard
    decisions) and RLS (rounding amplified by its P recursion) by mean MSE."""
    from ofdmgan_tpu_torch.eval import equalizers as eq
    from ofdmgan_tpu_torch.eval.benchmark import estimates_from_draws
    draws = _snr_draws(64, L, "oracle")
    clean, est = estimates_from_draws(draws, 10.0)
    noisy = est["NoEQ"]
    for name, fn in eq.EQUALIZERS.items():
        got, m_got = fn(noisy.to(cuda), clean.to(cuda))
        ref, m_ref = fn(noisy, clean)
        assert got.device == cuda
        if L == 16 or name in ("ZF", "MMSE", "LMS"):
            torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=2e-5)
        else:
            torch.testing.assert_close(m_got["mse"].mean().cpu(), m_ref["mse"].mean(),
                                       rtol=1e-3, atol=1e-9)


@pytest.mark.parametrize("protocol,normalization,nonlinear", [
    ("oracle", "independent", False), ("pilot", "joint", True)])
def test_snr_batch_on_the_card_matches_the_cpu(cuda, protocol, normalization, nonlinear):
    from ofdmgan_tpu_torch.eval.benchmark import estimates_from_draws
    from ofdmgan_tpu_torch.quant import intsim
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        g = MiniGenerator()
    ip = intsim.quantize_weights_rtl(g)
    draws = _snr_draws(100, 16, protocol, "multipath")
    kw = dict(channel_type="multipath", nonlinear=nonlinear, pa_saturation=0.8,
              normalization=normalization, int_params=ip, protocol=protocol)
    clean_c, est_c = estimates_from_draws({k: v.to(cuda) for k, v in draws.items()}, 20.0,
                                          generator=copy.deepcopy(g).to(cuda), **kw)
    clean, est = estimates_from_draws(draws, 20.0, generator=g, **kw)
    torch.testing.assert_close(clean_c.cpu(), clean, rtol=0, atol=2e-6)
    assert set(est_c) == set(est)
    for m in est:
        if m == "GAN-Q":   # bit for bit on the card's own input frames
            want = intsim.q88_to_float(intsim.generator_int_forward(
                ip, intsim.float_to_q88(est_c["NoEQ"].cpu())))
            assert torch.equal(est_c[m].cpu(), want)
        else:
            torch.testing.assert_close(est_c[m].cpu(), est[m], rtol=0, atol=2e-5, msg=m)


def test_distributional_report_on_the_card_matches_the_cpu(cuda):
    from ofdmgan_tpu_torch.eval.distributional import make_report_fn, seeded_draws
    cfg = sdg.DatagenConfig.make(frame_length=64, nonlinear=True, pa_saturation=0.8)
    draw_card = seeded_draws(2, 256, cfg, cuda)
    batches = [draw_card(i) for i in range(4)]
    report = make_report_fn(lambda x: 0.9 * x, cfg, 256, 4, 512)
    got = report(lambda i: batches[i])
    ref = report(lambda i: tuple({k: v.cpu() for k, v in d.items()} for d in batches[i]))
    for k in ref:
        torch.testing.assert_close(got[k].cpu(), ref[k], rtol=1e-4, atol=1e-6, msg=k)


def test_golden_vectors_on_the_card_match_the_cpu(cuda, tmp_path):
    from ofdmgan_tpu_torch.verify import golden
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        g = MiniGenerator()
    x = torch.randn(1, 2, 16, generator=torch.Generator().manual_seed(4)).numpy()
    golden.generate_golden_vectors(copy.deepcopy(g).to(cuda), x, str(tmp_path / "cuda"))
    golden.generate_golden_vectors(g, x, str(tmp_path / "cpu"))
    y_c, y = (np.load(tmp_path / d / "output_float.npy") for d in ("cuda", "cpu"))
    np.testing.assert_allclose(y_c, y, rtol=0, atol=1e-6)
    q_c, q = (np.load(tmp_path / d / "output_q88.npy") for d in ("cuda", "cpu"))
    np.testing.assert_array_equal(q_c, golden.q88_int16(y_c))
    straddle = golden.q88_int16(y_c) != golden.q88_int16(y)
    np.testing.assert_array_equal(q_c[~straddle], q[~straddle])
    assert np.abs(q_c.astype(int) - q).max() <= 1
    for name in ("input_float.npy", "input_q88.npy", "input.hex", "golden_metadata.json"):
        assert (tmp_path / "cuda" / name).read_bytes() == (tmp_path / "cpu" / name).read_bytes()


def test_proof_integer_mses_on_the_card_equal_the_cpu(cuda):
    from ofdmgan_tpu_torch.verify import proof
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        g = MiniGenerator()
    draws = proof.make_proof_draws(torch.Generator().manual_seed(6))
    g_c = copy.deepcopy(g).to(cuda)
    for snr in (0.0, 15.0, 30.0):
        got = proof.int_datapath_enhancement_from_draws(g_c, draws, snr)
        want = proof.int_datapath_enhancement_from_draws(g, draws, snr)
        assert got["mse_before"] == want["mse_before"] and got["mse_after"] == want["mse_after"]
        got = proof.signal_enhancement_from_draws(g_c, draws, snr)
        want = proof.signal_enhancement_from_draws(g, draws, snr)
        assert got["mse_after"] == pytest.approx(want["mse_after"], rel=1e-5)


def test_simplegan_integer_path_on_the_card_equals_the_cpu(cuda):
    from ofdmgan_tpu_torch import simplegan as sg
    p = sg.init_params(torch.Generator().manual_seed(7))
    p, _ = sg.train_from_draws(p, **sg.make_train_draws(torch.Generator().manual_seed(8), 200))
    q, q_c = sg.quantize_params(p), sg.quantize_params(sg.SimpleGANParams(*(t.to(cuda) for t in p)))
    assert all(torch.equal(q[k], q_c[k].cpu()) for k in q)
    ng = torch.arange(-2048, 2048, 4).reshape(-1, 2)
    img, img_c = sg.generator_int_forward(q, ng), sg.generator_int_forward(q_c, ng.to(cuda))
    assert img_c.device.type == "cuda" and torch.equal(img_c.cpu(), img)
    assert torch.equal(sg.discriminator_int_forward(q_c, img_c).cpu(),
                       sg.discriminator_int_forward(q, img))


def test_selfcheck_training_takes_both_kernels(cuda):
    from ofdmgan_tpu_torch import selfcheck
    before = (dk.launches, ck.launches)
    assert selfcheck._check_training(cuda) == {"routes": {"datagen": "kernel",
                                                          "critic": "kernel"}}
    assert (dk.launches - before[0], ck.launches - before[1]) == (1, 2)


def test_a_mini_export_on_the_card_matches_the_cpu(cuda, tmp_path):
    from ofdmgan_tpu_torch import export_serving
    from ofdmgan_tpu_torch.utils.jax_params import to_jax_params
    from ofdmgan_tpu_torch.utils.params_io import save_params_tree

    torch.manual_seed(0)
    g = MiniGenerator(input_residual=True)
    save_params_tree(str(tmp_path / "g.npz"), to_jax_params(g))
    meta = export_serving.main(["--device", str(cuda), "--residual", "--checkpoint",
                                str(tmp_path / "g.npz"), "--out", str(tmp_path / "a")])
    assert meta["device"] == str(cuda) and meta["selftest_max_abs_diff"] < 1e-5
    x = torch.randn(333, 16, 2, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = torch.export.load(str(tmp_path / "a.pt2")).module()(x.to(cuda)).cpu()
        torch.testing.assert_close(got, g(x), rtol=0, atol=1e-6)


@pytest.mark.parametrize("resident", [False, True])
def test_the_bench_launches_the_datagen_kernel_per_apply(cuda, resident, monkeypatch):
    from ofdmgan_tpu_torch import bench_infer

    monkeypatch.setattr(bench_infer, "WARMUP_WINDOWS", 1)
    monkeypatch.setattr(bench_infer, "TIMED_WINDOWS", 2)
    (r,) = bench_infer.main(["--models", "mini", "--batch", "4096", "--scan_steps", "8"]
                            + ["--resident"] * resident)
    assert r["stats"]["datagen_launches_per_window"] == (0 if resident else 8)
    assert r["row"]["value"] > 0 and 0 <= r["stats"]["idle_share"] < 1


def test_bf16_mode_critic_on_the_card_matches_the_cpu(cuda):
    from ofdmgan_tpu_torch.training import wgan_gp

    torch.manual_seed(3)
    critic = MiniDiscriminator()
    a, b = torch.randn(2, 2048, 16, 2, generator=torch.Generator().manual_seed(4)).unbind(0)
    with torch.no_grad(), wgan_gp.matmul_precision("bfloat16"):
        want = critic(a, b)
        got = copy.deepcopy(critic).to(cuda)(a.to(cuda), b.to(cuda)).cpu()
    # every score within rtol 1e-5 but where a layer-1 activation, summed in
    # another order, rounded to the other bf16 neighbour: at most 1 in 1,000
    # scores, each within one bf16 step (2^-8) of the scores' scale
    diff = (got - want).abs()
    off = diff > 1e-6 + 1e-5 * want.abs()
    assert int(off.sum()) <= max(1, want.numel() // 1000)
    assert float(diff.max()) <= 2 ** -8 * float(want.abs().max())


def test_a_remat_step_on_the_card_equals_the_plain_step(cuda):
    torch.manual_seed(5)
    g, d = MiniGenerator().to(cuda), MiniDiscriminator().to(cuda)
    steps = []
    for remat in (False, True):
        gg, dd = copy.deepcopy(g), copy.deepcopy(d)
        steps.append(TrainStep(gg, dd, make_adam(gg.parameters(), 2e-4),
                               make_adam(dd.parameters(), 2e-4), sdg.DatagenConfig(),
                               LossConfig(), 64, reference=True, remat=remat))
    start = [p.detach().clone() for p in [*g.parameters(), *d.parameters()]]
    for seed in (0, 1):
        gen = torch.Generator(device=cuda).manual_seed(seed)
        batch = sdg.synthetic_batch(gen, 64, sdg.DatagenConfig())
        alphas = [torch.rand(64, generator=gen, device=cuda) for _ in range(5)]
        for s in steps:
            s.run(batch, alphas)
    plain, remat = ([p.detach() for p in [*s.generator.parameters(), *s.critic.parameters()]]
                    for s in steps)
    for p0, a, b in zip(start, plain, remat):
        assert float((b - a).abs().max()) <= 1e-6 * float((a - p0).abs().max())



def _mini_pair(dev, batch, mesh=None):
    """The mini pair from seed 0 on ``dev``: a data-parallel step over
    ``mesh`` (else a plain step) at global ``batch``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        g, d = MiniGenerator().to(dev), MiniDiscriminator().to(dev)
    args = (g, d, make_adam(g.parameters(), 2e-4, (0.0, 0.9)),
            make_adam(d.parameters(), 2e-4, (0.0, 0.9)), sdg.DatagenConfig(), LossConfig())
    if mesh is None:
        return TrainStep(*args, batch)
    return make_sharded_train_step(*args, batch, mesh)


def _params(step):
    return [p.detach() for p in [*step.generator.parameters(), *step.critic.parameters()]]


def _world_of_one_rank() -> dict:
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cudnn.deterministic = True
    dp, plain = _mini_pair(dev, 64, make_mesh({"dp": 1})), _mini_pair(dev, 64)
    # a sharded step's generator update is autograd's, its forward the module's
    plain.generator_route, plain.forward_route = dp.generator_route, dp.forward_route
    seeds_dp, seeds_plain = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    equal = []
    for _ in range(4):
        m_dp = dp(seeds_dp)
        m_plain = plain(replica_generator(draw_seed(seeds_plain), 0, dev))
        equal.append(all(torch.equal(a, b) for a, b in zip(_params(dp), _params(plain)))
                     and all(torch.equal(m_dp[k], m_plain[k]) for k in m_plain))
    return {"backend": torch.distributed.get_backend(), "equal": equal,
            "routes": (dp.datagen_route, dp.critic_route, dp.generator_route)}


def test_data_parallel_world_of_one_over_nccl_equals_the_plain_step(cuda):
    out = distributed.launch(_world_of_one_rank, 1, device="cuda:0")[0]
    assert out["backend"] == "nccl" and out["routes"] == ("kernel", "kernel", "plain")
    assert all(out["equal"]), out["equal"]


def _launch_counts_rank() -> dict:
    dev = torch.device("cuda", torch.cuda.current_device())
    dp = _mini_pair(dev, 64, make_mesh({"dp": 1}))
    seeds = torch.Generator().manual_seed(4)
    dk.launches = ck.launches = 0
    for _ in range(3):
        dp(seeds)
    return {"datagen": dk.launches, "critic_grad": ck.launches}


def test_data_parallel_step_launches_one_datagen_and_five_critic_kernels(cuda):
    out = distributed.launch(_launch_counts_rank, 1, device="cuda:0")[0]
    assert out == {"datagen": 3, "critic_grad": 15}


def _two_ranks_rank(batch: int) -> dict:
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cudnn.deterministic = True
    dp = _mini_pair(dev, batch, make_mesh({"dp": 2}))
    seeds = torch.Generator().manual_seed(5)
    lockstep = []
    dk.launches = ck.launches = 0
    for _ in range(4):
        dp(seeds)
        flat = torch.cat([p.reshape(-1) for p in _params(dp)])
        lockstep.append(torch.equal(flat, distributed.broadcast(flat.clone(), 0)))
    launches = (dk.launches, ck.launches)
    single = _mini_pair(dev, batch)
    for mine, theirs in zip(_params(single), _params(dp)):
        mine.copy_(theirs)
    for src, dst in ((dp.opt_g, single.opt_g), (dp.opt_d, single.opt_d)):
        dst.opt.load_state_dict(copy.deepcopy(src.opt.state_dict()))
    start = [p.clone() for p in _params(dp)]
    probe = torch.Generator()
    probe.set_state(seeds.get_state())
    seed = draw_seed(probe)
    dp(seeds)
    parts = [dp.step.draw(replica_generator(seed, i, dev)) for i in range(2)]
    batch0 = {k: torch.cat([p[0][k] for p in parts]) for k in parts[0][0]}
    alphas = [torch.cat([p[1][j] for p in parts]) for j in range(5)]
    single.run(batch0, alphas)
    rel = max(float((a - b).abs().max()) / max(float((b - p0).abs().max()), 1e-12)
              for p0, a, b in zip(start, _params(dp), _params(single)))
    return {"lockstep": lockstep, "launches": launches, "rel": rel}


def test_two_ranks_share_the_card_over_gloo_in_lockstep(cuda):
    out = distributed.launch(_two_ranks_rank, 2, (16,), device="cuda:0", backend="gloo")
    for r in out:
        assert all(r["lockstep"]), r["lockstep"]
        assert r["launches"] == (4, 20)
        assert r["rel"] <= 1e-3, r["rel"]


def test_nccl_without_a_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="NCCL needs a CUDA device"):
        distributed.backend_for(torch.device("cuda"))
    with pytest.raises(RuntimeError, match="NCCL needs a CUDA device"):
        distributed.initialize(f"file://{tmp_path}/store", device="cuda")
    assert not distributed.is_initialized()


def _graph_state(trainer) -> dict:
    out = {f"p{i}": p for i, p in enumerate(list(trainer.generator.parameters())
                                            + list(trainer.critic.parameters()))}
    for tag, opt in (("g", trainer.opt_g), ("d", trainer.opt_d)):
        for i, st in enumerate(opt.opt.state.values()):
            out.update({f"{tag}{i}{k}": v for k, v in st.items()})
        out[tag + "lr"], out[tag + "count"] = opt.opt.param_groups[0]["lr"], opt.count
    return out


def _graphed_trainer(tmp_path, steps=8, scan=4):
    from ofdmgan_tpu_torch.config import Config, TrainingSection
    from ofdmgan_tpu_torch.training.trainer import Trainer
    cfg = Config(training=TrainingSection(batch_size=16), checkpoint_dir=str(tmp_path / "ck"),
                 log_dir=str(tmp_path / "logs"), export_after_training=False)
    t = Trainer(cfg, samples_per_epoch=steps * 16, val_samples=16, device="cuda", scan_steps=scan)
    assert t.graphed and t.scan_steps == scan
    return t


def _traced_kernels(fn):
    """``(fn(), counts)``: the port's kernels that ran on the device in one
    call of ``fn``, by name, from ``torch.profiler``'s trace (its first step,
    one small kernel, is dropped: the profiler misses a trace's first kernel).
    The traced window can lose its leading records, so it opens with 512
    launches of the Box-Muller kernel, a name no step runs, in groups of 64
    each ended by a synchronize, and one must be left in the trace."""
    from torch.profiler import ProfilerActivity, profile, schedule
    probe = torch.zeros(1, device="cuda")
    bits = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        probe.add_(1)
        torch.cuda.synchronize()
        prof.step()
        for _ in range(8):
            for _ in range(64):
                dk.box_muller(bits)
            torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
        prof.step()
    names = ("box_muller_kernel", "datagen_kernel", "critic_grad_kernel",
             "critic_grad_sum_kernel", "generator_grad_kernel", "generator_grad_sum_kernel",
             "generator_forward_kernel")
    events = [e for e in prof.key_averages() if e.device_type != torch.autograd.DeviceType.CPU]
    counts = {n: sum(e.count for e in events if re.search(rf"\b{n}\b", e.key)) for n in names}
    assert counts.pop("box_muller_kernel") > 0
    return out, counts


def test_a_graphed_chunk_matches_its_eager_twin_and_counts_its_launches(cuda, tmp_path):
    t = _graphed_trainer(tmp_path)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t.chunk()   # the warm-up chunk
        assert t.step.generator_route == t.step.forward_route == "kernel"
        dk.launches = ck.launches = gk.launches = gk.forward_launches = 0
        t.chunk.capture()
        snap = ({k: v.detach().clone() for k, v in _graph_state(t).items()}, t.rng.get_state())

        def restore(rng=True):
            with torch.no_grad():
                for k, v in _graph_state(t).items():
                    v.copy_(snap[0][k])
            if rng:
                t.rng.set_state(snap[1])

        m_replay, traced = _traced_kernels(t.chunk.replay)
        m_replay = {k: float(v) for k, v in m_replay.items()}
        assert (dk.launches, ck.launches, gk.launches, gk.forward_launches) == (0, 0, 0, 0)
        assert traced == {"datagen_kernel": 4, "critic_grad_kernel": 20,
                          "critic_grad_sum_kernel": 20, "generator_grad_kernel": 4,
                          "generator_grad_sum_kernel": 4, "generator_forward_kernel": 4}
        replayed = [p.detach().clone() for p in _params(t)]
        restore()
        m_eager = {k: float(v) for k, v in t.chunk.eager().items()}
        assert m_eager == m_replay
        assert all(torch.equal(a, b) for a, b in zip(replayed, _params(t)))
        restore()
        assert {k: float(v) for k, v in t.chunk.replay().items()} == m_replay
        restore(rng=False)
        assert {k: float(v) for k, v in t.chunk.replay().items()}["rec_loss"] != \
            m_replay["rec_loss"]
    finally:
        torch.backends.cudnn.deterministic = saved


def test_tf32_matmul_on_the_card_matches_the_cpu(cuda):
    from ofdmgan_tpu_torch.models.critic import compute_gradient_penalty
    from ofdmgan_tpu_torch.models.flat import make_critic_flat_apply
    gen = torch.Generator().manual_seed(8)
    frames = [torch.randn(512, 16, 2, generator=gen) * 0.5 for _ in range(3)]
    alpha = torch.rand(512, generator=gen)
    torch.manual_seed(3)
    critic = MiniDiscriminator()
    apply = make_critic_flat_apply(mm="tf32x3")
    out = {}
    for dev in ("cpu", cuda):
        c = copy.deepcopy(critic).to(dev)
        real, fake, cond = (f.to(dev) for f in frames)
        gp = compute_gradient_penalty(lambda a, b: apply(c, a, b), real, fake, cond,
                                      alpha.to(dev))
        grads = torch.autograd.grad(gp, list(c.parameters()), allow_unused=True)
        out[str(dev)] = ([apply(c, real, cond).detach().cpu()]
                         + [g.cpu() for g in grads if g is not None])
    (score, *grads), (score_ref, *grads_ref) = out[str(cuda)], out["cpu"]
    torch.testing.assert_close(score, score_ref, rtol=0, atol=1e-6 * float(score_ref.abs().max()))
    for g, r in zip(grads, grads_ref):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-3 * float(r.abs().max()) + 1e-12)


@pytest.mark.parametrize("mode", ["qat", "rtl"])
def test_e4m3fn_qat_forward_nans_as_on_the_cpu(cuda, mode):
    """An e4m3fn QAT forward is NaN everywhere on the card as on the CPU
    (the Q8.8 clip's bounds lie outside the format); ``rtl_faithful``
    alone is finite on both and agrees within atol 1e-5."""
    torch.manual_seed(4)
    kw = dict(qat=True) if mode == "qat" else dict(rtl_faithful=True)
    g = MiniGenerator(act_dtype="float8_e4m3fn", input_residual=True, **kw)
    x = (torch.randn(256, 16, 2, generator=torch.Generator().manual_seed(5)) * 0.5).to(
        torch.float8_e4m3fn)
    with torch.no_grad():
        y_cpu = g(x)
        y_card = copy.deepcopy(g).to(cuda)(x.to(cuda)).cpu()
    assert torch.equal(torch.isnan(y_card), torch.isnan(y_cpu))
    assert bool(torch.isnan(y_cpu).all()) == (mode == "qat")
    if mode == "rtl":
        torch.testing.assert_close(y_card, y_cpu, rtol=0, atol=1e-5)


@pytest.mark.parametrize("p", [4, 2])
def test_packed_step_matches_the_module_step_on_the_card(cuda, p):
    """From a state three packed steps warmed up (a fresh Adam turns a
    gradient that is zero up to rounding into a full step of either sign),
    one packed step (the datagen kernel's batch, packed with no copy)
    against the module step on that batch's [B, L, 2] view and the same
    uniforms: each tensor's update within 1e-3 of its largest entry, as the
    kernel and plain steps (the critic kernel and the packed critic's
    autograd sum in other orders)."""
    from ofdmgan_tpu_torch.ops import packed_step as ps
    torch.manual_seed(6)
    g, d = MiniGenerator().to(cuda), MiniDiscriminator().to(cuda)
    adam = lambda m: make_adam(m.parameters(), 2e-4, (0.0, 0.9))  # noqa: E731
    cfg = sdg.DatagenConfig()
    opt_g, opt_d = adam(g), adam(d)
    step = ps.PackedTrainStep(g, d, opt_g, opt_d, cfg, LossConfig(), 4096, p=p, scan_steps=3,
                              matmul_precision="float32")
    assert step.datagen_route == "kernel"
    rng = torch.Generator(device=cuda).manual_seed(7)
    before = dk.launches
    step(rng)
    assert dk.launches == before + 3
    g2, d2 = copy.deepcopy(g), copy.deepcopy(d)
    module = TrainStep(g2, d2, adam(g2), adam(d2), cfg, LossConfig(), 4096)
    for new, old in ((module.opt_g, opt_g), (module.opt_d, opt_d)):
        new.load_state_dict(*copy.deepcopy(old.state_dict()))
    batch, alphas = step.draw(rng)
    start = [q.detach().clone() for q in (*g.parameters(), *d.parameters())]
    step.run(batch, alphas)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        module.run({k: batch[k].view(4096, 16, 2) for k in ("noisy", "clean")}, alphas)
    finally:
        torch.backends.cudnn.deterministic = saved
    for q0, a, b in zip(start, (*g.parameters(), *d.parameters()),
                        (*g2.parameters(), *d2.parameters())):
        upd = (b - q0).detach()
        assert float(((a - q0) - upd).abs().max()) <= 1e-3 * float(upd.abs().max()) + 1e-9
