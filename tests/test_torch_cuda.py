"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q

(``--noconftest`` because ``tests/conftest.py`` sets JAX up.)

Tolerances: the datagen kernel rtol 1e-5, atol 1e-6 (the same float32
arithmetic; only fused multiply-adds round differently). The critic-gradient
kernel rtol 1e-4, atol 1e-4 of each tensor's largest entry: it sums the batch
in another order.
"""

import copy

import pytest
import torch

from ofdmgan_tpu_torch.models import MiniDiscriminator, MiniGenerator
from ofdmgan_tpu_torch.ops import critic_kernel as ck
from ofdmgan_tpu_torch.ops import datagen_kernel as dk
from ofdmgan_tpu_torch.signal import datagen as sdg
from ofdmgan_tpu_torch.signal.impairments import ImpairmentConfig
from ofdmgan_tpu_torch.training.schedules import make_adam
from ofdmgan_tpu_torch.training.wgan_gp import LossConfig, TrainStep, critic_loss_fn

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from ofdmgan_tpu_torch.device import resolve_device
    return resolve_device("cuda")


def _critic_close(got, ref):
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()) + 1e-7)


@pytest.mark.parametrize("nonlinear", [False, True])
@pytest.mark.parametrize("b", [64, 1000])
def test_datagen_kernel_matches_plain_version(cuda, b, nonlinear):
    gen = torch.Generator(device=cuda).manual_seed(2)
    draws = sdg.make_draws(gen, b, 16)
    cfg = sdg.DatagenConfig(nonlinear=nonlinear, impairments=ImpairmentConfig(pa_saturation=0.8))
    before = dk.launches
    got = dk.synthetic_batch_from_draws(draws, cfg)
    assert dk.launches == before + 1
    ref = dk.synthetic_batch_plain(draws, cfg)
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=1e-5, atol=1e-6)


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


@pytest.mark.parametrize("b", [64, 1000, 65536])
def test_critic_kernel_matches_plain_version(cuda, b):
    gen = torch.Generator(device=cuda).manual_seed(3)
    critic = MiniDiscriminator().to(cuda)
    h0r = torch.randn(b, 64, generator=gen, device=cuda)
    h0f = torch.randn(b, 64, generator=gen, device=cuda)
    eps = torch.rand(b, generator=gen, device=cuda)
    mats = ck.critic_dense_mats(critic)
    before = ck.launches
    got = ck.critic_grad_dense(h0r, h0f, eps, mats, 10.0)
    assert ck.launches == before + 1
    ref = ck.critic_grad_plain(h0r, h0f, eps, mats, 10.0)
    for k, r in ref.items():
        _critic_close(got[k], r)


def test_critic_kernel_matches_autograd(cuda):
    b = 1000
    gen = torch.Generator(device=cuda).manual_seed(4)
    critic, generator = MiniDiscriminator().to(cuda), MiniGenerator().to(cuda)
    clean = torch.randn(b, 16, 2, generator=gen, device=cuda)
    noisy = clean + 0.3 * torch.randn(b, 16, 2, generator=gen, device=cuda)
    eps = torch.rand(b, generator=gen, device=cuda)
    with torch.no_grad():
        fake = generator(noisy)
    grads, aux = ck.critic_grad(critic, ck.pack_h0(clean, noisy), ck.pack_h0(fake, noisy),
                                eps, 10.0)
    loss, ref_aux = critic_loss_fn(critic, generator, {"noisy": noisy, "clean": clean}, eps,
                                   LossConfig())
    ref = torch.autograd.grad(loss, list(critic.parameters()))
    for (name, _), r in zip(critic.named_parameters(), ref):
        _critic_close(grads[name], r)
    for name, r in ref_aux.items():
        torch.testing.assert_close(aux[name], r, rtol=1e-4, atol=1e-5)


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
    before = (dk.launches, ck.launches)
    m_k = kern.run(dk.synthetic_batch_from_draws(draws, sdg.DatagenConfig()), alphas)
    assert (dk.launches, ck.launches) == (before[0] + 1, before[1] + 5)
    m_p = plain.run(sdg.synthetic_batch_from_draws(draws, sdg.DatagenConfig()), alphas)
    for name in m_p:
        torch.testing.assert_close(m_k[name], m_p[name], rtol=1e-4, atol=1e-5)
    # each tensor's update agrees within 1e-3 of that update's largest entry
    after_p = [p for m in (plain.generator, plain.critic) for p in m.parameters()]
    after_k = [p for m in (kern.generator, kern.critic) for p in m.parameters()]
    for p0, a, b in zip(start, after_p, after_k):
        step_p, step_k = (a - p0).detach(), (b - p0).detach()
        torch.testing.assert_close(step_k, step_p, rtol=0,
                                   atol=1e-3 * float(step_p.abs().max()) + 1e-9)
