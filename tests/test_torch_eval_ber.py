"""The port's BER curves against the JAX package's, on JAX's own draws.

Each SNR's draws are rebuilt from the JAX package's key splits
(``ofdmgan_tpu/eval/ber.py:34-38, 62-73``: ``bernoulli`` is a uniform below
0.5) and handed to the port. The BER must agree within one decision (a
hard decision on a statistic within float32 rounding of zero may flip; on
these seeds none does), and the decision statistics by element: atol 2e-6
in the time domain, 1e-5 after the FFT. ``ber_curve_snr_offset`` is
numpy in both and must agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdmgan_tpu.eval import ber as jber
from ofdmgan_tpu.models import MiniGenerator as JGen
from ofdmgan_tpu_torch.eval import ber as tber
from ofdmgan_tpu_torch.models import MiniGenerator
from ofdmgan_tpu_torch.utils.jax_params import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

N, L = 256, 16


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_td_draws(key, n, length):
    k_bits, k_noise = jax.random.split(key)
    shape = (n, length, 2)
    return {"signs": _t(jax.random.bernoulli(k_bits, 0.5, shape)),
            "noise": _t(jax.random.normal(k_noise, shape))}


def jax_ofdm_draws(key, n, length):
    k_bits, k_noise = jax.random.split(key)
    kr, ki = jax.random.split(k_noise)
    return {"bits": _t(jax.random.bernoulli(k_bits, 0.5, (n, 2 * length)).astype(jnp.int32)),
            "nr": _t(jax.random.normal(kr, (n, length))),
            "ni": _t(jax.random.normal(ki, (n, length)))}


@pytest.fixture(scope="module")
def pair():
    g = JGen()
    params = jax.device_get(g.init(jax.random.PRNGKey(4), jnp.zeros((1, L, 2))))
    t = MiniGenerator()
    t.load_state_dict(from_jax_params(params))
    return g, params, t


@pytest.mark.parametrize("with_gan", [False, True])
@pytest.mark.parametrize("snr", [0.0, 8.0])
def test_time_domain_matches_jax(pair, with_gan, snr):
    g, params, t = pair
    key = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    ref = float(jber._ber_time_domain_one(key, params if with_gan else None, jnp.float32(snr),
                                          N, L, g.apply if with_gan else None))
    draws = jax_td_draws(key, N, L)
    got = float(tber.ber_time_domain_from_draws(draws, snr, t if with_gan else None))
    assert abs(got - ref) <= 1.0 / (N * L * 2)
    noisy = np.where(np.asarray(draws["signs"]), 0.7, -0.7).astype(np.float32)
    noise_power = np.float32(0.49) / np.float32(10 ** (snr / 10))
    noisy = noisy + np.sqrt(noise_power) * draws["noise"].numpy()
    est_ref = np.asarray(g.apply(params, noisy)) if with_gan else noisy
    np.testing.assert_allclose(tber.time_domain_estimate(draws, snr, t if with_gan else None)
                               .numpy(), est_ref, atol=2e-6)


@pytest.mark.parametrize("with_gan", [False, True])
@pytest.mark.parametrize("snr", [0.0, 10.0, 40.0])
def test_ofdm_matches_jax(pair, with_gan, snr):
    g, params, t = pair
    key = jax.random.fold_in(jax.random.PRNGKey(0), 1002)
    ref = float(jber._ber_ofdm_one(key, params if with_gan else None, jnp.float32(snr), N, L,
                                   g.apply if with_gan else None))
    got = float(tber.ber_ofdm_from_draws(jax_ofdm_draws(key, N, L), snr,
                                         t if with_gan else None))
    assert abs(got - ref) <= 1.0 / (N * L * 2)
    if snr == 40.0 and not with_gan:
        assert got < 1e-3


def test_ofdm_symbols_and_curves_on_generators():
    draws = jax_ofdm_draws(jax.random.PRNGKey(1), 64, 32)
    rx = tber.ofdm_received_symbols(draws, 60.0)
    # near-noiseless: the symbols are the QPSK points the bits map to
    from ofdmgan_tpu_torch.signal import qam
    np.testing.assert_allclose(rx.numpy(), qam.modulate(draws["bits"], "QPSK").numpy(), atol=1e-2)
    curve = tber.ber_time_domain(None, [0.0, 6.0, 12.0], n_frames=512, device="cpu")
    assert curve[0.0] > curve[6.0] > curve[12.0] and curve[0.0] > 0.05
    assert tber.ber_ofdm(None, [40.0], n_frames=256, device="cpu")[40.0] < 1e-3
    again = tber.ber_time_domain(None, [0.0, 6.0, 12.0], n_frames=512, device="cpu")
    assert again == curve   # seeded per SNR


def test_snr_offset_matches_jax():
    a = {0.0: 0.2, 5.0: 0.05, 10.0: 0.004, 15.0: 1e-4}
    b = {0.0: 0.15, 5.0: 0.02, 10.0: 0.001, 15.0: 0.0}
    for target in (1e-2, 1e-3, 1e-6):
        assert tber.ber_curve_snr_offset(a, b, target) == jber.ber_curve_snr_offset(a, b, target)
    assert tber.ber_curve_snr_offset(a, a) == 0.0
