"""The port's GAN-versus-classical sweep against the JAX package's.

One SNR's batch is rebuilt from the JAX package's own key splits
(``ofdmgan_tpu/eval/benchmark.py:75-109``: the spectra, the phase-noise
increments, the channel's draws and the fixed preamble of ``PRNGKey(2024)``)
and handed to both packages, which must give each trial's MSE and EVM by
element: MSE within rtol 1e-4, atol 1e-9 (float32 rounding of the FFT, the
channel and the equalizers' recurrences over 16 samples; ZF's oracle MSE
is ~1e-13, rounding itself), EVM in dB within atol 1e-3 (the oracle ZF's
EVM, the log of rounding noise near -140 dB, only below -100 dB), and
GAN-Q, the integer datapath, within the same MSE bound. The whole sweep
``run_benchmark`` cannot share draws with JAX (its generators differ), so
on a committed champion it is held by statistics: each method's mean MSE
over 200 trials within four standard errors of the difference of two
independent means (the trials' spread), at every SNR.
"""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdmgan_tpu.eval import benchmark as jb
from ofdmgan_tpu.models import MiniGenerator as JGen
from ofdmgan_tpu.quant import intsim as ji
from ofdmgan_tpu.signal.channel import ChannelConfig
from ofdmgan_tpu_torch.eval import benchmark as tb
from ofdmgan_tpu_torch.models import MiniGenerator
from ofdmgan_tpu_torch.quant import intsim as ti
from ofdmgan_tpu_torch.utils.jax_params import from_jax_params
from ofdmgan_tpu_torch.utils.params_io import load_params_tree
from test_torch_channels import jax_channel_draws
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
CHAMPION = REPO / "results" / "residual_checkpoints" / "nonlinear" / "champion_params_g.npz"


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_snr_draws(key, n, L, channel_type="awgn", protocol="oracle"):
    """The draws of ``jb._one_snr_batch(key, ...)``, from its key splits."""
    k_sym, k_imp, k_ch = jax.random.split(key, 3)
    kr, ki = jax.random.split(k_sym)
    tx_len = 2 * L if protocol == "pilot" else L
    draws = {"zr": _t(jax.random.normal(kr, (n, L))), "zi": _t(jax.random.normal(ki, (n, L))),
             "pn": _t(jax.random.normal(k_imp, (n, tx_len), jnp.float32))}
    draws.update(jax_channel_draws(k_ch, ChannelConfig(channel_type), (n,), tx_len))
    if protocol == "pilot":
        kp_r, kp_i = jax.random.split(jax.random.PRNGKey(2024))
        draws.update(pr=_t(jax.random.normal(kp_r, (L,))), pi=_t(jax.random.normal(kp_i, (L,))))
    return draws


def _mini_pair(seed=0, residual=False):
    g = JGen(input_residual=residual)
    params = jax.device_get(g.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16, 2))))
    t = MiniGenerator(input_residual=residual)
    t.load_state_dict(from_jax_params(params))
    return g, params, t


def _check(res_t, res_j):
    assert set(res_t) == set(res_j)
    for m in res_j:
        mse_t, evm_t = (v.numpy() for v in res_t[m])
        mse_j, evm_j = (np.asarray(v) for v in res_j[m])
        np.testing.assert_allclose(mse_t, mse_j, rtol=1e-4, atol=1e-9, err_msg=m)
        if m == "ZF" and evm_j.max() < -100.0:   # the oracle's: the log of rounding noise
            assert evm_t.max() < -100.0
        else:
            np.testing.assert_allclose(evm_t, evm_j, atol=1e-3, err_msg=m)


@pytest.mark.parametrize("protocol", ["oracle", "pilot"])
@pytest.mark.parametrize("normalization", ["independent", "joint"])
@pytest.mark.parametrize("nonlinear", [False, True])
def test_one_snr_batch_matches_jax(protocol, normalization, nonlinear):
    g, params, t = _mini_pair()
    key = jax.random.PRNGKey(3)
    n, snr = 24, 12.0
    res_j = jb._one_snr_batch(key, params, jnp.float32(snr), n, 16, "awgn", nonlinear, 0.8,
                              g.apply, normalization, ji.quantize_weights_rtl(params), "rtl",
                              protocol)
    res_t = tb.snr_batch_from_draws(
        jax_snr_draws(key, n, 16, "awgn", protocol), snr, channel_type="awgn",
        nonlinear=nonlinear, pa_saturation=0.8, generator=t, normalization=normalization,
        int_params=ti.quantize_weights_rtl(t), int_mode="rtl", protocol=protocol)
    _check(res_t, res_j)


@pytest.mark.parametrize("channel", ["rayleigh", "rician", "multipath"])
def test_pilot_protocol_carries_the_channel_from_the_preamble(channel):
    """Under pilot the front end and the channel act on preamble ++ data:
    the phase noise's walk and the multipath convolution carry across."""
    key = jax.random.PRNGKey(5)
    n, snr, L = 16, 20.0, 32
    res_j = jb._one_snr_batch(key, None, jnp.float32(snr), n, L, channel, True, 0.8, None,
                              "independent", None, "rtl", "pilot")
    res_t = tb.snr_batch_from_draws(jax_snr_draws(key, n, L, channel, "pilot"), snr,
                                    channel_type=channel, nonlinear=True, pa_saturation=0.8,
                                    protocol="pilot")
    _check(res_t, res_j)


def test_full_quantized_row_through_gen_q():
    """GAN-Q through a quantization-simulated forward (``gen_q``), here the
    float generator standing in for it, at L = 64 under the oracle."""
    key = jax.random.PRNGKey(9)
    g, params, t = _mini_pair(1, residual=True)
    res_j = jb._one_snr_batch(key, params, jnp.float32(25.0), 8, 64, "awgn", False, 1.0,
                              g.apply, "independent", None, "rtl", "oracle", g.apply)
    res_t = tb.snr_batch_from_draws(jax_snr_draws(key, 8, 64), 25.0, generator=t, gen_q=t)
    _check(res_t, res_j)


def test_preamble_is_a_fixed_cpu_draw():
    a, b = tb.preamble_draws(16), tb.preamble_draws(16)
    assert all(torch.equal(a[k], b[k]) for k in ("pr", "pi"))
    gen = torch.Generator().manual_seed(0)
    draws = tb.make_snr_draws(gen, 4, 16, "multipath", "pilot")
    assert draws["nr"].shape == (4, 32) and draws["zr"].shape == (4, 16)
    assert draws["hr"].shape == (4, 3) and torch.equal(draws["pr"], a["pr"])


def test_run_benchmark_on_the_champion_matches_jax_statistically():
    """The committed nonlinear residual champion through both sweeps
    (independent draws): each method's mean MSE within four standard errors
    of the difference, per SNR."""
    params = load_params_tree(str(CHAMPION))
    g = JGen(input_residual=True)
    t = MiniGenerator(input_residual=True)
    t.load_state_dict(from_jax_params(params))
    snrs = [0.0, 30.0]
    kw = dict(n_trials=200, snr_values=snrs, nonlinear=True, pa_saturation=0.8)
    res_j = jb.run_benchmark(g.apply, params, include_quantized=True, int_mode="rtl_residual",
                             **kw)
    res_t = tb.run_benchmark(t, include_quantized=True, int_mode="rtl_residual",
                             device="cpu", **kw)
    assert list(res_t) == list(res_j)
    for m in res_j:
        for s in snrs:
            a, b = res_t[m][s], res_j[m][s]
            se = math.hypot(a["mse_std"], b["mse_std"]) / math.sqrt(kw["n_trials"])
            assert abs(a["mse"] - b["mse"]) <= 4 * se + 1e-12, (m, s, a, b)
    assert res_t["ZF"][0.0]["mse"] < 1e-4
