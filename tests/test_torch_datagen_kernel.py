"""The datagen kernel's plain version against the Pallas TPU kernel.

Under ``pltpu.force_tpu_interpret_mode()`` the TPU kernel's hardware-PRNG
stub returns zero bits (tests/test_pallas_datagen.py:4), so every uniform
it draws is 0.5 * 2^-23 and every normal is Box-Muller of two such
uniforms. The plain version gets those same numbers as injected draws, which
pins the IDFT, Rapp PA, IQ imbalance, phase noise, power, SNR, noise and
normalisation exactly. Tolerance: rtol 1e-5, atol 1e-6 (float32 rounding
of the matmul IDFT against the direct sum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ofdmgan_tpu.ops.pallas_datagen import synthetic_batch_pallas
from ofdmgan_tpu_torch.ops import datagen_kernel as dk
from ofdmgan_tpu_torch.signal.channel import ChannelConfig
from ofdmgan_tpu_torch.signal.datagen import DatagenConfig, make_draws
from ofdmgan_tpu_torch.signal.impairments import ImpairmentConfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def interpreter_draws(batch_size, frame_length):
    """The draws the interpreted TPU kernel makes: zero bits everywhere."""
    u = jnp.float32(0.5 / (1 << 23))
    r = jnp.sqrt(-2.0 * jnp.log(u))
    a = jnp.float32(6.283185307179586) * u
    n1, n2 = float(r * jnp.cos(a)), float(r * jnp.sin(a))
    shape = (batch_size, frame_length)
    full = lambda v, s=shape: torch.full(s, v, dtype=torch.float32)  # noqa: E731
    return {"zr": full(n1), "zi": full(n2), "pn": full(n1), "nr": full(n1), "ni": full(n2),
            "u": full(float(u), (batch_size,))}


@pytest.mark.parametrize("nonlinear", [False, True])
def test_plain_version_matches_the_interpreted_tpu_kernel(nonlinear):
    b, sat = 256, 0.8
    with pltpu.force_tpu_interpret_mode():
        ref = synthetic_batch_pallas(jax.random.PRNGKey(0), b, 0.0, 30.0, 16,
                                     nonlinear=nonlinear, pa_saturation=sat, tile_rows=32)
    cfg = DatagenConfig(nonlinear=nonlinear, impairments=ImpairmentConfig(pa_saturation=sat))
    got = dk.synthetic_batch_plain(interpreter_draws(b, 16), cfg)
    for k in ("noisy", "clean", "snr"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_plain_version_statistics_from_its_own_generator():
    gen = torch.Generator().manual_seed(0)
    b = 16384
    out = dk.synthetic_batch(gen, b, DatagenConfig())
    snr, scale = out["snr"], out["scale"]
    p_clean = (out["clean"] ** 2).sum((1, 2)) / 16
    p_noise = ((out["noisy"] - out["clean"]) ** 2).sum((1, 2)) / 16
    assert float(snr.min()) >= 0.0 and float(snr.max()) <= 30.0
    assert abs(float(snr.mean()) - 15.0) < 0.3            # std of the mean 0.07
    assert abs(float((p_clean * scale ** 2).mean()) - 1.0) < 0.02   # std 0.002
    ratio = (p_noise / p_clean / 10 ** (-snr / 10)).mean()
    assert abs(float(ratio) - 1.0) < 0.02                   # std 0.002
    assert float(out["noisy"].abs().max()) <= 1.0 + 1e-6


def test_cpu_wrapper_takes_the_plain_version():
    gen = torch.Generator().manual_seed(1)
    draws = make_draws(gen, 32, 16)
    cfg = DatagenConfig(nonlinear=True)
    before = dk.launches
    got = dk.synthetic_batch_from_draws(draws, cfg)
    ref = dk.synthetic_batch_plain(draws, cfg)
    assert dk.launches == before
    for k in ref:
        assert torch.equal(got[k], ref[k])


@pytest.mark.parametrize("cfg", [
    DatagenConfig(channel=ChannelConfig("rayleigh")),
    DatagenConfig(nonlinear=True, impairments=ImpairmentConfig(pa_model="saleh")),
    DatagenConfig(nonlinear=True, impairments=ImpairmentConfig(dc_enabled=True)),
    DatagenConfig(frame_length=12),
])
def test_unsupported_configs_raise(cfg):
    with pytest.raises(ValueError):
        dk.check_config(cfg)
