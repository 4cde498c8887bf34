"""The port's fading channels, impairments and datagen coverage against the
JAX package.

Every random number is drawn once from the JAX package's own key splits
(channel.py:27-124, impairments.py:89, datagen.py:81-97) and handed to the
port as tensors, so the two compute the same function on the same numbers.
Tolerance: float32 rounding, rtol 1e-5 and atol 2e-6 on values of order
one (1e-5 on the SNR in dB), as in test_torch_signal.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdmgan_tpu.signal import channel as jchannel
from ofdmgan_tpu.signal import datagen as jdatagen
from ofdmgan_tpu.signal import impairments as jimp
from ofdmgan_tpu_torch.signal import channel as tchannel
from ofdmgan_tpu_torch.signal import datagen as tdatagen
from ofdmgan_tpu_torch.signal import impairments as timp
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RNG = np.random.default_rng(7)
KINDS = ("awgn", "rayleigh", "rician", "multipath", "none")


def _complex(shape):
    return (RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)).astype(np.complex64)


def _close(t, j, atol=2e-6):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=1e-5, atol=atol)


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_channel_draws(k_ch, cfg, frames, L):
    """The draws of ``ofdmgan_tpu.signal.channel.apply(k_ch, ...)`` for
    frames of batch shape ``frames`` and ``L`` samples, rebuilt from its key
    splits."""
    shape = frames + (L,)
    normal = lambda k, s: _t(jax.random.normal(k, s, jnp.float32))  # noqa: E731

    def noise(kn):
        kr, ki = jax.random.split(kn)
        return {"nr": normal(kr, shape), "ni": normal(ki, shape)}

    def cn01(kh, s):
        kr, ki = jax.random.split(kh)
        return {"hr": normal(kr, s), "hi": normal(ki, s)}

    if cfg.kind == "awgn":
        return noise(k_ch)
    if cfg.kind == "none":
        return {"nr": torch.zeros(shape), "ni": torch.zeros(shape)}
    if cfg.kind == "rician":
        kth, kh, kn = jax.random.split(k_ch, 3)
        theta = _t(jax.random.uniform(kth, frames, jnp.float32, 0.0, 2.0 * jnp.pi))
        return {"theta": theta, **cn01(kh, frames), **noise(kn)}
    kh, kn = jax.random.split(k_ch)
    taps = frames + (len(cfg.delays),) if cfg.kind == "multipath" else frames
    return {**cn01(kh, taps), **noise(kn)}


def jax_datagen_draws(key, batch_size, frame_length, channel):
    """The draws of ``ofdmgan_tpu.signal.datagen.synthetic_batch``."""
    k_sym, k_imp, k_snr, k_ch = jax.random.split(key, 4)
    kr, ki = jax.random.split(k_sym)
    shape = (batch_size, frame_length)
    draws = {
        "zr": _t(jax.random.normal(kr, shape, jnp.float32)),
        "zi": _t(jax.random.normal(ki, shape, jnp.float32)),
        "pn": _t(jax.random.normal(k_imp, shape, jnp.float32)),
        "u": _t(jax.random.uniform(k_snr, (batch_size,), jnp.float32)),
    }
    draws.update(jax_channel_draws(k_ch, channel, (batch_size,), frame_length))
    return draws


@pytest.mark.parametrize("kind", KINDS)
def test_channel_from_the_jax_draws(kind):
    x = _complex((8, 16))
    snr = RNG.uniform(0, 30, 8).astype(np.float32)
    key = jax.random.PRNGKey(21)
    cfg_j, cfg_t = jchannel.ChannelConfig(kind), tchannel.ChannelConfig(kind)
    y_j, info_j = jchannel.apply(key, jnp.asarray(x), jnp.asarray(snr), cfg_j)
    y_t, info_t = tchannel.apply(torch.from_numpy(x), torch.from_numpy(snr), cfg_t,
                                 jax_channel_draws(key, cfg_j, (8,), 16))
    _close(y_t, y_j)
    assert set(info_t) == set(info_j)
    for k in info_j:
        _close(info_t[k], info_j[k])


@pytest.mark.parametrize("kind", ["rician", "multipath"])
def test_channel_settings_from_the_jax_draws(kind):
    """A K factor and a tap profile other than the defaults."""
    x = _complex((4, 2, 32))
    snr = RNG.uniform(0, 30, (4, 2)).astype(np.float32)
    key = jax.random.PRNGKey(22)
    kw = dict(k_factor=10.0) if kind == "rician" else dict(delays=(0, 2, 5), powers=(1.0, 0.3, 0.1))
    cfg_j, cfg_t = jchannel.ChannelConfig(kind, **kw), tchannel.ChannelConfig(kind, **kw)
    y_j, _ = jchannel.apply(key, jnp.asarray(x), jnp.asarray(snr), cfg_j)
    y_t, _ = tchannel.apply(torch.from_numpy(x), torch.from_numpy(snr), cfg_t,
                            jax_channel_draws(key, cfg_j, (4, 2), 32))
    _close(y_t, y_j)


@pytest.mark.parametrize("taps,L", [(1, 16), (2, 16), (3, 16), (4, 16), (6, 4), (3, 2)])
def test_convolve_same_is_numpys(taps, L):
    """``numpy.convolve(mode="same")``, which ``jnp.convolve`` follows: a
    true convolution, the centre max(L, K) samples of the full one."""
    x, h = _complex((3, L)), _complex((3, taps))
    got = tchannel.convolve_same(torch.from_numpy(x), torch.from_numpy(h)).numpy()
    ref = np.stack([np.convolve(a, b, mode="same") for a, b in zip(x, h)])
    _close(got, ref)


def test_multipath_tap_zero_leads_by_one_sample():
    x = torch.zeros(1, 8, dtype=torch.complex64)
    x[0, 4] = 1.0
    h = torch.tensor([[1.0, 0.0, 0.0]], dtype=torch.complex64)
    y = tchannel.convolve_same(x, h)
    assert int(y.abs().argmax()) == 3


def test_unknown_channel_raises():
    x = torch.zeros(2, 16, dtype=torch.complex64)
    with pytest.raises(ValueError):
        tchannel.apply(x, torch.zeros(2), tchannel.ChannelConfig("awgn2"),
                       {"nr": x.real, "ni": x.real})


@pytest.mark.parametrize("nonlinear", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_synthetic_batch_from_the_jax_draws(kind, nonlinear):
    key = jax.random.PRNGKey(31)
    cfg_j = jdatagen.DatagenConfig.make(frame_length=16, channel_type=kind,
                                        nonlinear=nonlinear, pa_saturation=0.8)
    cfg_t = tdatagen.DatagenConfig.make(frame_length=16, channel_type=kind,
                                        nonlinear=nonlinear, pa_saturation=0.8)
    ref = jdatagen.synthetic_batch(key, 64, cfg_j)
    got = tdatagen.synthetic_batch_from_draws(jax_datagen_draws(key, 64, 16, cfg_j.channel),
                                              cfg_t)
    for k in ("noisy", "clean", "snr"):
        _close(got[k], ref[k], atol=2e-6 if k != "snr" else 1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_make_draws_gives_each_channel_its_draws(kind):
    cfg = tdatagen.DatagenConfig.make(frame_length=16, channel_type=kind)
    gen = torch.Generator().manual_seed(3)
    draws = tdatagen.make_draws(gen, 8, 16, cfg.channel)
    assert set(draws) == {"zr", "zi", "pn", "nr", "ni", "u"} | set(
        tchannel.draw_shapes(cfg.channel, (8,)))
    if kind == "rician":
        assert float(draws["theta"].min()) >= 0 and float(draws["theta"].max()) < 2 * np.pi
    out = tdatagen.synthetic_batch(torch.Generator().manual_seed(3), 8, cfg)
    assert out["noisy"].shape == (8, 16, 2) and bool(torch.isfinite(out["noisy"]).all())
    # the AWGN layout comes first, so an AWGN batch's draws are unchanged
    base = tdatagen.make_draws(torch.Generator().manual_seed(3), 8, 16)
    for k, v in base.items():
        assert torch.equal(draws[k], v)


@pytest.mark.parametrize("kind", ["awgn", "rayleigh"])
def test_batch_at_snr_from_the_jax_draws(kind):
    key = jax.random.PRNGKey(41)
    cfg_j = jdatagen.DatagenConfig.make(frame_length=16, channel_type=kind, nonlinear=True)
    cfg_t = tdatagen.DatagenConfig.make(frame_length=16, channel_type=kind, nonlinear=True)
    ref = jdatagen.test_batch_at_snr(key, 32, 12.5, cfg_j)
    got = tdatagen.test_batch_at_snr_from_draws(jax_datagen_draws(key, 32, 16, cfg_j.channel),
                                                12.5, cfg_t)
    for k in ("noisy", "clean", "snr"):
        _close(got[k], ref[k])
    assert bool((got["snr"] == 12.5).all())
    out = tdatagen.test_batch_at_snr(torch.Generator().manual_seed(0), 8, 5.0, cfg_t)
    assert out["noisy"].shape == (8, 16, 2) and bool((out["snr"] == 5.0).all())


def test_datagen_config_make_is_the_jax_one():
    kw = dict(frame_length=32, snr_range=(5, 25), channel_type="rician", nonlinear=True,
              pa_saturation=0.7, iq_imbalance_db=0.5, iq_phase_deg=3.0, phase_noise_dbchz=-70.0)
    j, t = jdatagen.DatagenConfig.make(**kw), tdatagen.DatagenConfig.make(**kw)
    assert (j.frame_length, j.snr_min, j.snr_max, j.nonlinear) == \
        (t.frame_length, t.snr_min, t.snr_max, t.nonlinear)
    assert (j.channel.kind, j.channel.k_factor, j.channel.delays, j.channel.powers) == \
        (t.channel.kind, t.channel.k_factor, t.channel.delays, t.channel.powers)
    assert dataclasses.asdict(j.impairments) == dataclasses.asdict(t.impairments)


# ---------------------------------------------------------------- impairments


@pytest.mark.parametrize("scale", [0.3, 1.0, 3.0])
def test_pa_saleh(scale):
    x = scale * _complex((8, 16))
    x[0, 0] = 0  # angle(0) is 0 in both
    _close(timp.pa_saleh(torch.from_numpy(x)), jimp.pa_saleh(jnp.asarray(x)))
    assert float(timp.pa_saleh(torch.zeros(1, dtype=torch.complex64)).abs()) == 0.0


def test_dc_offset_and_cfo():
    x = _complex((8, 16))
    _close(timp.dc_offset(torch.from_numpy(x), 0.02, -0.01),
           jimp.dc_offset(jnp.asarray(x), 0.02, -0.01))
    for hz, fs in ((100.0, 1e6), (2.5e4, 1e6)):
        _close(timp.cfo(torch.from_numpy(x), hz, fs), jimp.cfo(jnp.asarray(x), hz, fs))


@pytest.mark.parametrize("pa_model", ["rapp", "saleh"])
def test_apply_all_every_stage(pa_model):
    """PA -> IQ -> PN -> DC -> CFO, every stage on."""
    x = _complex((8, 16))
    key = jax.random.PRNGKey(5)
    kw = dict(pa_model=pa_model, pa_saturation=0.8, dc_enabled=True, cfo_enabled=True,
              cfo_hz=1e3)
    incr = _t(jax.random.normal(key, x.shape, jnp.float32))
    _close(timp.apply_all(torch.from_numpy(x), timp.ImpairmentConfig(**kw), incr),
           jimp.apply_all(key, jnp.asarray(x), jimp.ImpairmentConfig(**kw)))


def test_unknown_pa_model_raises():
    with pytest.raises(ValueError):
        timp.apply_all(torch.zeros(2, 16, dtype=torch.complex64),
                       timp.ImpairmentConfig(pa_model="tube"), torch.zeros(2, 16))
