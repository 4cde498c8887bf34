"""The port's signal layer and config against the JAX package.

Every random number is drawn once, with the JAX package's own key splits,
and handed to both sides as numpy. Tolerance: float32 rounding of the FFT
and of the elementwise chains, atol 2e-6 on values of order one (OFDM
symbols of N subcarriers scale as N, and their atol with them); QAM bits
and symbols exactly.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdmgan_tpu import config as jconfig
from ofdmgan_tpu.signal import channel as jchannel
from ofdmgan_tpu.signal import datagen as jdatagen
from ofdmgan_tpu.signal import impairments as jimp
from ofdmgan_tpu.signal import ofdm as jofdm
from ofdmgan_tpu.signal import qam as jqam
from ofdmgan_tpu.signal.ofdm import ofdm_like_frame as j_ofdm_like_frame
from ofdmgan_tpu.utils import iq as jiq
from ofdmgan_tpu_torch import config as tconfig
from ofdmgan_tpu_torch.signal import channel as tchannel
from ofdmgan_tpu_torch.signal import datagen as tdatagen
from ofdmgan_tpu_torch.signal import impairments as timp
from ofdmgan_tpu_torch.signal import ofdm as tofdm
from ofdmgan_tpu_torch.signal import qam as tqam
from ofdmgan_tpu_torch.signal.ofdm import ofdm_like_frame as t_ofdm_like_frame
from ofdmgan_tpu_torch.utils import iq as tiq
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 2e-6
YAML = str(Path(__file__).resolve().parents[1] / "config" / "config.yaml")
RNG = np.random.default_rng(0)


def _complex(shape, rng=RNG):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=1e-5, atol=atol)


def test_iq_layout_and_joint_normalize():
    x = _complex((8, 16))
    _close(tiq.complex_to_iq(torch.from_numpy(x)), jiq.complex_to_iq(jnp.asarray(x)))
    a = RNG.standard_normal((8, 16, 2)).astype(np.float32)
    b = 3 * RNG.standard_normal((8, 16, 2)).astype(np.float32)
    for t, j in zip(tiq.joint_max_normalize(torch.from_numpy(a), torch.from_numpy(b)),
                    jiq.joint_max_normalize(jnp.asarray(a), jnp.asarray(b))):
        _close(t, j)


def test_iq_converters():
    a = RNG.standard_normal((3, 8, 16, 2)).astype(np.float32)
    np.testing.assert_array_equal(tiq.iq_to_complex(torch.from_numpy(a)).numpy(),
                                  np.asarray(jiq.iq_to_complex(jnp.asarray(a))))
    for t, j in ((tiq.nlc_to_ncl, jiq.nlc_to_ncl), (tiq.ncl_to_nlc, jiq.ncl_to_nlc)):
        np.testing.assert_array_equal(t(torch.from_numpy(a)).numpy(), np.asarray(j(jnp.asarray(a))))


def test_ofdm_like_frame():
    x = _complex((8, 16))
    _close(t_ofdm_like_frame(torch.from_numpy(x)), j_ofdm_like_frame(jnp.asarray(x)))


@pytest.mark.parametrize("sat", [0.8, 1.0])
def test_pa_rapp_and_iq_imbalance(sat):
    x = _complex((8, 16))
    _close(timp.pa_rapp(torch.from_numpy(x), sat, 3.0), jimp.pa_rapp(jnp.asarray(x), sat, 3.0))
    _close(timp.iq_imbalance(torch.from_numpy(x), 1.0, 5.0),
           jimp.iq_imbalance(jnp.asarray(x), 1.0, 5.0))


def test_phase_noise_from_the_jax_draws():
    x = _complex((8, 16))
    key = jax.random.PRNGKey(3)
    incr = np.array(jax.random.normal(key, x.shape, jnp.float32))
    _close(timp.phase_noise(torch.from_numpy(x), torch.from_numpy(incr)),
           jimp.phase_noise(key, jnp.asarray(x)))


def test_apply_all_default_chain():
    x = _complex((8, 16))
    key = jax.random.PRNGKey(4)
    cfg_j = jimp.ImpairmentConfig(pa_saturation=0.8)
    cfg_t = timp.ImpairmentConfig(pa_saturation=0.8)
    incr = np.array(jax.random.normal(key, x.shape, jnp.float32))
    _close(timp.apply_all(torch.from_numpy(x), cfg_t, torch.from_numpy(incr)),
           jimp.apply_all(key, jnp.asarray(x), cfg_j))


def test_awgn_from_the_jax_draws():
    x = _complex((8, 16))
    snr = RNG.uniform(0, 30, 8).astype(np.float32)
    key = jax.random.PRNGKey(5)
    kr, ki = jax.random.split(key)  # channel.py:42
    nr = np.array(jax.random.normal(kr, x.shape, jnp.float32))
    ni = np.array(jax.random.normal(ki, x.shape, jnp.float32))
    y_t, info_t = tchannel.awgn(torch.from_numpy(x), torch.from_numpy(snr),
                                torch.from_numpy(nr), torch.from_numpy(ni))
    y_j, info_j = jchannel.awgn(key, jnp.asarray(x), jnp.asarray(snr))
    _close(y_t, y_j)
    _close(info_t["noise_power"], info_j["noise_power"])


def jax_draws(key, batch_size, frame_length):
    """The draws of ``ofdmgan_tpu.signal.datagen.synthetic_batch`` rebuilt
    from its key splits (datagen.py:81-97, impairments.py:89, channel.py:42)."""
    k_sym, k_imp, k_snr, k_ch = jax.random.split(key, 4)
    kr, ki = jax.random.split(k_sym)
    kr2, ki2 = jax.random.split(k_ch)
    shape = (batch_size, frame_length)
    draws = {
        "zr": jax.random.normal(kr, shape, jnp.float32),
        "zi": jax.random.normal(ki, shape, jnp.float32),
        "pn": jax.random.normal(k_imp, shape, jnp.float32),
        "nr": jax.random.normal(kr2, shape, jnp.float32),
        "ni": jax.random.normal(ki2, shape, jnp.float32),
        "u": jax.random.uniform(k_snr, (batch_size,), jnp.float32),
    }
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


@pytest.mark.parametrize("nonlinear", [False, True])
def test_synthetic_batch_from_the_jax_draws(nonlinear):
    key = jax.random.PRNGKey(11)
    cfg_j = jdatagen.DatagenConfig.make(frame_length=16, nonlinear=nonlinear, pa_saturation=0.8)
    cfg_t = tdatagen.DatagenConfig(
        nonlinear=nonlinear, impairments=timp.ImpairmentConfig(pa_saturation=0.8))
    ref = jdatagen.synthetic_batch(key, 128, cfg_j)
    got = tdatagen.synthetic_batch_from_draws(jax_draws(key, 128, 16), cfg_t)
    for k in ("noisy", "clean", "snr"):
        _close(got[k], ref[k], atol=2e-6 if k != "snr" else 1e-5)


def test_synthetic_batch_statistics():
    gen = torch.Generator().manual_seed(0)
    out = tdatagen.synthetic_batch(gen, 4096, tdatagen.DatagenConfig())
    assert out["noisy"].shape == (4096, 16, 2) and out["snr"].shape == (4096,)
    assert float(out["noisy"].abs().max()) <= 1.0 + 1e-6
    assert abs(float(out["snr"].mean()) - 15.0) < 0.6  # std of the mean: 0.14


def test_config_defaults_are_the_yaml():
    assert tconfig.load_config(YAML) == tconfig.Config()


def test_config_matches_the_jax_helpers():
    raw = jconfig.load_config(YAML)
    cfg = tconfig.load_config(YAML)
    dj, dt = jconfig.datagen_config_from(raw, True, 0.8), tconfig.datagen_config_from(cfg, True, 0.8)
    assert (dj.frame_length, dj.snr_min, dj.snr_max, dj.channel.kind, dj.nonlinear) == \
        (dt.frame_length, dt.snr_min, dt.snr_max, dt.channel.kind, dt.nonlinear)
    assert dataclasses.asdict(dj.impairments) == dataclasses.asdict(dt.impairments)
    assert dataclasses.asdict(jconfig.loss_config_from(raw)) == \
        dataclasses.asdict(tconfig.loss_config_from(cfg))
    tp = jconfig.training_params_from(raw)
    tr = cfg.training
    assert (tp["batch_size"], tp["epochs"], tp["lr_generator"], tp["lr_discriminator"],
            tp["betas"], tp["scheduler_step"], tp["scheduler_gamma"]) == \
        (tr.batch_size, tr.epochs, tr.lr_generator, tr.lr_discriminator, tr.betas,
         tr.scheduler_step, tr.scheduler_gamma)


@pytest.mark.parametrize("mod", ["QPSK", "QAM16", "QAM64"])
def test_qam_is_bit_exact(mod):
    b = tqam.bits_per_symbol(mod)
    assert b == jqam.bits_per_symbol(mod)
    np.testing.assert_array_equal(tqam.constellation(mod), jqam.constellation(mod))
    bits = RNG.integers(0, 2, (4, 30 * b + 1)).astype(np.int32)   # one bit left over
    sym_t = tqam.modulate(torch.from_numpy(bits), mod)
    sym_j = jqam.modulate(jnp.asarray(bits), mod)
    np.testing.assert_array_equal(sym_t.numpy(), np.asarray(sym_j))
    np.testing.assert_array_equal(tqam.demodulate(sym_t, mod).numpy(), bits[:, :30 * b])
    noisy = np.asarray(sym_j) + 0.2 * _complex(sym_t.shape)
    np.testing.assert_array_equal(tqam.demodulate(torch.from_numpy(noisy), mod).numpy(),
                                  np.asarray(jqam.demodulate(jnp.asarray(noisy), mod)))


def test_unknown_modulation_raises():
    with pytest.raises(ValueError):
        tqam.bits_per_symbol("QAM256")


@pytest.mark.parametrize("n,cp,spacing", [(8, 2, 4), (64, 16, 8)])
def test_ofdm_codec(n, cp, spacing):
    spec_t, spec_j = tofdm.OFDMSpec(n, cp, spacing), jofdm.OFDMSpec(n, cp, spacing)
    assert spec_t.samples_per_symbol == spec_j.samples_per_symbol
    np.testing.assert_array_equal(spec_t.data_indices, spec_j.data_indices)
    np.testing.assert_array_equal(spec_t.pilot_indices, spec_j.pilot_indices)
    for a, b in zip(tofdm.dft_matrices(n), jofdm.dft_matrices(n)):
        np.testing.assert_array_equal(a, b)
    sym = _complex((2, 3 * spec_t.n_data_subcarriers - 1))   # pads the last symbol
    sig_t = tofdm.modulate(torch.from_numpy(sym), spec_t)
    sig_j = jofdm.modulate(jnp.asarray(sym), spec_j)
    _close(sig_t, sig_j, atol=2e-6 * n)
    rx = np.asarray(sig_j) + 0.1 * _complex(sig_t.shape)
    for t, j in zip(tofdm.demodulate(torch.from_numpy(rx), spec_t),
                    jofdm.demodulate(jnp.asarray(rx), spec_j)):
        _close(t, j)
    data, h = tofdm.demodulate(sig_t, spec_t)
    _close(data[:, :sym.shape[1]], sym)
    _close(h, np.ones(h.shape))


def test_partial_yaml_takes_the_references_defaults(tmp_path):
    """A file that names only some keys: every other one takes the
    reference's default (training_params_from and its siblings), not the
    full YAML's."""
    path = tmp_path / "partial.yaml"
    path.write_text("ofdm:\n  frame_length: 32\ntraining:\n  n_critic: 3\n"
                    "  optimizer:\n    lr_generator: 3.0e-4\n")
    raw = jconfig.load_config(str(path))
    cfg = tconfig.load_config(str(path))
    tp = jconfig.training_params_from(raw)
    tr = cfg.training
    assert (tp["epochs"], tp["batch_size"], tp["lr_generator"], tp["lr_discriminator"],
            tp["betas"], tp["scheduler_step"], tp["scheduler_gamma"],
            tp["checkpoint_interval"], tp["save_best"], tp["checkpoint_dir"], tp["log_dir"]) == \
        (tr.epochs, tr.batch_size, tr.lr_generator, tr.lr_discriminator, tr.betas,
         tr.scheduler_step, tr.scheduler_gamma, tr.checkpoint_interval, tr.save_best,
         cfg.checkpoint_dir, cfg.log_dir)
    assert (tr.epochs, tr.batch_size, tr.scheduler_step, tr.checkpoint_interval) == \
        (200, 32, 50, 10)
    assert dataclasses.asdict(jconfig.loss_config_from(raw)) == \
        dataclasses.asdict(tconfig.loss_config_from(cfg))
    dj, dt = jconfig.datagen_config_from(raw), tconfig.datagen_config_from(cfg)
    assert (dj.frame_length, dj.snr_min, dj.snr_max, dj.channel.kind) == \
        (dt.frame_length, dt.snr_min, dt.snr_max, dt.channel.kind)
    assert tconfig.config_from_dict({}).training == tconfig.MISSING_KEY_TRAINING
