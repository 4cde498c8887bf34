"""The port's distributional metrics against the JAX package's.

The report's batches are rebuilt from JAX's own key splits
(``ofdmgan_tpu/eval/distributional.py:108-111``: one key per batch, and the
null floor's from ``fold_in(key, 777)``) and injected into the port's
report. Tolerances: periodograms and their distance atol 1e-4 dB, moments
rtol 1e-5 and atol 1e-6, the bandwidth rtol 1e-5 (the median of an even
count averages the two middle values, as ``jnp.median``; ``torch.median``
would take the lower), MMD^2 rtol 1e-3 and atol 1e-6 (float32 kernel sums
over m^2 pairs in another order), the paired L1 rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdmgan_tpu.eval import distributional as jd
from ofdmgan_tpu.models import MiniGenerator as JGen
from ofdmgan_tpu.signal.channel import ChannelConfig
from ofdmgan_tpu.signal.datagen import DatagenConfig as JCfg
from ofdmgan_tpu_torch.eval import distributional as td
from ofdmgan_tpu_torch.models import MiniGenerator
from ofdmgan_tpu_torch.signal.datagen import DatagenConfig
from ofdmgan_tpu_torch.utils.jax_params import from_jax_params
from test_torch_channels import jax_datagen_draws
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RNG = np.random.default_rng(5)


def _frames(shape, scale=1.0):
    return (scale * RNG.standard_normal(shape)).astype(np.float32)


def test_pointwise_statistics_match_jax():
    x, y = _frames((64, 16, 2)), _frames((64, 16, 2), 0.5)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(td.periodogram_db(tx).numpy(), np.asarray(jd.periodogram_db(x)),
                               atol=1e-4)
    np.testing.assert_allclose(float(td.psd_distance_db(tx, ty)),
                               float(jd.psd_distance_db(x, y)), atol=1e-4)
    assert float(td.psd_distance_db(tx, tx)) == 0.0
    np.testing.assert_allclose(td.amplitude_moments(tx).numpy(),
                               np.asarray(jd.amplitude_moments(x)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m", [63, 64])   # odd and even pair counts: 1953 and 2016
def test_bandwidth_and_mmd_match_jax(m):
    x, y, z = _frames((m, 32)), _frames((m, 32)), _frames((m, 32), 0.3)
    bw_j = jd.median_bandwidth(jnp.asarray(x))
    bw_t = td.median_bandwidth(torch.from_numpy(x))
    np.testing.assert_allclose(float(bw_t), float(bw_j), rtol=1e-5)
    for other in (y, z):
        np.testing.assert_allclose(
            float(td.mmd2_unbiased(torch.from_numpy(x), torch.from_numpy(other), bw_t)),
            float(jd.mmd2_unbiased(jnp.asarray(x), jnp.asarray(other), bw_j)),
            rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("with_gan,nonlinear,channel", [(False, False, "awgn"),
                                                        (True, True, "awgn"),
                                                        (True, False, "rayleigh")])
def test_report_matches_jax_on_its_draws(with_gan, nonlinear, channel):
    b, n_batches, mmd_samples = 64, 5, 200
    cfg_j = JCfg.make(frame_length=16, snr_range=(0, 30), nonlinear=nonlinear,
                      channel_type=channel, pa_saturation=0.8)
    cfg_t = DatagenConfig.make(frame_length=16, snr_range=(0, 30), nonlinear=nonlinear,
                               channel_type=channel, pa_saturation=0.8)
    g = JGen()
    params = jax.device_get(g.init(jax.random.PRNGKey(2), jnp.zeros((1, 16, 2))))
    t = MiniGenerator()
    t.load_state_dict(from_jax_params(params))
    key = jax.random.PRNGKey(7)
    ref = jax.device_get(jd.make_report_fn(g.apply if with_gan else (lambda p, x: x), cfg_j,
                                           b, n_batches, mmd_samples)(params, key))
    keys = jax.random.split(key, n_batches)
    null_keys = jax.random.split(jax.random.fold_in(key, 777), n_batches)
    ch = ChannelConfig(channel)

    def draw(i):
        return (jax_datagen_draws(keys[i], b, 16, ch), jax_datagen_draws(null_keys[i], b, 16, ch))

    got = td.make_report_fn(t if with_gan else (lambda x: x), cfg_t, b, n_batches,
                            mmd_samples)(draw)
    assert set(got) == set(ref)
    np.testing.assert_allclose(float(got["psd_distance_db"]), float(ref["psd_distance_db"]),
                               atol=1e-4)
    for k in ("moments_est", "moments_clean"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-6)
    for k, rtol, atol in (("bandwidth", 1e-5, 0), ("paired_l1", 1e-5, 0),
                          ("mmd2", 1e-3, 1e-6), ("mmd2_null", 1e-3, 1e-6)):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=rtol, atol=atol, err_msg=k)


def test_report_separates_noisy_from_clean():
    cfg = DatagenConfig.make(frame_length=16, snr_range=(0, 10))
    draw = td.seeded_draws(0, 128, cfg, torch.device("cpu"))
    r = td.make_report_fn(lambda x: x, cfg, 128, 8, 512)(draw)
    assert float(r["mmd2"]) > 5 * max(abs(float(r["mmd2_null"])), 1e-6)
    assert float(r["paired_l1"]) > 0.05
