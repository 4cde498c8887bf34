"""The port's ``viz/`` against the JAX package's.

* ``OFDMSignalGenerator``: the same numpy draws in the same order, so the
  arrays are equal for a seed, and the cosim report's scenarios (now taken
  from ``signal_viz``) are the JAX report's byte for byte.
* The research scenario rows: float MSEs within 1e-6 (one float32 forward
  of the same weights), the integer datapath's MSE equal.
* ``ImageOFDMSimulator`` on the JAX channel's own draws (rebuilt from its
  key splits, ``tests/test_torch_channels.py``): the reconstructed images
  equal and PSNR/SSIM/NMSE/BER within rtol 1e-5, with and without a mini
  generator over the received signal; the cross-section metrics as well.
* The ``.dot`` sources identical; the figures drawn on the CPU.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ofdmgan_tpu.models import MiniGenerator as JGen
from ofdmgan_tpu.signal import channel as jchannel
from ofdmgan_tpu.verify import cosim_report as jcr
from ofdmgan_tpu.viz import diagrams as jdiagrams
from ofdmgan_tpu.viz import image_transmission as jimg
from ofdmgan_tpu.viz import signal_viz as jsv
from ofdmgan_tpu_torch.models import MiniGenerator
from ofdmgan_tpu_torch.utils.jax_params import from_jax_params
from ofdmgan_tpu_torch.verify import cosim_report
from ofdmgan_tpu_torch.viz import diagrams, image_transmission, signal_viz
from test_torch_channels import jax_channel_draws
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def mini():
    params = JGen().init(jax.random.PRNGKey(5), np.zeros((1, 16, 2), np.float32))
    gen = MiniGenerator()
    gen.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    return params, gen.eval()


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_the_signal_generator_draws_the_jax_arrays(seed):
    gj, gt = jsv.OFDMSignalGenerator(seed=seed), signal_viz.OFDMSignalGenerator(seed=seed)
    cj, ct = gj.clean_frame(), gt.clean_frame()
    pairs = [(cj, ct)]
    for fn in ("add_awgn", "add_deep_fade", "add_burst_interference",
               "add_frequency_selective_fade"):
        pairs.append((getattr(gj, fn)(cj), getattr(gt, fn)(ct)))
    for sj, st in pairs:
        assert (sj.name, sj.description) == (st.name, st.description)
        np.testing.assert_array_equal(st.i, sj.i)
        np.testing.assert_array_equal(st.q, sj.q)
        assert st.power_db == sj.power_db


def test_the_cosim_report_keeps_its_scenarios():
    got, want = cosim_report._ofdm_scenarios(), jcr._ofdm_scenarios()
    assert list(got) == list(want)
    for k in want:
        for part in ("degraded", "clean"):
            assert got[k][part].dtype == np.float32
            np.testing.assert_array_equal(got[k][part], want[k][part])


def test_scenario_rows_match_the_jax_rows(mini, tmp_path):
    params, gen = mini
    want = jsv.create_research_quality_figures(params, str(tmp_path / "jax"), seed=2)
    clean, scenarios = signal_viz.research_scenarios(seed=2)
    got = signal_viz.scenario_rows(gen, clean, scenarios)
    assert [r["scenario"] for r in got] == [r["scenario"] for r in want["scenarios"]]
    for g, w in zip(got, want["scenarios"]):
        assert g["description"] == w["description"]
        assert g["mse_enhanced_int"] == w["mse_enhanced_int"]
        for k in ("mse_degraded", "mse_enhanced_float", "snr_degraded_db"):
            assert g[k] == pytest.approx(w[k], rel=1e-6, abs=1e-6), k


def test_research_figures_are_drawn(mini, tmp_path):
    out = signal_viz.create_research_quality_figures(mini[1], str(tmp_path), seed=2)
    assert len(out["scenarios"]) == 5
    for name in ("time_domain.png", "constellation.png", "psd.png", "spectrogram.png",
                 "scenario_results.json"):
        assert (tmp_path / name).stat().st_size > 0


def _jax_sim_draws(kind, seed, n):
    return jax_channel_draws(jax.random.PRNGKey(seed), jchannel.ChannelConfig(kind), (), n)


@pytest.mark.parametrize("kind", ["awgn", "rayleigh", "rician"])
@pytest.mark.parametrize("with_gan", [False, True])
def test_image_simulator_on_the_jax_draws(mini, kind, with_gan):
    params, gen = mini
    img = image_transmission.builtin_test_image()
    np.testing.assert_array_equal(img, jimg._test_image())
    snrs, seed = [0.0, 10.0, 20.0], 4
    jsim = jimg.ImageOFDMSimulator(channel_type=kind, gen_apply=JGen().apply if with_gan
                                   else None, gen_params=params if with_gan else None)
    want = jsim.evaluate(img, snrs, seed)
    tsim = image_transmission.ImageOFDMSimulator(channel_type=kind,
                                                 generator=gen if with_gan else None)
    draws = [_jax_sim_draws(kind, seed + i, 1024) for i in range(len(snrs))]
    got = tsim.evaluate_from_draws(img, snrs, draws)
    for g, w in zip(got, want):
        g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        assert (g["snr_db"], g["channel"]) == (w["snr_db"], w["channel"])
        assert g["ber"] == w["ber"]
        for k in ("psnr_db", "ssim", "nmse", "enhanced_psnr_db", "enhanced_ssim"):
            if w[k] is None:
                assert g[k] is None
            else:
                assert g[k] == pytest.approx(w[k], rel=1e-5, abs=1e-6), k
    recon_t, _, _ = tsim.transmit_from_draws(img, 10.0, draws[1], enhance=with_gan)
    recon_j, _, _ = jsim.transmit(img, 10.0, seed + 1, enhance=with_gan)
    np.testing.assert_array_equal(recon_t, recon_j)


def test_cross_pipeline_metrics_match_the_jax_figure(mini, tmp_path):
    params, gen = mini
    want = jimg.create_full_pipeline_cross_figure(str(tmp_path / "j.png"), JGen().apply, params,
                                                  snr_db=10.0, channel_type="rayleigh", seed=1)
    got = image_transmission.cross_pipeline_metrics(
        gen, snr_db=10.0, channel_type="rayleigh", draws=_jax_sim_draws("rayleigh", 1, 64))
    assert set(got["metrics"]) == set(want)
    for k, v in want.items():
        assert got["metrics"][k] == pytest.approx(v, rel=1e-5, abs=1e-6), k


def test_transmission_figures_are_drawn(mini, tmp_path):
    m = image_transmission.create_full_pipeline_cross_figure(str(tmp_path / "cross.png"),
                                                             mini[1], seed=1)
    assert np.isfinite(list(m.values())).all() and (tmp_path / "cross.png").stat().st_size
    rows = image_transmission.generate_transmission_figures(str(tmp_path / "t"), mini[1],
                                                            snr_values=(5.0, 15.0))
    assert set(rows) == {"awgn", "rayleigh", "rician"}
    assert all(len(v) == 2 and v[0]["enhanced_psnr_db"] is not None for v in rows.values())
    for name in ("metrics_vs_snr.png", "transmission_pipeline.png", "constellation_heatmap.png",
                 "simplegan_patterns.png", "transmission_metrics.json"):
        assert (tmp_path / "t" / name).stat().st_size > 0


def test_the_patterns_and_a_seeded_transmission():
    for k, v in jimg.patterns_3x3().items():
        np.testing.assert_array_equal(image_transmission.patterns_3x3()[k], v)
    sim = image_transmission.ImageOFDMSimulator(channel_type="rician")
    a = sim.transmit(image_transmission.builtin_test_image(), 15.0, seed=3)
    b = sim.transmit(image_transmission.builtin_test_image(), 15.0, seed=3)
    np.testing.assert_array_equal(a[1], b[1])
    assert a[1].shape == (1024, 2) and torch.isfinite(torch.from_numpy(a[1])).all()


def test_dot_sources_are_the_jax_packages(tmp_path):
    want = {name: fn() for name, fn in jdiagrams._DIAGRAMS.items()}
    assert diagrams.dot_sources() == want
    written = diagrams.generate_all_diagrams(str(tmp_path))
    assert len(written) == 2 * len(want)
    for name, dot in want.items():
        assert (tmp_path / f"{name}.dot").read_text() == dot + "\n"
        assert (tmp_path / f"{name}.png").stat().st_size > 0
