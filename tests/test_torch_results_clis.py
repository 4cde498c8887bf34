"""The two CLIs over the committed champions, ``cross_channel_matrix`` and
``distributional_figure``, on the CPU.

Their arithmetic against the JAX package's on the JAX datagen's own draws
(rebuilt from its key splits, ``tests/test_torch_channels.py``): the mean
L1 of the identity and of the committed AWGN residual champion on each
channel within rtol 1e-5, and the periodogram and amplitude density of the
figure within float32 rounding (rtol 1e-5, atol 1e-4 dB). Then each CLI at
a tiny size: a champion kept only as an Orbax directory is skipped, the
rest written.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ofdmgan_tpu.eval.distributional import periodogram_db as j_periodogram_db
from ofdmgan_tpu.models import MiniGenerator as JGen
from ofdmgan_tpu.signal import DatagenConfig as JDatagenConfig
from ofdmgan_tpu.signal import synthetic_batch as j_synthetic_batch
from ofdmgan_tpu.utils.params_io import load_params_tree as j_load
from ofdmgan_tpu_torch import cross_channel_matrix, distributional_figure
from ofdmgan_tpu_torch.signal.datagen import DatagenConfig, synthetic_batch_from_draws
from test_torch_channels import jax_datagen_draws
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
AWGN_LINEAR = "results/residual_checkpoints/linear/champion_params_g.npz"


def _batches(channel, nonlinear, n=3, b=64):
    """``n`` batches from JAX's datagen and the port's from the same draws."""
    jdg = JDatagenConfig.make(frame_length=16, snr_range=(0, 30), channel_type=channel,
                              nonlinear=nonlinear, pa_saturation=0.8)
    tdg = DatagenConfig.make(frame_length=16, snr_range=(0, 30), channel_type=channel,
                             nonlinear=nonlinear, pa_saturation=0.8)
    keys = jax.random.split(jax.random.PRNGKey(1234), n)
    jb = [j_synthetic_batch(k, b, jdg) for k in keys]
    tb = [synthetic_batch_from_draws(jax_datagen_draws(k, b, 16, jdg.channel), tdg)
          for k in keys]
    return jb, tb


@pytest.mark.parametrize("channel", cross_channel_matrix.CHANNELS)
def test_the_sweep_is_the_jax_sweep(channel):
    jb, tb = _batches(channel, False)
    params = j_load(str(REPO / AWGN_LINEAR))
    jgen = JGen(input_residual=True)
    gen = cross_channel_matrix.load_generator(REPO / AWGN_LINEAR, "cpu")
    for apply, japply in ((lambda x: x, lambda x: x),
                          (gen, lambda x: jgen.apply(params, x))):
        l1s = np.array([np.mean(np.abs(np.asarray(japply(b["noisy"])) - np.asarray(b["clean"])))
                        for b in jb])
        mean, sem = cross_channel_matrix.sweep(apply, tb)
        assert mean == pytest.approx(l1s.mean(), rel=1e-5)
        assert sem == pytest.approx(l1s.std() / np.sqrt(len(l1s)), rel=1e-3, abs=1e-7)


def test_the_figure_curves_are_the_jax_curves():
    jb, tb = _batches("awgn", True, n=1, b=256)
    got = distributional_figure.curves({"noisy": tb[0]["noisy"], "clean": tb[0]["clean"]})
    for label in ("noisy", "clean"):
        x = jb[0][label]
        np.testing.assert_allclose(got[label]["psd_db"], np.asarray(j_periodogram_db(x)),
                                   rtol=1e-5, atol=1e-4)
        hist, _ = np.histogram(np.abs(np.asarray(x)).ravel(), bins=np.linspace(0, 1.0, 80),
                               density=True)
        np.testing.assert_allclose(got[label]["amplitude_density"], hist, rtol=1e-5, atol=1e-4)


def test_cross_channel_matrix_cli(tmp_path, capsys):
    out = tmp_path / "m.json"
    res = cross_channel_matrix.main(["--device", "cpu", "--batches", "2", "--batch_size", "32",
                                     "--root", str(REPO), "--out", str(out)])
    text = capsys.readouterr().out
    assert "skip" in text and "rayleigh_checkpoint" in text   # an Orbax directory
    saved = json.loads(out.read_text())
    assert set(saved["linear"]) == set(cross_channel_matrix.CHANNELS)
    assert set(saved["nonlinear"]) == {"awgn", "multipath"}
    for tag in ("linear", "nonlinear"):
        for col in res[tag].values():
            assert {"identity", "trained_awgn"} <= set(col)
            assert all(np.isfinite(v).all() for v in col.values())


def test_distributional_figure_cli(tmp_path):
    out = tmp_path / "f.png"
    c = distributional_figure.main(["--device", "cpu", "--frames", "128", "--root", str(REPO),
                                    "--out", str(out)])
    assert {"clean", "noisy", "residual GAN"} <= set(c)
    assert out.stat().st_size > 0
    assert all(torch.isfinite(torch.from_numpy(v["psd_db"])).all() for v in c.values())
