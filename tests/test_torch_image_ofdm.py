"""The port's image <-> OFDM conversion and image datasets against the JAX
package, on small PNGs that each test writes.

Tolerance: float32 rounding of the IFFT and of the channel, rtol 1e-5 and
atol 2e-6 on max-normalised frames; pixels and bits exactly. Each dataset's
``sample_batch`` is held against the JAX one through its from-draws twin,
with the draws rebuilt from the JAX key splits (image_ofdm.py:216-225,
:251-260).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ofdmgan_tpu.signal import channel as jchannel
from ofdmgan_tpu.signal import image_ofdm as jimg
from ofdmgan_tpu_torch.config import Config, TrainingSection
from ofdmgan_tpu_torch.signal import image_ofdm as timg
from ofdmgan_tpu_torch.training.trainer import Trainer
from test_torch_channels import jax_channel_draws
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _close(t, j):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=1e-5, atol=2e-6)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """Three grayscale PNGs, an RGB one and one past 4096 pixels (resized)."""
    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    for i, shape in enumerate([(8, 8), (6, 10), (12, 12)]):
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(d / f"g{i}.png")
    Image.fromarray(rng.integers(0, 256, (9, 7, 3), dtype=np.uint8)).save(d / "rgb.png")
    Image.fromarray(rng.integers(0, 256, (70, 70), dtype=np.uint8)).save(d / "big.PNG")
    return d


def test_load_image_is_the_jax_packages(image_dir):
    for p in sorted(image_dir.iterdir()):
        np.testing.assert_array_equal(timg.load_image(str(p)), jimg.load_image(str(p)))
    assert timg.load_image(str(image_dir / "big.PNG")).shape == (64, 64)
    rgb = np.random.default_rng(1).integers(0, 256, (5, 4, 3), dtype=np.uint8)
    np.testing.assert_array_equal(timg.to_grayscale(rgb), jimg.to_grayscale(rgb))


@pytest.mark.parametrize("cfg", [
    dict(modulation="QPSK", n_subcarriers=8, cp_length=2, frame_length=16),
    dict(modulation="QAM16", n_subcarriers=64, cp_length=16, frame_length=1024),
    dict(modulation="QAM64", n_subcarriers=16, cp_length=4, frame_length=64),
])
@pytest.mark.parametrize("truncate", [True, False])
def test_image_to_ofdm_and_back(image_dir, cfg, truncate):
    img = timg.load_image(str(image_dir / "g1.png"))
    ct, cj = timg.ImageOFDMConfig(**cfg), jimg.ImageOFDMConfig(**cfg)
    iq_t, meta_t = timg.image_to_ofdm(img, ct, truncate=truncate)
    iq_j, meta_j = jimg.image_to_ofdm(img, cj, truncate=truncate)
    assert iq_t.dtype == np.float32 and iq_t.shape == iq_j.shape
    _close(iq_t, iq_j)
    assert {k: v for k, v in meta_t.items() if k != "normalization_factor"} == \
        {k: v for k, v in meta_j.items() if k != "normalization_factor"}
    np.testing.assert_allclose(meta_t["normalization_factor"], meta_j["normalization_factor"],
                               rtol=1e-5)
    noisy = iq_j + 0.02 * np.random.default_rng(2).standard_normal(iq_j.shape).astype(np.float32)
    back_t = timg.ofdm_to_image(noisy, img.shape, ct, meta_j["normalization_factor"])
    back_j = jimg.ofdm_to_image(noisy, img.shape, cj, meta_j["normalization_factor"])
    np.testing.assert_array_equal(back_t, back_j)
    if not truncate:   # the whole signal: the image comes back exactly
        np.testing.assert_array_equal(
            timg.ofdm_to_image(iq_t, img.shape, ct, meta_t["normalization_factor"]), img)


def _jax_image_draws(key, n, n_img, channel, L):
    k_img, k_snr, k_ch = jax.random.split(key, 3)
    return {"idx": torch.from_numpy(np.array(jax.random.randint(k_img, (n,), 0, n_img))),
            "u": torch.from_numpy(np.array(jax.random.uniform(k_snr, (n,), jnp.float32))),
            **jax_channel_draws(k_ch, channel, (n,), L)}


@pytest.mark.parametrize("kind", ["awgn", "rayleigh", "multipath"])
def test_image_dataset_sample_batch(image_dir, kind):
    kw = dict(frame_length=16, snr_range=(0, 30), channel_type=kind, samples_per_image=4)
    ds_t = timg.ImageOFDMDataset(str(image_dir), **kw)
    ds_j = jimg.ImageOFDMDataset(str(image_dir), **kw)
    assert [p.name for p in ds_t.image_files] == [p.name for p in ds_j.image_files]
    assert len(ds_t) == len(ds_j) == 20
    _close(ds_t._clean, ds_j._clean)
    np.testing.assert_allclose(ds_t._factors.numpy(), np.asarray(ds_j._factors), rtol=1e-5)
    key = jax.random.PRNGKey(9)
    ref = ds_j.sample_batch(key, 32)
    draws = _jax_image_draws(key, 32, len(ds_j.image_files), jchannel.ChannelConfig(kind), 16)
    got = ds_t.sample_batch_from_draws(draws)
    for k in ("noisy", "clean", "snr"):
        _close(got[k], ref[k])
    out = ds_t.sample_batch(torch.Generator().manual_seed(0), 8)
    assert out["noisy"].shape == (8, 16, 2) and bool(torch.isfinite(out["noisy"]).all())


def test_chunk_dataset_sample_batch(image_dir):
    kw = dict(chunk=16, snr_range=(0, 30), samples_per_image=8)
    ds_t = timg.ImageOFDMChunkDataset(str(image_dir), **kw)
    ds_j = jimg.ImageOFDMChunkDataset(str(image_dir), **kw)
    assert ds_t._chunks.shape == ds_j._chunks.shape and len(ds_t) == len(ds_j)
    np.testing.assert_allclose(ds_t._chunks.numpy(), np.asarray(ds_j._chunks),
                               rtol=1e-5, atol=2e-6 * float(np.abs(ds_j._chunks).max()))
    np.testing.assert_allclose(ds_t._power.numpy(), np.asarray(ds_j._power), rtol=1e-5)
    key = jax.random.PRNGKey(10)
    ref = ds_j.sample_batch(key, 32)
    k_idx, k_snr, k_n = jax.random.split(key, 3)
    draws = {"idx": torch.from_numpy(np.array(
                 jax.random.randint(k_idx, (32,), 0, ds_j._chunks.shape[0]))),
             "u": torch.from_numpy(np.array(jax.random.uniform(k_snr, (32,), jnp.float32))),
             "noise": torch.from_numpy(np.array(jax.random.normal(k_n, (32, 16, 2), jnp.float32)))}
    got = ds_t.sample_batch_from_draws(draws)
    for k in ("noisy", "clean", "snr"):
        _close(got[k], ref[k])


def test_missing_images_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        timg.ImageOFDMDataset(str(tmp_path))


@pytest.mark.parametrize("chunks", [False, True])
def test_trainer_trains_on_images(image_dir, tmp_path, chunks):
    """The image batches take the place of both datagen routes; validation
    draws from the same dataset (reference trainer.py:148-180, :417-433)."""
    cfg = Config(training=TrainingSection(batch_size=16), checkpoint_dir=str(tmp_path / "c"),
                 log_dir=str(tmp_path / "l"), export_dir=str(tmp_path / "e"))
    trainer = Trainer(cfg, samples_per_epoch=32, val_samples=16, device="cpu",
                      image_dir=str(image_dir), image_chunks=chunks, samples_per_image=4)
    assert isinstance(trainer.image_dataset,
                      timg.ImageOFDMChunkDataset if chunks else timg.ImageOFDMDataset)
    assert trainer.step.datagen_route == "plain" and trainer.step.critic_route == "kernel"
    calls = []
    real = trainer.image_dataset.sample_batch_from_draws
    trainer.image_dataset.sample_batch_from_draws = lambda d: calls.append(1) or real(d)
    history = trainer.train(epochs=1, experiment_name="img")
    assert len(calls) == 2 + 1   # two training steps, one validation batch
    assert all(np.isfinite(v) for v in history[0].values())
