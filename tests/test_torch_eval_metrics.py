"""The port's signal-quality metrics against the JAX package's, on numpy
inputs made from a seed: rtol 1e-5, atol 1e-6 (float32 reductions summed
in another order); BER exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdmgan_tpu.eval import metrics as jm
from ofdmgan_tpu_torch.eval import metrics as tm
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RNG = np.random.default_rng(3)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("per_item", [False, True])
@pytest.mark.parametrize("name", ["mse", "mse_db", "evm_db", "evm_percent"])
def test_paired_metrics(name, per_item):
    est = RNG.standard_normal((6, 16, 2)).astype(np.float32)
    ref = RNG.standard_normal((6, 16, 2)).astype(np.float32)
    _close(getattr(tm, name)(torch.from_numpy(est), torch.from_numpy(ref), per_item),
           getattr(jm, name)(jnp.asarray(est), jnp.asarray(ref), per_item))


@pytest.mark.parametrize("per_item", [False, True])
def test_snr_improvement(per_item):
    noisy, est, ref = (RNG.standard_normal((5, 16, 2)).astype(np.float32) for _ in range(3))
    _close(tm.snr_improvement_db(*map(torch.from_numpy, (noisy, est, ref)), per_item),
           jm.snr_improvement_db(*map(jnp.asarray, (noisy, est, ref)), per_item))


def test_complex_inputs():
    est = (RNG.standard_normal((4, 16)) + 1j * RNG.standard_normal((4, 16))).astype(np.complex64)
    ref = (RNG.standard_normal((4, 16)) + 1j * RNG.standard_normal((4, 16))).astype(np.complex64)
    for name in ("mse", "evm_db", "nmse"):
        _close(getattr(tm, name)(torch.from_numpy(est), torch.from_numpy(ref)),
               getattr(jm, name)(jnp.asarray(est), jnp.asarray(ref)))


def test_ber_exact():
    a, b = (RNG.integers(0, 2, (8, 32)).astype(np.int32) for _ in range(2))
    assert float(tm.ber(torch.from_numpy(a), torch.from_numpy(b))) == \
        float(jm.ber(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("name", ["psnr", "ssim_global", "nmse"])
def test_image_metrics(name):
    # uint8 images: psnr and ssim cast to float32 (jnp.var is the
    # population variance: correction=0)
    est = RNG.integers(0, 256, (32, 32)).astype(np.uint8)
    ref = np.clip(est.astype(int) + RNG.integers(-20, 20, (32, 32)), 0, 255).astype(np.uint8)
    if name == "nmse":
        est, ref = est.astype(np.float32), ref.astype(np.float32)
    _close(getattr(tm, name)(torch.from_numpy(est), torch.from_numpy(ref)),
           getattr(jm, name)(jnp.asarray(est), jnp.asarray(ref)))
