"""The port's classical equalizers against the JAX package's, frame by
frame and batched over trials (the port's batch against JAX's vmap).

Inputs are numpy frames from a seed through a 3-tap multipath channel, as
the reference's own tests make them (``tests/test_equalizers.py``), and
random I/Q frames at L = 16 (the mini frame), 32 and 64. Tolerance by
element: atol 2e-6 on outputs of order one for ZF, MMSE, DFE and LMS
(float32 rounding of complex products summed in another order); RLS, whose
P recursion (lambda 0.99) amplifies rounding, atol 2e-5 at L <= 32 and
2e-4 at L = 64. Per-frame metrics within rtol 1e-4 (ZF's oracle MSE is
rounding noise, ~1e-13: atol 1e-10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdmgan_tpu.eval import equalizers as je
from ofdmgan_tpu_torch.eval import equalizers as te
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RNG = np.random.default_rng(42)
OUT_ATOL = {"ZF": 2e-6, "MMSE": 2e-6, "DFE": 2e-6, "LMS": 2e-6, "RLS": 2e-5}


def _multipath_frames(b, n, snr_db=15):
    clean = (RNG.choice([-1, 1], (b, n)) + 1j * RNG.choice([-1, 1], (b, n))) / np.sqrt(2)
    h = np.array([1.0, 0.3 + 0.2j, 0.1 - 0.1j])
    noise = np.sqrt(1 / 10 ** (snr_db / 10) / 2) * (RNG.standard_normal((b, n))
                                                    + 1j * RNG.standard_normal((b, n)))
    noisy = np.stack([np.convolve(c, h, mode="same") for c in clean]) + noise
    return clean.astype(np.complex64), noisy.astype(np.complex64)


def _iq(c):
    return np.stack([c.real, c.imag], -1).astype(np.float32)


@pytest.mark.parametrize("L", [16, 32, 64])
def test_complex_recurrences_match_jax(L):
    clean, noisy = _multipath_frames(4, L)
    tn, tc = torch.from_numpy(noisy), torch.from_numpy(clean)
    for i in range(clean.shape[0]):
        jn, jc = jnp.asarray(noisy[i]), jnp.asarray(clean[i])
        cases = {
            "ZF": (te.zf_equalize(tn, tc), je.zf_equalize(jn, jc)),
            "MMSE": (te.mmse_equalize(tn, tc, 15.0), je.mmse_equalize(jn, jc, 15.0)),
            "DFE": (te.dfe_equalize(tn, *te.dfe_train(tn, tc)),
                    je.dfe_equalize(jn, *je.dfe_train(jn, jc))),
            "LMS": (te.lms_equalize(tn, te.lms_train(tn, tc)[0]),
                    je.lms_equalize(jn, je.lms_train(jn, jc)[0])),
            "RLS": (te.rls_equalize(tn, te.rls_train(tn, tc)[0]),
                    je.rls_equalize(jn, je.rls_train(jn, jc)[0])),
        }
        for name, (got, ref) in cases.items():
            atol = 2e-4 if name == "RLS" and L == 64 else OUT_ATOL[name]
            np.testing.assert_allclose(got[i].numpy(), np.asarray(ref), rtol=0, atol=atol,
                                       err_msg=f"{name} L={L} frame {i}")


@pytest.mark.parametrize("n_iterations", [1, 3])
def test_lms_history_and_passes(n_iterations):
    clean, noisy = _multipath_frames(3, 32)
    w_t, e_t = te.lms_train(torch.from_numpy(noisy), torch.from_numpy(clean),
                            n_iterations=n_iterations)
    for i in range(3):
        w_j, e_j = je.lms_train(jnp.asarray(noisy[i]), jnp.asarray(clean[i]),
                                n_iterations=n_iterations)
        np.testing.assert_allclose(w_t[i].numpy(), np.asarray(w_j), atol=2e-6)
        np.testing.assert_allclose(e_t[i].numpy(), np.asarray(e_j), rtol=1e-4, atol=1e-7)
    assert e_t.shape == (3, n_iterations * (32 - 10))


@pytest.mark.parametrize("name", list(je.EQUALIZERS))
@pytest.mark.parametrize("L", [16, 64])
def test_iq_api_batched_against_vmap(name, L):
    noisy = RNG.standard_normal((6, L, 2)).astype(np.float32)
    clean = (0.7 * RNG.standard_normal((6, L, 2))).astype(np.float32)
    out_j, m_j = jax.vmap(je.EQUALIZERS[name])(jnp.asarray(noisy), jnp.asarray(clean))
    out_t, m_t = te.EQUALIZERS[name](torch.from_numpy(noisy), torch.from_numpy(clean))
    atol = 2e-4 if name == "RLS" and L == 64 else OUT_ATOL[name]
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0, atol=atol)
    assert set(m_t) == set(m_j)
    for k in m_j:
        np.testing.assert_allclose(m_t[k].numpy(), np.asarray(m_j[k]), rtol=1e-4, atol=1e-10,
                                   err_msg=k)


def test_edges_sign_and_single_frame():
    # LMS/RLS write zeros outside [taps//2, N - taps//2): 10 of 16 samples
    clean, noisy = _multipath_frames(1, 16)
    tn, tc = torch.from_numpy(noisy[0]), torch.from_numpy(clean[0])
    for out in (te.lms_equalize(tn, te.lms_train(tn, tc)[0]),
                te.rls_equalize(tn, te.rls_train(tn, tc)[0])):
        assert out.shape == (16,) and torch.all(out[:5] == 0) and torch.all(out[11:] == 0)
        assert torch.any(out[5:11] != 0)
    # the DFE's decision of an exact zero is zero (jnp.sign(0) = 0): a zero
    # frame with zero taps feeds zeros back
    z = torch.zeros(1, 8, dtype=torch.complex64)
    w_ff, w_fb = torch.zeros(1, 5, dtype=torch.complex64), torch.ones(1, 3, dtype=torch.complex64)
    assert torch.equal(te.dfe_equalize(z, w_ff, w_fb), z)


def test_compare_equalizers_matches_jax():
    clean, noisy = _multipath_frames(1, 64, snr_db=20)
    n_iq, c_iq = _iq(noisy[0]), _iq(clean[0])
    got = te.compare_equalizers(torch.from_numpy(n_iq), torch.from_numpy(c_iq), 20.0)
    ref = je.compare_equalizers(jnp.asarray(n_iq), jnp.asarray(c_iq), 20.0)
    assert got.keys() == ref.keys()
    for name in ref:
        assert got[name].keys() == ref[name].keys()
        for k in ref[name]:
            np.testing.assert_allclose(got[name][k], ref[name][k], rtol=1e-4, atol=1e-10)
    noeq = float(np.mean((n_iq - c_iq) ** 2))
    assert got["ZF"]["mse"] < noeq and got["MMSE"]["mse"] < noeq
