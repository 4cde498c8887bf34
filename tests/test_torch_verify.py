"""The port's verification layer against the JAX package's: golden vectors,
the architecture check, the reconstruction proof and the cosim report, on
the same parameters (through the weight bridge) and the same draws (JAX's
own key splits, handed to the port).

Tolerances. Golden vectors: the input files and the metadata byte for
byte; the output floats within 1e-6 (torch's and XLA's float32 tanh and
conv sums round apart: an ulp on most entries); the output's Q8.8 files
the encoding of the port's own floats, equal to JAX's on every entry whose
two floats do not straddle a Q8.8 step, and within 1 LSB where they do.
Architecture check: every item's pass or fail equal, ``gp_value`` within
1e-5, the summary JSON byte for byte. Proof: every metric within 1e-5
relative: the port sums its means in float64 (so that the card and the
CPU agree bit for bit), the JAX package in float32, whose mean of the
constant clean power rounds to 0.4899998 where the exact value is
0.48999998; the noisy frames then differ by an ulp, which a Q8.8
truncation may carry, so the integer metrics are held to the same bound.
Cosim report: the results JSON byte for byte, with and without fixsim.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdmgan_tpu.models import MiniDiscriminator as JCritic
from ofdmgan_tpu.models import MiniGenerator as JGen
from ofdmgan_tpu.verify import arch_check as jarch
from ofdmgan_tpu.verify import cosim_report as jcr
from ofdmgan_tpu.verify import golden as jgolden
from ofdmgan_tpu.verify import proof as jproof
from ofdmgan_tpu_torch.models import MiniDiscriminator, MiniGenerator
from ofdmgan_tpu_torch.utils.jax_params import from_jax_params
from ofdmgan_tpu_torch.verify import arch_check, cosim_report, golden, proof
from test_torch_quant import GOLDEN
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

X0 = jnp.zeros((1, 16, 2))


def _pair(seed):
    """JAX parameters of the mini pair from ``PRNGKey(seed)`` and the port's
    models holding them."""
    key = jax.random.PRNGKey(seed)
    pg = jax.device_get(JGen().init(key, X0))
    pd = jax.device_get(JCritic().init(key, X0, X0))
    g, d = MiniGenerator(), MiniDiscriminator()
    g.load_state_dict(from_jax_params(pg))
    d.load_state_dict(from_jax_params(pd))
    return pg, pd, g, d


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_golden_dirs_match(jax_dir, port_dir):
    for name in ("input_float.npy", "input_q88.npy", "input.hex", "golden_metadata.json"):
        assert (jax_dir / name).read_bytes() == (port_dir / name).read_bytes(), name
    y_j, y_t = np.load(jax_dir / "output_float.npy"), np.load(port_dir / "output_float.npy")
    assert y_t.dtype == np.float32 and y_t.shape == y_j.shape
    np.testing.assert_allclose(y_t, y_j, rtol=0, atol=1e-6)
    q_j, q_t = np.load(jax_dir / "output_q88.npy"), np.load(port_dir / "output_q88.npy")
    np.testing.assert_array_equal(q_t, golden.q88_int16(y_t))
    np.testing.assert_array_equal(golden.read_hex(port_dir / "output.hex"), q_t.flatten())
    straddle = golden.q88_int16(y_t) != jgolden.q88_int16(y_j)
    np.testing.assert_array_equal(q_t[~straddle], q_j[~straddle])
    assert np.abs(q_t.astype(int) - q_j).max() <= 1


class TestGolden:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_bundle_matches_jax(self, tmp_path, seed):
        pg, _, g, _ = _pair(seed)
        x = np.asarray(jax.random.normal(jax.random.PRNGKey(100 + seed), (1, 2, 16)), np.float32)
        meta_j = jgolden.generate_golden_vectors(JGen(), pg, x, str(tmp_path / "jax"))
        meta_t = golden.generate_golden_vectors(g, x, str(tmp_path / "port"))
        assert meta_t == meta_j == {"input_shape": [1, 2, 16], "output_shape": [1, 2, 16],
                                    "format": "Q8.8 fixed-point", "layers": 4}
        assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
        _assert_golden_dirs_match(tmp_path / "jax", tmp_path / "port")

    def test_reference_encoding_parity(self):
        res = golden.check_reference_encoding_parity(str(GOLDEN))
        assert res == jgolden.check_reference_encoding_parity(str(GOLDEN))
        assert len(res) == 4 and all(res.values()), res

    def test_encoders_match_jax(self, tmp_path):
        x = np.random.default_rng(0).standard_normal(4096).astype(np.float32) * 40
        np.testing.assert_array_equal(golden.q88_int16(x), jgolden.q88_int16(x))
        golden.write_hex(tmp_path / "a.hex", golden.q88_int16(x))
        jgolden.write_hex(tmp_path / "b.hex", jgolden.q88_int16(x))
        assert (tmp_path / "a.hex").read_bytes() == (tmp_path / "b.hex").read_bytes()
        np.testing.assert_array_equal(golden.read_hex(tmp_path / "a.hex"), golden.q88_int16(x))


def jax_verification_draws():
    """The draws of ``jarch.run_full_verification`` and its verifier, from
    their keys (``arch_check.py:47-160``, ``critic.py:95``)."""
    k0, k1, k2 = (jax.random.PRNGKey(i) for i in range(3))
    return {"x": _t(jax.random.normal(k0, (1, 16, 2))),
            "x_batch": _t(jax.random.normal(k0, (10, 16, 2))),
            "candidate": _t(jax.random.normal(k0, (1, 16, 2))),
            "condition": _t(jax.random.normal(k1, (1, 16, 2))),
            "golden_input": _t(jax.random.normal(k0, (1, 2, 16))),
            "real": _t(jax.random.normal(k0, (4, 16, 2))),
            "fake": _t(jax.random.normal(k1, (4, 16, 2))),
            "gp_condition": _t(jax.random.normal(k2, (4, 16, 2))),
            "alpha": _t(jax.random.uniform(jax.random.PRNGKey(3), (4, 1, 1)).reshape(4))}


class TestArchCheck:
    @pytest.mark.parametrize("seed", [0, 7])
    def test_full_verification_matches_jax(self, tmp_path, seed):
        pg, pd, g, d = _pair(seed)
        res_j = jarch.run_full_verification(pg, pd, str(tmp_path / "jax"))
        res_t = arch_check.run_full_verification(g, d, str(tmp_path / "port"),
                                                 draws=jax_verification_draws(), device="cpu")
        assert list(res_t) == list(res_j)
        assert all(r.passed for r in res_t.values())
        for name in ("generator", "discriminator"):
            det_j, det_t = res_j[name].details, res_t[name].details
            assert set(det_t) == set(det_j)
            for test in det_j:
                assert det_t[test]["passed"] == det_j[test]["passed"], (name, test)
        for k in ("min", "max"):
            assert res_t["generator"].details["range_test"][k] == pytest.approx(
                res_j["generator"].details["range_test"][k], abs=1e-6)
        assert res_t["gradient_penalty"].details["gp_value"] == pytest.approx(
            res_j["gradient_penalty"].details["gp_value"], rel=0, abs=1e-5)
        summary = "verification_summary.json"
        assert (tmp_path / "port" / summary).read_bytes() == \
            (tmp_path / "jax" / summary).read_bytes()
        _assert_golden_dirs_match(tmp_path / "jax" / "golden_vectors",
                                  tmp_path / "port" / "golden_vectors")

    @pytest.mark.parametrize("widths", [dict(enc1_channels=6, dec1_channels=6),
                                        dict(bottleneck_channels=16)])
    def test_wrong_architecture_fails_as_in_jax(self, widths):
        jmodel = JGen(**widths)
        pg = jmodel.init(jax.random.PRNGKey(0), X0)
        res_j = jarch.MiniArchitectureVerifier().verify_generator(jmodel, pg)
        draws = jax_verification_draws()
        res_t = arch_check.MiniArchitectureVerifier().verify_generator(
            MiniGenerator(**widths), draws["x"], draws["x_batch"])
        assert not res_t.passed and not res_j.passed
        assert {k: v["passed"] for k, v in res_t.details.items()} == \
            {k: v["passed"] for k, v in res_j.details.items()}
        assert res_t.details["channel_test"] == res_j.details["channel_test"]
        assert res_t.details["param_test"] == res_j.details["param_test"]

    def test_wrong_critic_fails_as_in_jax(self):
        jmodel = JCritic(conv2_channels=12)
        pd = jmodel.init(jax.random.PRNGKey(0), X0, X0)
        res_j = jarch.MiniArchitectureVerifier().verify_discriminator(jmodel, pd)
        draws = jax_verification_draws()
        res_t = arch_check.MiniArchitectureVerifier().verify_discriminator(
            MiniDiscriminator(conv2_channels=12), draws["candidate"], draws["condition"])
        assert not res_t.passed and not res_j.passed
        assert res_t.details["channel_test"] == res_j.details["channel_test"]
        assert res_t.details["param_test"] == res_j.details["param_test"]

    def test_own_draws_pass(self, tmp_path):
        res = arch_check.run_full_verification(output_dir=str(tmp_path), device="cpu")
        assert all(r.passed for r in res.values())
        assert json.loads((tmp_path / "verification_summary.json").read_text())["generator"][
            "passed"]


def jax_proof_draws(key=None, n=100, L=16):
    """``jproof``'s draws from its key splits (``proof.py:28-33``)."""
    key = jax.random.PRNGKey(0) if key is None else key
    k_sig, k_noise = jax.random.split(key)
    return {"signs": _t(jax.random.bernoulli(k_sig, 0.5, (n, L, 2))),
            "noise": _t(jax.random.normal(k_noise, (n, L, 2)))}


class TestProof:
    @pytest.mark.parametrize("seed", [0, 3])
    def test_metrics_match_jax(self, seed):
        pg, _, g, _ = _pair(seed)
        draws = jax_proof_draws()
        for snr in range(0, 31, 5):
            r_j = jproof.test_signal_enhancement(JGen().apply, pg, float(snr))
            r_t = proof.signal_enhancement_from_draws(g, draws, float(snr))
            assert list(r_t) == list(r_j)
            for k in r_j:
                assert r_t[k] == pytest.approx(r_j[k], rel=1e-5), (snr, k)
            for mode in ("rtl", "float_ref"):
                i_j = jproof.test_int_datapath_enhancement(pg, float(snr), mode=mode)
                i_t = proof.int_datapath_enhancement_from_draws(g, draws, float(snr), mode)
                assert list(i_t) == list(i_j) and i_t["mode"] == mode
                for k in ("snr_input_db", "mse_before", "mse_after", "snr_improvement_db"):
                    assert i_t[k] == pytest.approx(i_j[k], rel=1e-5), (snr, mode, k)

    def test_clean_power_is_exact(self):
        """The float64 sums make the clean power exact, so the noisy frames
        do not depend on a device's order of summation."""
        draws = proof.make_proof_draws(torch.Generator().manual_seed(0))
        clean, noisy = proof._frames(draws, 10.0, torch.device("cpu"))
        c = float(np.float32(0.7) * np.float32(0.7))
        np.testing.assert_array_equal(noisy.numpy(),
                                      (clean + math.sqrt(c / 10.0) * draws["noise"]).numpy())

    def test_entry_points_draw_their_own(self):
        _, _, g, _ = _pair(0)
        r = proof.test_signal_enhancement(g, 10.0, n_samples=50)
        assert r["mse_before"] > 0 and r["mse_after"] > 0 and np.isfinite(r["snr_improvement_db"])
        r = proof.test_int_datapath_enhancement(g, 10.0, n_samples=20)
        assert r["mode"] == "rtl" and np.isfinite(r["snr_improvement_db"])


class TestCosimReport:
    @pytest.mark.parametrize("use_native", [True, False])
    @pytest.mark.parametrize("seed", [0, 5])
    def test_results_match_jax(self, tmp_path, seed, use_native):
        pg, pd, g, d = _pair(seed)
        res_j = jcr.run_cosim_verification(pg, pd, str(tmp_path / "jax"), use_native=use_native)
        res_t = cosim_report.run_cosim_verification(g, d, str(tmp_path / "port"),
                                                    use_native=use_native, device="cpu")
        assert res_t == res_j
        name = "cosim_verification_results.json"
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
        assert res_t["passed_tests"] == res_t["total_tests"] == 17
        assert res_t["native_engine"] is use_native

    def test_scenarios_match_jax(self):
        for (kj, vj), (kt, vt) in zip(jcr._ofdm_scenarios().items(),
                                      cosim_report._ofdm_scenarios().items()):
            assert kj == kt
            for k in ("degraded", "clean"):
                assert vt[k].dtype == np.float32
                np.testing.assert_array_equal(vt[k], vj[k])
        for (kj, vj), (kt, vt) in zip(jcr._gen_patterns().items(),
                                      cosim_report._gen_patterns().items()):
            assert kj == kt
            np.testing.assert_array_equal(vt, vj)

    def test_a_failed_fixsim_build_raises(self, tmp_path, monkeypatch):
        from ofdmgan_tpu_torch.verify import cosim

        def broken():
            raise RuntimeError("g++ failed for fixsim.cpp")

        monkeypatch.setattr(cosim, "load", broken)
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            cosim_report.run_cosim_verification(output_dir=str(tmp_path), device="cpu")
        res = cosim_report.run_cosim_verification(output_dir=str(tmp_path), use_native=False,
                                                  device="cpu")
        assert not res["native_engine"]
        assert not any("native_bitexact" in t for t in res["tests"])

    def test_without_matplotlib_the_dashboard_is_skipped(self, tmp_path, monkeypatch, capsys):
        import sys

        monkeypatch.setitem(sys.modules, "matplotlib", None)
        res = cosim_report.run_cosim_verification(output_dir=str(tmp_path), use_native=False,
                                                  device="cpu")
        assert res["passed_tests"] == res["total_tests"]
        assert "matplotlib is not installed" in capsys.readouterr().out
        assert (tmp_path / "cosim_verification_results.json").exists()
        assert not (tmp_path / "cosim_dashboard.png").exists()
