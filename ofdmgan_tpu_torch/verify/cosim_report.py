"""The integer-datapath verification suite and its dashboard (counterpart
of ``ofdmgan_tpu/verify/cosim_report.py``; reference
visualization/rtl_verification_viz.py:62-652).

The "hardware" is the bit-true integer datapath, run two ways: the port's
``quant/intsim.py`` on the device, and the native C++ engine
``native/fixsim.cpp`` (``verify/cosim.py``) on the host; every test holds
them bit for bit and the results go to ``cosim_verification_results.json``
with the JAX package's structure. Test sets mirror the reference
testbenches:

* generator: zero / DC / impulse / sine / ramp / random patterns
  (tb_generator_mini.v:214-430) and the five OFDM channel scenarios of
  ``viz/signal_viz.py`` (tb_cwgan_gp_full.v:447-586);
* discriminator: zero / matching / mismatched / random / DC
  (tb_discriminator_mini.v:179-255);
* system: generator -> critic(fake, cond) and critic(clean, cond), the
  "training mode" pass (tb_cwgan_gp.v:328-503).

The patterns and scenarios come from numpy's ``default_rng``, so they are
the JAX package's to the byte. ``use_native`` builds fixsim, and a failed
build raises: the bit-exact column is never dropped quietly. The dashboard
needs matplotlib, which is imported where it is drawn; without it the
suite says so in one line and writes the JSON alone.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..viz.signal_viz import research_scenarios

QPSK_EVM_LIMIT_PERCENT = 17.5  # acceptance criterion (tb_generator_mini.v:719-720)


def _gen_patterns(frame: int = 16) -> Dict[str, np.ndarray]:
    t = np.arange(frame)
    rng = np.random.default_rng(7)
    return {
        "zero": np.zeros((frame, 2), np.float32),
        "dc": np.full((frame, 2), 0.5, np.float32),
        "impulse": (np.eye(frame, 2, dtype=np.float32) * 0.9),
        "sine": np.stack([np.sin(2 * np.pi * t / frame),
                          np.cos(2 * np.pi * t / frame)], -1).astype(np.float32) * 0.7,
        "ramp": np.stack([t / frame, 1 - t / frame], -1).astype(np.float32),
        "random": rng.standard_normal((frame, 2)).astype(np.float32) * 0.4,
    }


COSIM_SCENARIOS = {"awgn_30": "awgn_30pct", "deep_fade_60": "deep_fade_60pct",
                   "burst": "burst_interference", "freq_selective": "freq_selective",
                   "worst_case": "worst_case"}   # the scenarios' names in the report


def _ofdm_scenarios(frame: int = 16) -> Dict[str, Dict[str, np.ndarray]]:
    """The research scenarios (``viz/signal_viz.py``) from seed 3, as I/Q."""
    clean, scenarios = research_scenarios(seed=3, frame_length=frame)
    return {COSIM_SCENARIOS[k]: {"degraded": s.iq, "clean": clean.iq} for k, s in scenarios}


def run_cosim_verification(
    generator: Optional[torch.nn.Module] = None,
    critic: Optional[torch.nn.Module] = None,
    output_dir: str = "./verification_output",
    use_native: bool = True,
    device=None,
) -> Dict[str, Any]:
    """Run the integer-datapath suite on ``device`` (the GPU unless
    ``"cpu"``), with models of the port (initialised from seed 0 where
    none is given); returns the results written to the JSON."""
    from ..models import MiniDiscriminator, MiniGenerator
    from ..quant import intsim
    from ..quant.rom_codegen import pack_rom_arrays
    from . import cosim

    dev = resolve_device(device)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        generator = MiniGenerator() if generator is None else generator
        critic = MiniDiscriminator() if critic is None else critic
    ip_g = intsim.quantize_weights_rtl(generator, "generator")
    ip_d = intsim.quantize_weights_rtl(critic, "discriminator")
    rom_w, rom_b = pack_rom_arrays(generator, critic)
    if use_native:
        cosim.load()   # builds fixsim; a failed build raises

    def q88(frames: np.ndarray) -> torch.Tensor:
        return intsim.float_to_q88(torch.from_numpy(frames[None]).to(dev))

    def ncl(q: torch.Tensor) -> np.ndarray:
        return np.ascontiguousarray(q.cpu().numpy().transpose(0, 2, 1).astype(np.int16))

    def gen_forward(q: torch.Tensor):
        """The integer generator's output ``[1, 16, 2]`` and, with fixsim,
        whether fixsim agrees."""
        y = intsim.generator_int_forward(ip_g, q, "rtl").cpu().numpy()
        native = {}
        if use_native:
            yn = cosim.generator_forward(rom_w, rom_b, ncl(q))
            native["native_bitexact"] = bool(
                np.array_equal(np.swapaxes(y, 1, 2).astype(np.int16), yn))
        return y, native

    results: Dict[str, Any] = {"tests": [], "passed_tests": 0, "total_tests": 0}

    def record(name: str, passed: bool, details: Dict[str, Any]):
        passed = bool(passed) and details.get("native_bitexact", True)
        results["tests"].append({"name": name, "passed": passed, **details})
        results["total_tests"] += 1
        results["passed_tests"] += int(passed)

    # ---- generator pattern tests
    for pname, pat in _gen_patterns().items():
        y, native = gen_forward(q88(pat))
        record(f"gen_{pname}", np.all(np.abs(y) <= 256),
               {"kind": "generator_pattern", "out_min": int(y.min()), "out_max": int(y.max()),
                **native})

    # ---- generator OFDM scenarios (with float-model and int-path metrics)
    for sname, d in _ofdm_scenarios().items():
        deg, ref = d["degraded"][None], d["clean"][None]
        y, native = gen_forward(q88(d["degraded"]))
        enh = y.astype(np.float32) / 256.0
        mse_before = float(np.mean((deg - ref) ** 2))
        mse_after = float(np.mean((enh - ref) ** 2))
        evm_pct = float(100 * np.sqrt(np.mean((enh - ref) ** 2) / (np.mean(ref**2) + 1e-12)))
        det = {
            "kind": "generator_ofdm",
            "mse_degraded": mse_before,
            "mse_enhanced": mse_after,
            "snr_before_db": float(10 * np.log10(np.mean(ref**2) / (mse_before + 1e-12))),
            "snr_after_db": float(10 * np.log10(np.mean(ref**2) / (mse_after + 1e-12))),
            "evm_percent": evm_pct,
            "evm_limit_percent": QPSK_EVM_LIMIT_PERCENT,
            **native,
        }
        record(f"gen_ofdm_{sname}", np.isfinite(mse_after), det)

    # ---- discriminator tests
    rng = np.random.default_rng(11)
    rnd = rng.standard_normal((16, 2)).astype(np.float32) * 0.4
    disc_cases = {
        "zero": (np.zeros((16, 2), np.float32), np.zeros((16, 2), np.float32)),
        "matching": (rnd, rnd),
        "mismatched": (rnd, -rnd),
        "random": (rng.standard_normal((16, 2)).astype(np.float32) * 0.4, rnd),
        "dc": (np.full((16, 2), 0.4, np.float32), np.full((16, 2), 0.4, np.float32)),
    }
    for dname, (cand, cond) in disc_cases.items():
        qc, qd = q88(cand), q88(cond)
        s = int(intsim.discriminator_int_forward(ip_d, qc, qd, "rtl")[0, 0])
        det = {"kind": "discriminator", "score_q88": s, "score_float": s / 256.0}
        if use_native:
            sn = cosim.discriminator_forward(rom_w, rom_b, ncl(qc), ncl(qd))
            det["native_bitexact"] = int(sn[0]) == s
        record(f"disc_{dname}", abs(s) <= 32767, det)

    # ---- system "training mode" pass: G -> D(fake,cond), D(clean,cond)
    scen = _ofdm_scenarios()["awgn_30pct"]
    cond_q, clean_q = q88(scen["degraded"]), q88(scen["clean"])
    fake_q = intsim.generator_int_forward(ip_g, cond_q, "rtl")
    s_fake = int(intsim.discriminator_int_forward(ip_d, fake_q, cond_q, "rtl")[0, 0])
    s_real = int(intsim.discriminator_int_forward(ip_d, clean_q, cond_q, "rtl")[0, 0])
    record("system_training_mode", True,
           {"kind": "system", "score_fake_q88": s_fake, "score_real_q88": s_real})

    results["native_engine"] = use_native
    with open(out / "cosim_verification_results.json", "w") as f:
        json.dump(results, f, indent=2)
    try:
        _render_dashboard(results, out / "cosim_dashboard.png")
    except ImportError:
        print(f"matplotlib is not installed: no dashboard written to {out}")
    return results


def _render_dashboard(results: Dict[str, Any], path: Path):
    """Status-grid dashboard (rtl_verification_viz.py:291-601 role)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    tests = results["tests"]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(13, max(4, 0.4 * len(tests))))
    names = [t["name"] for t in tests]
    colors = ["#2e9e4f" if t["passed"] else "#cc3333" for t in tests]
    y = np.arange(len(tests))
    ax1.barh(y, [1] * len(tests), color=colors)
    ax1.set_yticks(y, names, fontsize=7)
    ax1.set_xticks([])
    ax1.invert_yaxis()
    ax1.set_title(f"Cosim verification: {results['passed_tests']}/{results['total_tests']} passed")

    ofdm = [t for t in tests if t.get("kind") == "generator_ofdm"]
    if ofdm:
        labels = [t["name"].replace("gen_ofdm_", "") for t in ofdm]
        x = np.arange(len(ofdm))
        ax2.bar(x - 0.2, [t["snr_before_db"] for t in ofdm], 0.4, label="degraded SNR")
        ax2.bar(x + 0.2, [t["snr_after_db"] for t in ofdm], 0.4, label="after int datapath")
        ax2.set_xticks(x, labels, rotation=20, fontsize=7)
        ax2.set_ylabel("SNR (dB)")
        ax2.legend(fontsize=8)
        ax2.grid(alpha=0.3, axis="y")
        ax2.set_title("OFDM scenarios")
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
