"""Check every subsystem of the port once: ``python -m ofdmgan_tpu_torch.selfcheck
[--device cpu] [--json PATH]`` (counterpart of ``ofdmgan_tpu/selfcheck.py``).

Each check exercises one subsystem end to end on ``--device`` (the GPU
unless ``cpu``) and prints PASS or FAIL under the JAX package's names:
``signal``, ``models``, ``training``, ``quant``, ``equalizers``,
``native-cosim`` and ``pallas-datagen``, whose counterpart here is the CUDA
datagen kernel's statistical check against the FFT datagen. ``training``
takes the mini step on both kernel routes: on the GPU one datagen and two
critic-gradient launches, on the CPU the kernels' plain versions. On the
CPU ``pallas-datagen`` is skipped, as the JAX package skips it without
its hardware. A kernel that fails to build or launch is a FAIL.
The exit code is 0 iff every check passed; ``--json`` writes each check's
status, what it measured and the kernel launches it made.
"""

from __future__ import annotations

import sys
import traceback

import torch

DATAGEN_FRAMES = 65536
DATAGEN_STAT_ATOL = 0.01   # kernel against FFT datagen: std and L1 of the frames
SNR_MEAN_ATOL = 0.5        # the drawn SNR's mean against 15 dB (U(0, 30))


def _check_signal(dev):
    from .signal import ofdm, qam
    from .signal.datagen import DatagenConfig, synthetic_batch

    gen = torch.Generator(device=dev).manual_seed(0)
    bits = (torch.rand(120, generator=gen, device=dev) < 0.5).to(torch.int64)
    spec = ofdm.OFDMSpec(n_subcarriers=16, cp_length=4, pilot_spacing=4)
    syms = qam.modulate(bits, "QAM16")
    data, _ = ofdm.demodulate(ofdm.modulate(syms, spec), spec)
    ber = float((qam.demodulate(data[: syms.shape[-1]], "QAM16") != bits).float().mean())
    assert ber == 0.0, f"QAM/OFDM roundtrip BER {ber} != 0"
    out = synthetic_batch(gen, 256, DatagenConfig())
    assert out["noisy"].shape == (256, 16, 2)
    assert bool(torch.isfinite(out["noisy"]).all())


def _models(dev):
    from .models import MiniDiscriminator, MiniGenerator

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return MiniGenerator().to(dev), MiniDiscriminator().to(dev)


def _check_models(dev):
    from .models import count_parameters

    g, d = _models(dev)
    assert count_parameters(g) == 258 and count_parameters(d) == 521
    x = torch.zeros(2, 16, 2, device=dev)
    with torch.no_grad():
        assert g(x).shape == (2, 16, 2)
        assert d(x, x).shape == (2, 1)


def _launches():
    from .ops import critic_kernel, datagen_kernel
    return {"datagen": datagen_kernel.launches, "critic_grad": critic_kernel.launches}


def _check_training(dev):
    from .signal.datagen import DatagenConfig
    from .training.schedules import make_adam
    from .training.wgan_gp import LossConfig, TrainStep

    g, d = _models(dev)
    step = TrainStep(g, d, make_adam(g.parameters(), 1e-4), make_adam(d.parameters(), 1e-4),
                     DatagenConfig(), LossConfig(n_critic=2), 64)
    routes = {"datagen": step.datagen_route, "critic": step.critic_route}
    assert routes == {"datagen": "kernel", "critic": "kernel"}, routes
    before = _launches()
    m = step(torch.Generator(device=dev).manual_seed(0))
    launched = {k: v - before[k] for k, v in _launches().items()}
    on_gpu = dev.type == "cuda"
    assert launched == {"datagen": int(on_gpu), "critic_grad": 2 * on_gpu}, launched
    assert all(bool(torch.isfinite(v)) for v in m.values()), m
    return {"routes": routes}


def _check_quant(dev):
    from .quant import intsim

    g, _ = _models(dev)
    ip = intsim.quantize_weights_rtl(g, "generator")
    y = intsim.generator_int_forward(
        ip, intsim.float_to_q88(torch.full((1, 16, 2), 0.3, device=dev)), "rtl")
    assert int(y.abs().max()) <= 256


def _check_equalizers(dev):
    import numpy as np

    from .eval.equalizers import compare_equalizers

    rng = np.random.default_rng(0)
    clean = (rng.choice([-1, 1], 64) + 1j * rng.choice([-1, 1], 64)) / np.sqrt(2)
    noisy = clean + 0.1 * (rng.standard_normal(64) + 1j * rng.standard_normal(64))

    def iq(c):
        return torch.from_numpy(np.stack([c.real, c.imag], -1).astype(np.float32)).to(dev)

    res = compare_equalizers(iq(noisy), iq(clean))
    assert set(res) == {"ZF", "MMSE", "DFE", "LMS", "RLS"}


def _check_cosim(dev):
    from .verify import cosim

    cosim.load()   # builds native/fixsim.cpp; a failed build raises


def _check_datagen_kernel(dev):
    """The CUDA datagen kernel against the FFT datagen by statistics, at
    65,536 frames, linear and nonlinear (PA saturation 0.8): the noisy and
    clean frames' std and the noisy-clean L1 within 0.01, the SNR within
    [0, 30] dB with a mean within 0.5 dB of 15. A kernel runs only on the
    GPU, so on the CPU the check is skipped."""
    if dev.type != "cuda":
        print("    (skipped on cpu: the kernel runs on the GPU)")
        return None
    from .ops import datagen_kernel
    from .signal.datagen import DatagenConfig, synthetic_batch

    gen = torch.Generator(device=dev).manual_seed(0)
    measured = {}
    for nl in (False, True):
        cfg = DatagenConfig.make(frame_length=16, snr_range=(0, 30), nonlinear=nl,
                                 pa_saturation=0.8)
        out = datagen_kernel.synthetic_batch(gen, DATAGEN_FRAMES, cfg)
        ref = synthetic_batch(gen, DATAGEN_FRAMES, cfg)
        task = "nonlinear" if nl else "linear"
        for field, fn in (("noisy_std", lambda b: b["noisy"].std()),
                          ("clean_std", lambda b: b["clean"].std()),
                          ("l1", lambda b: (b["noisy"] - b["clean"]).abs().mean())):
            a, b = float(fn(out)), float(fn(ref))
            assert abs(a - b) < DATAGEN_STAT_ATOL, (task, field, a, b)
            measured[f"{task}_{field}_kernel"] = a
            measured[f"{task}_{field}_fft"] = b
        snr = out["snr"]
        lo, hi, mean = float(snr.min()), float(snr.max()), float(snr.mean())
        assert lo >= 0 and hi <= 30 and abs(mean - 15) < SNR_MEAN_ATOL, (task, lo, hi, mean)
        measured[f"{task}_snr_min_max_mean"] = [lo, hi, mean]
    return measured


CHECKS = {
    "signal": _check_signal,
    "models": _check_models,
    "training": _check_training,
    "quant": _check_quant,
    "equalizers": _check_equalizers,
    "native-cosim": _check_cosim,
    "pallas-datagen": _check_datagen_kernel,
}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--json", default=None,
                    help="write a machine-readable artifact (per-check status, measured "
                         "datagen-kernel statistics and kernel launches) to this path")
    args = ap.parse_args(argv)

    from .device import resolve_device

    dev = resolve_device(args.device)
    ok = True
    report = {}
    for name, fn in CHECKS.items():
        before = _launches()
        try:
            detail = fn(dev)
            print(f"  [PASS] {name}")
            report[name] = {"status": "pass", **({"measured": detail} if detail else {})}
        except Exception as e:   # a failed check is reported and the rest still run
            ok = False
            print(f"  [FAIL] {name}")
            traceback.print_exc()
            report[name] = {"status": "fail", "error": repr(e)}
        report[name]["launches"] = {k: v - before[k] for k, v in _launches().items()}
    print("ALL PASSED" if ok else "FAILURES PRESENT")
    if args.json:
        import json
        import platform
        import time

        report["_meta"] = {
            "device": str(dev),
            "device_name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                            else platform.processor() or platform.machine()),
            "python": platform.python_version(),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "ok": ok,
        }
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
        print(f"artifact written: {args.json}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
