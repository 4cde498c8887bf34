"""The architecture contract of the RTL blueprint (counterpart of
``ofdmgan_tpu/verify/arch_check.py``): shape round trip, parameter budgets
(258/521 within 5%), channel progressions (2->4->8->4->2 and
4->8->16->1), the tanh output range and a gradient-penalty smoke test,
written to ``verification_summary.json`` with the same structure.

Randomness is split from the checks: ``make_verification_draws`` draws
every input from a ``torch.Generator``, and the verifier and
``run_full_verification`` take them, so a test can hand both packages the
same numbers (the JAX package draws from ``PRNGKey(0)`` to ``PRNGKey(3)``).
Models and draws the caller does not give are made from seed 0.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import MiniDiscriminator, MiniGenerator, compute_gradient_penalty, count_parameters


@dataclasses.dataclass
class VerificationResult:
    passed: bool
    message: str
    details: Dict[str, Any]


EXPECTED_GEN_PARAMS = 258
EXPECTED_DISC_PARAMS = 521
EXPECTED_FRAME_LENGTH = 16
GEN_CHANNELS = (2, 4, 8, 4, 2)
DISC_CHANNELS = (4, 8, 16, 1)
GP_BATCH = 4


def make_verification_draws(gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """Every random input of ``run_full_verification``, on ``gen``'s device:
    ``x`` [1, 16, 2] and ``x_batch`` [10, 16, 2] (the generator checks),
    ``candidate``, ``condition`` [1, 16, 2] (the critic check),
    ``golden_input`` [1, 2, 16] (the golden vectors, channel-first),
    ``real``, ``fake``, ``gp_condition`` [4, 16, 2] and ``alpha`` [4] (the
    gradient penalty)."""
    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=gen.device)

    L = EXPECTED_FRAME_LENGTH
    return {"x": normal(1, L, 2), "x_batch": normal(10, L, 2), "candidate": normal(1, L, 2),
            "condition": normal(1, L, 2), "golden_input": normal(1, 2, L),
            "real": normal(GP_BATCH, L, 2), "fake": normal(GP_BATCH, L, 2),
            "gp_condition": normal(GP_BATCH, L, 2),
            "alpha": torch.rand(GP_BATCH, generator=gen, device=gen.device)}


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


class MiniArchitectureVerifier:
    def __init__(self, tolerance: float = 0.05):
        self.tolerance = tolerance

    def verify_generator(self, model: MiniGenerator, x: torch.Tensor,
                         x_batch: torch.Tensor) -> VerificationResult:
        """``x`` [1, 16, 2] for the shape round trip, ``x_batch`` for the range."""
        results: Dict[str, Any] = {}
        dev = _device_of(model)
        x, x_batch = x.to(dev), x_batch.to(dev)
        try:
            with torch.no_grad():
                y = model(x)
            results["shape_test"] = {
                "passed": y.shape == x.shape,
                "input_shape": list(x.shape),
                "output_shape": list(y.shape),
            }
        except Exception as e:  # forward itself broken (proof/verification.py:98-99)
            results["shape_test"] = {"passed": False, "error": str(e)}
        n = count_parameters(model)
        err = abs(n - EXPECTED_GEN_PARAMS) / EXPECTED_GEN_PARAMS
        results["param_test"] = {
            "passed": err < self.tolerance,
            "actual_params": n,
            "expected_params": EXPECTED_GEN_PARAMS,
            "error": f"{err*100:.1f}%",
        }
        # read from the layers themselves, so that a model built with other
        # widths reports them
        prog = (model.enc1.in_channels, model.enc1.out_channels,
                model.bottleneck.out_channels, model.dec1.out_channels,
                model.out_conv.out_channels)
        results["channel_test"] = {
            "passed": prog == GEN_CHANNELS,
            "expected": "->".join(map(str, GEN_CHANNELS)),
            "actual": "->".join(map(str, prog)),
        }
        try:
            with torch.no_grad():
                yb = model(x_batch)
            lo, hi = float(yb.min()), float(yb.max())
            results["range_test"] = {
                "passed": lo >= -1.0 and hi <= 1.0,
                "min": lo,
                "max": hi,
                "expected_range": "[-1, 1]",
            }
        except Exception as e:
            results["range_test"] = {"passed": False, "error": str(e)}
        ok = all(r["passed"] for r in results.values())
        return VerificationResult(ok, "Generator verification " + ("PASSED" if ok else "FAILED"),
                                  results)

    def verify_discriminator(self, model: MiniDiscriminator, candidate: torch.Tensor,
                             condition: torch.Tensor) -> VerificationResult:
        results: Dict[str, Any] = {}
        dev = _device_of(model)
        with torch.no_grad():
            score = model(candidate.to(dev), condition.to(dev))
        results["shape_test"] = {
            "passed": tuple(score.shape) == (1, 1),
            "output_shape": list(score.shape),
            "expected_shape": [1, 1],
        }
        n = count_parameters(model)
        err = abs(n - EXPECTED_DISC_PARAMS) / EXPECTED_DISC_PARAMS
        results["param_test"] = {
            "passed": err < self.tolerance,
            "actual_params": n,
            "expected_params": EXPECTED_DISC_PARAMS,
            "error": f"{err*100:.1f}%",
        }
        prog = (model.conv1.in_channels, model.conv1.out_channels, model.conv2.out_channels,
                model.dense.out_features)
        results["channel_test"] = {
            "passed": prog == DISC_CHANNELS,
            "expected": "->".join(map(str, DISC_CHANNELS)),
            "actual": "->".join(map(str, prog)),
        }
        ok = all(r["passed"] for r in results.values())
        return VerificationResult(
            ok, "Discriminator verification " + ("PASSED" if ok else "FAILED"), results)


def run_full_verification(
    generator: Optional[MiniGenerator] = None,
    critic: Optional[MiniDiscriminator] = None,
    output_dir: str = "./verification_output",
    draws: Optional[Dict[str, torch.Tensor]] = None,
    device=None,
) -> Dict[str, VerificationResult]:
    """The verification suite, the golden vectors and the gradient-penalty
    smoke test (proof/verification.py:387-473), on ``device`` (the GPU
    unless ``"cpu"``). Models not given are initialised from seed 0;
    ``draws`` (``make_verification_draws``) not given are drawn from a
    generator seeded 0 on the device."""
    from .golden import generate_golden_vectors

    dev = resolve_device(device)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        generator = MiniGenerator() if generator is None else generator
        critic = MiniDiscriminator() if critic is None else critic
    generator, critic = generator.to(dev), critic.to(dev)
    if draws is None:
        draws = make_verification_draws(torch.Generator(device=dev).manual_seed(0))
    draws = {k: v.to(dev) for k, v in draws.items()}

    results: Dict[str, VerificationResult] = {}
    print("Running mini architecture verification...")
    v = MiniArchitectureVerifier()
    results["generator"] = v.verify_generator(generator, draws["x"], draws["x_batch"])
    print(f"  Generator: {results['generator'].message}")
    results["discriminator"] = v.verify_discriminator(critic, draws["candidate"],
                                                      draws["condition"])
    print(f"  Discriminator: {results['discriminator'].message}")

    print("\nGenerating golden vectors for RTL...")
    meta = generate_golden_vectors(generator, draws["golden_input"].cpu().numpy(),
                                   str(out / "golden_vectors"))
    results["golden_vectors"] = VerificationResult(True, "Golden vectors generated successfully",
                                                   meta)

    print("\nTesting gradient penalty...")
    gp = float(compute_gradient_penalty(critic, draws["real"], draws["fake"],
                                        draws["gp_condition"], draws["alpha"]).detach())
    results["gradient_penalty"] = VerificationResult(
        bool(np.isfinite(gp)), "Gradient penalty computed successfully", {"gp_value": gp})

    summary = {k: {"passed": r.passed, "message": r.message} for k, r in results.items()}
    with open(out / "verification_summary.json", "w") as f:
        json.dump(summary, f, indent=2)

    print("\n" + "=" * 60 + "\nVERIFICATION SUMMARY\n" + "=" * 60)
    all_ok = True
    for name, r in results.items():
        print(f"{name}: {'PASS' if r.passed else 'FAIL'}")
        all_ok &= r.passed
    print("=" * 60)
    print(f"OVERALL: {'ALL TESTS PASSED' if all_ok else 'SOME TESTS FAILED'}")
    return results
