"""How close each of the port's CUDA kernels must come to its plain version
(and to autograd) on the card: the tolerances of ``tests/test_torch_cuda.py``
and of ``chip_smoke.py``'s kernel phases, kept once here.

* The datagen kernel: rtol 1e-5, atol 1e-6. It does the same float32
  arithmetic; fused multiply-adds round differently, and the phase scan
  and the frame reductions sum in another order.
* A gradient of the critic- or generator-gradient kernel: rtol 1e-4, atol
  1e-4 of the tensor's largest entry (plus ``floor``): the kernels sum the
  batch in another order.
* Their metrics: rtol 1e-4, atol 1e-5.
* The generator forward kernel's fake: rtol 1e-5, atol 1e-6 of its largest
  entry, as for the datagen kernel: the same float32 forward of each frame,
  each conv's taps summed in another order than cuDNN's and the plain
  version's.

Each check raises ``AssertionError`` naming the tensor that failed.
"""

from __future__ import annotations

from typing import Dict

import torch


def _close(got: torch.Tensor, ref: torch.Tensor, rtol: float, atol: float, what: str) -> None:
    torch.testing.assert_close(got, ref, rtol=rtol, atol=atol, msg=lambda m: f"{what}: {m}")


def assert_datagen_close(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                         what: str = "datagen") -> None:
    """Every output of ``ref`` (noisy, clean, snr, scale) within the datagen
    kernel's tolerance."""
    for k, r in ref.items():
        _close(got[k], r, 1e-5, 1e-6, f"{what} {k}")


def assert_forward_close(got: torch.Tensor, ref: torch.Tensor,
                         what: str = "generator forward") -> None:
    """The forward kernel's fake within rtol 1e-5 and 1e-6 of ``ref``'s
    largest entry."""
    _close(got, ref, 1e-5, 1e-6 * float(ref.abs().max()), what)


def assert_grads_close(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                       what: str = "", floor: float = 1e-7) -> None:
    """Every gradient of ``ref``, by parameter name, within rtol 1e-4 and
    1e-4 of its largest entry plus ``floor``."""
    for name, r in ref.items():
        _close(got[name], r, 1e-4, 1e-4 * float(r.abs().max()) + floor, f"{what} {name}")


def assert_metrics_close(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                         what: str = "") -> None:
    """Every metric of ``ref`` within rtol 1e-4, atol 1e-5."""
    for name, r in ref.items():
        _close(got[name], r, 1e-4, 1e-5, f"{what} {name}")
