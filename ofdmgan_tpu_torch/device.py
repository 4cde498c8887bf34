"""Device selection and the float32 numerics policy.

WGAN-GP collapses under reduced-precision matmuls (the reference trains at
``matmul_precision="float32"``), so the port keeps TF32 off for both matrix
products and cuDNN convolutions; cuDNN would otherwise run float32
convolutions in TF32 by default. ``float32_policy`` puts that in effect: the
package calls it when it is imported, so every function of the port runs
float32 convolutions on the card, and ``resolve_device`` calls it again for
each entry point.
"""

from __future__ import annotations

import torch


def float32_policy() -> None:
    """TF32 off for matrix products and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Return the device an entry point runs on.

    ``None`` means the GPU. Asking for CUDA where there is none raises:
    nothing falls back to the CPU unless the caller passes ``"cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        if dev.index is None:  # the form tensors report, so devices compare equal
            dev = torch.device("cuda", torch.cuda.current_device())
    float32_policy()
    return dev
