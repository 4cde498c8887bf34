"""Checkpoints of the original PyTorch repository, read into the port's models.

Counterpart of ``ofdmgan_tpu/utils/torch_port.py``. The original
repository saves ``.pt`` files in its training script's format (a dict with
``generator_state_dict`` and ``discriminator_state_dict``) or as a bare
``state_dict``. Its generator wraps each conv in a block, so its keys are
``enc1.conv.weight`` where the port's ``MiniGenerator`` says
``enc1.weight``; its critic's keys are the port's. Both store conv weights
as torch does, ``[C_out, C_in, K]``, so the map renames keys and copies
values.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

# the original repository's MiniGenerator key -> the port's
REFERENCE_GENERATOR_KEYS = {
    "enc1.conv.weight": "enc1.weight",
    "enc1.conv.bias": "enc1.bias",
    "bottleneck.conv.weight": "bottleneck.weight",
    "bottleneck.conv.bias": "bottleneck.bias",
    "dec1.conv.weight": "dec1.weight",
    "dec1.conv.bias": "dec1.bias",
    "out_conv.weight": "out_conv.weight",
    "out_conv.bias": "out_conv.bias",
}
REFERENCE_CRITIC_KEYS = {k: k for k in ("conv1.weight", "conv1.bias", "conv2.weight",
                                        "conv2.bias", "dense.weight", "dense.bias")}
_TABLES = {"generator": REFERENCE_GENERATOR_KEYS, "discriminator": REFERENCE_CRITIC_KEYS}


def state_dict_from_reference(sd: Mapping[str, torch.Tensor],
                              which: str = "generator") -> Dict[str, torch.Tensor]:
    """The original repository's ``state_dict`` of ``which`` (``generator``
    or ``discriminator``), or its checkpoint dict holding
    ``<which>_state_dict``, as a float32 ``state_dict`` of the port's model."""
    if which not in _TABLES:
        raise ValueError(f"which must be one of {tuple(_TABLES)}, not {which!r}")
    sd = sd.get(f"{which}_state_dict", sd)
    table = _TABLES[which]
    missing = sorted(set(table) - set(sd))
    if missing:
        raise KeyError(f"not a {which} state_dict of the original repository: "
                       f"missing {missing}")
    return {mine: torch.as_tensor(sd[theirs]).detach().to(torch.float32).clone()
            for theirs, mine in table.items()}


def load_reference_checkpoint(path: str, which: str = "generator") -> Dict[str, torch.Tensor]:
    """A ``.pt`` file of the original repository -> the port's ``state_dict``
    of ``which``. The file is unpickled in full (its training script saves
    the optimizers and the config beside the weights): open only trusted
    files."""
    return state_dict_from_reference(
        torch.load(path, map_location="cpu", weights_only=False), which)
