"""The evaluation CLIs' generators: a flax-layout parameter tree (a ``.npz``
champion or a checkpoint directory's, ``utils/params_io.load_params_tree``)
into a model of the port.

The mini generator takes the checkpoint's training head and modes
(``input_residual``, ``qat``, ``rtl_faithful``: the tree is the same for
all, so the caller must name them). The full U-Net's depth and width are
read from the tree (the number of ``enc*_1`` layers, ``enc1_1``'s output
channels), so a reduced model evaluates too; ``quant_bits`` builds it under
the int8 export's quantization.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from ..models import FullUNetGenerator, MiniGenerator
from ..utils.jax_params import from_jax_params

EXPECTED_LAYER = {"mini": "enc1", "full": "enc1_1"}


def check_family(tree: Dict[str, Any], model: str) -> None:
    """Raise ``ValueError`` unless ``tree`` holds a ``model`` generator."""
    inner = tree.get("params", tree)
    if inner and EXPECTED_LAYER[model] not in inner:
        raise ValueError(f"checkpoint does not hold a '{model}' generator (missing layer "
                         f"'{EXPECTED_LAYER[model]}'; found {sorted(inner)[:4]}...): pass the "
                         "matching --model")


def build_generator(tree: Optional[Dict[str, Any]], model: str, frame_length: int,
                    residual: bool = False, qat: bool = False, rtl_faithful: bool = False,
                    quant_bits: Optional[Sequence[int]] = None, seed: int = 0,
                    act_dtype=None) -> torch.nn.Module:
    """The ``model`` generator with ``tree``'s weights (with ``tree`` None,
    initialised from ``seed``), on the CPU, in eval mode; ``act_dtype`` is
    the mini generator's activation storage format."""
    if tree is not None:
        check_family(tree, model)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        if model == "full":
            levels, base = 5, 32
            if tree is not None:
                inner = tree.get("params", tree)
                levels = sum(1 for k in inner if k.startswith("enc") and k.endswith("_1"))
                base = int(inner["enc1_1"]["kernel"].shape[-1])
            wb, ab = quant_bits or (0, 0)
            gen = FullUNetGenerator(frame_length=frame_length, levels=levels,
                                    base_channels=base, weight_bits=wb, act_bits=ab)
        else:
            gen = MiniGenerator(input_residual=residual, qat=qat, rtl_faithful=rtl_faithful,
                                act_dtype=act_dtype)
    if tree is not None:
        gen.load_state_dict(from_jax_params(tree))
    return gen.eval()
