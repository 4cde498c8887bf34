"""The mini generator and conditional critic, and the full U-Net family."""

from .critic import MiniDiscriminator, compute_gradient_penalty  # noqa: F401
from .full_unet import FullDiscriminator, FullUNetGenerator  # noqa: F401
from .generator import MiniGenerator, count_parameters  # noqa: F401
