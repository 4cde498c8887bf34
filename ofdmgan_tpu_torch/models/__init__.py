"""The mini generator and conditional critic."""

from .critic import MiniDiscriminator, compute_gradient_penalty  # noqa: F401
from .generator import MiniGenerator, count_parameters  # noqa: F401
