"""The 3x3 simpleGAN (counterpart of ``ofdmgan_tpu/simplegan``): the dense
circle/cross GAN, its fixed-point export and its integer datapath."""

from .export import (  # noqa: F401
    discriminator_int_forward,
    export_weights_txt,
    generator_int_forward,
    load_weights_txt,
    quantize_params,
)
from .model import (  # noqa: F401
    SimpleGANParams,
    discriminator_forward,
    generate_samples,
    generator_forward,
    init_params,
    make_train_draws,
    pattern_score,
    patterns,
    train,
    train_from_draws,
)
