"""Multi-device training of the port: the mesh and the data-parallel step
(``mesh``), the global dp x tp x sp step (``gspmd``), the GPipe pipeline
(``pipeline``) and the multi-process runtime (``distributed``); the
counterpart of ``ofdmgan_tpu/parallel/``."""

from . import distributed  # noqa: F401
from .gspmd import make_gspmd_train_step  # noqa: F401
from .mesh import (  # noqa: F401
    fold_device_seed,
    make_mesh,
    make_sharded_train_step,
    replicate_state,
)
from .pipeline import (  # noqa: F401
    make_pp_supervised_train_step,
    make_pp_trainstate_step,
    unet_stage_fns,
)
