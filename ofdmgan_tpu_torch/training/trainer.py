"""The trainer: epochs in scan chunks, validation, the NaN policy, JSONL
metrics, full-state checkpoints with resume and warm start, an EMA of the
generator, the profiling hook, the image datasets and the flat step.

Counterpart of ``ofdmgan_tpu/training/trainer.py:52-674``. An epoch is
``samples_per_epoch // batch_size`` outer steps, dispatched in chunks of
``scan_steps`` (``training/chunks.py``: 0 picks the reference's
``min(steps_per_epoch, 32)``, lowered until it divides the epoch); an
epoch's metrics are those of its last chunk's last step. The EMA of the
generator is updated once per chunk with the decay ``ema_decay **
scan_steps`` (reference ``trainer.py:436-456``): an EMA of the
chunk-boundary parameters. How a chunk runs is fixed by the
configuration: on the card, the mini family's single-device step (its QAT
modes and the flat step included) runs each chunk as one CUDA graph
(``GraphedChunk``, its optimizers holding their schedules on the device);
the full family (its step is bound by the device), the parallel
strategies (gloo cannot be captured), the image datasets (their samplers
run on the host), ``debug_nans`` (a check after every step) and the CPU
run each chunk step by step (``EagerChunk``), as does ``profile_steps``,
whose count is in chunks. Checkpoints keep the
reference's names: ``checkpoint_epoch_{N}/``, ``best_model/`` (a copy of the
best) and ``final_model/``, each with

* ``params_g.npz``, ``params_d.npz`` (and ``ema_params_g.npz`` with an EMA):
  the parameters in the JAX package's ``.npz`` format (flax layout,
  ``/``-joined keys), so either package can load them;
* ``optimizer.pt``: both Adam states and their StepLR positions
  (``torch.save``);
* ``trainer_state.json``: ``epoch`` (the index of the epoch just trained,
  where a resumed run starts again, as the reference's does),
  ``global_step``, ``best_val_loss`` and ``config``.

The generator alone is also written as ``champion_params_g.npz`` (on each
new best) and ``final_params_g.npz``. After ``final_model/`` a run writes
the raw generator's FPGA export bundle (not the EMA's, as the reference)
into ``export_dir/generator/`` (``quant/export.py``: the mini or the full
U-Net layout), unless the configuration's ``export_after_training`` is
false.

Parallel strategies, with the reference's meanings and checks
(``trainer.py:282-392``), across the ranks of the process group
(``parallel/distributed.py``): ``strategy="shard_map"`` is the explicit
data-parallel step over ``data_parallel`` ranks (``parallel/mesh.py``;
0 means every rank), taken whenever the process group is initialized, a
world of one included; ``"gspmd"`` the global step over ``dp`` x
``tensor_parallel`` x ``seq_parallel`` (``parallel/gspmd.py``); ``"pp"`` the
GPipe pipeline of the full U-Net's supervised path over
``pipeline_parallel`` stages with ``microbatches`` microbatches
(``parallel/pipeline.py``). Every rank holds the full models (under tensor
parallelism the step trains shards of the generator, gathered back into
the full one after each epoch, and after each step with an EMA); rank 0
alone writes checkpoints, the JSONL metrics and the export. Resume and warm
start load on every rank and place the state under the step's sharding.
As the reference's trainer, ``"gspmd"`` builds its step without
``act_dtype`` (``trainer.py:323-330``: the batch is not cast; the mini pair
keeps its modules' storage and the fused decoder its apply's), and ``"pp"``
passes on neither ``act_dtype`` nor ``matmul_precision``
(``trainer.py:337-366``): both are accepted and change nothing there.

The models are the mini pair of the configuration unless the caller
injects another family (``generator``/``discriminator``, as the reference's
``trainer.py:86-126``; ``build_models`` makes either family from a seed,
the mini generator with ``qat``/``rtl_faithful``, Q1.7/Q8.8 fake
quantization and the RTL's operations, with or without an ``act_dtype``,
and the full U-Net with ``quant_bits``, the int8 export's quantization).
The quantized full U-Net with an ``act_dtype`` is refused where the step
casts its batch (one device, ``shard_map``): the reference's ``_QuantConv``
cannot convolve a bf16 input with float32 kernels, so it cannot run it
either.
Checkpoints, resume, warm start, the EMA and validation work on any family,
through the module's own forward. ``fused_decoder`` trains the full U-Net
through the fused k = 2-pair decoder (``models/unet_infer.py``), and
``act_dtype``, ``matmul_precision`` and ``remat`` are the step's
(``wgan_gp.py``). ``debug_nans`` (the reference's ``jax_debug_nans``) runs
the steps under autograd's anomaly detection, which names the backward op
that first made a NaN, and raises ``FloatingPointError`` on the first step
whose metrics are not finite.

The reference's TPU layout settings (``trainer.py:193-252``):
``flat_step`` trains the standard mini pair through its flat ``[B, F]``
applies (``models/flat.py``; not with QAT, the RTL's operations or the full
family, and only on the single-device step), with ``premap`` (the dense
matrices built once per parameter value per loss), ``mm`` (``"ambient"``,
``"tf32x3"``, or ``"tf32x3_gp"``: the penalty chain alone on the bf16x3
products); ``mm`` and ``premap`` need ``flat_step``. ``conv_expand`` (the
reference's choice of the dense matrices' expansion, ``"dus"`` or
``"onehot"``) is accepted and changes nothing: the two forms give the same
matrices bit for bit, and the port builds the ``"onehot"`` form
(``ops/dense_conv.py``).
``use_pallas_datagen`` requires the datagen kernel's route and raises
outside its scope; without it the route is chosen by scope.
``critic_unroll`` (the reference's unroll of its critic scan, "pure
codegen, identical numerics") and ``prng`` (its bit generator, "the same
recipe statistics with a different stream") are accepted and change
nothing: eager and graphed steps have no scan to unroll, and the port's
draws always come from its Philox ``torch.Generator``s. The parallel
strategies refuse the flat step, ``use_pallas_datagen``, ``mm`` and
``critic_unroll`` as the reference's do.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import shutil
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from ..config import Config, datagen_config_from, loss_config_from
from ..device import resolve_device
from ..models import FullDiscriminator, FullUNetGenerator, MiniDiscriminator, MiniGenerator
from ..models.flat import STEP_MM_MODES, make_flat_step
from ..models.full_unet import unet_param_shardings
from ..models.generator import FP8_DTYPES, storage_dtype
from ..models.unet_infer import make_unet_infer_apply
from ..quant.export import export_any_generator
from ..utils.jax_params import from_jax_params, to_jax_params
from ..utils.logging import MetricsLogger
from ..utils import spans
from ..utils.params_io import load_params_tree, save_params_tree
from ..parallel import distributed
from ..parallel.mesh import ShardedTrainStep
from .chunks import EagerChunk, GraphedChunk, chunk_size
from .schedules import make_adam
from .wgan_gp import TrainStep, make_eval_step, require_datagen_kernel

NAN_POLICIES = ("restore_best", "raise", "ignore")
STRATEGIES = ("shard_map", "gspmd", "pp")
# the training metrics the reference logs, under its names (trainer.py:636-640)
TRAIN_LOG_KEYS = {"d_loss": "d_loss", "g_loss": "g_loss", "wasserstein": "wasserstein_distance",
                  "rec_loss": "rec_loss", "gp": "gradient_penalty"}


MODEL_FAMILIES = ("mini", "full")
PRNG_IMPLS = ("threefry", "rbg", "unsafe_rbg")   # the reference's; accepted, no effect
CONV_EXPANDS = ("dus", "onehot")                  # the reference's; accepted, no effect


def build_models(config: Config, family: str = "mini", seed: int = 0, act_dtype=None,
                 qat: bool = False, rtl_faithful: bool = False, quant_bits=None):
    """The generator and critic of ``family`` (``MODEL_FAMILIES``) for
    ``config``, initialised from ``seed`` on the CPU. ``act_dtype`` is the
    mini pair's activation storage (the full family has none: the step
    casts its batch, as the reference does). ``qat``/``rtl_faithful`` are
    the mini generator's modes, ``quant_bits`` (weight bits, activation
    bits) the full generator's."""
    if family not in MODEL_FAMILIES:
        raise ValueError(f"model family must be one of {MODEL_FAMILIES}, not {family!r}")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        if family == "full":
            f, L = config.full, config.frame_length
            wb, ab = quant_bits or (0, 0)
            return (FullUNetGenerator(frame_length=L, levels=f.levels,
                                      base_channels=f.base_channels, weight_bits=wb, act_bits=ab),
                    FullDiscriminator(frame_length=L, levels=f.levels,
                                      base_channels=f.base_channels))
        g, d = config.generator, config.discriminator
        return (MiniGenerator(enc1_channels=g.enc1_channels,
                              bottleneck_channels=g.bottleneck_channels,
                              dec1_channels=g.dec1_channels, leaky_slope=g.leaky_slope,
                              input_residual=g.input_residual, rtl_faithful=rtl_faithful,
                              qat=qat, act_dtype=act_dtype),
                MiniDiscriminator(conv1_channels=d.conv1_channels,
                                  conv2_channels=d.conv2_channels,
                                  leaky_slope=d.leaky_slope, act_dtype=act_dtype))


class Trainer:
    def __init__(self, config: Optional[Config] = None, nonlinear: bool = False,
                 pa_saturation: float = 0.8, samples_per_epoch: Optional[int] = None,
                 val_samples: int = 1_000, seed: int = 0,
                 device: str | torch.device | None = None, ema_decay: float = 0.0,
                 image_dir: Optional[str] = None, image_chunks: bool = False,
                 samples_per_image: int = 10, generator: Optional[torch.nn.Module] = None,
                 discriminator: Optional[torch.nn.Module] = None,
                 fused_decoder: bool = False, act_dtype=None,
                 matmul_precision: str = "float32", remat: bool = False,
                 debug_nans: bool = False, data_parallel: int = 0,
                 strategy: str = "shard_map", tensor_parallel: int = 1,
                 seq_parallel: int = 1, pipeline_parallel: int = 0, microbatches: int = 8,
                 scan_steps: Optional[int] = None, flat_step: bool = False,
                 mm: str = "ambient", premap: bool = False, conv_expand: str = "dus",
                 use_pallas_datagen: bool = False, critic_unroll: int = 1,
                 prng: str = "threefry"):
        """Runs on the GPU unless ``device`` says otherwise (``"cpu"``).
        ``scan_steps`` (default: the configuration's) sets the chunks, and
        ``ema_decay > 0`` keeps an EMA of the generator, updated after every
        chunk; ``image_dir`` trains on image-derived frames
        (``image_chunks``: the chunk dataset) instead of synthetic ones.
        ``generator``/``discriminator`` replace the mini pair built from
        ``seed``; ``fused_decoder`` (a float full U-Net only, float32 or
        bfloat16 ``act_dtype``) trains through the fused decoder. The
        parallel and layout settings are described in the module's docstring."""
        for value, allowed, name in ((mm, STEP_MM_MODES, "mm"), (conv_expand, CONV_EXPANDS,
                                                                  "conv_expand"),
                                     (prng, PRNG_IMPLS, "prng")):
            if value not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, not {value!r}")
        if critic_unroll < 1:
            raise ValueError(f"critic_unroll must be at least 1, not {critic_unroll}")
        self.device = resolve_device(device)
        self.config = config or Config()
        tr = self.config.training
        self.dg_cfg = datagen_config_from(self.config, nonlinear, pa_saturation)
        self.loss_cfg = loss_config_from(self.config)
        self.batch_size = tr.batch_size
        spe = samples_per_epoch or self.config.samples_per_epoch
        self.steps_per_epoch = max(1, spe // self.batch_size)
        self.scan_steps = chunk_size(self.steps_per_epoch, self.config.scan_steps
                                     if scan_steps is None else scan_steps)
        self.val_batches = max(1, val_samples // self.batch_size)

        act_dtype = storage_dtype(act_dtype)
        if generator is None or discriminator is None:
            mini_g, mini_d = build_models(self.config, "mini", seed, act_dtype)
            generator = mini_g if generator is None else generator
            discriminator = mini_d if discriminator is None else discriminator
        self.generator, self.critic = generator.to(self.device), discriminator.to(self.device)
        quantized = bool(getattr(self.generator, "weight_bits", 0)
                         or getattr(self.generator, "act_bits", 0))
        if quantized and act_dtype is not None and strategy not in ("gspmd", "pp"):
            # the step casts its batch to act_dtype, which the reference's
            # _QuantConv cannot take (full_unet.py:52-71)
            raise ValueError("the quantized full U-Net (quant_bits) cannot take an act_dtype "
                             "batch: the reference's _QuantConv convolves it with float32 "
                             "kernels, which lax.conv_general_dilated refuses (it requires "
                             "arguments to have the same dtypes), so the reference cannot run "
                             "it either")
        gen_forward = None
        if fused_decoder:
            # reference trainer.py:254-281
            if not isinstance(self.generator, FullUNetGenerator) or quantized:
                raise ValueError("fused_decoder is the float full-U-Net training forward "
                                 "(--model full)")
            if act_dtype in FP8_DTYPES:
                raise ValueError("fused_decoder supports float32 or bfloat16 activation "
                                 "storage (fp8 operands have no conv path)")
            gen_forward = make_unet_infer_apply(
                levels=self.generator.levels, leaky_slope=self.generator.leaky_slope,
                act_dtype=act_dtype or torch.float32)

        flat = None
        if flat_step:
            g, d = self.generator, self.critic
            if not (isinstance(g, MiniGenerator) and isinstance(d, MiniDiscriminator)
                    and not g.qat and not g.rtl_faithful):
                raise ValueError("flat_step supports the standard mini model family "
                                 "(float, tanh/residual head)")
            flat = make_flat_step(g, d, self.dg_cfg.frame_length, act_dtype, mm, premap)
        elif mm != "ambient":
            raise ValueError("mm requires flat_step")
        elif premap:
            raise ValueError("premap requires flat_step")

        self.image_dataset = self._image_dataset(image_dir, image_chunks, samples_per_image)
        batch_fn = self.image_dataset.sample_batch if self.image_dataset else None
        if use_pallas_datagen:
            require_datagen_kernel(self.dg_cfg, batch_fn)
        self.debug_nans = debug_nans
        self._fresh_optimizers()
        step_kw = dict(batch_fn=batch_fn, gen_forward=gen_forward, act_dtype=act_dtype,
                       matmul_precision=matmul_precision, remat=remat)
        layout = {"flat_step": flat_step, "use_pallas_datagen": use_pallas_datagen,
                  "mm": mm != "ambient", "critic_unroll": critic_unroll != 1}
        self.mesh = None
        self.step = self._parallel_step(strategy, data_parallel, tensor_parallel, seq_parallel,
                                        pipeline_parallel, microbatches, step_kw, layout)
        if self.step is None:
            self.step = TrainStep(self.generator, self.critic, self.opt_g, self.opt_d,
                                  self.dg_cfg, self.loss_cfg, self.batch_size, flat=flat,
                                  **step_kw)
        self.is_main_process = distributed.is_main_process()
        self._eval = make_eval_step(self.generator, self.dg_cfg, self.batch_size, batch_fn)
        self.rng = torch.Generator(device=self.device)
        self.rng.manual_seed(seed + 1)
        # the data-parallel step draws each step's seed from this host
        # generator, alike on every rank, and folds in its replica's index
        self.step_seeds = torch.Generator().manual_seed(seed + 1)
        self._step_rng = self.step_seeds if self.mesh is not None and \
            isinstance(self.step, ShardedTrainStep) else self.rng
        # the mini family's single-device step on the card: one CUDA graph a chunk
        self.graphed = (self.device.type == "cuda" and self.mesh is None and batch_fn is None
                        and not debug_nans and isinstance(self.generator, MiniGenerator)
                        and isinstance(self.critic, MiniDiscriminator))
        if self.graphed:
            self.opt_g.hold_on_device()
            self.opt_d.hold_on_device()
            self.chunk = GraphedChunk(self.step, self.rng, self.scan_steps)
        else:
            self.chunk = EagerChunk(self.step, self._step_rng, self.scan_steps)

        self.ema_decay = float(ema_decay)
        self.ema_generator: Optional[torch.nn.Module] = None
        if self.ema_decay > 0.0:
            self.ema_generator = copy.deepcopy(self.generator).requires_grad_(False)

        self.nan_policy = "restore_best"
        self.current_epoch = 0
        self.global_step = 0
        self.best_val_loss = math.inf
        self.logger: Optional[MetricsLogger] = None
        self._last_best_path: Optional[Path] = None

    def _image_dataset(self, image_dir, image_chunks, samples_per_image):
        """The image dataset of reference trainer.py:148-180, or None."""
        if not image_dir:
            return None
        from ..signal.image_ofdm import ImageOFDMChunkDataset, ImageOFDMDataset

        snr = (self.dg_cfg.snr_min, self.dg_cfg.snr_max)
        if image_chunks:
            ds = ImageOFDMChunkDataset(image_dir, chunk=self.dg_cfg.frame_length,
                                       snr_range=snr, samples_per_image=samples_per_image,
                                       device=self.device)
            print(f"Image CHUNK dataset: {len(ds.image_files)} images, "
                  f"{ds._chunks.shape[0]} chunks from {image_dir}")
            return ds
        c = self.config
        ds = ImageOFDMDataset(image_dir, frame_length=self.dg_cfg.frame_length,
                              modulation=c.modulation, n_subcarriers=c.num_subcarriers,
                              cp_length=c.cp_length, snr_range=snr,
                              channel_type=self.dg_cfg.channel.kind,
                              samples_per_image=samples_per_image, device=self.device)
        print(f"Image dataset: {len(ds.image_files)} images from {image_dir}")
        return ds

    def _parallel_step(self, strategy, data_parallel, tensor_parallel, seq_parallel,
                       pipeline_parallel, microbatches, step_kw, layout):
        """The step of ``strategy`` over a mesh of the process group's ranks,
        or ``None`` for the single-process step (reference
        ``trainer.py:282-392``). ``layout`` holds which of the TPU layout
        settings are set, which the parallel strategies refuse."""
        from ..parallel import (make_gspmd_train_step, make_mesh, make_pp_trainstate_step,
                                make_sharded_train_step, replicate_state)

        world = distributed.world_size()
        if strategy in ("gspmd", "pp"):
            for name, flag in layout.items():
                if flag:
                    raise ValueError(f"strategy={strategy!r} does not support {name}")
        if strategy == "gspmd":
            for flag, name in ((step_kw["remat"], "remat"),
                               (step_kw["batch_fn"] is not None, "image datasets")):
                if flag:
                    raise ValueError(f"strategy='gspmd' does not support {name}")
            if tensor_parallel > 1 and not isinstance(self.generator, FullUNetGenerator):
                raise ValueError("tensor_parallel > 1 requires the full U-Net family "
                                 "(--model full): the Megatron sharding rule keys on its "
                                 "layer names")
            if tensor_parallel > 1 and seq_parallel > 1:
                raise ValueError("sp x tp training is disabled, as in the JAX package (an XLA "
                                 "SPMD conv miscompile there): use dp x sp or dp x tp")
            if data_parallel == 0:
                data_parallel = max(1, world // (tensor_parallel * seq_parallel))
            axes = {"dp": data_parallel}
            if tensor_parallel > 1:
                axes["tp"] = tensor_parallel
            if seq_parallel > 1:
                axes["sp"] = seq_parallel
            self.mesh = make_mesh(axes)
            replicate_state((self.generator, self.critic))
            # the reference builds its GSPMD step without act_dtype
            # (trainer.py:323-330): the batch is not cast
            gspmd_kw = {k: v for k, v in step_kw.items() if k != "act_dtype"}
            return make_gspmd_train_step(
                self.generator, self.critic, self.opt_g, self.opt_d, self.dg_cfg,
                self.loss_cfg, self.batch_size, self.mesh,
                gen_tp_rule=unet_param_shardings if tensor_parallel > 1 else None, **gspmd_kw)
        if strategy == "pp":
            # act_dtype and matmul_precision are not passed on, as the
            # reference's trainer passes neither (trainer.py:337-366)
            for flag, name in ((step_kw["gen_forward"] is not None, "fused_decoder"),
                               (step_kw["batch_fn"] is not None, "image datasets")):
                if flag:
                    raise ValueError(f"strategy='pp' does not support {name}")
            if not isinstance(self.generator, FullUNetGenerator):
                raise ValueError("strategy='pp' requires the full U-Net family (--model full): "
                                 "the pipeline splits on its encode|decode stage seam")
            pp = pipeline_parallel if pipeline_parallel > 0 else min(world, 2)
            self.mesh = make_mesh({"pp": pp})
            replicate_state((self.generator,))
            return make_pp_trainstate_step(self.generator, self.opt_g, self.dg_cfg,
                                           self.loss_cfg, self.batch_size, microbatches,
                                           self.mesh, remat=step_kw["remat"])
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r} (expected one of {STRATEGIES})")
        if tensor_parallel > 1 or seq_parallel > 1:
            raise ValueError("tensor_parallel/seq_parallel require strategy='gspmd'")
        if data_parallel == 0:
            data_parallel = world
        if step_kw["remat"] and data_parallel > 1:
            raise ValueError("remat is wired for the single-device step; drop --remat with dp>1")
        if not distributed.is_initialized():
            if data_parallel > 1:
                raise RuntimeError(f"data_parallel={data_parallel} needs {data_parallel} ranks: "
                                   "launch with --local_devices, a coordinator or torchrun")
            return None
        if layout["flat_step"]:   # reference trainer.py:384-392, and so every flat mode here
            raise ValueError("the flat step (and mm='tf32x3_gp') is wired for the single-device "
                             "step; drop --flat with dp>1")
        self.mesh = make_mesh({"dp": data_parallel})
        replicate_state((self.generator, self.critic))
        return make_sharded_train_step(self.generator, self.critic, self.opt_g, self.opt_d,
                                       self.dg_cfg, self.loss_cfg, self.batch_size, self.mesh,
                                       **step_kw)

    def _fresh_optimizers(self) -> None:
        """New Adam states at schedule position 0. StepLR counts optimizer
        updates: G updates once per step, D n_critic times. A graphed chunk
        holds them on the device and is captured again."""
        tr = self.config.training
        decay_g = tr.scheduler_step * self.steps_per_epoch
        decay_d = decay_g * max(self.loss_cfg.n_critic, 1)
        self.opt_g = make_adam(self.generator.parameters(), tr.lr_generator, tr.betas,
                               decay_g, tr.scheduler_gamma)
        self.opt_d = make_adam(self.critic.parameters(), tr.lr_discriminator, tr.betas,
                               decay_d, tr.scheduler_gamma)
        if getattr(self, "graphed", False):
            self.opt_g.hold_on_device()
            self.opt_d.hold_on_device()
        if hasattr(self, "step"):
            self.step.set_optimizers(self.opt_g, self.opt_d)
        if hasattr(self, "chunk"):
            self.chunk.reset()

    def _gather_state(self) -> None:
        """The step's tensor-sharded generator state back into
        ``self.generator`` and ``self.opt_g`` (no-op for the other steps)."""
        gather = getattr(self.step, "gather_into", None)
        if gather is not None:
            gather(self.generator, self.opt_g)

    # ------------------------------------------------------------- training
    @torch.no_grad()
    def update_ema(self) -> None:
        """ema = d * ema + (1 - d) * generator, per parameter, with the
        chunk's decay d = ``ema_decay ** scan_steps`` (reference
        ``trainer.py:450-455``)."""
        d = self.ema_decay ** self.scan_steps
        for e, p in zip(self.ema_generator.parameters(), self.generator.parameters()):
            e.mul_(d).add_(p, alpha=1.0 - d)

    def _checked_chunk(self, first_step: int) -> Dict[str, torch.Tensor]:
        """A chunk step by step under anomaly detection, each step's metrics
        checked on the host (``debug_nans``)."""
        for i in range(self.scan_steps):
            with torch.autograd.detect_anomaly():
                metrics = self.step(self._step_rng)
            bad = [k for k, v in metrics.items() if not bool(torch.isfinite(v))]
            if bad:
                raise FloatingPointError(f"non-finite {bad} at step {first_step + i}: {metrics}")
        return metrics

    def train_epoch(self) -> Dict[str, float]:
        """Run one epoch in chunks; the metrics of the last chunk's last
        step, read once at the end."""
        metrics: Dict[str, torch.Tensor] = {}
        for c in range(self.steps_per_epoch // self.scan_steps):
            if self.debug_nans:
                metrics = self._checked_chunk(self.global_step + c * self.scan_steps)
            else:
                metrics = self.chunk()
            if self.ema_generator is not None:
                self._gather_state()
                self.update_ema()
        self._gather_state()
        self.global_step += self.steps_per_epoch
        return {k: float(v) for k, v in metrics.items()}

    def validate(self) -> Dict[str, float]:
        """Mean ``rec_loss``/``mse`` over the validation batches, and with an
        EMA ``rec_loss_ema``/``mse_ema`` on the same batches."""
        totals: Dict[str, float] = {}
        for _ in range(self.val_batches):
            for k, v in self._eval(self.rng, self.ema_generator).items():
                totals[k] = totals.get(k, 0.0) + float(v)
        return {k: v / self.val_batches for k, v in totals.items()}

    def profile_steps(self, n_chunks: int = 2, trace_dir: Optional[str] = None) -> str:
        """Trace ``n_chunks`` chunks, run step by step with spans on
        (``utils/spans.py``), with ``torch.profiler`` into a Chrome trace
        ``trace.json`` under ``trace_dir`` (default: the run's log
        directory's ``profile/``), in which the spans enclose their kernels;
        beside it ``spans.json``: the outer steps traced and each span
        name's self time an outer step, ``host_ms_per_step`` and, on the
        card, ``device_ms_per_step``. Returns the directory."""
        from torch.profiler import ProfilerActivity, profile

        trace_dir = Path(trace_dir or (self.logger.dir if self.logger
                                       else Path(self.config.log_dir)) / "profile")
        trace_dir.mkdir(parents=True, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        chunk = EagerChunk(self.step, self._step_rng, self.scan_steps)
        first = len(spans.records())
        spans.enable()
        try:
            with profile(activities=activities) as prof:
                for _ in range(n_chunks):
                    chunk()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        finally:
            spans.disable()
        prof.export_chrome_trace(str(trace_dir / "trace.json"))
        recs = spans.records()[first:]
        out = {"steps": n_chunks * self.scan_steps,
               "host_ms_per_step": spans.per_step_ms(recs, device=False)}
        if self.device.type == "cuda":
            out["device_ms_per_step"] = spans.per_step_ms(recs)
        (trace_dir / "spans.json").write_text(json.dumps(out, indent=2))
        return str(trace_dir)

    # ---------------------------------------------------------- checkpoints
    def save_champion(self, path: str | Path) -> None:
        """The generator as a JAX-format ``.npz`` champion (rank 0 writes it)."""
        if self.is_main_process:
            save_params_tree(str(path), to_jax_params(self.generator))

    def load_champion(self, path: str | Path) -> None:
        self._load_module(self.generator, Path(path))

    def save_checkpoint(self, path: str | Path, is_best: bool = False) -> None:
        """The full state into the directory ``path`` (replaced if present);
        ``is_best`` also copies it to ``best_model/`` beside it. Rank 0
        writes; every rank waits for it."""
        path = Path(path)
        if is_best:
            self._last_best_path = path.parent / "best_model"
        if self.is_main_process:
            self._write_checkpoint(path, is_best)
        distributed.barrier()

    def _write_checkpoint(self, path: Path, is_best: bool) -> None:
        if path.exists():
            shutil.rmtree(path)
        path.mkdir(parents=True)
        save_params_tree(str(path / "params_g.npz"), to_jax_params(self.generator))
        save_params_tree(str(path / "params_d.npz"), to_jax_params(self.critic))
        if self.ema_generator is not None:
            save_params_tree(str(path / "ema_params_g.npz"), to_jax_params(self.ema_generator))
        (opt_g, sched_g), (opt_d, sched_d) = self.opt_g.state_dict(), self.opt_d.state_dict()
        torch.save({"opt_g": opt_g, "sched_g": sched_g, "opt_d": opt_d, "sched_d": sched_d},
                   path / "optimizer.pt")
        sidecar = {"epoch": self.current_epoch, "global_step": self.global_step,
                   "best_val_loss": self.best_val_loss,
                   "config": dataclasses.asdict(self.config)}
        (path / "trainer_state.json").write_text(json.dumps(sidecar, indent=2))
        if is_best:
            best = path.parent / "best_model"
            if best.exists():
                shutil.rmtree(best)
            shutil.copytree(path, best)

    def _load_module(self, module: torch.nn.Module, path: Path) -> None:
        sd = from_jax_params(load_params_tree(str(path)))
        module.load_state_dict({k: v.to(self.device) for k, v in sd.items()})

    def init_params_from(self, path: str | Path) -> None:
        """Warm start: only the parameters of the checkpoint ``path``, with
        fresh optimizers at schedule position 0 (reference :553-566)."""
        path = Path(path)
        self._load_module(self.generator, path / "params_g.npz")
        self._load_module(self.critic, path / "params_d.npz")
        self._fresh_optimizers()
        if self.ema_generator is not None:
            self.ema_generator.load_state_dict(self.generator.state_dict())

    def init_generator_params(self, tree: Dict[str, Any]) -> None:
        """Warm start of the generator alone from a flax parameter tree (a
        ``.npz`` champion): the critic stays as it is, the optimizers start
        fresh at schedule position 0 (reference :568-580)."""
        sd = from_jax_params(tree)
        self.generator.load_state_dict({k: v.to(self.device) for k, v in sd.items()})
        self._fresh_optimizers()
        if self.ema_generator is not None:
            self.ema_generator.load_state_dict(self.generator.state_dict())

    def load_checkpoint(self, path: str | Path) -> None:
        """Resume: parameters, Adam moments, schedule positions, epoch,
        global step and best loss (reference :582-601). Without a saved EMA
        the EMA starts again from the restored generator."""
        path = Path(path)
        self._load_module(self.generator, path / "params_g.npz")
        self._load_module(self.critic, path / "params_d.npz")
        # loaded to the host: Adam moves the moments to the parameters' device
        # and keeps its step counts on the host, as it makes them
        state = torch.load(path / "optimizer.pt", map_location="cpu")
        self.opt_g.load_state_dict(state["opt_g"], state["sched_g"])
        self.opt_d.load_state_dict(state["opt_d"], state["sched_d"])
        if self.ema_generator is not None:
            if (path / "ema_params_g.npz").exists():
                self._load_module(self.ema_generator, path / "ema_params_g.npz")
            else:
                self.ema_generator.load_state_dict(self.generator.state_dict())
        sidecar = json.loads((path / "trainer_state.json").read_text())
        self.current_epoch = sidecar["epoch"]
        self.global_step = sidecar["global_step"]
        self.best_val_loss = sidecar["best_val_loss"]
        self.step.set_optimizers(self.opt_g, self.opt_d)
        self.chunk.reset()   # the optimizer's state tensors were replaced

    # ----------------------------------------------------------------- loop
    def train(self, epochs: Optional[int] = None,
              experiment_name: Optional[str] = None) -> List[Dict[str, float]]:
        """Train and return one record per epoch of the logged train and val
        metrics (kept as ``self.history``); then write the FPGA export unless
        the configuration's ``export_after_training`` is false."""
        if self.nan_policy not in NAN_POLICIES:
            raise ValueError(f"nan_policy must be one of {NAN_POLICIES}")
        tr = self.config.training
        epochs = epochs or tr.epochs
        main = self.is_main_process
        self.logger = MetricsLogger(self.config.log_dir, experiment_name) if main else None
        ckpt_dir = Path(self.config.checkpoint_dir)
        if main:
            ckpt_dir.mkdir(parents=True, exist_ok=True)
        history: List[Dict[str, float]] = []
        mesh = dict(zip(self.mesh.mesh_dim_names, self.mesh.shape)) if self.mesh else None
        print(f"Training for {epochs} epochs | batch {self.batch_size} | "
              f"{self.steps_per_epoch} steps/epoch (scan {self.scan_steps}, "
              f"{'graphed' if self.graphed else 'eager'}) | n_critic {self.loss_cfg.n_critic} | "
              f"gp {self.loss_cfg.gp_weight} | rec {self.loss_cfg.rec_weight} | "
              f"device {self.device} | datagen {self.step.datagen_route} | "
              f"critic {self.step.critic_route} | "
              f"precision {self.step.matmul_precision} | rank {distributed.rank()} of "
              f"{distributed.world_size()} | mesh {mesh}", flush=True)
        t0 = time.time()
        try:
            for epoch in range(self.current_epoch, epochs):
                self.current_epoch = epoch
                tm = self.train_epoch()
                if not all(math.isfinite(v) for v in tm.values()):
                    msg = f"non-finite training metrics at epoch {epoch}: {tm}"
                    if self.nan_policy == "raise":
                        raise FloatingPointError(msg)
                    print(f"FAILURE DETECTED: {msg}", flush=True)
                    if self.nan_policy == "restore_best":
                        if self._last_best_path is not None:
                            print(f"Restoring best checkpoint {self._last_best_path} and "
                                  "stopping.", flush=True)
                            self.load_checkpoint(self._last_best_path)
                        else:
                            print("No best checkpoint yet; stopping.", flush=True)
                        break
                vm = self.validate()
                logged = {k: tm[m] for k, m in TRAIN_LOG_KEYS.items()}
                if self.logger:
                    self.logger.log_scalars("train", logged, self.global_step)
                    self.logger.log_scalars("val", vm, epoch)
                history.append({**{f"train/{k}": v for k, v in logged.items()},
                                **{f"val/{k}": v for k, v in vm.items()}})
                ema_txt = f" | EMA L1 {vm['rec_loss_ema']:.4f}" if "rec_loss_ema" in vm else ""
                print(f"Epoch {epoch}: D {tm['d_loss']:.4f} G {tm['g_loss']:.4f} "
                      f"W {tm['wasserstein_distance']:.4f} L1 {tm['rec_loss']:.4f} | "
                      f"val L1 {vm['rec_loss']:.4f} MSE {vm['mse']:.4f}{ema_txt}", flush=True)
                # best-model tracking takes the EMA generator too (the
                # checkpoint carries both)
                val_best = min(vm["rec_loss"], vm.get("rec_loss_ema", math.inf))
                is_best = tr.save_best and val_best < self.best_val_loss
                if is_best:
                    self.best_val_loss = val_best
                    self.save_champion(ckpt_dir / "champion_params_g.npz")
                if is_best or (epoch + 1) % tr.checkpoint_interval == 0:
                    self.save_checkpoint(ckpt_dir / f"checkpoint_epoch_{epoch + 1}", is_best)
            self.save_checkpoint(ckpt_dir / "final_model")
            self.save_champion(ckpt_dir / "final_params_g.npz")
            if self.config.export_after_training and main:
                export_dir = Path(self.config.export_dir) / "generator"
                print(f"Exporting weights for FPGA to {export_dir} ...", flush=True)
                export_any_generator(self.generator, str(export_dir))
        finally:
            if self.logger:
                self.logger.close()
        print(f"Training complete in {time.time() - t0:.1f} s", flush=True)
        self.history = history
        return history
