"""CWGAN-GP training CLI of the port: ``python -m ofdmgan_tpu_torch.train``.

Counterpart of the repository's ``train.py``, with its flags and meanings:
the model family (``--model mini`` or ``full``: the 1024-sample U-Net, whose
frame length defaults to 1024; ``--fused_decoder`` trains it through the
fused decoder, at float32 too), the step's numerics (``--act_dtype``,
``--matmul_precision``), any channel (``--channel``), frame length
(``--frame_length``), the nonlinear impairments (``--nonlinear``), image
data (``--image_dir``, ``--image_chunks``), resume (``--resume``), warm start
(``--init_from``: a checkpoint directory, or a generator ``.npz``), an EMA
of the generator (``--ema``), a profiler trace (``--profile N``),
recomputed activations (``--remat``), a NaN trap (``--debug_nans``) and
the synthetic data source, the default (``--synthetic``);
quantization-aware training (``--qat``; ``--rtl_qat``, the RTL's own
operations under QAT, with ``--residual`` the RTL-residual datapath;
``--quant_bits W A`` for the full U-Net) and the FPGA export that ends
every run (``--export_dir``, ``--skip_export``), or the export alone of a
checkpoint (``--export_only --export_checkpoint DIR or G.npz``). Runs on
the GPU unless ``--device cpu`` (the export alone runs on the host).

Several ranks train together with the reference's flags: ``--strategy``
(``shard_map``, the explicit data-parallel step over ``--dp`` ranks;
``gspmd``, the global step over ``--dp`` x ``--tp`` x ``--sp``; ``pp``, the
GPipe pipeline over ``--pp`` stages with ``--microbatches``). The ranks come
from ``--local_devices N`` (this launch spawns N ranks on this host: gloo
with ``--device cpu``), from ``--coordinator host:port --num_processes P
--process_id I`` (a rendezvous of P launches, each with ``--local_devices``
ranks or one), or from torchrun's environment; rank 0 alone writes
checkpoints, metrics and the export.

The reference's TPU layout flags, with its defaults: ``--scan_steps N``
(outer steps per dispatched chunk; 0, the default, picks the reference's
chunk; on the card the mini step runs each chunk as one CUDA graph),
``--flat`` (the mini pair's flat ``[B, F]`` step) with ``--premap``, ``--mm
{ambient,tf32x3,tf32x3_gp}``, ``--pallas_datagen`` (require the datagen
kernel's route), ``--platform {cpu,gpu,cuda}`` (an alias of ``--device``),
and ``--conv_expand {dus,onehot}``, ``--critic_unroll N`` and ``--prng
{threefry,rbg,unsafe_rbg}``, which are accepted and change nothing
(``training/trainer.py`` says why).
Without ``--config`` it uses the defaults of ``config/config.yaml``; with
it, the YAML file (needs PyYAML).
"""

from __future__ import annotations

import argparse
import dataclasses


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the CWGAN-GP (PyTorch/CUDA port)")
    p.add_argument("--config", default=None, help="reference-format YAML config")
    p.add_argument("--model", choices=["mini", "full"], default="mini",
                   help="model family: mini (16-sample, 258 parameters) or the full "
                        "1024-sample 5-level U-Net (3.94M parameters)")
    p.add_argument("--fused_decoder", action="store_true",
                   help="--model full: train through the fused k=2-pair decoder "
                        "(8 instead of 12 Cin*Cout*L decoder multiply-adds, no upsampled "
                        "activation; slower than the unfused forward on the H100); "
                        "float32 or --act_dtype bfloat16")
    p.add_argument("--act_dtype", default=None, choices=["bfloat16", "float8_e4m3fn",
                                                         "float8_e5m2"],
                   help="activation storage format of the step (parameters, products "
                        "and optimizer state stay float32)")
    p.add_argument("--matmul_precision", default="float32",
                   choices=["float32", "tensorfloat32", "bfloat16", "bf16_tf32gp",
                            "bf16_f32gp"],
                   help="the step's numerics (float32, the default, keeps TF32 off; the "
                        "bf16_*gp modes keep the gradient penalty at TF32 or float32)")
    p.add_argument("--qat", action="store_true", help="quantization-aware training (mini)")
    p.add_argument("--rtl_qat", action="store_true",
                   help="train against the RTL's op semantics with QAT (mini)")
    p.add_argument("--quant_bits", type=int, nargs=2, default=None,
                   metavar=("WEIGHT_BITS", "ACT_BITS"),
                   help="--model full: quantization-aware training under the int8 export "
                        "semantics")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None, help="learning rate of both nets")
    p.add_argument("--lr_d", type=float, default=None,
                   help="critic learning rate (after --lr)")
    p.add_argument("--n_critic", type=int, default=None)
    p.add_argument("--adv_weight", type=float, default=None)
    p.add_argument("--rec_weight", type=float, default=None, help="L1 reconstruction weight")
    p.add_argument("--lr_step", type=int, default=None, help="StepLR interval in epochs")
    p.add_argument("--lr_gamma", type=float, default=None, help="StepLR decay factor")
    p.add_argument("--channel", default=None, choices=["awgn", "rayleigh", "rician", "multipath"],
                   help="training channel (default: the config's channel_type)")
    p.add_argument("--frame_length", type=int, default=None, help="samples per frame")
    p.add_argument("--samples_per_epoch", type=int, default=None)
    p.add_argument("--val_samples", type=int, default=1000)
    p.add_argument("--residual", action="store_true", help="input-residual generator head")
    p.add_argument("--nonlinear", action="store_true", help="PA + IQ + phase-noise impairments")
    p.add_argument("--pa_saturation", type=float, default=0.8)
    p.add_argument("--image_dir", default=None,
                   help="train on image-derived OFDM frames from this directory")
    p.add_argument("--image_chunks", action="store_true",
                   help="with --image_dir: every aligned chunk of the whole transmissions, "
                        "normalised by the noisy chunk's maximum")
    p.add_argument("--resume", default=None, help="checkpoint directory to resume from")
    p.add_argument("--init_from", default=None,
                   help="warm start with fresh optimizers: a checkpoint directory (both "
                        "nets) or a generator .npz (the generator alone)")
    p.add_argument("--ema", type=float, default=0.0, metavar="DECAY",
                   help="keep an EMA of the generator with this decay per step (0: off)")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic OFDM frames, the default data source unless --image_dir")
    p.add_argument("--remat", action="store_true",
                   help="recompute the model applies' activations in the backward instead of "
                        "keeping them (torch.utils.checkpoint; the same function)")
    p.add_argument("--debug_nans", action="store_true",
                   help="autograd anomaly detection, and stop at the first step whose "
                        "metrics are not finite")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="trace N outer steps with torch.profiler before training")
    p.add_argument("--skip_export", action="store_true",
                   help="write no FPGA export after training")
    p.add_argument("--export_dir", default=None,
                   help="the FPGA export's directory (default: the config's, ./export)")
    p.add_argument("--export_only", action="store_true",
                   help="only export --export_checkpoint's generator, without training")
    p.add_argument("--export_checkpoint", default=None,
                   help="with --export_only: a checkpoint directory (its params_g.npz) or a "
                        "generator .npz")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--log_dir", default=None)
    p.add_argument("--experiment", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--platform", default=None, choices=sorted(PLATFORMS),
                   help="the reference's platform flag: an alias of --device (gpu = cuda)")
    p.add_argument("--scan_steps", type=int, default=None,
                   help="outer steps per dispatched chunk (0: min(steps per epoch, 32), "
                        "lowered until it divides the epoch; default: the config's); the "
                        "EMA is updated once per chunk")
    p.add_argument("--pallas_datagen", action="store_true",
                   help="require the datagen kernel's route (the AWGN channel, linear or the "
                        "default nonlinear chain); without it the route is chosen by scope")
    p.add_argument("--flat", action="store_true",
                   help="mini model only: train with the flat-layout [B, F] applies (folded "
                        "upsample/concat/pool); the batches come from the same datagen as "
                        "without it; checkpoints, eval and export are unchanged")
    p.add_argument("--mm", default="ambient", choices=["ambient", "tf32x3", "tf32x3_gp"],
                   help="the flat step's products (requires --flat): tf32x3 = every model "
                        "product on the bf16x3 decomposition, tf32x3_gp = the gradient-penalty "
                        "chain's alone")
    p.add_argument("--premap", action="store_true",
                   help="build the flat step's dense matrices once per parameter value per "
                        "loss (requires --flat)")
    p.add_argument("--conv_expand", default="dus", choices=["dus", "onehot"],
                   help="the reference's dense-matrix expansion; accepted, no effect here "
                        "(both forms give the same matrices bit for bit)")
    p.add_argument("--critic_unroll", type=int, default=1,
                   help="the reference's unroll of its critic scan; accepted, no effect here")
    p.add_argument("--prng", default="threefry", choices=["threefry", "rbg", "unsafe_rbg"],
                   help="the reference's bit generator; accepted, the draws here are always "
                        "Philox torch.Generator streams")
    p.add_argument("--nan_policy", choices=["restore_best", "raise", "ignore"],
                   default="restore_best")
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel mesh size (0 or unset: every rank)")
    p.add_argument("--strategy", choices=["shard_map", "gspmd", "pp"], default="shard_map",
                   help="multi-rank strategy: shard_map = the explicit data-parallel step "
                        "(default); gspmd = the global step over dp x tp x sp; pp = the GPipe "
                        "pipeline of the full U-Net's supervised path (--model full "
                        "--n_critic 0 --adv_weight 0)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel mesh size (Megatron sharding of the U-Net's "
                        "kernels; --strategy gspmd --model full)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel mesh size (frame-length-sharded activations with "
                        "halo exchanges; --strategy gspmd --model full)")
    p.add_argument("--pp", type=int, default=0,
                   help="pipeline stages (the U-Net splits into 2; 0 = min(ranks, 2); "
                        "--strategy pp)")
    p.add_argument("--microbatches", type=int, default=8,
                   help="GPipe microbatches per step for --strategy pp (they divide the batch)")
    p.add_argument("--coordinator", default=None,
                   help="rendezvous address host:port of a multi-launch run")
    p.add_argument("--num_processes", type=int, default=None,
                   help="launches in the rendezvous")
    p.add_argument("--process_id", type=int, default=None, help="this launch's index")
    p.add_argument("--local_devices", type=int, default=None,
                   help="spawn this many ranks on this host (gloo with --device cpu)")
    return p


PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def check_args(parser: argparse.ArgumentParser, args) -> None:
    """The reference's refusals (train.py:274-276, 329-343), and
    ``--platform`` folded into ``--device``."""
    if args.platform is not None:
        kind = PLATFORMS[args.platform]
        if args.device is not None and args.device.split(":")[0] != kind:
            parser.error(f"--platform {args.platform} conflicts with --device {args.device}")
        args.device = args.device or kind
    full = args.model == "full"
    if args.residual and full:
        parser.error("--residual applies to the mini generator")
    if (args.qat or args.rtl_qat) and full:
        parser.error("--qat/--rtl_qat apply to the mini (ROM-deployable) model only")
    if args.fused_decoder and not full:
        parser.error("--fused_decoder is the full U-Net's training forward (--model full)")
    if args.fused_decoder and args.act_dtype not in (None, "bfloat16"):
        parser.error("--fused_decoder supports float32 or --act_dtype bfloat16 (fp8 "
                     "operands have no conv path)")
    if args.quant_bits and not full:
        parser.error("--quant_bits applies to the full model (mini QAT is --qat/--rtl_qat)")


def config_from_args(args):
    """The run's ``Config``: the file or the defaults, then the flags."""
    from .config import FULL_FRAME_LENGTH, Config, load_config

    frame_length = args.frame_length
    if frame_length is None and args.model == "full":
        frame_length = FULL_FRAME_LENGTH
    cfg = load_config(args.config) if args.config else Config()
    tr = cfg.training
    lr_d = args.lr_d if args.lr_d is not None else args.lr
    tr = dataclasses.replace(tr, **{k: v for k, v in dict(
        epochs=args.epochs, batch_size=args.batch_size, n_critic=args.n_critic,
        adversarial_weight=args.adv_weight, reconstruction_weight=args.rec_weight,
        scheduler_step=args.lr_step, scheduler_gamma=args.lr_gamma,
        lr_generator=args.lr, lr_discriminator=lr_d).items() if v is not None})
    cfg = dataclasses.replace(cfg, training=tr, **{k: v for k, v in dict(
        checkpoint_dir=args.checkpoint_dir, log_dir=args.log_dir, channel_type=args.channel,
        frame_length=frame_length, export_dir=args.export_dir).items() if v is not None})
    if args.skip_export:
        cfg = dataclasses.replace(cfg, export_after_training=False)
    if args.residual:
        cfg = dataclasses.replace(
            cfg, generator=dataclasses.replace(cfg.generator, input_residual=True))
    return cfg


def main(argv=None):
    """Train as the flags say; returns the trainer (``None`` with
    ``--export_only``; with ``--local_devices``, each spawned rank's
    ``rank_summary``)."""
    import os

    parser = build_parser()
    args = parser.parse_args(argv)
    check_args(parser, args)
    cfg = config_from_args(args)
    if args.export_only:   # reference train.py:276-302
        from .quant.export import export_generator_checkpoint

        print(f"Exporting weights from checkpoint: {args.export_checkpoint}")
        print(f"Writing to: {cfg.export_dir}/generator")
        export_generator_checkpoint(args.export_checkpoint, cfg.export_dir)
        print("Export complete.")
        return None
    from .parallel import distributed

    if args.local_devices:
        return distributed.launch(
            _train_rank, args.local_devices, (argv,), device=args.device or "cuda",
            coordinator=args.coordinator, num_processes=args.num_processes,
            process_id=args.process_id, timeout_s=None)
    if args.coordinator or args.num_processes or "RANK" in os.environ:
        device = distributed.initialize(args.coordinator, args.num_processes, args.process_id,
                                        device=args.device)
        try:
            return train(args, cfg, device)
        finally:
            distributed.shutdown()
    return train(args, cfg, args.device)


def _train_rank(argv):
    """One spawned rank of ``--local_devices``: train, then return its
    ``rank_summary``."""
    import torch

    parser = build_parser()
    args = parser.parse_args(argv)
    check_args(parser, args)
    device = "cpu" if args.device == "cpu" else torch.device("cuda", torch.cuda.current_device())
    return rank_summary(train(args, config_from_args(args), device))


def rank_summary(trainer) -> dict:
    """A rank's final state: its rank, whether it wrote the files, both
    nets' parameters (JAX layout) and the last epoch's logged metrics."""
    from .parallel import distributed
    from .utils.jax_params import to_jax_params
    from .utils.params_io import flatten_tree

    return {"rank": distributed.rank(), "is_main_process": trainer.is_main_process,
            "params_g": flatten_tree(to_jax_params(trainer.generator)),
            "params_d": flatten_tree(to_jax_params(trainer.critic)),
            "history": trainer.history}


def train(args, cfg, device):
    """Build the models and the trainer on ``device`` and train."""
    from .models import count_parameters
    from .training.trainer import Trainer, build_models
    from .utils.params_io import load_params_tree

    generator, critic = build_models(cfg, args.model, args.seed, args.act_dtype,
                                     qat=args.qat or args.rtl_qat, rtl_faithful=args.rtl_qat,
                                     quant_bits=args.quant_bits)
    trainer = Trainer(cfg, nonlinear=args.nonlinear,
                      pa_saturation=args.pa_saturation,
                      samples_per_epoch=args.samples_per_epoch, val_samples=args.val_samples,
                      seed=args.seed, device=device, ema_decay=args.ema,
                      image_dir=args.image_dir, image_chunks=args.image_chunks,
                      generator=generator, discriminator=critic,
                      fused_decoder=args.fused_decoder, act_dtype=args.act_dtype,
                      matmul_precision=args.matmul_precision, remat=args.remat,
                      debug_nans=args.debug_nans, data_parallel=args.dp or 0,
                      strategy=args.strategy, tensor_parallel=args.tp, seq_parallel=args.sp,
                      pipeline_parallel=args.pp, microbatches=args.microbatches,
                      scan_steps=args.scan_steps, flat_step=args.flat, mm=args.mm,
                      premap=args.premap, conv_expand=args.conv_expand,
                      use_pallas_datagen=args.pallas_datagen,
                      critic_unroll=args.critic_unroll, prng=args.prng)
    trainer.nan_policy = args.nan_policy
    print(f"Generator parameters: {count_parameters(trainer.generator):,}")
    print(f"Discriminator parameters: {count_parameters(trainer.critic):,}")
    if args.resume:
        print(f"Resuming from {args.resume}")
        trainer.load_checkpoint(args.resume)
    elif args.init_from:
        if args.init_from.endswith(".npz"):
            print(f"Warm-starting the generator from {args.init_from} (fresh optimizers)")
            trainer.init_generator_params(load_params_tree(args.init_from))
        else:
            print(f"Warm-starting both nets from {args.init_from} (fresh optimizers)")
            trainer.init_params_from(args.init_from)
    if args.profile:
        print(f"Profiler trace written to {trainer.profile_steps(args.profile)}")
    trainer.train(experiment_name=args.experiment)
    return trainer


if __name__ == "__main__":
    main()
