#!/usr/bin/env python3
"""Outer-step time and device time by kernel for the PyTorch/CUDA port.

    python3 scripts/torch_step_profile.py [--steps N] [--profile_steps 20]
        [--channel awgn|rayleigh|rician|multipath] [--nonlinear]
        [--model mini|full] [--fused_decoder] [--batch B]

Runs the CWGAN-GP outer step of ``ofdmgan_tpu_torch`` with the config
defaults (n_critic 5) on one GPU: the mini pair at batch 64 and L = 16, or
with ``--model full`` the full U-Net pair at full width, L = 1024 and batch
512 (the full recipe's), through the fused decoder with
``--fused_decoder``; ``--batch`` overrides the batch; ``--cudnn_benchmark``
lets cuDNN time its algorithms per shape. It runs over
``--channel`` (default the config's AWGN) with the nonlinear impairments if
``--nonlinear``: once with
the step's routes chosen by scope (each CUDA kernel where it covers the
configuration; ``routes`` in the output) and once through the plain path
(autograd critic, FFT datagen). For each it
prints the wall time per outer step (host clock around ``--steps`` steps
ending in a synchronize, after 20 warm-up steps, 3 for the full pair;
``--steps`` defaults to 200, 5 for the full pair). For the kernel path it
then records ``--profile_steps`` steps (20; 5 for the full pair) with
``torch.profiler`` (``utils/profiling.traced``: after one traced warm-up
step that it drops, taken again where the trace lost its device records),
and prints the device time per step by kernel name and the device's idle
share: one minus the device time per step over the unprofiled wall time
per step, and the device time by kind of kernel (``CATEGORIES``). It also
counts the ATen calls per step of both paths (``torch.profiler`` on the
host). Prints one
JSON object as its last line. Needs a GPU; it does not fall back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ofdmgan_tpu_torch.config import (FULL_FRAME_LENGTH, Config,  # noqa: E402
                                      datagen_config_from, loss_config_from)
from ofdmgan_tpu_torch.device import card_name, resolve_device  # noqa: E402
from ofdmgan_tpu_torch.models.unet_infer import make_unet_infer_apply  # noqa: E402
from ofdmgan_tpu_torch.training.schedules import make_adam  # noqa: E402
from ofdmgan_tpu_torch.training.trainer import build_models  # noqa: E402
from ofdmgan_tpu_torch.training.wgan_gp import TrainStep  # noqa: E402
from ofdmgan_tpu_torch.utils.profiling import device_ms_by_kernel, traced  # noqa: E402


# device time by kind of kernel, by the first words its name holds
CATEGORIES = (("datagen_kernel", ("datagen_kernel",)), ("critic_grad", ("critic_grad",)),
              ("adam", ("adam", "multi_tensor")),
              ("conv", ("conv", "cudnn", "xmma", "gemm", "implicit", "wgrad", "dgrad",
                        "sm90", "cutlass", "winograd", "fft")),
              ("copy_and_elementwise", ("elementwise", "copy", "memcpy", "memset", "fill",
                                        "reduce", "index", "cat", "pad")))


def make_step(dev, use_kernels: bool, args) -> TrainStep:
    full = args.model == "full"
    cfg = Config(channel_type=args.channel, frame_length=FULL_FRAME_LENGTH if full else 16)
    tr = cfg.training
    g, d = build_models(cfg, args.model, seed=0)
    g, d = g.to(dev), d.to(dev)
    fwd = (make_unet_infer_apply(levels=g.levels, act_dtype=torch.float32)
           if args.fused_decoder else None)
    return TrainStep(g, d, make_adam(g.parameters(), tr.lr_generator, tr.betas),
                     make_adam(d.parameters(), tr.lr_discriminator, tr.betas),
                     datagen_config_from(cfg, args.nonlinear), loss_config_from(cfg), args.batch,
                     reference=not use_kernels, gen_forward=fwd)


def step_ms(step: TrainStep, rng: torch.Generator, n: int, warmup: int) -> float:
    for _ in range(warmup):
        step(rng)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        step(rng)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e3


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=None, help="timed steps (200; full: 5)")
    p.add_argument("--profile_steps", type=int, default=None, help="(20; full: 5)")
    p.add_argument("--channel", default="awgn", choices=["awgn", "rayleigh", "rician", "multipath"])
    p.add_argument("--nonlinear", action="store_true", help="PA + IQ + phase-noise impairments")
    p.add_argument("--model", default="mini", choices=["mini", "full"])
    p.add_argument("--fused_decoder", action="store_true", help="--model full: fused decoder")
    p.add_argument("--batch", type=int, default=None, help="batch (64; full: 512)")
    p.add_argument("--cudnn_benchmark", action="store_true",
                   help="let cuDNN time its algorithms for each shape (torch.backends.cudnn."
                        "benchmark) instead of taking its heuristics' choice")
    args = p.parse_args()
    if args.fused_decoder and args.model != "full":
        p.error("--fused_decoder needs --model full")
    full = args.model == "full"
    args.batch = args.batch or (512 if full else 64)
    args.steps = args.steps or (5 if full else 200)
    args.profile_steps = args.profile_steps or (5 if full else 20)
    warmup = 3 if full else 20
    dev = resolve_device("cuda")
    torch.backends.cudnn.benchmark = args.cudnn_benchmark
    card = card_name(dev)
    rng = torch.Generator(device=dev).manual_seed(0)
    kern = make_step(dev, True, args)
    plain = make_step(dev, False, args)
    # plain, kernel, kernel, plain: the card's state drifts less between turns
    times = {"plain": [step_ms(plain, rng, args.steps, warmup)], "kernel": []}
    times["kernel"] += [step_ms(kern, rng, args.steps, warmup) for _ in range(2)]
    times["plain"].append(step_ms(plain, rng, args.steps, warmup))
    wall_ms = min(times["kernel"])

    from torch.profiler import ProfilerActivity, profile

    def aten_calls_per_step(step: TrainStep) -> float:
        with profile(activities=[ProfilerActivity.CPU]) as p:
            for _ in range(args.profile_steps):
                step(rng)
            torch.cuda.synchronize()
        calls = sum(e.count for e in p.key_averages() if e.key.startswith("aten::"))
        return calls / args.profile_steps

    aten_calls = {"kernel": aten_calls_per_step(kern), "plain": aten_calls_per_step(plain)}
    by_kernel = device_ms_by_kernel(traced(lambda: kern(rng), args.profile_steps),
                                    args.profile_steps)
    if not by_kernel:
        # a profiler that traced no device time: say so rather than report 0
        by_kernel, by_category, device_ms, idle = None, None, None, None
    else:
        by_category = {}
        for k, v in by_kernel.items():
            cat = next((c for c, words in CATEGORIES if any(w in k.lower() for w in words)),
                       "other")
            by_category[cat] = by_category.get(cat, 0.0) + v
        device_ms = sum(by_kernel.values())
        idle = 1.0 - device_ms / wall_ms
        by_kernel = {k: v for i, (k, v) in enumerate(by_kernel.items())
                     if i < 15 or "critic_grad" in k or "datagen_kernel" in k}
    print(card)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": card,
        "model": args.model, "fused_decoder": args.fused_decoder,
        "cudnn_benchmark": args.cudnn_benchmark,
        "frame_length": kern.dg_cfg.frame_length,
        "batch": args.batch, "n_critic": 5, "channel": args.channel, "nonlinear": args.nonlinear,
        "routes": {"datagen": kern.datagen_route, "critic": kern.critic_route,
                   "generator": kern.generator_route, "forward": kern.forward_route},
        "step_ms": times, "steps_per_s_kernel": 1e3 / wall_ms,
        "steps_per_s_plain": 1e3 / min(times["plain"]),
        "aten_calls_per_step": aten_calls,
        "profiled_device_ms_per_step": device_ms, "device_idle_share": idle,
        "device_ms_per_step_by_category": by_category,
        "device_ms_per_step_by_kernel": by_kernel,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
