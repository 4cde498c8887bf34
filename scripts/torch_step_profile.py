#!/usr/bin/env python3
"""Outer-step time and device time by kernel for the PyTorch/CUDA port.

    python3 scripts/torch_step_profile.py [--steps 200] [--profile_steps 20]

Runs the mini CWGAN-GP outer step of ``ofdmgan_tpu_torch`` with the config
defaults (batch 64, n_critic 5) on one GPU, once through both CUDA kernels
and once through the plain path (autograd critic, FFT datagen). For each it
prints the wall time per outer step (host clock around ``--steps`` steps
ending in a synchronize, after 20 warm-up steps). For the kernel path it then
records ``--profile_steps`` steps with ``torch.profiler`` and prints the
device time per step by kernel name, and the device's idle share: one minus
the device time per step over the unprofiled wall time per step. Prints one
JSON object as its last line. Needs a GPU; it does not fall back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ofdmgan_tpu_torch.config import Config, datagen_config_from, loss_config_from  # noqa: E402
from ofdmgan_tpu_torch.device import resolve_device  # noqa: E402
from ofdmgan_tpu_torch.models import MiniDiscriminator, MiniGenerator  # noqa: E402
from ofdmgan_tpu_torch.training.schedules import make_adam  # noqa: E402
from ofdmgan_tpu_torch.training.wgan_gp import TrainStep  # noqa: E402


def make_step(dev, use_kernels: bool) -> TrainStep:
    cfg = Config()
    tr = cfg.training
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        g, d = MiniGenerator().to(dev), MiniDiscriminator().to(dev)
    return TrainStep(g, d, make_adam(g.parameters(), tr.lr_generator, tr.betas),
                     make_adam(d.parameters(), tr.lr_discriminator, tr.betas),
                     datagen_config_from(cfg), loss_config_from(cfg), tr.batch_size,
                     reference=not use_kernels)


def step_ms(step: TrainStep, rng: torch.Generator, n: int) -> float:
    for _ in range(20):
        step(rng)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        step(rng)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e3


def device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--profile_steps", type=int, default=20)
    args = p.parse_args()
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    rng = torch.Generator(device=dev).manual_seed(0)
    kern, plain = make_step(dev, True), make_step(dev, False)
    # plain, kernel, kernel, plain: the card's state drifts less between turns
    times = {"plain": [step_ms(plain, rng, args.steps)], "kernel": []}
    times["kernel"] += [step_ms(kern, rng, args.steps), step_ms(kern, rng, args.steps)]
    times["plain"].append(step_ms(plain, rng, args.steps))
    wall_ms = min(times["kernel"])

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.profile_steps):
            kern(rng)
        torch.cuda.synchronize()
    by_kernel = {}
    for evt in prof.key_averages():
        us = device_us(evt)
        # kernels and copies only: a user annotation (Optimizer.step#...)
        # spans kernels and the gaps between them
        if (us > 0 and evt.device_type != torch.autograd.DeviceType.CPU
                and not getattr(evt, "is_user_annotation", False) and "#" not in evt.key):
            by_kernel[evt.key] = us / args.profile_steps / 1e3
    if not by_kernel:
        # a profiler that traced no device time: say so rather than report 0
        by_kernel, device_ms, idle = None, None, None
    else:
        device_ms = sum(by_kernel.values())
        idle = 1.0 - device_ms / wall_ms
        ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1])
        by_kernel = {k: v for i, (k, v) in enumerate(ranked)
                     if i < 15 or "critic_stage" in k or "datagen_kernel" in k}
    print(card)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": card,
        "batch": 64, "n_critic": 5,
        "step_ms": times, "steps_per_s_kernel": 1e3 / wall_ms,
        "steps_per_s_plain": 1e3 / min(times["plain"]),
        "profiled_device_ms_per_step": device_ms, "device_idle_share": idle,
        "device_ms_per_step_by_kernel": by_kernel,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
