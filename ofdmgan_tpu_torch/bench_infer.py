"""Serving throughput of the generator's forward alone:
``python -m ofdmgan_tpu_torch.bench_infer`` (counterpart of the repository's
``bench_infer.py``).

Both model families, at the reference's widths, with random weights from
seed 0:

* ``mini``: the 258-parameter 16-sample generator, its module forward with
  bfloat16 activations, batch ``--batch`` (65,536);
* ``full``: the 3,936,578-parameter 1024-sample U-Net through the fused
  serving forward (``models/unet_infer.py``: bfloat16 weights and
  activations), batch ``min(--batch // 64, 512)``; ``--unfused`` runs the
  module's forward in bfloat16 instead.

Frames come from the datagen kernel (``ops/datagen_kernel.synthetic_batch``:
AWGN, SNR 0 to 30 dB; both frame lengths are in its scope) inside the timed
loop, one launch per apply; ``--resident`` generates one batch before the
loop and chains the applies through a carry-dependent epsilon-add (each
input depends on the last output, so no apply can be skipped or hoisted).

Timing: a window is ``--scan_steps`` chained applies (256; the full model
half of it, at least 8), ended by ``torch.cuda.synchronize()`` and a host
read of a scalar that depends on the last output; 3 warm-up windows (cuDNN
builds its bf16 plans on the first calls), then the median of 5, in one
process. Prints, for each model, one line with the datagen kernel's
launches per window and the device's idle share of a window, then one
JSON line per model in the reference's format:

  {"metric": "generator_inference_frames_per_sec_per_chip", "model": ...,
   "value": N, "unit": "frames/s/chip", "input": ..., "vs_reference_fpga": N}

(the reference's FPGA estimate is 1e5 frames/s) with ``us_per_apply`` under
``--resident``. The idle share is one minus the device time of a profiled
window (``torch.profiler``, after one traced window that is dropped: the
profiler misses a trace's first kernel) over the median window's wall time;
``--profile_dir`` also writes that window's Chrome trace. Runs on the GPU
unless ``--device cpu`` (no idle share there).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

REFERENCE_FPGA_FRAMES_PER_SEC = 100_000.0
WARMUP_WINDOWS, TIMED_WINDOWS = 3, 5
FULL_MAX_BATCH = 512


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Window:
    """``scan_steps`` chained applies of ``apply`` on ``batch`` frames of
    length ``L``, from the datagen in the loop or from one resident batch."""

    def __init__(self, apply: Callable, batch: int, L: int, scan_steps: int, resident: bool,
                 dev: torch.device, act_dtype: torch.dtype):
        from .ops import datagen_kernel
        from .signal.datagen import DatagenConfig

        self.apply, self.batch, self.steps, self.resident = apply, batch, scan_steps, resident
        self.dev, self.act_dtype = dev, act_dtype
        self.gen = torch.Generator(device=dev).manual_seed(0)
        self.cfg = DatagenConfig(frame_length=L)
        self.make = lambda: datagen_kernel.synthetic_batch(  # noqa: E731
            self.gen, batch, self.cfg)["noisy"].to(act_dtype)
        self.base = self.make() if resident else None

    @torch.no_grad()
    def run(self) -> float:
        """One window; returns the host-read scalar (finite unless broken)."""
        acc = torch.zeros((), device=self.dev)
        carry = torch.zeros((), device=self.dev, dtype=self.act_dtype)
        for _ in range(self.steps):
            if self.resident:
                x = self.base + carry * 1e-12
                carry = self.apply(x).flatten()[0].to(self.act_dtype)
            else:
                acc = acc + self.apply(self.make()).flatten()[0].float()
        _sync(self.dev)
        return float(carry if self.resident else acc)

    def timed(self) -> float:
        t0 = time.perf_counter()
        value = self.run()
        dt = time.perf_counter() - t0
        if value != value:
            raise FloatingPointError("non-finite serving output")
        return dt


def device_ms(window: Window, trace_path: Optional[Path] = None) -> float:
    """Device milliseconds of one window, by ``torch.profiler``, after one
    traced and dropped window."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            window.run()
            prof.step()
    if trace_path is not None:
        trace_path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace_path))
    us = sum(float(getattr(e, "self_device_time_total", 0.0)) for e in prof.key_averages()
             if e.device_type != torch.autograd.DeviceType.CPU)
    return us / 1e3


def measure(window: Window, model: str, profile_dir: Optional[str]) -> Dict:
    """Frames/s of ``window`` (median of ``TIMED_WINDOWS`` after
    ``WARMUP_WINDOWS``), its datagen launches, and its idle share."""
    from .ops import datagen_kernel

    for _ in range(WARMUP_WINDOWS):
        window.timed()
    start = datagen_kernel.launches
    times = [window.timed() for _ in range(TIMED_WINDOWS)]
    launches = (datagen_kernel.launches - start) / TIMED_WINDOWS
    wall = statistics.median(times)
    fps = window.steps * window.batch / wall
    stats = {"model": model, "input": "resident" if window.resident else "datagen_in_loop",
             "datagen_launches_per_window": launches, "window_ms": wall * 1e3,
             "device_ms_per_window": None, "idle_share": None}
    if window.dev.type == "cuda":
        trace = Path(profile_dir) / f"{model}.json" if profile_dir else None
        dms = device_ms(window, trace)
        if dms > 0:   # else the profiler traced no kernel: not measured
            stats.update(device_ms_per_window=dms,
                         idle_share=max(0.0, 1.0 - dms / (wall * 1e3)))
    row = {"metric": "generator_inference_frames_per_sec_per_chip", "model": model,
           "value": round(fps, 1), "unit": "frames/s/chip", "input": stats["input"],
           "vs_reference_fpga": round(fps / REFERENCE_FPGA_FRAMES_PER_SEC, 1)}
    if window.resident:
        # the applies are serialised by the carry: window time / scan_steps
        # is the latency of one apply at this batch
        row["us_per_apply"] = round(1e6 * window.batch / fps, 3)
    return {"row": row, "stats": stats}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Generator serving throughput (frames/s)")
    ap.add_argument("--models", default="mini,full", help="comma list: mini, full")
    ap.add_argument("--batch", type=int, default=65_536,
                    help="mini batch per apply (full: batch // 64, at most 512)")
    ap.add_argument("--scan_steps", type=int, default=256,
                    help="chained applies per timed window (full: half, at least 8)")
    ap.add_argument("--resident", action="store_true",
                    help="one pre-generated batch on the device instead of the datagen in "
                         "the loop")
    ap.add_argument("--unfused", action="store_true",
                    help="full: the module's forward (upsample, then k=3 conv) instead of the "
                         "fused serving decoder")
    ap.add_argument("--profile_dir", default=None, metavar="DIR",
                    help="write a Chrome trace of one steady window per model")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def main(argv=None) -> list:
    """Bench as the flags say; returns ``{"row", "stats"}`` per model."""
    args = build_parser().parse_args(argv)
    from .device import resolve_device
    from .models import MiniGenerator
    from .models.full_unet import FullUNetGenerator
    from .models.unet_infer import make_unet_infer_apply

    dev = resolve_device(args.device)
    act = torch.bfloat16
    wanted = args.models.split(",")
    unknown = set(wanted) - {"mini", "full"}
    if unknown:
        raise SystemExit(f"unknown models {sorted(unknown)}: mini, full")
    results = []
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        mini = MiniGenerator(act_dtype=act).to(dev).eval()
        full = FullUNetGenerator().to(dev, act).eval()
    if "mini" in wanted:
        window = Window(mini, args.batch, 16, args.scan_steps, args.resident, dev, act)
        results.append(measure(window, "mini_258p_L16", args.profile_dir))
    if "full" in wanted:
        if args.unfused:
            apply, name = full, "full_unet_3.94Mp_L1024_unfused"
        else:
            serve = make_unet_infer_apply(levels=full.levels, act_dtype=act)
            apply, name = (lambda x: serve(full, x)), "full_unet_3.94Mp_L1024"
        fb = min(max(args.batch // 64, 1), FULL_MAX_BATCH)
        window = Window(apply, fb, full.frame_length, max(args.scan_steps // 2, 8),
                        args.resident, dev, act)
        results.append(measure(window, name, args.profile_dir))
    for r in results:
        print(json.dumps(r["stats"]), flush=True)
    for r in results:
        print(json.dumps(r["row"]), flush=True)
    return results


if __name__ == "__main__":
    main()
