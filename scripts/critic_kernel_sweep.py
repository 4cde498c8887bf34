"""Variants of the critic-gradient kernel (``csrc/critic_grad.cu``), built
and timed on the card in one process.

A variant is the kernel's source with some of its tuning constants replaced
(``WPB`` warps a block, ``BLOCKS_PER_SM`` in the launch bounds, ``X1S`` the
row stride of the layer-1 tiles) and its launches allowed more than 48 KB
of dynamic shared memory (eight warps a block at two frames a warp need
73 KB), built by nvcc with the library's flags into ``build/critic_sweep/``.
``--source FILE`` builds and times FILE as it is in place of the variants:
another version of the kernel, such as a parent commit's (a source whose
entry points take no frames a warp walks one frame a warp). Each build is
held against the plain version (``critic_grad_packed``) at every batch,
then timed: device microseconds a call of both stages (torch.profiler) at
the frames a warp the source picks and, for a source with both mappings,
at one and at two frames a warp; the resident blocks an SM by the
occupancy calculator; ptxas's registers and spilled bytes. Prints one JSON
line and writes it to ``--out``.

    python3 scripts/critic_kernel_sweep.py --batches 64 65536
    python3 scripts/critic_kernel_sweep.py --variants 4,2,12 4,3,12
    python3 scripts/critic_kernel_sweep.py --source build/parent/ofdmgan_tpu_torch/csrc/critic_grad.cu
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from ofdmgan_tpu_torch.models import MiniDiscriminator, MiniGenerator  # noqa: E402
from ofdmgan_tpu_torch.ops import build, critic_kernel as ck  # noqa: E402

OUT_DIR = ROOT / "build" / "critic_sweep"
NAMES = {"wpb": "WPB", "bps": "BLOCKS_PER_SM", "x1s": "X1S"}
# (warps a block, blocks an SM, layer-1 row stride); the first is the source's
VARIANTS = ((4, 2, 12), (4, 3, 12), (4, 4, 12), (8, 2, 12), (8, 1, 12), (4, 2, 8), (4, 3, 8))
# the source's limit of a block's tiles to 48 KB, and its two uses of the
# per-block kernel (the launch and the occupancy query), which a variant
# precedes with an allowance of the block's dynamic shared memory
TILE_LIMIT = r"\n\s*static_assert\(bytes <= 48 \* 1024[^;]*;"
KERNEL_USE = r"(\n(\s*)auto kernel = critic_grad_kernel<[^;]*;)"
ALLOW = (r"\1\n\2cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, "
         r"tile_bytes<F>());")


def variant_source(src: str, **values) -> str:
    """``src`` with the constants of ``values`` replaced (keys of ``NAMES``)
    and the tiles' 48 KB limit lifted."""
    for key, value in values.items():
        src, n = re.subn(rf"\b{NAMES[key]} = \d+([,;])", rf"{NAMES[key]} = {value}\1", src)
        if n != 1:
            raise ValueError(f"the source has no single {NAMES[key]} constant")
    src, n = re.subn(TILE_LIMIT, "", src)
    src, m = re.subn(KERNEL_USE, ALLOW, src)
    if n != 1 or m != 2:
        raise ValueError("the source has no single tile limit and two uses of the kernel")
    return src


def build_libraries(sources: dict) -> dict:
    """Compile each ``{name: text}`` with the library's flags, all at once:
    ``{name: (library, ptxas summary of its log)}``."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src, lib = OUT_DIR / f"{name}.cu", OUT_DIR / f"lib{name}.so"
        src.write_text(text)
        procs[name] = (lib, subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                                              str(src)], stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate(timeout=4 * build.TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        built[name] = (ctypes.CDLL(str(lib)), ck.ptxas_summary(log))
    return built


def launcher(lib: ctypes.CDLL):
    """(frames a warp for (B, sms), blocks for (B, sms, frames), launch(args
    without frames, frames), resident blocks an SM for frames, the mappings
    it has) of a library."""
    i, ll, f, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p
    frames_args = [ptr, ll, ll, ll] * 3 + [ptr] * 10
    if not hasattr(lib, "ofdm_critic_grad_frames_per_warp"):   # one frame a warp
        lib.ofdm_critic_grad_launch.argtypes = [i, i, f, f, i, i] + frames_args
        lib.ofdm_critic_grad_blocks.argtypes = [i, i]
        return (lambda b, sms: 1, lambda b, sms, frames: lib.ofdm_critic_grad_blocks(b, sms),
                lambda args, frames: lib.ofdm_critic_grad_launch(*args), lambda frames: None,
                (1,))
    lib.ofdm_critic_grad_launch.argtypes = [i, i, i, f, f, i, i] + frames_args
    lib.ofdm_critic_grad_frames_per_warp.argtypes = [i, i]
    lib.ofdm_critic_grad_blocks.argtypes = [i, i, i]
    lib.ofdm_critic_grad_blocks_per_sm.argtypes = [i]
    return (lib.ofdm_critic_grad_frames_per_warp, lib.ofdm_critic_grad_blocks,
            lambda args, frames: lib.ofdm_critic_grad_launch(*args[:2], frames, *args[2:]),
            lib.ofdm_critic_grad_blocks_per_sm, (1, 2))


def device_us(fn, n: int = 20) -> float:
    """Device microseconds a call of ``fn`` in kernels named ``critic_grad``."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    for _ in range(3):   # the card's profiler can lose a window's records
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = sum(float(getattr(e, "self_device_time_total", 0)) for e in prof.key_averages()
                 if "critic_grad" in e.key and e.device_type != torch.autograd.DeviceType.CPU)
        if us > 0:
            return us / n
    raise RuntimeError("the profiler traced no critic_grad kernel")


def inputs(b: int, dev, storage: bool):
    gen = torch.Generator(device=dev).manual_seed(b)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        critic, generator = MiniDiscriminator().to(dev), MiniGenerator().to(dev)
    clean = torch.randn(b, 16, 2, generator=gen, device=dev)
    noisy = clean + 0.3 * torch.randn(b, 16, 2, generator=gen, device=dev)
    alpha = torch.rand(b, generator=gen, device=dev)
    with torch.no_grad():
        fake = generator(noisy)
    if storage:
        clean, noisy = clean.bfloat16(), noisy.bfloat16()
    return critic, clean, fake, noisy, alpha


def measure(lib, b: int, dev, storage: bool, frames_list) -> dict:
    """Check the library against the plain version at batch ``b`` and time
    it at each mapping of ``frames_list`` (None: the library's choice)."""
    frames_of, blocks_of, launch, *_ = launcher(lib)
    critic, clean, fake, noisy, alpha = inputs(b, dev, storage)
    ref, _ = ck.critic_grad_packed(critic, clean, fake, noisy, alpha, 10.0)
    _fn, args, _out, keep = ck.prepare(critic, clean, fake, noisy, alpha, 10.0)
    args = list(args[:2]) + list(args[3:])   # without frames: (B, nblocks, slope, ...)
    sms = build.sm_count(dev)
    row = {}
    for frames in frames_list:
        fr = frames or frames_of(b, sms)
        nblocks = blocks_of(b, sms, fr)
        scratch = torch.empty(nblocks * 528, dtype=torch.float32, device=dev)
        out = torch.empty(526, dtype=torch.float32, device=dev)
        call = list(args)
        call[1], call[-3], call[-2] = nblocks, scratch.data_ptr(), out.data_ptr()
        if launch(call, fr) != 0:
            raise RuntimeError(f"launch failed at B={b}, frames {fr}")
        torch.cuda.synchronize()
        grads, _ = ck._split(out)
        for name, r in ref.items():
            torch.testing.assert_close(grads[name], r, rtol=1e-4,
                                       atol=1e-4 * float(r.abs().max()) + 1e-7)
        row["auto" if frames is None else f"frames_{fr}"] = {
            "frames": fr, "blocks": nblocks, "device_us": device_us(lambda: launch(call, fr))}
    del keep
    return row


def sweep(dev, batches, sources: dict, storage_forms=(False, True)) -> dict:
    """Build ``sources`` (``{name: text}``) and measure each at ``batches``
    and storage forms, at its own mapping and at each it has."""
    result = {}
    for name, (lib, ptxas) in build_libraries(sources).items():
        *_, resident, mappings = launcher(lib)
        row = {"ptxas": ptxas, "blocks_per_sm": {f: resident(f) for f in mappings}}
        for b in batches:
            frames_list = (None, *mappings) if len(mappings) > 1 else (None,)
            for storage in storage_forms:
                row[f"B{b}{'_storage' if storage else ''}"] = measure(lib, b, dev, storage,
                                                                      frames_list)
        result[name] = row
    return result


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batches", type=int, nargs="+", default=[64, 65536])
    p.add_argument("--variants", nargs="+", default=None, metavar="WPB,BPS,X1S",
                   help="variants to build (default: all of VARIANTS)")
    p.add_argument("--source", default=None,
                   help="a version of csrc/critic_grad.cu to build as it is, in place of the variants")
    p.add_argument("--out", default=str(OUT_DIR / "sweep.json"))
    a = p.parse_args()
    dev = torch.device("cuda", 0)
    if a.source:
        sources = {Path(a.source).stem: Path(a.source).read_text()}
    else:
        src = (build.CSRC / "critic_grad.cu").read_text()
        variants = VARIANTS if a.variants is None else [tuple(int(x) for x in v.split(","))
                                                        for v in a.variants]
        sources = {f"w{wpb}_b{bps}_x{x1s}": variant_source(src, wpb=wpb, bps=bps, x1s=x1s)
                   for wpb, bps, x1s in variants}
    result = {"device": torch.cuda.get_device_name(0), "variants": sweep(dev, a.batches, sources)}
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
