"""Build the CUDA kernels with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers) and is
compiled on its own into ``build/ofdmgan_tpu_torch/lib<name>-<hash>.so`` at
the root of the checkout, for ``sm_90a``. A library is built at its first use
and again whenever its source changes (the hash is of the source and the
flags). ``build()`` starts one nvcc per source, all at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

from ..utils import spans

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ofdmgan_tpu_torch"
SOURCES = ("datagen", "critic_grad", "generator_grad", "generator_forward")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
TIMEOUT_S = 120.0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every library in ``names`` that is missing; return each
    compiler log (ptxas registers, shared memory, spills), ``""`` for a
    library that was already built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs = {name: "" for name in names}
    procs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
            os.replace(tmp, out)
            logs[name] = log
    finally:
        for _, _, tmp, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return logs


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device; the launchers size their
    grids by it."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built first if needed; an
    ``ops.build`` span, kept with spans off too, times the build and the load."""
    with spans.setup_span("ops.build"):
        build([name])
        return ctypes.CDLL(str(library_path(name)))
