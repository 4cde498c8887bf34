"""ctypes binding of the native fixed-point engine ``native/fixsim.cpp``
(counterpart of ``ofdmgan_tpu/verify/cosim.py``): an independent C++
implementation of the Q1.7/Q8.8 datapath, against which ``quant/intsim``
is held bit for bit.

The library is built at its first use with ``g++ -O2 -shared -fPIC`` into
``build/fixsim/libfixsim-<hash>.so`` at the root of the checkout, and again
whenever the source changes. A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from ..quant.rom_codegen import BIAS_DEPTH, WEIGHT_DEPTH

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "fixsim.cpp"
BUILD_DIR = REPO / "build" / "fixsim"
CXX_FLAGS = ("-O2", "-Wall", "-Wextra", "-fPIC", "-std=c++17", "-shared")
TIMEOUT_S = 120.0


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libfixsim-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is there; returns its path."""
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        try:
            proc = subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
                                   str(SOURCE)], capture_output=True, text=True,
                                  timeout=TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)   # atomic: each concurrent build writes its own tmp file
        finally:
            tmp.unlink(missing_ok=True)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    for name in ("fixsim_generator_forward_batch", "fixsim_generator_forward_res_batch"):
        getattr(lib, name).argtypes = [i8p, i16p, i16p, i16p, ctypes.c_int]
        getattr(lib, name).restype = None
    lib.fixsim_discriminator_forward_batch.argtypes = [i8p, i16p, i16p, i16p, i16p, ctypes.c_int]
    lib.fixsim_discriminator_forward_batch.restype = None
    return lib


def _frames(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, np.int16)
    if x.ndim != 3 or x.shape[1:] != (2, 16):
        raise ValueError(f"fixsim takes int16 frames [N, 2, 16], not {x.shape}")
    return x


def _roms(rom_w: np.ndarray, rom_b: np.ndarray):
    w, b = np.ascontiguousarray(rom_w, np.int8), np.ascontiguousarray(rom_b, np.int16)
    if w.shape != (WEIGHT_DEPTH,) or b.shape != (BIAS_DEPTH,):
        raise ValueError(f"ROM images must be [{WEIGHT_DEPTH}] and [{BIAS_DEPTH}], "
                         f"not {w.shape} and {b.shape}")
    return w, b


def generator_forward(rom_w: np.ndarray, rom_b: np.ndarray, x_ncl_q88: np.ndarray,
                      residual: bool = False) -> np.ndarray:
    """The generator on int16 Q8.8 frames ``[N, 2, 16]`` (channel-major) ->
    int16 ``[N, 2, 16]``; ``residual`` selects the saturating input add in
    place of the clamp (intsim's ``"rtl_residual"``)."""
    lib = load()
    w, b = _roms(rom_w, rom_b)
    x = _frames(x_ncl_q88)
    out = np.zeros_like(x)
    fn = lib.fixsim_generator_forward_res_batch if residual else lib.fixsim_generator_forward_batch
    fn(w, b, x, out, x.shape[0])
    return out


def discriminator_forward(rom_w: np.ndarray, rom_b: np.ndarray, cand_ncl_q88: np.ndarray,
                          cond_ncl_q88: np.ndarray) -> np.ndarray:
    """The critic on two int16 Q8.8 frame sets ``[N, 2, 16]`` -> int16 scores ``[N]``."""
    lib = load()
    w, b = _roms(rom_w, rom_b)
    cand, cond = _frames(cand_ncl_q88), _frames(cond_ncl_q88)
    if cand.shape != cond.shape:
        raise ValueError(f"candidate {cand.shape} and condition {cond.shape} differ")
    scores = np.zeros(cand.shape[0], np.int16)
    lib.fixsim_discriminator_forward_batch(w, b, cand, cond, scores, cand.shape[0])
    return scores
