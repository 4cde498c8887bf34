"""Synthetic-batch datagen: the CUDA kernel ``csrc/datagen.cu`` and its plain
PyTorch version.

Counterpart of ``ofdmgan_tpu/ops/pallas_datagen.py:200-274``. Scope is the
TPU kernel's: the AWGN channel, linear or with the default nonlinear chain
(Rapp PA -> IQ imbalance -> Wiener phase noise). Both functions return
``noisy``/``clean`` ``[B, L, 2]`` jointly max-normalized, ``snr`` ``[B]`` and
``scale`` ``[B]``, the per-frame normaliser (the pre-normalisation frames are
the outputs times ``scale``).

A CUDA tensor or generator goes to the kernel; a CPU one to the plain
version, which repeats the kernel's arithmetic step by step from the same
draws (standard normals ``zr``, ``zi``, ``pn``, ``nr``, ``ni`` ``[B, L]`` and
uniforms ``u`` ``[B]``). Frame lengths: every ``L`` that the TPU kernel
takes (``pallas_datagen._pack``: the divisors of 128 and the multiples of
128) from 2 up to ``MAX_LENGTH``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict

import numpy as np
import torch

from . import build
from ..signal.datagen import DatagenConfig, make_draws

MAX_LENGTH = 1024
DRAW_KEYS = ("zr", "zi", "pn", "nr", "ni")
# kernel launches run since the caller last set it to 0; a launch captured
# into a CUDA graph is not counted: it runs at the graph's replays, which
# call no wrapper (a profiler's trace counts those)
launches = 0


def _covers_recipe(cfg: DatagenConfig) -> bool:
    imp = cfg.impairments
    return cfg.channel.kind == "awgn" and not (cfg.nonlinear and (
        imp.pa_model != "rapp" or not imp.pa_enabled or not imp.iq_enabled
        or not imp.phase_noise_enabled or imp.dc_enabled or imp.cfo_enabled))


def covers(cfg: DatagenConfig) -> bool:
    """Whether the kernel computes ``cfg``'s batches: the AWGN channel, linear
    or with the default nonlinear chain (the test of ``wgan_gp.py:282-293``),
    at a length ``supports_length`` takes."""
    return _covers_recipe(cfg) and supports_length(cfg.frame_length)


def check_config(cfg: DatagenConfig) -> None:
    """Raise unless the kernel covers ``cfg`` (see ``covers``)."""
    if not _covers_recipe(cfg):
        raise ValueError("the datagen kernel covers the AWGN channel with the "
                         "default nonlinear chain (Rapp PA + IQ + phase noise)")
    if not supports_length(cfg.frame_length):
        raise ValueError(f"frame_length {cfg.frame_length} must divide 128 or be a multiple "
                         f"of 128, and lie in [2, {MAX_LENGTH}]")


def supports_length(L: int) -> bool:
    """The lengths of ``pallas_datagen._pack`` from 2 up to ``MAX_LENGTH``
    (``ofdm_datagen_supports`` in ``csrc/datagen.cu``)."""
    return 2 <= L <= MAX_LENGTH and (128 % L == 0 if L <= 128 else L % 128 == 0)


@functools.lru_cache(maxsize=None)
def twiddles(L: int, device: torch.device) -> torch.Tensor:
    """``[L, 2]`` float32 cos and sin of ``2 pi m / L``, computed in float64
    and rounded, with the second half the exact negative of the first (the
    kernel reads one entry for samples t and t + L/2); the kernel and the
    plain version read the same table. Kept per device, so the kernel's call
    copies nothing from the host."""
    m = np.arange(L // 2) * (2 * np.pi / L)
    half = np.stack([np.cos(m), np.sin(m)], axis=1).astype(np.float32)
    return torch.from_numpy(np.concatenate([half, -half])).to(device)


def _constants(cfg: DatagenConfig) -> Dict[str, np.float32]:
    """The float32 constants both versions use."""
    imp = cfg.impairments
    phi = math.radians(imp.iq_phase_deg)
    return {k: np.float32(v) for k, v in dict(
        pa_inv_sat2=1.0 / imp.pa_saturation ** 2,
        pa_p=imp.pa_smoothness,
        iq_g=10.0 ** (imp.iq_amplitude_db / 20.0),
        iq_cos=math.cos(phi),
        iq_sin=math.sin(phi),
        pn_sigma=math.sqrt(10.0 ** (imp.phase_noise_dbchz / 10.0) * imp.sample_rate),
    ).items()}


def synthetic_batch_plain(draws: Dict[str, torch.Tensor], cfg: DatagenConfig):
    """The kernel's arithmetic in PyTorch, from injected draws."""
    check_config(cfg)
    L = cfg.frame_length
    dev = draws["zr"].device
    zr, zi = draws["zr"], draws["zi"]
    tw = twiddles(L, dev)
    cos_tbl, sin_tbl = tw[:, 0], tw[:, 1]
    t = torch.arange(L, device=dev)
    ar = torch.zeros_like(zr)
    ai = torch.zeros_like(zr)
    for k in range(L):  # direct IDFT, summed over k in the kernel's order
        c, s = cos_tbl[(t * k) % L], sin_tbl[(t * k) % L]
        ar = ar + (zr[:, k:k + 1] * c - zi[:, k:k + 1] * s)
        ai = ai + (zr[:, k:k + 1] * s + zi[:, k:k + 1] * c)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(2 * L)))
    cr, ci = ar * scale, ai * scale

    xr, xi = cr, ci
    if cfg.nonlinear:
        k = _constants(cfg)
        a2 = (xr * xr + xi * xi) * float(k["pa_inv_sat2"])
        p = float(k["pa_p"])
        up = a2 * a2 * a2 if p == 3.0 else torch.exp(p * torch.log(a2.clamp_min(1e-30)))
        gain = torch.exp(float(np.float32(-0.5) / k["pa_p"]) * torch.log1p(up))
        gr, gi = xr * gain, xi * gain
        qi = float(k["iq_g"]) * (float(k["iq_cos"]) * gi + float(k["iq_sin"]) * gr)
        theta = torch.cumsum(float(k["pn_sigma"]) * draws["pn"], dim=-1)
        c, s = torch.cos(theta), torch.sin(theta)
        xr, xi = gr * c - qi * s, gr * s + qi * c

    power = (xr * xr + xi * xi).sum(dim=-1, keepdim=True) * (1.0 / L)
    snr = cfg.snr_min + (cfg.snr_max - cfg.snr_min) * draws["u"]
    sigma = torch.sqrt(power * torch.exp2(-snr[:, None] * 0.33219280948873623) * 0.5)
    nr_, ni_ = xr + sigma * draws["nr"], xi + sigma * draws["ni"]
    mx = torch.stack([nr_.abs(), ni_.abs(), cr.abs(), ci.abs()]).amax(dim=(0, 2))
    mx = mx.clamp_min(1e-12)
    noisy = torch.stack([nr_, ni_], dim=-1) / mx[:, None, None]
    clean = torch.stack([cr, ci], dim=-1) / mx[:, None, None]
    return {"noisy": noisy, "clean": clean, "snr": snr, "scale": mx}


def box_muller_plain(bits: torch.Tensor) -> torch.Tensor:
    """The kernel's Box-Muller in float64: random words ``bits`` ``[n, 2]``
    (uint32 held in int32) -> ``[n, 2]`` float32 normals. A word's top 23
    bits, offset by half a step, are its (0, 1) uniform."""
    u = ((bits.to(torch.int64) & 0xFFFFFFFF) >> 9).double() * 2.0 ** -23 + 2.0 ** -24
    r = torch.sqrt(-2.0 * torch.log(u[:, 0]))
    ang = 2.0 * math.pi * u[:, 1]
    return torch.stack([r * torch.cos(ang), r * torch.sin(ang)], dim=1).float()


def box_muller(bits: torch.Tensor) -> torch.Tensor:
    """The datagen kernel's Box-Muller on chosen random words ``bits``
    ``[n, 2]`` (uint32 held in int32): on CUDA the kernel's own device
    function, on CPU ``box_muller_plain``. For tests of the draws at the
    extreme uniforms."""
    if bits.device.type != "cuda":
        return box_muller_plain(bits)
    if bits.dtype != torch.int32 or bits.dim() != 2 or bits.shape[1] != 2:
        raise ValueError("bits must be int32 [n, 2]")
    bits = bits.contiguous()
    out = torch.empty(bits.shape, dtype=torch.float32, device=bits.device)
    fn = build.load("datagen").ofdm_datagen_box_muller
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    err = fn(bits.shape[0], bits.data_ptr(), out.data_ptr(),
             torch.cuda.current_stream(bits.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"Box-Muller kernel launch failed: CUDA error {err}")
    return out


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("datagen").ofdm_datagen_launch
    ptr, f = ctypes.c_void_p, ctypes.c_float
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr, f, f,
                   f, f, f, f, f, f, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                   ptr, ptr, ptr, ptr, ptr]
    fn.restype = ctypes.c_int
    return fn


def prepare(cfg: DatagenConfig, batch_size: int, device: torch.device,
            seed: torch.Tensor | None, draws: Dict[str, torch.Tensor] | None):
    """Check the inputs and allocate the outputs: ``(launcher, its arguments,
    outputs)``. ``launcher(*args)`` launches the kernel once and returns a
    CUDA error code; the wrappers do this and count it, ``chip_smoke.py``
    repeats it to time the kernel alone. ``seed`` (Philox mode) or ``draws``
    must outlive the launches."""
    check_config(cfg)
    L = cfg.frame_length
    ptrs = [None] * 6
    if draws is not None:
        for i, key in enumerate(DRAW_KEYS + ("u",)):
            want = (batch_size,) if key == "u" else (batch_size, L)
            if key == "pn" and not cfg.nonlinear:
                continue
            x = draws[key]
            if (x.device != device or x.dtype != torch.float32 or tuple(x.shape) != want
                    or not x.is_contiguous() or x.data_ptr() % 8):
                raise ValueError(
                    f"draw {key!r} must be contiguous, 8-byte aligned float32 {want} on {device}")
            ptrs[i] = x.data_ptr()
    else:
        if seed.device != device or seed.dtype != torch.int64 or seed.numel() != 1:
            raise ValueError(f"seed must be one int64 on {device}")
    noisy = torch.empty((batch_size, L, 2), dtype=torch.float32, device=device)
    clean = torch.empty_like(noisy)
    snr = torch.empty((batch_size,), dtype=torch.float32, device=device)
    scale = torch.empty_like(snr)
    k = _constants(cfg)
    args = (batch_size, L, build.sm_count(device), int(cfg.nonlinear),
            None if seed is None else seed.data_ptr(),
            cfg.snr_min, cfg.snr_max, float(k["pa_inv_sat2"]), float(k["pa_p"]),
            float(k["iq_g"]), float(k["iq_cos"]), float(k["iq_sin"]), float(k["pn_sigma"]),
            twiddles(L, device).data_ptr(), *ptrs, noisy.data_ptr(), clean.data_ptr(),
            snr.data_ptr(), scale.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    return _launcher(), args, {"noisy": noisy, "clean": clean, "snr": snr, "scale": scale}


def _launch(cfg: DatagenConfig, batch_size: int, device: torch.device,
            seed: torch.Tensor | None, draws: Dict[str, torch.Tensor] | None):
    global launches
    fn, args, out = prepare(cfg, batch_size, device, seed, draws)
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"datagen kernel launch failed: CUDA error {err}")
    if not torch.cuda.is_current_stream_capturing():   # a captured launch runs at replays
        launches += 1
    return out


def synthetic_batch_from_draws(draws: Dict[str, torch.Tensor], cfg: DatagenConfig):
    """Frames from injected draws: the kernel on CUDA, the plain version on CPU."""
    if draws["zr"].device.type == "cuda":
        return _launch(cfg, draws["zr"].shape[0], draws["zr"].device, None, draws)
    return synthetic_batch_plain(draws, cfg)


def synthetic_batch(gen: torch.Generator, batch_size: int, cfg: DatagenConfig):
    """Frames drawn from ``gen``: on CUDA the kernel's own Philox stream,
    seeded from ``gen`` on the device (no host sync); on CPU the plain
    version from ``gen``'s normals."""
    if gen.device.type == "cuda":
        seed = torch.randint(0, 2 ** 62, (1,), dtype=torch.int64, generator=gen,
                             device=gen.device)
        return _launch(cfg, batch_size, seed.device, seed, None)
    return synthetic_batch_plain(make_draws(gen, batch_size, cfg.frame_length), cfg)
