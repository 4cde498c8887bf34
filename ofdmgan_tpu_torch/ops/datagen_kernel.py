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
uniforms ``u`` ``[B]``).
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

SUPPORTED_LENGTHS = (8, 16, 32)
DRAW_KEYS = ("zr", "zi", "pn", "nr", "ni")
launches = 0  # kernel launches since the caller last set it to 0


def check_config(cfg: DatagenConfig) -> None:
    """Raise unless the kernel covers ``cfg`` (as ``wgan_gp.py:282-293``)."""
    imp = cfg.impairments
    if cfg.channel.kind != "awgn" or (cfg.nonlinear and (
            imp.pa_model != "rapp" or not imp.pa_enabled or not imp.iq_enabled
            or not imp.phase_noise_enabled or imp.dc_enabled or imp.cfo_enabled)):
        raise ValueError("the datagen kernel covers the AWGN channel with the "
                         "default nonlinear chain (Rapp PA + IQ + phase noise)")
    if cfg.frame_length not in SUPPORTED_LENGTHS:
        raise ValueError(f"frame_length must be one of {SUPPORTED_LENGTHS}")


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
    f32 = torch.float32
    dev = draws["zr"].device
    zr, zi = draws["zr"], draws["zi"]
    m = np.arange(L)   # the kernel's float32 twiddle table (csrc/datagen.cu)
    cos_tbl = torch.tensor(np.cos(2 * np.pi * m / L), dtype=f32, device=dev)
    sin_tbl = torch.tensor(np.sin(2 * np.pi * m / L), dtype=f32, device=dev)
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


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("datagen").ofdm_datagen_launch
    ptr, f = ctypes.c_void_p, ctypes.c_float
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr, f, f,
                   f, f, f, f, f, f, ptr, ptr, ptr, ptr, ptr, ptr,
                   ptr, ptr, ptr, ptr, ptr]
    fn.restype = ctypes.c_int
    return fn


def _launch(cfg: DatagenConfig, batch_size: int, device: torch.device,
            seed: torch.Tensor | None, draws: Dict[str, torch.Tensor] | None):
    global launches
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
                    or not x.is_contiguous() or x.data_ptr() % 16):
                raise ValueError(
                    f"draw {key!r} must be contiguous, 16-byte aligned float32 {want} on {device}")
            ptrs[i] = x.data_ptr()
    else:
        if seed.device != device or seed.dtype != torch.int64 or seed.numel() != 1:
            raise ValueError(f"seed must be one int64 on {device}")
    noisy = torch.empty((batch_size, L, 2), dtype=torch.float32, device=device)
    clean = torch.empty_like(noisy)
    snr = torch.empty((batch_size,), dtype=torch.float32, device=device)
    scale = torch.empty_like(snr)
    k = _constants(cfg)
    err = _launcher()(
        batch_size, L, int(cfg.nonlinear), None if seed is None else seed.data_ptr(),
        cfg.snr_min, cfg.snr_max, float(k["pa_inv_sat2"]), float(k["pa_p"]),
        float(k["iq_g"]), float(k["iq_cos"]), float(k["iq_sin"]), float(k["pn_sigma"]),
        *ptrs, noisy.data_ptr(), clean.data_ptr(), snr.data_ptr(), scale.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"datagen kernel launch failed: CUDA error {err}")
    launches += 1
    return {"noisy": noisy, "clean": clean, "snr": snr, "scale": scale}


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
