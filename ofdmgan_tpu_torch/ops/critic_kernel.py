"""WGAN-GP critic-loss gradient: the CUDA kernel ``csrc/critic_grad.cu`` and
its plain PyTorch version.

Counterpart of ``ofdmgan_tpu/ops/pallas_critic.py:60-268``. For the mini
16-sample critic it computes the gradient of

    L_D = mean D(fake) - mean D(real) + gp_weight * GP

with respect to every critic parameter, and the loss's metrics, from the
packed critic inputs ``h0 = concat(candidate, condition).reshape(B, 64)`` and
the per-sample interpolation uniforms ``eps`` ``[B]``. The work is done on
the dense (block-Toeplitz) layer matrices of ``ops/dense_conv.py``:

    forward  z1 = h0 A1 + b1, a1 = m1*z1, z2 = a1 A2 + b2, a2 = m2*z2,
             y = a2 . q2 + bd                     (q2 = pool map times w)
    penalty  g = ((m2*q2) A2^T * m1) A1^T  on the candidate lanes,
             n = sqrt(sum g^2 + 1e-12),  c = 2 lambda (n-1)/(n B) g,
             dA1 += c^T e1, dA2 += c1^T e2, dw += pool(c2*m2),
             e2 = m2*q2, e1 = m1*(e2 A2^T), c1 = (c A1)*m1, c2 = c1 A2

(the leaky masks have zero second derivative almost everywhere, as autograd
of autograd assumes). The dense gradients map back to the conv kernels
through autograd of the Toeplitz expansion (``dense_grads_to_params``).

A CUDA tensor goes to the kernel, a CPU tensor to the plain version, which
computes the same sums batch-wide.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch
from torch import nn

from . import build
from .dense_conv import conv1d_dense_matrix

IN, PO = 64, 16  # h0 width, pooled width
launches = 0  # kernel launches since the caller last set it to 0


def critic_dense_mats(critic: nn.Module) -> Dict[str, torch.Tensor]:
    """Critic parameters -> dense layer matrices and vectors (no grad)."""
    if (tuple(critic.conv1.weight.shape), tuple(critic.conv2.weight.shape)) != ((8, 4, 3), (16, 8, 3)):
        raise ValueError("the critic-gradient kernel covers the mini 16-sample critic")
    with torch.no_grad():
        w = critic.dense.weight[0]
        return {
            "a1": conv1d_dense_matrix(critic.conv1.weight, 16, 2, 1).contiguous(),
            "a2": conv1d_dense_matrix(critic.conv2.weight, 8, 2, 1).contiguous(),
            "b1": critic.conv1.bias.repeat(8).contiguous(),
            "b2": critic.conv2.bias.repeat(4).contiguous(),
            "q2": w.repeat(4).contiguous(),   # q2[t*16 + c] = w[c]: pool then dense
            "bd": critic.dense.bias[0].clone(),
        }


def pack_h0(candidate: torch.Tensor, condition: torch.Tensor) -> torch.Tensor:
    """``[B, 16, 2] x [B, 16, 2] -> [B, 64]``, the critic's concat and
    row-major flatten."""
    return torch.cat([candidate, condition], dim=-1).reshape(candidate.shape[0], -1)


def critic_grad_plain(h0_real, h0_fake, eps, mats, gp_weight: float, slope: float = 0.2):
    """The kernel's sums in PyTorch: ``gA1``, ``gA2`` ``[64, 64]``, ``gb1``,
    ``gb2`` ``[64]``, ``gw`` ``[16]`` and ``sums`` ``[3]`` (sum of y_real and
    y_fake without the dense bias, sum of (n - 1)^2)."""
    b = h0_real.shape[0]
    a1, a2, q2 = mats["a1"], mats["a2"], mats["q2"]
    e = eps[:, None]
    h = torch.cat([h0_real, h0_fake, e * h0_real + (1.0 - e) * h0_fake])
    z1 = h @ a1 + mats["b1"]
    m1 = torch.where(z1 > 0, 1.0, slope)
    x1 = z1 * m1
    z2 = x1 @ a2 + mats["b2"]
    m2 = torch.where(z2 > 0, 1.0, slope)
    x2 = z2 * m2

    inv_b = 1.0 / b
    dy = torch.cat([torch.full((b, 1), -inv_b, device=h.device),
                    torch.full((b, 1), inv_b, device=h.device)])
    dz2 = dy * q2 * m2[:2 * b]
    dz1 = (dz2 @ a2.T) * m1[:2 * b]
    ga2 = x1[:2 * b].T @ dz2
    ga1 = h[:2 * b].T @ dz1
    gw = (dy * x2[:2 * b].reshape(2 * b, 4, PO).sum(1)).sum(0)

    m1i, m2i = m1[2 * b:], m2[2 * b:]
    e2 = m2i * q2
    e1 = m1i * (e2 @ a2.T)
    g = e1 @ a1.T
    gc = torch.where(torch.arange(IN, device=h.device) % 4 < 2, g, 0.0)
    n = torch.sqrt((gc * gc).sum(1, keepdim=True) + 1e-12)
    c = (2.0 * gp_weight * inv_b * (n - 1.0) / n) * gc
    c1 = (c @ a1) * m1i
    c2 = c1 @ a2
    ga1 = ga1 + c.T @ e1
    ga2 = ga2 + c1.T @ e2
    gw = gw + (c2 * m2i).reshape(b, 4, PO).sum(1).sum(0)

    y = (x2[:2 * b] * q2).sum(1)
    sums = torch.stack([y[:b].sum(), y[b:].sum(), ((n - 1.0) ** 2).sum()])
    return {"gA1": ga1, "gA2": ga2, "gb1": dz1.sum(0), "gb2": dz2.sum(0), "gw": gw,
            "sums": sums}


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("critic_grad")
    ptr, f = ctypes.c_void_p, ctypes.c_float
    lib.ofdm_critic_grad_launch.argtypes = [ctypes.c_int, f, f, f] + [ptr] * 11
    lib.ofdm_critic_grad_launch.restype = ctypes.c_int
    for name in ("ofdm_critic_grad_slot_floats", "ofdm_critic_grad_out_floats"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.ofdm_critic_grad_blocks.argtypes = [ctypes.c_int]
    lib.ofdm_critic_grad_blocks.restype = ctypes.c_int
    return lib


def _launch(h0_real, h0_fake, eps, mats, gp_weight: float, slope: float):
    global launches
    b = h0_real.shape[0]
    dev = h0_real.device
    want = {"h0_real": (h0_real, (b, IN)), "h0_fake": (h0_fake, (b, IN)), "eps": (eps, (b,)),
            **{k: (mats[k], (IN, IN)) for k in ("a1", "a2")},
            **{k: (mats[k], (IN,)) for k in ("b1", "b2", "q2")}}
    for name, (x, shape) in want.items():
        if (x.device != dev or x.dtype != torch.float32 or tuple(x.shape) != shape
                or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {shape} on {dev}")
    lib = _library()
    nblocks = lib.ofdm_critic_grad_blocks(b)
    partial = torch.empty(nblocks * lib.ofdm_critic_grad_slot_floats(),
                          dtype=torch.float32, device=dev)
    out = torch.empty(lib.ofdm_critic_grad_out_floats(), dtype=torch.float32, device=dev)
    err = lib.ofdm_critic_grad_launch(
        b, slope, 2.0 * gp_weight / b, 1.0 / b,
        h0_real.data_ptr(), h0_fake.data_ptr(), eps.data_ptr(),
        mats["a1"].data_ptr(), mats["a2"].data_ptr(), mats["b1"].data_ptr(),
        mats["b2"].data_ptr(), mats["q2"].data_ptr(), partial.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"critic-gradient kernel launch failed: CUDA error {err}")
    launches += 1
    return {"gA1": out[:4096].view(IN, IN), "gA2": out[4096:8192].view(IN, IN),
            "gb1": out[8192:8256], "gb2": out[8256:8320], "gw": out[8320:8336],
            "sums": out[8336:8339]}


def critic_grad_dense(h0_real, h0_fake, eps, mats, gp_weight: float, slope: float = 0.2):
    """Dense-matrix gradients and sums: the kernel on CUDA, the plain
    version on CPU."""
    if h0_real.device.type == "cuda":
        return _launch(h0_real, h0_fake, eps, mats, gp_weight, slope)
    return critic_grad_plain(h0_real, h0_fake, eps, mats, gp_weight, slope)


def dense_grads_to_params(critic: nn.Module, dense: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Dense-matrix gradients -> one gradient per critic parameter, through
    autograd of the Toeplitz expansion (its exact transpose)."""
    def conv_grad(w, l_in, g):
        w = w.detach().requires_grad_(True)
        with torch.enable_grad():
            (gw,) = torch.autograd.grad(conv1d_dense_matrix(w, l_in, 2, 1), w, g)
        return gw

    return {
        "conv1.weight": conv_grad(critic.conv1.weight, 16, dense["gA1"]),
        "conv1.bias": dense["gb1"].reshape(8, 8).sum(0),
        "conv2.weight": conv_grad(critic.conv2.weight, 8, dense["gA2"]),
        "conv2.bias": dense["gb2"].reshape(4, PO).sum(0),
        "dense.weight": dense["gw"][None, :].clone(),
        "dense.bias": torch.zeros_like(critic.dense.bias),
    }


def critic_grad(critic: nn.Module, h0_real: torch.Tensor, h0_fake: torch.Tensor,
                eps: torch.Tensor, gp_weight: float, slope: float = 0.2
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(gradient per critic parameter, metrics) of the critic loss, with the
    metrics of ``training/wgan_gp.critic_loss_fn``."""
    mats = critic_dense_mats(critic)
    dense = critic_grad_dense(h0_real, h0_fake, eps, mats, gp_weight, slope)
    inv_b = 1.0 / h0_real.shape[0]
    d_real = dense["sums"][0] * inv_b + mats["bd"]
    d_fake = dense["sums"][1] * inv_b + mats["bd"]
    gp = dense["sums"][2] * inv_b
    aux = {"d_loss": d_fake - d_real + gp_weight * gp,
           "wasserstein_distance": d_real - d_fake,
           "gradient_penalty": gp, "d_real_mean": d_real, "d_fake_mean": d_fake}
    return dense_grads_to_params(critic, dense), aux
