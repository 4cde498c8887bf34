"""WGAN-GP critic-loss gradient: the CUDA kernel ``csrc/critic_grad.cu`` and
its plain PyTorch version.

Counterpart of ``ofdmgan_tpu/ops/pallas_critic.py:60-268``. For the mini
16-sample critic ``critic_grad`` computes the gradient of

    L_D = mean D(fake) - mean D(real) + gp_weight * GP

with respect to every critic parameter, and the loss's metrics, from the
critic, the frames ``clean``, ``fake`` and ``noisy`` ``[B, 16, 2]`` and the
per-sample interpolation uniforms ``alpha`` ``[B]``. The math, written on
the dense (block-Toeplitz) layer matrices of ``ops/dense_conv.py``:

    forward  z1 = h0 A1 + b1, a1 = m1*z1, z2 = a1 A2 + b2, a2 = m2*z2,
             y = a2 . q2 + bd                     (q2 = pool map times w)
    penalty  g = ((m2*q2) A2^T * m1) A1^T  on the candidate lanes,
             n = sqrt(sum g^2 + 1e-12),  c = 2 lambda (n-1)/(n B) g,
             dA1 += c^T e1, dA2 += c1^T e2, dw += pool(c2*m2),
             e2 = m2*q2, e1 = m1*(e2 A2^T), c1 = (c A1)*m1, c2 = c1 A2

with ``h0 = concat(candidate, condition).reshape(B, 64)`` (the leaky masks
have zero second derivative almost everywhere, as autograd of autograd
assumes).

``bf16=True`` computes the same gradient under bf16 matmul precision, as
the step's autograd route does under ``ops/bf16_dots.py``: every operand of
a product (the weights, h0, the activations x1, the pooled layer-2
activations, dy, dz2, e2, dz1, e1, c, c1 and the penalty's pooled
cotangent) is rounded to bf16 and the products are summed in float32; the
bias gradients sum unrounded values. The score is then the dense layer of
the rounded pooled vector, ``R(pool(x2)) . R(w)``, as in the module.

``clean`` and ``noisy`` may arrive in a storage format, bfloat16 both (the
reference's ``act_dtype="bfloat16"`` step hands its Pallas kernel the
stored batch, ``wgan_gp.py:317-344``), with ``fake`` and ``alpha`` in
float32: the frames are widened to float32 where they are read, which is
exact, and the gradient is the float32 (or bf16-precision) one of those
values. fp8 frames raise (the reference's kernel raises a type promotion
error on them).

A CUDA tensor goes to the kernel, which walks only the conv taps and writes
the 521 parameter gradients and the five metrics in one call (a per-block
stage and a second stage that sums the blocks, launched together). A warp
of the kernel walks two frames at a time where the batch fills the card
with two frames a warp, else one (``ofdm_critic_grad_frames_per_warp``);
``launches_one_frame`` and ``launches_two_frames`` count the launches of
each mapping. A CPU tensor goes to the plain version
``critic_grad_packed``: the dense sums of ``critic_grad_plain`` on the
packed rows, mapped back to the conv kernels through autograd of the
Toeplitz expansion (``dense_grads_to_params``).
"""

from __future__ import annotations

import ctypes
import functools
import math
import re
from typing import Dict, Tuple

import torch
from torch import nn

from . import build
from .bf16_dots import round_bf16
from .dense_conv import conv1d_dense_matrix

IN, PO = 64, 16  # h0 width, pooled width
FRAME = (16, 2)
STORAGE = {torch.float32: 0, torch.bfloat16: 1}   # the kernel's storage codes of clean, noisy
PARAM_SHAPES = (("conv1.weight", (8, 4, 3)), ("conv1.bias", (8,)),
                ("conv2.weight", (16, 8, 3)), ("conv2.bias", (16,)),
                ("dense.weight", (1, 16)), ("dense.bias", (1,)))
METRICS = ("d_loss", "wasserstein_distance", "gradient_penalty", "d_real_mean", "d_fake_mean")
# kernel launches run since the caller last set it to 0; a launch captured
# into a CUDA graph is not counted: it runs at the graph's replays, which
# call no wrapper (a profiler's trace counts those)
launches = 0
# the same launches by mapping: one frame a warp (small batches) or two
launches_one_frame = 0
launches_two_frames = 0


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def critic_dense_mats(critic: nn.Module, bf16: bool = False) -> Dict[str, torch.Tensor]:
    """Critic parameters -> dense layer matrices and vectors (no grad), from
    bf16-rounded weights with ``bf16``."""
    if (tuple(critic.conv1.weight.shape), tuple(critic.conv2.weight.shape)) != ((8, 4, 3), (16, 8, 3)):
        raise ValueError("the critic-gradient kernel covers the mini 16-sample critic")
    r = round_bf16 if bf16 else _same
    with torch.no_grad():
        w = r(critic.dense.weight[0])
        return {
            "a1": conv1d_dense_matrix(r(critic.conv1.weight), 16, 2, 1).contiguous(),
            "a2": conv1d_dense_matrix(r(critic.conv2.weight), 8, 2, 1).contiguous(),
            "b1": critic.conv1.bias.repeat(8).contiguous(),
            "b2": critic.conv2.bias.repeat(4).contiguous(),
            "q2": w.repeat(4).contiguous(),   # q2[t*16 + c] = w[c]: pool then dense
            "bd": critic.dense.bias[0].clone(),
        }


def pack_h0(candidate: torch.Tensor, condition: torch.Tensor) -> torch.Tensor:
    """``[B, 16, 2] x [B, 16, 2] -> [B, 64]``, the critic's concat and
    row-major flatten."""
    return torch.cat([candidate, condition], dim=-1).reshape(candidate.shape[0], -1)


def critic_grad_plain(h0_real, h0_fake, eps, mats, gp_weight: float, slope: float = 0.2,
                      bf16: bool = False):
    """The kernel's sums in PyTorch: ``gA1``, ``gA2`` ``[64, 64]``, ``gb1``,
    ``gb2`` ``[64]``, ``gw`` ``[16]`` and ``sums`` ``[3]`` (sum of y_real and
    y_fake without the dense bias, sum of (n - 1)^2). With ``bf16`` the
    operands of every product are rounded to bf16 (``mats`` from
    ``critic_dense_mats(critic, bf16=True)``)."""
    r = round_bf16 if bf16 else _same
    pool = lambda x: x.reshape(x.shape[0], 4, PO).sum(1)  # noqa: E731
    b = h0_real.shape[0]
    a1, a2, q2 = mats["a1"], mats["a2"], mats["q2"]
    e = eps[:, None]
    h = r(torch.cat([h0_real, h0_fake, e * h0_real + (1.0 - e) * h0_fake]))
    z1 = h @ a1 + mats["b1"]
    m1 = torch.where(z1 > 0, 1.0, slope)
    x1 = r(z1 * m1)
    z2 = x1 @ a2 + mats["b2"]
    m2 = torch.where(z2 > 0, 1.0, slope)
    x2 = z2 * m2

    inv_b = 1.0 / b
    dy_b = float(round_bf16(torch.tensor(inv_b))) if bf16 else inv_b
    dy = torch.cat([torch.full((b, 1), -dy_b, device=h.device),
                    torch.full((b, 1), dy_b, device=h.device)])
    dz2 = dy * q2 * m2[:2 * b]
    dz1 = (r(dz2) @ a2.T) * m1[:2 * b]
    ga2 = x1[:2 * b].T @ r(dz2)
    ga1 = h[:2 * b].T @ r(dz1)
    pooled = r(pool(x2[:2 * b]))
    gw = (dy * pooled).sum(0)

    m1i, m2i = m1[2 * b:], m2[2 * b:]
    e2 = r(m2i * q2)
    e1 = r(m1i * (e2 @ a2.T))
    g = e1 @ a1.T
    gc = torch.where(torch.arange(IN, device=h.device) % 4 < 2, g, 0.0)
    n = torch.sqrt((gc * gc).sum(1, keepdim=True) + 1e-12)
    c = r((2.0 * gp_weight * inv_b * (n - 1.0) / n) * gc)
    c1 = r((c @ a1) * m1i)
    c2 = c1 @ a2
    ga1 = ga1 + c.T @ e1
    ga2 = ga2 + c1.T @ e2
    gw = gw + r(pool(c2 * m2i)).sum(0)

    y = pooled @ q2[:PO] if bf16 else (x2[:2 * b] * q2).sum(1)
    sums = torch.stack([y[:b].sum(), y[b:].sum(), ((n - 1.0) ** 2).sum()])
    return {"gA1": ga1, "gA2": ga2, "gb1": dz1.sum(0), "gb2": dz2.sum(0), "gw": gw,
            "sums": sums}


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("critic_grad")
    i, ll, f, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p
    lib.ofdm_critic_grad_launch.argtypes = [i, i, i, f, f, i, i] + [ptr, ll, ll, ll] * 3 + [ptr] * 10
    lib.ofdm_critic_grad_launch.restype = i
    for name in ("ofdm_critic_grad_slot_floats", "ofdm_critic_grad_out_floats"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    lib.ofdm_critic_grad_frames_per_warp.argtypes = [i, i]
    lib.ofdm_critic_grad_frames_per_warp.restype = i
    lib.ofdm_critic_grad_blocks.argtypes = [i, i, i]
    lib.ofdm_critic_grad_blocks.restype = i
    lib.ofdm_critic_grad_blocks_per_sm.argtypes = [i]
    lib.ofdm_critic_grad_blocks_per_sm.restype = i
    return lib


def ptxas_summary(log: str) -> Dict[str, Dict[str, int]]:
    """Registers and spilled bytes (stores) of each instantiation of the
    per-block kernel in an nvcc ``-Xptxas -v`` log (``build.build``'s), by
    ``frames<F>_<matmul precision>_<storage>``; a source whose kernel has no
    frames parameter walks one frame a warp."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?(?:\s|$)", line)
        if m:
            k = re.search(r"critic_grad_kernelI(?:Li(\d)E)?Lb(\d)E(f|13__nv_bfloat16)", m.group(1))
            key = k and (f"frames{k.group(1) or 1}_{'bf16' if k.group(2) == '1' else 'f32'}_"
                         f"{'f32' if k.group(3) == 'f' else 'bf16'}")
            continue
        if key is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores", line)
        regs = re.search(r"Used (\d+) registers", line)
        if spill:
            out.setdefault(key, {})["spill_bytes"] = int(spill.group(1))
        if regs:
            out.setdefault(key, {})["registers"] = int(regs.group(1))
    return out


def covers(critic: nn.Module, frame_length: int) -> bool:
    """Whether the kernel computes ``critic``'s loss gradient on frames of
    ``frame_length`` samples: the mini critic's shapes (``PARAM_SHAPES``) at
    16 samples."""
    shapes = tuple((n, tuple(p.shape)) for n, p in critic.named_parameters())
    return shapes == PARAM_SHAPES and frame_length == FRAME[0]


def check_inputs(critic: nn.Module, clean: torch.Tensor, fake: torch.Tensor,
                 noisy: torch.Tensor) -> None:
    """Raise unless the kernel covers ``critic`` on frames ``[B, L, 2]``:
    ``clean`` and ``noisy`` of one dtype of ``STORAGE``, ``fake`` float32."""
    for x in (clean, fake, noisy):
        if x.dim() != 3 or tuple(x.shape[1:]) != FRAME:
            raise ValueError(f"the critic-gradient kernel takes frames of shape [B, {FRAME[0]}, "
                             f"{FRAME[1]}], not {list(x.shape)}")
    if not covers(critic, FRAME[0]):
        raise ValueError("the critic-gradient kernel covers the mini 16-sample critic")
    if clean.dtype != noisy.dtype or clean.dtype not in STORAGE:
        raise ValueError("the critic-gradient kernel reads clean and noisy frames in one of "
                         f"float32 and bfloat16, not {clean.dtype} and {noisy.dtype}")
    if fake.dtype != torch.float32:
        raise ValueError(f"the critic-gradient kernel reads float32 fake frames, not {fake.dtype}")


def _split(out: torch.Tensor):
    """The kernel's output buffer -> (gradient per parameter, metrics), as views."""
    grads, off = {}, 0
    for name, shape in PARAM_SHAPES:
        n = math.prod(shape)
        grads[name] = out[off:off + n].view(shape)
        off += n
    return grads, {m: out[off + i] for i, m in enumerate(METRICS)}


def prepare(critic, clean, fake, noisy, alpha, gp_weight: float, slope: float = 0.2,
            bf16: bool = False):
    """Check the inputs and allocate the buffers: ``(launcher, its arguments,
    output buffer, buffers the launches read)``. ``launcher(*args)`` launches
    the kernel (both stages) once and returns a CUDA error code;
    ``critic_grad`` does this and counts it, ``chip_smoke.py`` repeats it to
    time the kernel alone at large batches. With ``bf16`` the weights are
    passed rounded to bf16; ``clean`` and ``noisy`` go in their storage
    format (``STORAGE``)."""
    check_inputs(critic, clean, fake, noisy)
    b, dev = clean.shape[0], clean.device
    for name, x in (("clean", clean), ("fake", fake), ("noisy", noisy)):
        if x.device != dev or tuple(x.shape) != (b, *FRAME):
            raise ValueError(f"{name} must be {(b, *FRAME)} on {dev}")
    if (alpha.device != dev or alpha.dtype != torch.float32 or tuple(alpha.shape) != (b,)
            or not alpha.is_contiguous()):
        raise ValueError(f"alpha must be contiguous float32 ({b},) on {dev}")
    params = dict(critic.named_parameters())
    for name, p in params.items():
        if p.device != dev or p.dtype != torch.float32 or not p.is_contiguous():
            raise ValueError(f"critic parameter {name} must be contiguous float32 on {dev}")
    lib = _library()
    frames = lib.ofdm_critic_grad_frames_per_warp(b, build.sm_count(dev))
    nblocks = lib.ofdm_critic_grad_blocks(b, build.sm_count(dev), frames)
    scratch = torch.empty(nblocks * lib.ofdm_critic_grad_slot_floats(),
                          dtype=torch.float32, device=dev)
    out = torch.empty(lib.ofdm_critic_grad_out_floats(), dtype=torch.float32, device=dev)
    if bf16:
        with torch.no_grad():
            params = {n: round_bf16(p) if n.endswith("weight") else p for n, p in params.items()}
    args = (b, nblocks, frames, slope, gp_weight, int(bf16), STORAGE[clean.dtype],
            clean.data_ptr(), *clean.stride(), fake.data_ptr(), *fake.stride(),
            noisy.data_ptr(), *noisy.stride(), alpha.data_ptr(),
            *(params[name].data_ptr() for name, _ in PARAM_SHAPES),
            scratch.data_ptr(), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return lib.ofdm_critic_grad_launch, args, out, (scratch, params)


def _launch(critic, clean, fake, noisy, alpha, gp_weight: float, slope: float, bf16: bool):
    global launches, launches_one_frame, launches_two_frames
    fn, args, out, _keep = prepare(critic, clean, fake, noisy, alpha, gp_weight, slope, bf16)
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"critic-gradient kernel launch failed: CUDA error {err}")
    if not torch.cuda.is_current_stream_capturing():   # a captured launch runs at replays
        launches += 1
        if args[2] == 2:
            launches_two_frames += 1
        else:
            launches_one_frame += 1
    return _split(out)


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


def critic_grad_packed(critic: nn.Module, clean: torch.Tensor, fake: torch.Tensor,
                       noisy: torch.Tensor, alpha: torch.Tensor, gp_weight: float,
                       slope: float = 0.2, bf16: bool = False):
    """The kernel's plain version: the packed rows through the dense sums of
    ``critic_grad_plain``, mapped back to the parameters, and the metrics;
    bf16 ``clean`` and ``noisy`` are widened to float32 first."""
    check_inputs(critic, clean, fake, noisy)
    clean, noisy = clean.float(), noisy.float()
    mats = critic_dense_mats(critic, bf16)
    dense = critic_grad_plain(pack_h0(clean, noisy), pack_h0(fake, noisy), alpha, mats,
                              gp_weight, slope, bf16)
    inv_b = 1.0 / clean.shape[0]
    d_real = dense["sums"][0] * inv_b + mats["bd"]
    d_fake = dense["sums"][1] * inv_b + mats["bd"]
    gp = dense["sums"][2] * inv_b
    aux = {"d_loss": d_fake - d_real + gp_weight * gp,
           "wasserstein_distance": d_real - d_fake,
           "gradient_penalty": gp, "d_real_mean": d_real, "d_fake_mean": d_fake}
    return dense_grads_to_params(critic, dense), aux


def critic_grad(critic: nn.Module, clean: torch.Tensor, fake: torch.Tensor,
                noisy: torch.Tensor, alpha: torch.Tensor, gp_weight: float,
                slope: float = 0.2, bf16: bool = False
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(gradient per critic parameter, metrics) of the critic loss, with the
    metrics of ``training/wgan_gp.critic_loss_fn``, at float32 or (``bf16``)
    bf16 matmul precision, on float32 or bf16 ``clean`` and ``noisy``: the
    kernel for CUDA tensors (one call, the results are views of its
    output), the plain version for CPU ones."""
    if clean.device.type == "cuda":
        return _launch(critic, clean, fake, noisy, alpha, gp_weight, slope, bf16)
    return critic_grad_packed(critic, clean, fake, noisy, alpha, gp_weight, slope, bf16)
