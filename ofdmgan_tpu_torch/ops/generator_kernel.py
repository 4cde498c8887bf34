"""The mini generator's loss gradient: the CUDA kernel ``csrc/generator_grad.cu``
and its plain PyTorch version.

It replaces no TPU kernel: the reference's generator update is autograd
(``ofdmgan_tpu/training/wgan_gp.py``, ``generator_loss_fn`` under
``value_and_grad``), and so was the port's, until on the H100 cuDNN's
weight gradients of the tiny convolutions took 6.59 of 10.6 ms an outer
step at B = 65,536. ``generator_grad`` computes, for the mini generator
``G`` and the mini critic ``D`` on frames ``[B, 16, 2]``, the gradient of

    L_G = adv_weight * (-mean D(G(noisy), noisy)) + rec_weight * mean |G(noisy) - clean|

with respect to each of the generator's 258 parameters, and the metrics of
``training/wgan_gp.generator_loss_fn`` (``g_loss``, ``adv_loss``,
``rec_loss``), with the derivatives written out by hand, conv tap by conv
tap: the critic's gradient back to its candidate input only (its own
parameter gradients are not needed); ``rec_weight / (32 B) * sgn(fake -
clean)`` for the L1 term, 0 at a tie, as ``abs``'s backward gives; tanh's
``1 - y^2``; each LeakyReLU by the sign of its pre-activation (``> 0``,
else the slope, as ``leaky_relu_backward``); the nearest x2 upsample as the
sum of each pair; the skip into both branches.

What bounds the kernel on the H100: operations, 8,592 float32 multiply-adds
a frame over the conv taps inside the frame against 256 bytes read. Its
design (one warp a frame, one output of each generator layer a lane,
per-lane gradient sums over a grid-stride loop, a block sum into one slot
and a second kernel that sums the slots in a fixed order, so the result is
deterministic for a given B) is set out in the source.

A CUDA tensor goes to the kernel (one call: both stages, whose results are
views of one output buffer) or raises; a CPU tensor goes to the plain
version ``generator_grad_plain``, the same hand-derived math on whole
batches, a conv as a sum over its three taps of the positions that fall
inside the frame (``_tap``). Neither runs autograd.

``generator_forward`` is the generator's forward alone, the no-grad fake
that an outer step's critic updates read: the CUDA kernel
``csrc/generator_forward.cu`` (one launch, one thread a frame) for a
CUDA tensor, or its plain
version ``generator_forward_plain``, the forward at the top of
``generator_grad_plain``, for a CPU one. ``covers_forward`` says where the
kernel computes the module's forward, ``forward_bound_ms`` its least time.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import torch
from torch import nn

from . import build, critic_kernel
from ..models.generator import MiniGenerator

FRAME = (16, 2)
PARAM_SHAPES = (("enc1.weight", (4, 2, 3)), ("enc1.bias", (4,)),
                ("bottleneck.weight", (8, 4, 3)), ("bottleneck.bias", (8,)),
                ("dec1.weight", (4, 8, 3)), ("dec1.bias", (4,)),
                ("out_conv.weight", (2, 4, 3)), ("out_conv.bias", (2,)))
METRICS = ("g_loss", "adv_loss", "rec_loss")
FORWARD_MACS = 1608        # a frame's multiply-adds of the forward, the taps inside the frame
FORWARD_BYTES = 2 * 32 * 4  # a frame's noisy read and fake written, float32
# kernel launches run since the caller last set it to 0; a launch captured
# into a CUDA graph is not counted: it runs at the graph's replays, which
# call no wrapper (a profiler's trace counts those). ``launches`` counts the
# gradient kernel's, ``forward_launches`` the forward kernel's.
launches = 0
forward_launches = 0


def covers_forward(generator: nn.Module, frame_length: int) -> bool:
    """Whether the forward kernel computes ``generator``'s forward on frames
    of ``frame_length`` samples: the deployed ``MiniGenerator``
    (2->4->8->4->2, k3, tanh head; no ``input_residual``, ``rtl_faithful``,
    ``qat`` or ``act_dtype``) at 16 samples."""
    if not isinstance(generator, MiniGenerator) or frame_length != FRAME[0]:
        return False
    shapes = tuple((n, tuple(p.shape)) for n, p in generator.named_parameters())
    return (shapes == PARAM_SHAPES and not generator.input_residual
            and not generator.rtl_faithful and not generator.qat and generator.act_dtype is None)


def covers(generator: nn.Module, critic: nn.Module, frame_length: int) -> bool:
    """Whether the kernel computes ``generator``'s loss gradient against
    ``critic`` on frames of ``frame_length`` samples: a generator the
    forward kernel covers (``covers_forward``), with a critic the critic
    kernel covers that stores nothing in a storage format."""
    return (covers_forward(generator, frame_length)
            and getattr(critic, "act_dtype", None) is None
            and critic_kernel.covers(critic, frame_length))


def check_inputs(generator: nn.Module, critic: nn.Module, clean: torch.Tensor,
                 noisy: torch.Tensor) -> None:
    """Raise unless the kernel covers the pair on float32 frames ``[B, 16, 2]``
    of one device, with float32 parameters there."""
    if not covers(generator, critic, FRAME[0]):
        raise ValueError("the generator-gradient kernel covers the deployed mini generator "
                         "with the mini critic at 16 samples")
    b, dev = clean.shape[0], clean.device
    for name, x in (("clean", clean), ("noisy", noisy)):
        if x.dtype != torch.float32 or x.device != dev or tuple(x.shape) != (b, *FRAME):
            raise ValueError(f"{name} must be float32 {(b, *FRAME)} on {dev}, not "
                             f"{x.dtype} {list(x.shape)} on {x.device}")
    for module in (generator, critic):
        for name, p in module.named_parameters():
            if p.device != dev or p.dtype != torch.float32 or not p.is_contiguous():
                raise ValueError(f"parameter {name} must be contiguous float32 on {dev}")


def check_forward_inputs(generator: nn.Module, noisy: torch.Tensor) -> None:
    """Raise unless the forward kernel covers ``generator`` on float32
    frames ``[B, 16, 2]``, B >= 1, with float32 parameters on their device."""
    if not covers_forward(generator, FRAME[0]):
        raise ValueError("the generator forward kernel covers the deployed mini generator "
                         "at 16 samples")
    dev = noisy.device
    if noisy.dtype != torch.float32 or noisy.dim() != 3 or tuple(noisy.shape[1:]) != FRAME \
            or noisy.shape[0] < 1:
        raise ValueError(f"noisy must be float32 [B >= 1, *{FRAME}], not {noisy.dtype} "
                         f"{list(noisy.shape)}")
    for name, p in generator.named_parameters():
        if p.device != dev or p.dtype != torch.float32 or not p.is_contiguous():
            raise ValueError(f"parameter {name} must be contiguous float32 on {dev}")


def forward_bound_ms(b: int, flops_per_s: float, bytes_per_s: float) -> Tuple[float, str]:
    """``(ms, "operations" or "bytes")``: the forward kernel's least time at
    batch ``b`` on a card of these peaks (float32 outside the tensor cores;
    memory), ``FORWARD_MACS`` multiply-adds a frame against
    ``FORWARD_BYTES`` a frame and the parameters read once, and what sets
    it."""
    t_ops = b * 2 * FORWARD_MACS / flops_per_s * 1e3
    n_params = sum(math.prod(shape) for _, shape in PARAM_SHAPES)
    t_bytes = (b * FORWARD_BYTES + n_params * 4) / bytes_per_s * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _tap(l_in: int, l_out: int, stride: int, k: int) -> Tuple[slice, slice]:
    """``(outputs, inputs)``: the positions ``t`` and ``p = stride t - 1 + k``
    of tap ``k`` (padding 1) that fall inside a frame of ``l_in`` samples."""
    ts = [t for t in range(l_out) if 0 <= stride * t - 1 + k < l_in]
    p0 = stride * ts[0] - 1 + k
    return slice(ts[0], ts[-1] + 1), slice(p0, p0 + stride * (len(ts) - 1) + 1, stride)


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> torch.Tensor:
    """``[B, C_in, L_in] -> [B, C_out, L_out]``, k3, padding 1, tap by tap."""
    l_in, l_out = x.shape[-1], (x.shape[-1] - 1) // stride + 1
    z = b[None, :, None].expand(x.shape[0], -1, l_out).clone()
    for k in range(3):
        t, p = _tap(l_in, l_out, stride, k)
        z[:, :, t] += torch.einsum("oi,bip->bop", w[:, :, k], x[:, :, p])
    return z


def _conv_t(d: torch.Tensor, w: torch.Tensor, stride: int, l_in: int) -> torch.Tensor:
    """The transposed product: cotangent ``[B, C_out, L_out]`` -> ``[B, C_in, l_in]``."""
    x = d.new_zeros(d.shape[0], w.shape[1], l_in)
    for k in range(3):
        t, p = _tap(l_in, d.shape[-1], stride, k)
        x[:, :, p] += torch.einsum("oi,bot->bit", w[:, :, k], d[:, :, t])
    return x


def _conv_w(d: torch.Tensor, x: torch.Tensor, stride: int) -> torch.Tensor:
    """The weight gradient ``[C_out, C_in, 3]`` of cotangent ``d`` on input ``x``."""
    return torch.stack([torch.einsum("bot,bit->oi", d[:, :, t], x[:, :, p])
                        for t, p in (_tap(x.shape[-1], d.shape[-1], stride, k)
                                     for k in range(3))], dim=-1)


def _leaky(z: torch.Tensor, slope: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(activation, mask)``: the mask is 1 where ``z > 0``, else the slope."""
    m = torch.where(z > 0, 1.0, slope)
    return z * m, m


def _pairs(x: torch.Tensor) -> torch.Tensor:
    """The nearest x2 upsample's transpose: each pair of positions summed."""
    return x[..., 0::2] + x[..., 1::2]


def _forward(g: nn.Module, x: torch.Tensor):
    """The generator's forward on ``x`` ``[B, 2, 16]``, channels first: the
    ``(activation, mask)`` of enc1's and the bottleneck's LeakyReLU, the
    bottleneck upsampled, dec1's mask, the skip upsampled and the output ``y``."""
    gs = g.leaky_slope
    a1, m1 = _leaky(_conv(x, g.enc1.weight, g.enc1.bias, 2), gs)
    a2, m2 = _leaky(_conv(a1, g.bottleneck.weight, g.bottleneck.bias, 2), gs)
    up1 = a2.repeat_interleave(2, dim=-1)
    a3, m3 = _leaky(_conv(up1, g.dec1.weight, g.dec1.bias, 1), gs)
    up2 = (a3 + a1).repeat_interleave(2, dim=-1)
    y = torch.tanh(_conv(up2, g.out_conv.weight, g.out_conv.bias, 1))
    return (a1, m1), (a2, m2), up1, m3, up2, y


def generator_forward_plain(generator: nn.Module, noisy: torch.Tensor) -> torch.Tensor:
    """The forward kernel's plain version: ``noisy`` ``[B, 16, 2]`` -> the
    fake ``[B, 16, 2]``, no gradient."""
    check_forward_inputs(generator, noisy)
    with torch.no_grad():
        return _forward(generator, noisy.transpose(1, 2))[-1].transpose(1, 2)


def generator_grad_plain(generator: nn.Module, critic: nn.Module, clean: torch.Tensor,
                         noisy: torch.Tensor, adv_weight: float, rec_weight: float):
    """The kernel's plain version: ``(gradient per parameter, metrics)``."""
    check_inputs(generator, critic, clean, noisy)
    g, d = generator, critic
    cs = d.leaky_slope
    b = clean.shape[0]
    with torch.no_grad():
        x = noisy.transpose(1, 2)
        (a1, m1), (a2, m2), up1, m3, up2, y = _forward(g, x)
        # the critic's forward on (fake, noisy) and its gradient back to fake
        # for a unit score
        c1, cm1 = _leaky(_conv(torch.cat([y, x], dim=1), d.conv1.weight, d.conv1.bias, 2), cs)
        c2, cm2 = _leaky(_conv(c1, d.conv2.weight, d.conv2.bias, 2), cs)
        wd = d.dense.weight[0]
        e1 = _conv_t(cm2 * wd[None, :, None], d.conv2.weight, 2, 8) * cm1
        dfake = _conv_t(e1, d.conv1.weight[:, :2], 2, 16)
        # the loss's cotangent of out_conv's pre-activation, then back
        diff = y - clean.transpose(1, 2)
        d4 = ((-adv_weight / b) * dfake + (rec_weight / (32 * b)) * torch.sign(diff)) * (1 - y * y)
        dskip = _pairs(_conv_t(d4, g.out_conv.weight, 1, 16))
        d3 = dskip * m3
        d2 = _pairs(_conv_t(d3, g.dec1.weight, 1, 8)) * m2
        d1 = (dskip + _conv_t(d2, g.bottleneck.weight, 2, 8)) * m1
        grads = {"enc1.weight": _conv_w(d1, x, 2), "enc1.bias": d1.sum((0, 2)),
                 "bottleneck.weight": _conv_w(d2, a1, 2), "bottleneck.bias": d2.sum((0, 2)),
                 "dec1.weight": _conv_w(d3, up1, 1), "dec1.bias": d3.sum((0, 2)),
                 "out_conv.weight": _conv_w(d4, up2, 1), "out_conv.bias": d4.sum((0, 2))}
        adv = -((c2.sum(-1) * wd).sum() / b + d.dense.bias[0])
        rec = diff.abs().sum() / (32 * b)
    aux = {"g_loss": adv_weight * adv + rec_weight * rec, "adv_loss": adv, "rec_loss": rec}
    return grads, aux


def bind_forward(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of the forward kernel's C entry
    points on a library built from ``csrc/generator_forward.cu``."""
    i, ll, f, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p
    lib.ofdm_generator_forward_launch.argtypes = [i, i, f, ptr, ll, ll, ll] + [ptr] * 10
    lib.ofdm_generator_forward_launch.restype = i
    lib.ofdm_generator_forward_blocks.argtypes = [i, i]
    lib.ofdm_generator_forward_blocks.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _forward_library():
    return bind_forward(build.load("generator_forward"))


def prepare_forward(generator, noisy):
    """Check the inputs and allocate the output: ``(launcher, its arguments,
    output, parameters the launch reads)``. ``launcher(*args)`` launches the
    forward kernel once and returns a CUDA error code;
    ``generator_forward`` does this and counts it; repeating it times the
    kernel alone."""
    check_forward_inputs(generator, noisy)
    b, dev = noisy.shape[0], noisy.device
    lib = _forward_library()
    out = torch.empty((b, *FRAME), dtype=torch.float32, device=dev)
    params = list(generator.parameters())
    args = (b, lib.ofdm_generator_forward_blocks(b, build.sm_count(dev)),
            generator.leaky_slope, noisy.data_ptr(), *noisy.stride(),
            *(p.data_ptr() for p in params), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    return lib.ofdm_generator_forward_launch, args, out, params


def generator_forward(generator: nn.Module, noisy: torch.Tensor) -> torch.Tensor:
    """``generator``'s forward of ``noisy`` ``[B, 16, 2]``, no gradient: the
    kernel for a CUDA tensor (one launch; the fake contiguous), the plain
    version for a CPU one."""
    global forward_launches
    if noisy.device.type != "cuda":
        return generator_forward_plain(generator, noisy)
    fn, args, out, _keep = prepare_forward(generator, noisy)
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"generator forward kernel launch failed: CUDA error {err}")
    if not torch.cuda.is_current_stream_capturing():   # a captured launch runs at replays
        forward_launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("generator_grad")
    i, ll, f, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p
    lib.ofdm_generator_grad_launch.argtypes = ([i, i, f, f, f, f] + [ptr, ll, ll, ll] * 2
                                               + [ptr] * 17)
    lib.ofdm_generator_grad_launch.restype = i
    for name in ("ofdm_generator_grad_slot_floats", "ofdm_generator_grad_out_floats"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    lib.ofdm_generator_grad_blocks.argtypes = [i, i]
    lib.ofdm_generator_grad_blocks.restype = i
    return lib


def _split(out: torch.Tensor):
    """The kernel's output buffer -> (gradient per parameter, metrics), as views."""
    grads, off = {}, 0
    for name, shape in PARAM_SHAPES:
        n = math.prod(shape)
        grads[name] = out[off:off + n].view(shape)
        off += n
    return grads, {m: out[off + i] for i, m in enumerate(METRICS)}


def prepare(generator, critic, clean, noisy, adv_weight: float, rec_weight: float):
    """Check the inputs and allocate the buffers: ``(launcher, its arguments,
    output buffer, buffers the launches read)``. ``launcher(*args)`` launches
    the kernel (both stages) once and returns a CUDA error code;
    ``generator_grad`` does this and counts it; repeating it times the
    kernel alone."""
    check_inputs(generator, critic, clean, noisy)
    b, dev = clean.shape[0], clean.device
    lib = _library()
    nblocks = lib.ofdm_generator_grad_blocks(b, build.sm_count(dev))
    scratch = torch.empty(nblocks * lib.ofdm_generator_grad_slot_floats(),
                          dtype=torch.float32, device=dev)
    out = torch.empty(lib.ofdm_generator_grad_out_floats(), dtype=torch.float32, device=dev)
    params = [p for m in (generator, critic) for p in m.parameters()]
    args = (b, nblocks, generator.leaky_slope, critic.leaky_slope, adv_weight, rec_weight,
            clean.data_ptr(), *clean.stride(), noisy.data_ptr(), *noisy.stride(),
            *(p.data_ptr() for p in params), scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    return lib.ofdm_generator_grad_launch, args, out, (scratch, params)


def _launch(generator, critic, clean, noisy, adv_weight: float, rec_weight: float):
    global launches
    fn, args, out, _keep = prepare(generator, critic, clean, noisy, adv_weight, rec_weight)
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"generator-gradient kernel launch failed: CUDA error {err}")
    if not torch.cuda.is_current_stream_capturing():   # a captured launch runs at replays
        launches += 1
    return _split(out)


def generator_grad(generator: nn.Module, critic: nn.Module, clean: torch.Tensor,
                   noisy: torch.Tensor, adv_weight: float, rec_weight: float
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(gradient per generator parameter, metrics) of the generator's loss:
    the kernel for CUDA tensors (one call, the results are views of its
    output), the plain version for CPU ones."""
    if clean.device.type == "cuda":
        return _launch(generator, critic, clean, noisy, adv_weight, rec_weight)
    return generator_grad_plain(generator, critic, clean, noisy, adv_weight, rec_weight)
