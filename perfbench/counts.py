"""Operations and bytes of the training step and of its two kernels, from
shapes, and the peaks they are held against.

The peaks are one NVIDIA H100 SXM's, from its data sheet: 67 TFLOP/s in
float32 outside the tensor cores (the cells run float32 with TF32 off) and
3.35 TB/s of HBM. A multiply-add is 2 FLOP. Nothing here reads a trace or
the program: every count follows from a configuration file's sizes.
"""

from __future__ import annotations

import math
from typing import Tuple

from .reference.models import param_shapes

FP32_FLOPS_PER_S = 67e12   # H100 SXM, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # H100 SXM


def _layer_lengths(config: dict) -> Tuple[dict, dict]:
    """The output length of every convolution of the generator and of the
    critic, by layer name."""
    L = config["frame_length"]
    if config["family"] == "mini":
        return ({"enc1": L // 2, "bottleneck": L // 4, "dec1": L // 2, "out_conv": L},
                {"conv1": L // 2, "conv2": L // 4})
    lv = config["levels"]
    gen = {}
    for i in range(lv):
        gen[f"enc{i+1}_1"] = gen[f"enc{i+1}_2"] = L >> (i + 1)
        gen[f"dec{i+1}_1"] = gen[f"dec{i+1}_2"] = L >> (lv - i - 1)
    gen["bottle1"] = gen["bottle2"] = L >> lv
    gen["final"] = L
    return gen, {f"conv{i+1}": L >> (i + 1) for i in range(lv)}


def macs_per_frame(config: dict) -> Tuple[int, int]:
    """Multiply-adds a frame of one generator forward and of one critic
    forward (its dense layer included): K * C_in * C_out * L_out a
    convolution."""
    shapes = param_shapes(config)
    lengths = _layer_lengths(config)
    out = []
    for net, lens in zip(("generator", "critic"), lengths):
        total = 0
        for layer, l_out in lens.items():
            c_out, c_in, k = shapes[net][f"{layer}.weight"]
            total += k * c_in * c_out * l_out
        out.append(total)
    out[1] += math.prod(shapes["critic"]["dense.weight"])
    return out[0], out[1]


def step_flops(config: dict, batch: int, n_critic: int = 5) -> float:
    """FLOP of one outer step, counting a backward as twice its forward and
    no recomputation: each critic update runs the generator once (1 G) and
    the critic on the real and fake frames with its backward (6 D) and the
    penalty (its forward, input gradient and the second-order parameter
    gradient of both: 6 D); the generator update runs the generator with
    its backward (3 G) and, where there is a critic (n_critic > 0), the
    critic forward and back to the frames (2 D). At n_critic 5: 8 G + 62 D
    multiply-adds a frame."""
    g, d = macs_per_frame(config)
    return 2.0 * batch * ((n_critic + 3) * g + (12 * n_critic + 2 * (n_critic > 0)) * d)


def _taps_inside(l_in: int, stride: int, k: int = 3, pad: int = 1) -> int:
    """Conv taps that fall inside a frame of ``l_in`` samples: the non-zero
    blocks of the layer's dense (block-Toeplitz) matrix."""
    l_out = (l_in + 2 * pad - k) // stride + 1
    return sum(1 for t in range(l_out) for kk in range(k) if 0 <= stride * t - pad + kk < l_in)


def critic_macs_per_frame() -> int:
    """Multiply-adds a frame of one critic-gradient evaluation of the mini
    critic at 16 samples: of its 18 products with a layer matrix (6
    forward, 6 Wasserstein backward, 6 gradient penalty), 8 use the first
    layer's and 10 the second's, each needing only the matrix's non-zeros
    (the conv taps inside the frame), not its dense 64 x 64."""
    nz1 = _taps_inside(16, 2) * 4 * 8
    nz2 = _taps_inside(8, 2) * 8 * 16
    return 8 * nz1 + 10 * nz2


CRITIC_PARAMS = 521


def critic_bound_ms(batch: int) -> Tuple[float, str]:
    """Least time of one critic-gradient call: its float32 inputs (clean,
    fake and noisy ``[B, 16, 2]``, alpha, the parameters) read once and a
    gradient a parameter plus five metrics written once, against its
    multiply-adds."""
    frame_bytes = 3 * 32 * 4 + 4
    t_bytes = (batch * frame_bytes + (2 * CRITIC_PARAMS + 5) * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = batch * 2 * critic_macs_per_frame() / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def datagen_bound_ms(batch: int, L: int) -> Tuple[float, str]:
    """Least time of one datagen call: the outputs the step reads (noisy,
    clean ``[B, L, 2]`` and snr ``[B]``) written once, against the least
    operations of the same work: an inverse DFT in about 5 L log2 L FLOP a
    frame plus about 30 a sample for the draws, impairments and noise."""
    t_bytes = batch * (2 * 2 * L + 1) * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = batch * (5 * L * math.log2(L) + 30 * L) / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
