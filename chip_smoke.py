#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Builds the port's CUDA kernels from ``ofdmgan_tpu_torch/csrc``, holds each
against its plain PyTorch version at the main path's shapes and times it
beside that version (phases ``datagen``, ``critic`` and ``generator``; the
generator-gradient kernel, which replaces no TPU kernel, also beside
autograd's generator update, and the generator forward kernel, which
replaces none either, beside the module's forward through cuDNN; the
critic-gradient kernel as built: its registers, spills, frames a warp and
blocks an SM; every other shape, form and precision:
``tests/test_torch_cuda.py``). Then it trains the mini CWGAN-GP for two
short epochs through the four kernels with ``Trainer``,
and checks that the kernel path and the plain path take the same step. A
mini trainer on the card runs its second epoch as one CUDA graph replay
(``training/chunks.py``); a replay calls no wrapper, so wherever a trainer
runs, its launches are the wrappers' counts plus the kernels each replay ran,
counted by name from that replay's profiler trace (``counted_launches``),
and every such run is held to its exact count and to its route of each
kernel. Phase ``train_scope``
then trains a configuration outside the datagen kernel's scope (multipath
channel, every default impairment, an EMA, a checkpoint each epoch) and
checks that it takes the FFT datagen and the critic kernel, that a trainer
resumed from its checkpoint takes the same step, and that an L = 32 Rician
step takes neither kernel. Phase ``full`` trains the full U-Net pair
(3,936,578 and 524,129 parameters) at full width, L = 1024 and batch 512,
two epochs of four outer steps through the datagen kernel and the autograd
critic in float32 with TF32 off; checks that its kernel step and its
reference step agree, and that the fused decoder computes the module's
forward; and times the step fused and unfused. Phase ``quant`` trains the
mini pair under quantization-aware training, ``qat`` and then
``rtl_faithful`` with the residual head (the RTL-residual datapath), each
2 x 20 steps through both kernels, and the full U-Net under
``quant_bits`` 8 16 (2 x 4 steps through the datagen kernel); checks each
run's FPGA export, the Verilog ROM's round trip, and the bit-true integer
datapath on the card against the same call on the CPU and against the
native engine ``native/fixsim.cpp`` (built with g++); and times the QAT
steps against the float ones. Phase ``eval`` runs the evaluation layer on
the checkpoints of phases ``train`` and ``full`` through its CLIs
(``--device cuda:0``; their printed output goes to
``build/chip_smoke/eval/``): the mini sweep of ``benchmark_comparison`` at
its defaults (100 trials, SNR 0 to 30 dB in steps of 5, linear and
nonlinear, GAN-Q on the integer datapath) in both protocols and both
normalizations, the full-width sweep (L = 1024, 100 trials, 7 SNRs, GAN-Q
under ``quant_bits`` 8 16), ``eval_checkpoint`` at batch 512 and L = 1024
as the module, ``--serving`` and ``--quant_bits 8 16`` (each twice: the
first rate includes cuDNN's first calls), the distributional report, BER
and ``enhance`` in both layouts; it launches neither kernel. Phase
``verify`` runs the hardware-verification and handoff slice on the card,
each part against the CPU: golden vectors and the architecture check on
phase ``train``'s checkpoint, the reconstruction proof (SNR 0 to 30 dB,
float and integer), the integer-datapath cosim report with fixsim, the
RTL handoff bundle (``make_rtl_handoff``) from phase ``quant``'s
RTL-residual generator, the simpleGAN through its CLI at the recipe's
30,000 steps and 2,000 steps on the card and the CPU from one draw set,
and ``selfcheck`` (in this process and as a CLI), whose training step
and kernel statistics launch both kernels. Phase ``serve`` exports phase
``train``'s mini checkpoint, phase ``quant``'s RTL-residual one
(``--residual``) and phase ``full``'s U-Net (bf16) with ``export_serving``
on the card and on the CPU, each selftested and reloaded here; runs
``bench_infer`` for both families at full width (mini batch 65,536, full
512), datagen in the loop and resident, and the full model unfused, with
128 applies a window (64 for the full model), half the CLI's default, for
time; checks the repaired numerics (TF32 off in a fresh process that only
imports the port and writes golden vectors with a bare ``.cuda()`` model;
the ``bfloat16`` mode's critic forward on the card against the CPU's, and
its routes); takes one full step with ``--remat`` and one without from
phase ``full``'s trained state, then times both with their peak memory;
and runs the image-transmission study with the mini generator on the card
against the CPU. Phase ``parallel`` runs the parallel strategies: leg a
trains the mini recipe's data-parallel trainer 2 x 20 steps on a world of
one over NCCL (NCCL refuses two ranks on one GPU) and holds five more steps
bit for bit against the plain step; leg b trains it on two ranks that share
the card over gloo, in lockstep, and holds one step against a
single-process step on both ranks' draws; leg c trains the full U-Net pair
at full width under gspmd ``{dp: 2}``, ``{dp: 1, tp: 2}``, ``{dp: 1, sp:
2}`` and the ``pp = 2`` pipeline (supervised, 8 microbatches), each rank
resuming from one warmed-up checkpoint, and holds each layout's step against
the single-device step on the same global draws (the datagen kernel's);
then times each leg. Phase ``layout`` runs the TPU layout variants: leg a
trains the mini recipe 2 x 20 steps through the flat ``[B, F]`` step
(``--flat``) and both kernels, in graphed chunks, and holds one flat step
against the module step; leg b runs the reference bench's headline flags
(``--flat --premap --conv_expand onehot --mm tf32x3_gp --act_dtype
bfloat16 --matmul_precision bf16_tf32gp --critic_unroll 5 --prng rbg``) at
batch 65,536, two chunks of 32 steps through the datagen kernel (the
first eager, the second a graph replay), times replayed chunks, eager
steps and the eager steps as a trainer without graphs runs them (its
schedule on the host, Adam not capturable), holds one step on the card
against the same step on the CPU
from one state and CPU-made draws, with a control (the same step with
Hopper TF32 in the penalty chain in place of the bf16x3 products) that
must fail that gate, and holds the flat critic's ``tf32_matmul`` scores
and penalty gradients on the card against the CPU; leg c takes the mini
default's chunk of 26 steps, captures it, and holds one replay against the
same chunk run eagerly from the same state and generator state, checks
that a second replay from that state repeats it and that a replay after
the generator moved on draws other batches, counts the launches of a
replay from its trace (and checks that neither the capture nor the replay
moved a wrapper's count), and times and profiles a replayed chunk, the
eager chunk and the eager chunk as a trainer without graphs runs it. Phase
``completion`` runs what the last slice ported: leg a trains the mini
``--rtl_qat --residual --act_dtype bfloat16`` recipe 2 x 20 steps through
the datagen kernel (the critic through autograd, in graphed chunks),
holds one step on the card against the same step on the CPU from one
state and CPU-made draws, and shows that an e4m3fn ``qat`` forward is NaN
everywhere on the card as on the CPU (``rtl_faithful`` alone finite on
both); leg b trains the mini default under gspmd ``{dp: 1, sp: 2}`` on two
ranks sharing the card over gloo (one epoch) and holds one step against
the single-process step on the same global draws; leg c takes the full U-Net at
full width (phase ``parallel``'s global batch) under gspmd dp2, tp2 and sp2
with ``--quant_bits 8 16`` and tp2 and sp2 with ``--fused_decoder``, each
from phase ``parallel``'s warmed-up checkpoint, against the single-device
step of the same generator on the same draws, and times each; leg d takes
the packed step (``ops/packed_step.py``) at batch 65,536, L = 16, p = 4
and p = 2, two chunks of 32 steps through the datagen kernel, holds one
packed step against the module step on the same batch's ``[B, L, 2]`` view
from one state, and times both beside the flat step. Phase ``bench``
runs the two training benches through their entry points, in this
process: ``ofdmgan_tpu_torch.bench`` at batch 65,536 with the reference's
headline flags, with ``--fuse_realfake``, with ``--flat_params``, with
``--pallas_datagen --pallas_critic --matmul_precision float32 --act_dtype
none`` (the ``[B, L, 2]`` module step through both kernels) and with
``--pallas_datagen --pallas_critic --matmul_precision float32`` (the same
at the CLI's bf16 storage: the critic kernel's storage form), each at
``--scan_steps 64`` (two replays of a graph of 32 steps a window, cut from
3,072 for time), and with ``--packed 4 --scan_steps 32`` (eager), each
with one warm-up window (which holds the eager chunk and the capture) and
the median of 3 timed ones (the CLI's 3 and 5, cut for time; 2 for the
bf16-storage leg); then
``bench_full_train`` on its ``gan_f32`` and ``supervised_f32`` rows at 2
steps a window and 2 windows (cut from 16 and 5). Each line must parse
with a finite, positive value, the card's name and no baseline; each
leg's routes and launches are exact (a window's steps each launch the
datagen kernel once and, on the kernel leg, the critic kernel five times;
the replays, which call no wrapper, are counted, and the launches of one
more replay of the same graph are counted from its trace). From the
headline leg's trained state, one step of the ``--fuse_realfake`` step and
one of the ``--flat_params`` step are held against the plain bench step;
from the bf16-storage leg's, its first critic gradient through the kernel
against the kernel's plain version on the same tensors, and its penalty
uniforms on the bf16 grid k/128 (the reference's bf16 draws).
Every phase prints one JSON line with its wall seconds as it ends. Any failed check raises, and the
script exits non-zero. The last lines are the kernel table, the card's name
and power limit, and the result line.

Tolerances: the kernels' are ``ofdmgan_tpu_torch/utils/kernel_checks.py``'s,
at L = 16 and B = 64 and 2^20 for the datagen kernel (both chains), B = 64
and 65,536 for the others (the critic's float32 and storage forms). One
outer step through the kernels and one through the plain path (FFT
datagen, autograd critic and generator update) from the same state and
draws: each parameter tensor's update agrees within STEP_RTOL of its
largest entry. The kernel table gives each kernel's time per call (``ms``,
with its host work), device time per call (``device_us_per_launch``: the
profiler's time of the kernel's own launches), plain time (and the
generator kernel's autograd time), bound (``perfbench/counts.py``'s, and
the generator kernel's
``perfbench/metrics/generator_grad_roofline.py``'s; the critic kernel's
storage form's with 2-byte ``clean`` and ``noisy``) and error at the main
path's batch (64); the phase lines give them at every length and batch
timed, and at the large batches also the time per launch of back-to-back
launches of the kernel alone (CUDA events; at B = 64 that would time the
host's call rate, not the device).
Phase ``full``: the datagen kernel and its plain version at the kernel's
shape there (B = 512, L = 1024, linear and nonlinear), each against a
float64 evaluation of the function: both are 1024-term float32 sums some
2e-6 from the exact value at their worst entries (past atol 1e-6 where a
value is small), so the kernel's worst error must stay within 1.5 times
its plain version's; the kernel step and the reference step on the
kernel's batch, with cuDNN's deterministic algorithms, within STEP_RTOL,
1e-3, of each tensor's largest update (cuDNN's default weight-gradient
algorithms add in another order on every run; their spread is reported,
not gated); the kernel step on the kernel's batch and the reference step
on the FFT datagen's batch from the same draws, the plain path end to end,
with metrics within rtol 1e-3: their inputs differ by rounding (about
2e-6), which the full step carries into its update as it does cuDNN's
summation order (a few hundredths of a tensor's largest update on a CPU,
32 to 128 frames), so the update difference is reported, not gated;
the fused decoder within atol 1e-5 of the module's tanh output (the bound
of ``tests/test_unet_infer.py``). Its step times are host clocks around
five steps ending in a synchronize, after two warm-up steps, unfused,
fused, fused, unfused; FLOP per step are ``perfbench/counts.step_flops``'s.
Phase ``quant``: the QAT kernel step and reference step
on one batch, the kernel datagen's (so that both see the same Q8.8
rounding boundaries), within 1e-3 of each tensor's largest update, as
above; the integer datapath bit for bit (``torch.equal``) on 2^18 frames.
Its mini step times are host clocks around 50 steps ending in a
synchronize, float, QAT, QAT, float; its full step time is taken as phase
``full`` takes its own, with cuDNN's default algorithms, and its device
time by kind of kernel (``torch.profiler``, one step) beside that of the
same weights with quantization off, in the same process. Phase ``eval``,
the card against the CPU on the same draws (made on the CPU, or on the card
and copied): the mini estimates of ZF, MMSE, Wiener, NoEQ, GAN and LMS by
element within atol 2e-5, DFE (hard decisions) and RLS (its P recursion
amplifies rounding) by mean MSE within rtol 1e-3, GAN-Q bit for bit
against the CPU's integer datapath on the card's own noisy frames
(``float_to_q88`` truncates, so frames that differ by rounding may differ
by one Q8.8 step); the full sweep by each method's mean MSE within rtol
1e-3 (atol 1e-9: the oracle ZF's MSE is rounding noise, ~4e-16); the full
forward within atol 1e-4, and the serving (bf16) and quantized forwards
within 3 times the CPU's own distance from its float32 forward; the
report's statistics within rtol 1e-3, its null floor within 6 times the
RMS of 8 independent clean-against-clean MMD^2 pairs (a Student-t ratio
with 8 degrees of freedom: a false alarm about 3e-4 of the time); BER's
hard decisions equal except within 1e-6 of zero; ``enhance`` within atol
1e-5, its integer mode bit for bit. The oracle ZF is near perfect (MSE
under 1e-4) and NoEQ's MSE falls as the SNR rises. Phase ``verify``: the
golden output floats within atol 1e-6 of the CPU's, the card's Q8.8 files
its own floats' encoding and the CPU's but for entries whose two floats
straddle a Q8.8 step (1 LSB), the input files byte for byte; every
architecture item and cosim test passes, fixsim bit for bit on every
generator test; the proof's float MSEs within rtol 1e-5 and its integer
MSEs equal (its means are float64 sums, its noise scaled on the host);
the handoff bundles byte for byte, fixsim equal to every vector; the
simpleGAN's mean distance to the nearer pattern under 0.60 over 64
samples (``tests/test_simplegan.py``), its integer path bit for bit, and
its parameters after 500, 1,000, 1,500 and 2,000 steps on the card within
1e-4 of the CPU's, each tensor's difference over its layer's largest
entry (weight and bias together): CUDA's and the CPU's tanh, sigmoid and
log round apart by an ulp or two, which plain SGD carries without
amplifying (on an H100: at most 1.1e-7 in ``matlab`` mode and 4.6e-8 in
``exact``, growing from 4.7e-9 and 2.7e-8 after the first 500 steps); a
tensor's own largest entry is no scale where a bias crosses zero (the
critic's output bias is 6.2e-6 after 1,000 steps, where its 1.7e-9
difference read 2.8e-4); selfcheck ``ALL PASSED`` in both runs, its kernel statistics
within 0.01 of the FFT datagen's. Phase ``serve``: a mini export on the card
against the CPU's export on one CPU-made batch within atol 1e-6 (one float32
forward, summed in another order); the full bf16 export within 3 times the
CPU export's own distance from the float32 forward (as phase ``eval``
holds the serving forward: two bf16 forwards that round their products
and activations in different places differ by about that distance; whether
it is within 2e-2, the JAX package's bound for its own artifact, is
reported); the bench's datagen launches exactly one per apply in the
datagen-in-loop windows and none in the resident ones; the ``bfloat16``
critic forward, card against CPU, rtol 1e-5, atol 1e-6 (bf16 products are
exact in float32), but for scores where a layer-1 activation summed in
another order rounds to the other bf16 neighbour: at most 1 in 1,000, each
within one bf16 step (2^-8) of the scores' scale; the ``bfloat16`` step launches the datagen kernel once
and the critic kernel n_critic times, and its kernel step takes its
reference step's update within 1e-3 of each tensor's largest update (from
one state, the second step); the ``--remat`` step's update within 1e-6 of each
tensor's largest update of the plain step's, with cuDNN's deterministic
algorithms (recomputation computes the same function); the image study's
PSNR, SSIM, NMSE and BER within rtol 1e-4 of the CPU's. Phase
``parallel``: leg a ``torch.equal`` to the plain step (a mean over one rank
is exact; cuDNN's deterministic algorithms) with exactly one datagen and
five critic launches a step; leg b the ranks' parameters ``torch.equal``
after every step and, from the trained state, the two-rank step within
1e-3 of each tensor's largest update of the single-process step (deterministic
cuDNN); leg c, from PAR_WARM_STEPS single-device steps (from a fresh Adam
state an update carries rounding as a full step of either sign), each GAN
layout's step within 1e-2 and the pipeline's (supervised) within 1e-3 of
each tensor's largest update of the single-device step (deterministic
cuDNN), their metrics within rtol 1e-4, the ranks' parameters equal, the
datagen kernel launched, the pipeline's loss within rtol 1e-5. The GAN
gate is wider because every layout sums the step's reductions in another
order, and the GAN step's gradients (the critic's a difference of sums
over fake and real frames) then move by 2e-4 to 1.2e-3 of each tensor's
largest entry on the card; Adam with b1 = 0 divides each entry by its own
RMS, so an entry whose gradient and RMS are 1e-5 to 1e-4 of its tensor's
largest turns that into a share of a largest update: up to 2.9e-3 for the
single-device step with cuDNN's default algorithms, up to 4.6e-3 for a
layout (PERF.md section 6). Two controls
show the gate's power: the same single-device step with TF32 operands,
which must lie beyond it (7.4e-2 GAN, 0.78 supervised, on an H100), and the
CPU tests' steps with one collective left out (1.9 of a largest update,
``tests/test_torch_parallel_gspmd.py``). The phase reports, for each
layout and control, the worst entry: its tensor, its update, last gradient
and RMS over their tensor's largest, and the last gradients' distance
before Adam's division. Leg c's global batch is 512
where two ranks at the single-device step's peak fit 90 % of the card, else
256 (printed with its reason); its times are host clocks around
PAR_TIMED_STEPS steps ending in a synchronize, with each rank's peak memory
and the bytes through collectives a step (``staged_bytes``: the CUDA
payloads gloo takes through host memory). Phase ``layout``: the flat step
against the module step from one state and one batch within STEP_RTOL of
each tensor's largest update, as the kernel and plain steps (the flat
generator's matmuls and the module's convolutions sum in another order;
9.0e-6 on an H100); the headline step on the card against the CPU, from
the state the run left, within LAYOUT_CPU_FACTOR, 2, times the floor
measured beside it, of each tensor's largest update, deterministic cuDNN.
The floor is the CPU step from every parameter one float32 ulp up against
the CPU step: the bf16 step turns any float32-level difference (here the
card's other summation order) into bf16 roundings that land apart, and its
five critic updates, Adam-normalized, carry them on, so how far such a
difference moves it depends on the state: on an H100 the card read 0.85,
0.67 and 0.58 of the floor after 64, 160 and 288 steps (1.1e-3, 8.7e-3,
2.3e-2 of each tensor's largest update). The control must lie beyond the
same limit (0.23 to 0.37);
``tf32_matmul``'s scores and penalty gradients within LAYOUT_TF32_RTOL,
1e-3, of each tensor's largest entry (measured 1.4e-7 and 2.2e-5); the
replayed chunk against the eager chunk within GRAPH_RTOL, 1e-6, of each
tensor's largest update over the chunk (the same kernels on the same
inputs: measured 0), the second replay equal to the first; launches exact
in every leg. All on an H100 (NVIDIA H100 80GB HBM3, 700.00 W). Its times
are host clocks ending in a synchronize, each call timed alone after one
untimed call, given as the median of LAYOUT_TIMED_RUNS calls with their
spread: chunks of 26 steps at batch 64, chunks of 32 or calls of
LAYOUT_EAGER_STEPS eager steps at 65,536. Phase ``completion``: leg a,
the step on the card against the CPU, every parameter within a tenth of
the learning rate and each tensor's update within 0.02 of the CPU
update's norm (``tests/test_torch_act_dtype.py``'s bf16 tolerances: the
critic's bf16 storage rounds sums taken in another order; the QAT
generator's operands lie on the 2^-8 and 2^-7 grids, so its sums are
exact on both devices), the e4m3fn NaN patterns equal; exact launches
(40 datagen, 0 critic). Leg b within STEP_RTOL of each tensor's largest
update (deterministic cuDNN), the ranks' parameters equal, 21 datagen and
no critic launches a rank. Leg c: the fused layouts within phase
``parallel``'s PAR_STEP_RTOL (1e-2 of each tensor's largest update, the
same reasoning), with the fused step at TF32 beyond it, from phase
``parallel``'s state warmed by PAR_WARM_STEPS steps (from a state warmed
by 2 steps the fused tp2 layout read 1.4e-2 and 3.0e-2 at a
near-zero-gradient entry whose update is 0.3 of its tensor's largest, on
an H100: the less Adam's moments have seen, the more a summation order
moves such an entry). The fused step's own spread under cuDNN's default
algorithms is reported. The quantized layouts are held by their metrics
(PAR_METRIC_RTOL) and by every quantization point's maximum on each
rank's shard against the single-device step's on the global batch, within
COMP_SCALE_RTOL, 2^-13 (four 16-bit steps; under tp the row-parallel
sums round apart; 0 under dp and sp on an H100, 4.9e-5 under tp); their
updates are reported, not gated: a float32 rounding that a layout moves
flips 16-bit steps of the activations, which Adam's per-entry division
carries into the update (under tp2 on an H100, 1.7e-2 of a largest
update from PAR_WARM_STEPS warm-up steps, 0.17 and 0.24 from 2; JAX's
own step moves 0.10 between dp1 and dp2 on the CPU). Leg
d: the packed step within STEP_RTOL of the module step's update (the
critic kernel and the packed critic's autograd sum in other orders),
exactly 2 x 32 + 1 datagen launches for each p. Its times are host clocks
ending in a synchronize: the second chunk of 32 for the packed step,
PACKED_TIMED_STEPS eager steps after two for the flat and module steps;
leg c's one timed step after one untimed. Phase ``bench``: from the
headline leg's trained state, on one batch and one set of penalty
uniforms, the ``--flat_params`` step's update within BENCH_GATE_RTOL, 1e-3,
of each tensor's largest update of the plain (per-parameter, unfused)
step, at the bench's numerics and at float32 (Adam is elementwise: the
same numbers, measured 0); the ``--fuse_realfake`` step's critic gradient
(its first critic update's, before Adam) within 1e-3 of each tensor's
largest entry of the plain step's at float32 (flat, premapped, ``mm``
ambient, both routes plain), where its parameter gradients' batch sums are
taken in another order, and within BENCH_FUSED_FACTOR, 4, times the
largest distance of the plain and the control critic gradients from a
float64 witness (a float64 copy of the critic module on the same batch
and fake frames): the fused distance is float32 rounding, not a fault; at
the bench's numerics (bf16 storage, ``bf16_tf32gp``) its distance from the
plain critic gradient, by norm over all tensors, within 4 times the
controls' largest (by norm, since the bf16 gradient rounds entry by entry:
one control once read 1.6e-2 by the largest entry against 2e-5 to 5e-5
for the others). The controls are the plain step on the same frames and
uniforms in other orders (reversed, rolled by half the batch, a fixed
permutation). The updates are reported, not gated: at 65,536 frames the
critic's gradient is a difference of a sum over fake frames and one over
real ones, so any reordering moves the entries whose gradient is near
zero, which Adam divides by their own RMS (on an H100, from the
headline's state after 512 steps, at float32: the controls 1.9e-3 to
2.4e-3 of a largest update, the fused step 1.2e-3 and 6.2e-3 in two runs;
at bf16 storage 1.2e-3 to 1.4e-2, where the reordering also turns into
bf16 roundings that land apart, as phase ``layout``'s one-ulp floor).
The bf16-storage kernel leg's first critic gradient within
BENCH_GATE_RTOL of each tensor's largest entry of the kernel's plain
version on the same tensors (the batch summed in another order; 4.3e-6 on
an H100). Phase ``bench``'s frames/s are the benches' own: the
median of 3 windows after 1 (the bf16-storage leg: of 2; the grid: of 2
after 2), each ended by a host read of the last step's loss.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import torch

MAIN_B = 64                 # the mini recipe's batch (config/config.yaml)
DATAGEN_TIMED = ((16, MAIN_B), (16, 1 << 20), (1024, 4096))   # (L, B)
KERNEL_BATCHES = (MAIN_B, 65536)   # the gradient kernels' held and timed batches
STEP_RTOL = 1e-3            # kernel vs plain outer step, of each tensor's largest update
RESUME_RTOL = 1e-6          # resumed vs uninterrupted step, of each tensor's largest update
FULL_B = 512               # the full recipe's batch (scripts/r4_fading_gan_queue.sh:28)
FULL_L = 1024
FULL_STEPS = 4             # outer steps per epoch of the full run
FULL_G_PARAMS, FULL_D_PARAMS = 3_936_578, 524_129
FULL_G_MACS, FULL_D_MACS = 200_048_640, 23_790_080   # per frame, unfused generator forward
DATAGEN_EXACT_RATIO = 1.5  # full: kernel's worst error from float64 over its plain version's
FULL_METRIC_RTOL = 1e-3    # full step's metrics on the kernel's vs the FFT datagen's batch
FUSED_ATOL = 1e-5          # fused against unfused decoder, tanh output (tests/test_unet_infer.py)
QUANT_FRAMES = 1 << 18     # integer datapath: card against CPU and against fixsim
QUANT_FULL_BITS = (8, 16)  # --quant_bits of the full U-Net run
FULL_EXPORT_LAYERS = 23    # levels 5: 10 encoder, 2 bottleneck, 10 decoder, final
EVAL_BATCHES = 4           # eval: batches of eval_checkpoint and the report (51,200-frame runs cut)
EVAL_FULL_CPU_TRIALS = 16  # eval: trials and frames of the full forward's CPU comparisons
EVAL_MINI_ATOL = 2e-5      # eval: mini estimates on the card against the CPU, by element
EVAL_MEAN_MSE_RTOL = 1e-3  # eval: per-method mean MSE, the card against the CPU
EVAL_FULL_ATOL = 1e-4      # eval: the full forward on the card against the CPU's (cuDNN sums)
EVAL_FORM_FACTOR = 3.0     # eval: serving/quantized forward, card against CPU, over the CPU's
                           # own distance from the float32 forward
EVAL_REPORT_RTOL = 1e-3    # eval: the report's statistics, the card against the CPU
EVAL_NULL_PAIRS = 8        # eval: independent clean-vs-clean MMD^2 pairs beside the null floor
EVAL_NULL_T = 6.0          # eval: |null floor| / their RMS (Student-t, 8 dof: p ~ 3e-4)
GOLDEN_ATOL = 1e-6         # verify: golden output floats, the card against the CPU
PROOF_RTOL = 1e-5          # verify: the proof's float MSEs, the card against the CPU
VERIFY_SNRS = (0, 5, 10, 15, 20, 25, 30)   # verify: the proof's SNRs (dB)
SIMPLEGAN_BAR = 0.60       # verify: mean distance to the nearer pattern (tests/test_simplegan.py)
SIMPLEGAN_CMP_STEPS = 2000  # verify: simpleGAN steps on the card and the CPU from one draw set
SIMPLEGAN_RTOL = 1e-4      # verify: their parameters, of each layer's largest entry
SIMPLEGAN_FILE_LINES = {"gen_w1.txt": 6, "gen_b1.txt": 3, "gen_w2.txt": 27, "gen_b2.txt": 9,
                        "disc_w1.txt": 27, "disc_b1.txt": 3, "disc_w2.txt": 3, "disc_b2.txt": 1}
SERVE_MINI_ATOL = 1e-6     # serve: a mini export reloaded on the card against the CPU's export
SERVE_FULL_FACTOR = 3.0    # serve: the full bf16 export, card against CPU, over the CPU
                           # export's own distance from the float32 forward (as EVAL_FORM_FACTOR)
SERVE_BF16_ATOL = 2e-2     # serve: reported beside it (tests/test_export_serving.py's bound)
SERVE_SCAN_STEPS = 128     # serve: bench_infer's applies per window, half its 256 (full: 64)
SERVE_BF16_RTOL = 1e-5     # serve: a bfloat16-mode critic forward, card against CPU
REMAT_RTOL = 1e-6          # serve: a --remat full step against the plain one, of each
                           # tensor's largest update (deterministic cuDNN)
FULL_STEP_PEAK_GB = 36.40  # the full step's peak memory recorded before (PERF.md section 5)
TRAIN_LOG_KEYS = {"train/d_loss", "train/g_loss", "train/wasserstein", "train/rec_loss",
                  "train/gp", "val/rec_loss", "val/mse"}   # the reference's log keys
PAR_MINI_STEPS = 20        # parallel: mini steps per epoch (two epochs) of legs a and b
PAR_CHECK_STEPS = 5        # parallel: leg a's steps held bit for bit against the plain step;
                           # leg b's steps with the ranks' parameters compared after each
PAR_WARM_STEPS = 6         # parallel, leg c: single-device steps before the compared one
PAR_TIMED_STEPS = 2        # parallel, leg c: timed steps per layout
PAR_SEED = 77              # parallel, leg c: the compared step's generator seed
PAR_TIMEOUT_S = 600        # parallel: each launch of ranks must end within this
PAR_PP_RTOL = 1e-5         # parallel: the pipeline's loss against the single-device step's
PAR_STEP_RTOL = {"gan": 1e-2,   # parallel, leg c: a layout's update against the single-
                 "sup": 1e-3}   # device step's, of each tensor's largest update (the module
                                # docstring says why the GAN step's is wider)
PAR_METRIC_RTOL = 1e-4     # parallel, leg c: its metrics against the single-device step's
PAR_LAYOUTS = {"dp2": dict(strategy="gspmd", data_parallel=2),
               "tp2": dict(strategy="gspmd", data_parallel=1, tensor_parallel=2),
               "sp2": dict(strategy="gspmd", data_parallel=1, seq_parallel=2),
               "pp2": dict(strategy="pp", pipeline_parallel=2, microbatches=8)}
LAYOUT_STEPS = 20          # layout, leg a: flat mini steps per epoch (two epochs)
LAYOUT_B = 65536           # layout, leg b: the reference bench's headline batch (bench.py:139)
LAYOUT_SCAN = 32           # layout, leg b: its chunk; two chunks
LAYOUT_HEADLINE = dict(flat_step=True, premap=True, conv_expand="onehot", mm="tf32x3_gp",
                       act_dtype="bfloat16", matmul_precision="bf16_tf32gp", critic_unroll=5,
                       prng="rbg")   # bench.py's defaults (bench.py:139-264)
LAYOUT_CPU_FACTOR = 2.0    # layout, leg b: the headline step, card against CPU, of each
                           # tensor's largest update, over the floor measured beside it
                           # (see the docstring)
LAYOUT_TF32_RTOL = 1e-3    # layout, leg b: tf32_matmul's forward and the penalty's parameter
                           # gradients, card against CPU, of each tensor's largest entry
LAYOUT_CHUNK = 26          # layout, leg c: the default configuration's chunk (156 steps an epoch)
LAYOUT_EAGER_STEPS = 4     # layout, leg b: outer steps a timed eager call
LAYOUT_TIMED_RUNS = 3      # layout, legs b and c: timed calls of each form, after a warm one
GRAPH_RTOL = 1e-6          # layout, leg c: a replayed chunk against the eager chunk, of each
                           # tensor's largest update over the chunk (deterministic cuDNN)
COMP_STEPS = 20            # completion, leg a: rtl_qat bf16 steps per epoch (two epochs)
COMP_PARAM_LR = 0.1        # completion, leg a: the step, card against CPU: every parameter within
COMP_NORM_RTOL = 0.02      # a tenth of lr, each update within 0.02 of the CPU update's norm
                           # (tests/test_torch_act_dtype.py's bf16 tolerances)
COMP_LAYOUTS = {"dp2_quant": dict(data_parallel=2, quant_bits=(8, 16)),
                "tp2_quant": dict(data_parallel=1, tensor_parallel=2, quant_bits=(8, 16)),
                "sp2_quant": dict(data_parallel=1, seq_parallel=2, quant_bits=(8, 16)),
                "tp2_fused": dict(data_parallel=1, tensor_parallel=2, fused_decoder=True),
                "sp2_fused": dict(data_parallel=1, seq_parallel=2, fused_decoder=True)}
COMP_SCALE_RTOL = 2.0 ** -13  # completion, leg c: a quantization point's maximum on a rank's
                              # shard against the single-device step's (four 16-bit steps)
COMP_TIMED_STEPS = 1       # completion, leg c: timed steps per layout, after one untimed step
PACKED_B = 65536           # completion, leg d: the reference bench's batch (bench.py:56)
PACKED_SCAN = 32           # completion, leg d: its chunk; two chunks for each p
PACKED_PS = (4, 2)
PACKED_TIMED_STEPS = 8     # completion, leg d: timed steps of the flat and module steps
BENCH_SCAN = 64            # bench: --scan_steps of the graphed legs (chunks of 32, two a window),
                           # cut from the CLI's 3,072 for time
BENCH_LEGS = {             # bench: the legs of ofdmgan_tpu_torch.bench, with their flags
    "headline": [],
    "fuse_realfake": ["--fuse_realfake"],
    "flat_params": ["--flat_params"],
    "kernels": ["--pallas_datagen", "--pallas_critic", "--matmul_precision", "float32",
                "--act_dtype", "none"],
    # the critic kernel's storage form: bf16 storage, the CLI's default
    "kernels_bf16": ["--pallas_datagen", "--pallas_critic", "--matmul_precision", "float32"],
    "packed4": ["--packed", "4", "--scan_steps", "32"],   # eager: 32 steps a window
}
BENCH_WINDOWS = (1, 3)     # bench: warm-up and timed windows a leg (the CLI's 3 and 5), cut for
                           # time: the first holds the eager chunk and the capture
BENCH_LEG_WINDOWS = {"kernels_bf16": (1, 2)}   # bench: legs cut further, for time
BENCH_GRID = ("gan_f32", "supervised_f32")   # bench: rows of bench_full_train, of its 14
BENCH_GRID_SCAN, BENCH_GRID_WINDOWS = 2, 2   # ... cut from 16 steps and 5 windows for time
BENCH_GATE_RTOL = 1e-3     # bench: the fused critic gradient and the flat_params update
                           # against the plain step's, of each tensor's largest entry
BENCH_FUSED_FACTOR = 4     # bench: the fused critic gradient's distance, from its float64
                           # witness and (bf16 storage, by norm) from the plain one, at most
                           # this times the plain and control gradients' largest
BENCH_ORDERS = {           # bench: the controls' orders of the frames (a step's batch sums)
    "reversed": lambda n, dev: torch.arange(n - 1, -1, -1, device=dev),
    "rolled": lambda n, dev: torch.arange(n, device=dev).roll(n // 2),
    "permuted": lambda n, dev: torch.randperm(n, generator=torch.Generator().manual_seed(5)).to(dev),
}


def log(phase: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": phase, "seconds": round(time.time() - t0, 3), **fields}),
          flush=True)


def time_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def back_to_back_us_per_launch(fn, args, n: int = 200) -> float:
    """Microseconds per launch: CUDA events around ``n`` back-to-back
    launches of the kernel alone (``fn(*args)`` from the wrapper's
    ``prepare``: no checks or allocations between launches). Device time
    only where a launch takes longer on the device than on the host."""
    for _ in range(10):
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    errs = {fn(*args) for _ in range(n)}
    end.record()
    end.synchronize()
    if errs != {0}:
        raise RuntimeError(f"kernel launches failed: CUDA errors {errs}")
    return start.elapsed_time(end) / n * 1e3


# kinds of kernel by the words their names hold: the categories of
# scripts/torch_step_profile.py, with ATen's reductions apart
KERNEL_KINDS = (("datagen_kernel", ("datagen_kernel",)), ("critic_grad", ("critic_grad",)),
                ("adam", ("adam", "multi_tensor")), ("reduce", ("at::native::reduce_kernel",)),
                ("conv", ("conv", "cudnn", "xmma", "gemm", "implicit", "wgrad", "dgrad", "sm90",
                          "cutlass", "winograd", "fft")),
                ("copy_and_elementwise", ("elementwise", "copy", "memcpy", "memset", "fill",
                                          "index", "cat", "pad")))


def kernel_kind(name: str) -> str:
    name = name.lower()
    return next((c for c, words in KERNEL_KINDS if any(w in name for w in words)), "other")


def device_ms_by_kind(step, rng, n: int = 1) -> dict:
    """Device ms per outer step of ``step`` by kind of kernel
    (``KERNEL_KINDS``) and by kernel, and ATen calls per step, from
    ``torch.profiler`` over ``n`` steps."""
    from ofdmgan_tpu_torch.utils.profiling import device_ms_by_kernel, traced
    events = traced(lambda: step(rng), n)
    by_kernel = device_ms_by_kernel(events, n)
    if not by_kernel:
        raise RuntimeError("the profiler traced no device time for the full step")
    by_kind = {}
    for k, ms in by_kernel.items():
        by_kind[kernel_kind(k)] = by_kind.get(kernel_kind(k), 0.0) + ms
    aten = sum(e.count for e in events if e.key.startswith("aten::"))
    return {"total": sum(by_kernel.values()), "by_kind": by_kind, "by_kernel": by_kernel,
            "aten_calls": aten / n}


def max_err(got: dict, ref: dict, keys=None) -> float:
    """The largest difference of ``got`` from ``ref`` over ``keys`` (all of
    ``ref``'s by default)."""
    return max(float((got[k] - ref[k]).abs().max()) for k in (ref if keys is None else keys))


def critic_storage_bound_ms(b: int) -> tuple[float, str]:
    """``perfbench.counts.critic_bound_ms`` for the storage form (``clean``
    and ``noisy`` read as 2-byte bf16): only its bytes term shrinks, so
    where the float32 form is bound by its operations (at every timed batch;
    by its parameters' bytes below 3 frames), so is the storage form, at
    the same bound."""
    from perfbench import counts
    bound, by = counts.critic_bound_ms(b)
    if by != "operations":
        raise AssertionError(f"the critic kernel is bound by {by} at B = {b}: the storage "
                             "form's bound needs its own bytes term")
    return bound, by


def generator_bound_ms(b: int) -> tuple[float, str]:
    """The generator-gradient kernel's least time for one call at batch
    ``b`` and what bounds it: the bound of the benchmark's
    ``generator_grad_roofline`` (``perfbench/metrics/``), at the same peaks."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent / "perfbench" / "metrics" / "generator_grad_roofline.py"
    spec = importlib.util.spec_from_file_location("generator_grad_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.bound_ms(b)


def updates_agree(start: dict, a: dict, b: dict, rtol, what: str) -> tuple:
    """(largest difference, largest difference over the tensor's largest
    update) of two updates from ``start``, per parameter tensor; raises where
    a difference passes ``rtol`` of that tensor's largest update (``b``'s),
    unless ``rtol`` is None."""
    worst_abs, worst_rel = 0.0, 0.0
    for name, p0 in start.items():
        upd_a, upd_b = (a[name] - p0).detach(), (b[name] - p0).detach()
        diff, size = float((upd_a - upd_b).abs().max()), float(upd_b.abs().max())
        if rtol is not None and not diff <= rtol * size + 1e-9:   # so that a NaN fails
            raise AssertionError(f"{what} differ on {name}: {diff:.3e} against a largest "
                                 f"update of {size:.3e} (limit {rtol} of it)")
        worst_abs = max(worst_abs, diff)
        worst_rel = max(worst_rel, diff / size if size else 0.0)
    return worst_abs, worst_rel


def clone_step(trainer, reference: bool, gen_forward=None, device=None, **step_kw):
    """A ``TrainStep`` on deep copies of ``trainer``'s models and Adam states
    (and StepLR positions, held on the host), on ``device`` (default: the
    trainer's): ``reference`` selects the reference step, ``gen_forward``
    the training forward, ``step_kw`` the step's other settings."""
    from ofdmgan_tpu_torch.training.schedules import make_adam
    from ofdmgan_tpu_torch.training.wgan_gp import TrainStep
    g, d = copy.deepcopy(trainer.generator), copy.deepcopy(trainer.critic)
    if device is not None:
        g, d = g.to(device), d.to(device)
    tr = trainer.config.training
    opt_g = make_adam(g.parameters(), tr.lr_generator, tr.betas, 1)
    opt_d = make_adam(d.parameters(), tr.lr_discriminator, tr.betas, 1)
    for new, old in ((opt_g, trainer.opt_g), (opt_d, trainer.opt_d)):
        new.load_state_dict(*copy.deepcopy(old.state_dict()))
    return TrainStep(g, d, opt_g, opt_d, trainer.dg_cfg, trainer.loss_cfg, trainer.batch_size,
                     reference=reference, gen_forward=gen_forward, **step_kw)


def all_params(model) -> dict:
    """Every parameter of a trainer's or a step's generator and critic."""
    return {**{f"generator.{n}": p for n, p in model.generator.named_parameters()},
            **{f"critic.{n}": p for n, p in model.critic.named_parameters()}}


def timed_steps(step, rng, n: int = 5, warmup: int = 2) -> tuple[float, int]:
    """(host ms per outer step over ``n`` steps ending in a synchronize,
    after ``warmup`` steps; peak device memory of those steps)."""
    for _ in range(warmup):
        step(rng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    for _ in range(n):
        step(rng)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e3, torch.cuda.max_memory_allocated()


RETRACED = {"replay": 0}   # replays traced again (``utils/profiling.retraces``: the rest)
TRACE_SENTINELS = 512  # Box-Muller launches that open a traced window (see replay_launches)
TRACE_SENTINEL_GROUP = 64   # ... in groups, each ended by a synchronize
# the port's kernels by the names the profiler gives them (csrc/*.cu); the
# critic wrapper launches the per-block kernel and its sum together
TRACED_KERNELS = {"datagen": "datagen_kernel", "critic_grad": "critic_grad_kernel",
                  "critic_grad_sum": "critic_grad_sum_kernel",
                  "generator_grad": "generator_grad_kernel",
                  "generator_grad_sum": "generator_grad_sum_kernel",
                  "generator_forward": "generator_forward_kernel"}
# launch counts, by wrapper
KERNELS = ("datagen", "critic_grad", "generator_grad", "generator_forward")


class TraceLost(RuntimeError):
    """A traced window lost every sentinel launch (``replay_launches``)."""


def traced_replay(trainer, replay) -> tuple:
    """``replay_launches(replay)`` for one replay of ``trainer``'s graphed
    chunk. Where the trace lost every sentinel, the state the replay
    started from is copied back in place (``_restore``: the parameters,
    Adam's states and counts, the generator) and the same replay is traced
    again, up to ``utils/profiling.ATTEMPTS`` times; the last replay's state
    stands."""
    from ofdmgan_tpu_torch.utils import profiling
    snap = _snapshot(trainer)
    for attempt in range(profiling.ATTEMPTS):
        try:
            return replay_launches(replay)
        except TraceLost:
            if attempt + 1 == profiling.ATTEMPTS:
                raise
            RETRACED["replay"] += 1
            _restore(trainer, snap)
    raise AssertionError("unreachable")


def replay_launches(fn) -> tuple:
    """``(fn(), launches)``: one call of ``fn`` (a graph replay, which calls
    no wrapper and so moves no launch count) under ``torch.profiler``, and
    the port's kernels that ran on the device in it, counted by name from
    the trace (``TRACED_KERNELS``). The trace's first step runs one small
    kernel and is dropped: the profiler misses the first kernel of a trace.
    The traced window can also lose its leading records (on an H100, the
    first 1 to 4 kernels of a replay in some calls, whole steps in others,
    and once all of 32 sentinel launches), so it opens with TRACE_SENTINELS
    launches of the datagen module's Box-Muller kernel, a name no step runs,
    in groups of TRACE_SENTINEL_GROUP each ended by a synchronize, before
    ``fn``: the count stands only where a sentinel is left in the trace,
    and raises otherwise."""
    import re

    from ofdmgan_tpu_torch.ops import datagen_kernel as dk
    from torch.profiler import ProfilerActivity, profile, schedule
    probe = torch.zeros(1, device="cuda")
    bits = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        probe.add_(1)
        torch.cuda.synchronize()
        prof.step()
        for _ in range(TRACE_SENTINELS // TRACE_SENTINEL_GROUP):
            for _ in range(TRACE_SENTINEL_GROUP):
                dk.box_muller(bits)
            torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
        prof.step()
    # the trace's raw records: key_averages() would build and group an event
    # object for each of a replay's ~1.3e5 device records first (on an H100,
    # 10-12 s a replay of the headline's 32 steps against 4)
    names = collections.Counter(e.name() for e in prof.profiler.kineto_results.events()
                                if e.device_type() != torch.autograd.DeviceType.CPU)
    count = lambda name: sum(n for key, n in names.items()  # noqa: E731
                             if re.search(rf"\b{name}\b", key))
    if not count("box_muller_kernel"):
        raise TraceLost(f"the trace lost all {TRACE_SENTINELS} sentinel launches: "
                        "its count of the replay's launches may be short")
    counts = {k: count(name) for k, name in TRACED_KERNELS.items()}
    for k in ("critic_grad", "generator_grad"):
        if counts[f"{k}_sum"] != counts[k]:
            raise AssertionError(f"a replay ran the {k} kernels unpaired: {counts}")
    return out, {k: counts[k] for k in KERNELS}


@contextlib.contextmanager
def counted_launches(trainer=None):
    """The launches of a run of the main path: sets the wrappers' counts
    to 0 and, while ``trainer`` (if given) replays graphed chunks, counts
    each replay's launches from its trace (``replay_launches``). Yields a
    dict that holds, after the block, each of KERNELS: the launches the
    wrappers ran plus those the replays ran; ``replays`` and ``replayed``
    (the replays' share)."""
    _counts_reset()
    out = {"replays": 0, "replayed": dict.fromkeys(KERNELS, 0)}
    chunk = trainer.chunk if trainer is not None and trainer.graphed else None
    if chunk is not None:
        replay = chunk.replay

        def traced():
            metrics, n = traced_replay(trainer, replay)
            out["replays"] += 1
            for k, v in n.items():
                out["replayed"][k] += v
            return metrics

        chunk.replay = traced
    try:
        yield out
    finally:
        if chunk is not None:
            del chunk.replay
    out.update({k: v + out["replayed"][k] for k, v in _counts().items()})


def trained(trainer, name: str, want_routes: dict, want_launches: dict,
            keys=TRAIN_LOG_KEYS) -> dict:
    """Train ``trainer`` two epochs, its launches counted
    (``counted_launches``); check its routes, its launch counts and that
    its metrics are finite under the log ``keys``. Returns the run's
    fields."""
    routes = _routes(trainer.step)
    if routes != want_routes:
        raise AssertionError(f"the {name} run took the routes {routes}")
    t_train = time.time()
    with counted_launches(trainer) as counted:
        history = trainer.train(epochs=2, experiment_name=f"chip_smoke_{name}")
        torch.cuda.synchronize()
    train_s = time.time() - t_train
    launches = {k: counted[k] for k in KERNELS}
    if launches != want_launches:
        raise AssertionError(f"the {name} run launched {launches} ({counted['replayed']} in "
                             f"{counted['replays']} replays), not {want_launches}")
    if (len(history) != 2 or any(set(rec) != keys for rec in history)
            or not all(math.isfinite(v) for rec in history for v in rec.values())):
        raise AssertionError(f"non-finite or missing {name} training metrics: {history}")
    return {"routes": routes, "launches": launches, "replays": counted["replays"],
            "replayed_launches": counted["replayed"], "train_s": round(train_s, 3),
            "history": history}


def check_bundle(export_dir: str) -> int:
    """The layers of the export bundle in ``export_dir``, after checking that
    every file of its metadata exists with the size its shapes give and that
    every weight file's CRC32 recomputes."""
    import binascii
    from pathlib import Path
    d = Path(export_dir)
    meta = json.loads((d / "metadata.json").read_text())
    for name, info in meta["layers"].items():
        data = (d / info["weight_file"]).read_bytes()
        if len(data) != math.prod(info["weight_shape"]):
            raise AssertionError(f"{name}: {len(data)} weight bytes for {info['weight_shape']}")
        if f"{binascii.crc32(data) & 0xFFFFFFFF:08x}" != info["crc32"]:
            raise AssertionError(f"{name}: the CRC32 of {info['weight_file']} does not recompute")
        n_out = info["weight_shape"][0]
        for key, size in ((info["scale_file"], 4 * n_out), (info["bias"]["file"], 4 * n_out)):
            if (d / key).stat().st_size != size:
                raise AssertionError(f"{name}: {key} is not {size} bytes")
    return len(meta["layers"])


def train_scope(dev, gen, steps: int) -> dict:
    """Phase ``train_scope``: the mini recipe at its full width (batch 64,
    n_critic 5) outside the datagen kernel's scope, then one step outside
    both kernels' scope. Returns the phase line's fields."""
    from ofdmgan_tpu_torch.config import Config
    from ofdmgan_tpu_torch.signal import datagen as sdg
    from ofdmgan_tpu_torch.training.trainer import Trainer

    out = {}
    # a fading, fully impaired run: multipath, Rapp PA -> IQ -> phase noise,
    # an EMA, a checkpoint every epoch
    base = Config(checkpoint_dir="build/chip_smoke/scope/checkpoints",
                  log_dir="build/chip_smoke/scope/logs", export_dir="build/chip_smoke/scope/export")
    cfg = dataclasses.replace(base, channel_type="multipath", training=dataclasses.replace(
        base.training, checkpoint_interval=1))
    tr = cfg.training
    kw = dict(nonlinear=True, samples_per_epoch=steps * tr.batch_size, val_samples=256, seed=0,
              device="cuda", ema_decay=0.999)
    trainer = Trainer(cfg, **kw)
    fading = trained(trainer, "scope", {"datagen": "plain", "critic": "kernel",
                                        "generator": "kernel", "forward": "kernel"},
                     {"datagen": 0, "critic_grad": tr.n_critic * 2 * steps,
                      "generator_grad": 2 * steps, "generator_forward": 2 * steps},
                     TRAIN_LOG_KEYS | {"val/rec_loss_ema", "val/mse_ema"})

    # resume from the last epoch's checkpoint: the same step on the same draws
    resumed = Trainer(cfg, **{**kw, "seed": 1})
    resumed.load_checkpoint(f"{cfg.checkpoint_dir}/checkpoint_epoch_2")
    if (resumed.current_epoch, resumed.global_step) != (1, 2 * steps):
        raise AssertionError("the checkpoint did not restore the epoch and step: "
                             f"{resumed.current_epoch}, {resumed.global_step}")
    draws = sdg.make_draws(gen, tr.batch_size, cfg.frame_length, trainer.dg_cfg.channel)
    batch = sdg.synthetic_batch_from_draws(draws, trainer.dg_cfg)
    alphas = [torch.rand(tr.batch_size, generator=gen, device=dev) for _ in range(tr.n_critic)]
    start = {n: p.detach().clone() for n, p in all_params(trainer).items()}
    for name, p in all_params(resumed).items():
        if not torch.equal(p, start[name]):
            raise AssertionError(f"the resumed {name} differs from the saved one")
    trainer.step.run(batch, alphas)
    resumed.step.run(batch, alphas)
    torch.cuda.synchronize()
    _, resume_rel = updates_agree(start, all_params(resumed), all_params(trainer), RESUME_RTOL,
                                  "resumed and uninterrupted steps")
    out["fading"] = {**fading, "resume_step_max_rel_diff": resume_rel}

    # one step at L = 32 over a Rician channel: outside both kernels' scope
    cfg32 = dataclasses.replace(base, frame_length=32, channel_type="rician")
    trainer32 = Trainer(cfg32, samples_per_epoch=tr.batch_size, val_samples=64, seed=0,
                        device="cuda")
    routes = _routes(trainer32.step)
    if routes != {"datagen": "plain", "critic": "plain", "generator": "plain", "forward": "plain"}:
        raise AssertionError(f"the L = 32 Rician step took the routes {routes}")
    _counts_reset()
    t_train = time.time()
    metrics = {k: float(v) for k, v in trainer32.step(trainer32.rng).items()}
    torch.cuda.synchronize()
    train_s = time.time() - t_train
    launches = _counts()
    if launches != dict.fromkeys(KERNELS, 0):
        raise AssertionError(f"the L = 32 step launched {launches}")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite L = 32 step metrics: {metrics}")
    out["l32_rician"] = {"routes": routes, "launches": launches, "train_s": round(train_s, 3),
                         "metrics": metrics}
    return out


def dec1_macs_per_frame(g, L: int) -> int:
    """Multiply-adds a frame of the full generator's ``dec*_1``
    convolutions, K * C_in * C_out * L_out each: the fused decoder runs
    them at 8/12 of that."""
    lv = g.levels
    return sum(math.prod(getattr(g, f"dec{i+1}_1").weight.shape) * (L >> (lv - i - 1))
               for i in range(lv))


def full_phase(dev, gen) -> dict:
    """Phase ``full``: the full U-Net pair at full width (levels 5, base 32,
    L = 1024, batch 512, n_critic 5, float32 with TF32 off), trained two
    epochs of FULL_STEPS outer steps through the datagen kernel; the
    datagen kernel's error at this shape against its plain version's; the kernel step against the reference step; the fused decoder against the unfused
    forward; then step times, frames/s fused and unfused, peak memory, the
    datagen kernel's device time at this shape and the achieved float32
    FLOP/s. Returns the phase line's fields."""
    from ofdmgan_tpu_torch.config import Config
    from ofdmgan_tpu_torch.models import count_parameters
    from ofdmgan_tpu_torch.models.unet_infer import make_unet_infer_apply
    from ofdmgan_tpu_torch.ops import datagen_kernel as dk
    from ofdmgan_tpu_torch.signal import datagen as sdg
    from ofdmgan_tpu_torch.training.trainer import Trainer, build_models
    from pathlib import Path

    from ofdmgan_tpu_torch.utils.profiling import device_us_per_call
    from perfbench import counts

    base = Config(checkpoint_dir="build/chip_smoke/full/checkpoints",
                  log_dir="build/chip_smoke/full/logs", export_dir="build/chip_smoke/full/export")
    cfg = dataclasses.replace(base, frame_length=FULL_L,
                              training=dataclasses.replace(base.training, batch_size=FULL_B))
    g, d = build_models(cfg, "full", seed=0)
    n_params = (count_parameters(g), count_parameters(d))
    if n_params != (FULL_G_PARAMS, FULL_D_PARAMS):
        raise AssertionError(f"the full pair has {n_params} parameters")
    bench_cfg = json.loads((Path(__file__).resolve().parent / "perfbench" / "configs"
                            / "full_unet.json").read_text())   # the benchmark's full pair
    g_macs, d_macs = counts.macs_per_frame(bench_cfg)
    if (g_macs, d_macs) != (FULL_G_MACS, FULL_D_MACS):
        raise AssertionError(f"the benchmark counts {g_macs}, {d_macs} multiply-adds a frame "
                             "of the full pair")
    fused_saves = dec1_macs_per_frame(g, FULL_L) // 3   # dec*_1 at 8/12 of their multiply-adds
    g_macs_fused = g_macs - fused_saves
    trainer = Trainer(cfg, samples_per_epoch=FULL_STEPS * FULL_B, val_samples=FULL_B, seed=0,
                      device=dev, generator=g, discriminator=d)
    run = trained(trainer, "full", {"datagen": "kernel", "critic": "plain", "generator": "plain",
                                    "forward": "plain"},
                  {"datagen": 2 * FULL_STEPS, "critic_grad": 0, "generator_grad": 0,
                   "generator_forward": 0})
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    if flags != (False, False):
        raise AssertionError(f"TF32 was left on after the full run: {flags}")
    out = {"params": {"generator": n_params[0], "critic": n_params[1]},
           "macs_per_frame": {"generator": g_macs, "generator_fused": g_macs_fused,
                              "critic": d_macs}, **run}

    # the datagen kernel at this path's shape, B = 512 and L = 1024, on one
    # set of draws, linear and with the default nonlinear chain. The kernel
    # and its plain version are both 1024-term float32 sums, each some 2e-6
    # from the exact value at its worst entry, which is more than atol 1e-6
    # where a value is small, so the pair cannot be held at the tolerance
    # of the shorter frames. Both are measured against a float64 evaluation
    # of the function (the FFT datagen on the draws in float64), and the
    # kernel's worst error must stay within DATAGEN_EXACT_RATIO of its plain
    # version's; their difference and the kernel's difference from the
    # float32 FFT datagen (the reference route's batch) are reported
    draws = sdg.make_draws(gen, FULL_B, FULL_L)
    draws64 = {k: v.double() for k, v in draws.items()}
    keys = ("noisy", "clean", "snr")
    dg_err = {}
    for nl in (False, True):
        dg_cfg = dataclasses.replace(trainer.dg_cfg, nonlinear=nl)
        got = dk.synthetic_batch_from_draws(draws, dg_cfg)
        plain = dk.synthetic_batch_plain(draws, dg_cfg)
        fft = sdg.synthetic_batch_from_draws(draws, dg_cfg)
        exact = sdg.synthetic_batch_from_draws(draws64, dg_cfg)
        torch.cuda.synchronize()
        for k in keys:
            e_kernel, e_plain = max_err(got, exact, (k,)), max_err(plain, exact, (k,))
            if not e_kernel <= max(DATAGEN_EXACT_RATIO * e_plain, 1e-6):   # so that a NaN fails
                raise AssertionError(
                    f"datagen L={FULL_L} B={FULL_B} nonlinear={nl} {k}: the kernel is "
                    f"{e_kernel:.3e} from float64, its plain version {e_plain:.3e}")
        dg_err[f"nonlinear={nl}"] = {"float64": max_err(got, exact, keys),
                                     "plain_float64": max_err(plain, exact, keys),
                                     "plain": max_err(got, plain, keys + ("scale",)),
                                     "fft": max_err(got, fft, keys)}
        if nl == trainer.dg_cfg.nonlinear:
            batch_k, batch_p = got, fft
    out["datagen_max_abs_err"] = dg_err
    del plain, exact, draws64

    # one outer step from the trained state on the kernel route and one on
    # the reference route, with the same penalty uniforms: first on the same
    # injected batch (the kernel's), where the routes must change nothing
    # but the datagen; then the reference step on the FFT datagen's batch
    # from the same draws, the plain path end to end. cuDNN's default
    # weight-gradient algorithms add with atomics, in another order on every
    # run, and Adam's per-entry scaling carries that into the update: the
    # pairs run with cuDNN's deterministic algorithms, and the spread of the
    # default ones is reported beside them. Across the two datagens the
    # inputs differ by rounding, and the update by more than STEP_RTOL of
    # its largest entry, as with cuDNN's summation order: that pair is held
    # by its metrics, and its update difference is reported
    alphas = [torch.rand(FULL_B, generator=gen, device=dev) for _ in range(trainer.loss_cfg.n_critic)]

    def step_pair(deterministic: bool, batch_ref) -> tuple:
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = deterministic
        try:
            step_k, step_p = clone_step(trainer, False), clone_step(trainer, True)
            start = {n: p.detach().clone() for n, p in all_params(step_k).items()}
            m_k = {k: float(v) for k, v in step_k.run(batch_k, alphas).items()}
            m_p = {k: float(v) for k, v in step_p.run(batch_ref, alphas).items()}
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = saved
        return (start, all_params(step_k), all_params(step_p)), m_k, m_p

    pair, _, _ = step_pair(True, batch_k)
    step_diff, step_rel = updates_agree(*pair, STEP_RTOL, "full kernel and reference steps")
    pair, m_k, m_p = step_pair(True, batch_p)
    metric_rel = {k: abs(m_k[k] - m_p[k]) / max(abs(m_p[k]), 1e-12) for k in m_p}
    if not all(v <= FULL_METRIC_RTOL for v in metric_rel.values()):   # so that a NaN fails
        raise AssertionError(f"the full step's metrics differ between the kernel's and the FFT "
                             f"datagen's batches: {metric_rel} (rtol {FULL_METRIC_RTOL})")
    _, cross_rel = updates_agree(*pair, None, "")
    _, spread_rel = updates_agree(*step_pair(False, batch_k)[0], None, "")
    out.update(step_update_max_abs_diff=step_diff, step_update_max_rel_diff=step_rel,
               fft_batch_metric_max_rel_diff=max(metric_rel.values()),
               fft_batch_step_update_max_rel_diff=cross_rel,
               step_update_max_rel_diff_default_cudnn=spread_rel)
    del pair

    # the fused decoder against the module's forward, float32
    fused_apply = make_unet_infer_apply(levels=trainer.generator.levels, act_dtype=torch.float32)
    with torch.no_grad():
        y_mod = trainer.generator(batch_k["noisy"])
        y_fused = fused_apply(trainer.generator, batch_k["noisy"])
    fused_err = float((y_fused - y_mod).abs().max())
    if not fused_err <= FUSED_ATOL:
        raise AssertionError(f"fused and unfused decoders differ by {fused_err:.3e} "
                             f"(atol {FUSED_ATOL})")
    out["fused_vs_unfused_max_abs_err"] = fused_err
    del y_mod, y_fused, batch_k, batch_p, fft, got

    # step time, unfused and fused in turns (unfused, fused, fused, unfused),
    # each after two warm-up steps; peak memory of each
    fused_fwd = make_unet_infer_apply(levels=trainer.generator.levels, act_dtype=torch.float32)
    steps = {"unfused": clone_step(trainer, False),
             "fused": clone_step(trainer, False, gen_forward=fused_fwd)}
    ms = {"unfused": [], "fused": []}
    peak = {}
    for name in ("unfused", "fused", "fused", "unfused"):
        t_ms, peak[name] = timed_steps(steps[name], trainer.rng)
        ms[name].append(t_ms)
    best = {k: min(v) for k, v in ms.items()}
    dg_cfg = trainer.dg_cfg
    dg_us = device_us_per_call(lambda: dk.synthetic_batch(gen, FULL_B, dg_cfg), "datagen_kernel")
    # counts.step_flops counts 8 generator forwards a step (n_critic + 3)
    unfused = counts.step_flops(bench_cfg, FULL_B)
    flops = {"unfused": unfused, "fused": unfused - 2.0 * FULL_B * 8 * fused_saves}
    out["times"] = {
        "ms_per_step": ms, "frames_per_s": {k: FULL_B / v * 1e3 for k, v in best.items()},
        "max_memory_allocated_bytes": peak,
        "datagen_device_us_per_call": dg_us,
        "datagen_share_of_step": dg_us / 1e3 / best["unfused"],
        "flop_per_step": flops,
        "achieved_fp32_flop_per_s": {k: flops[k] / (best[k] / 1e3) for k in best},
        "share_of_fp32_peak": {k: flops[k] / (best[k] / 1e3) / counts.FP32_FLOPS_PER_S
                               for k in best},
    }
    return out


def quant_phase(dev, gen, float_trainer, full_times: dict) -> dict:
    """Phase ``quant``: the mini pair under ``--qat`` and ``--rtl_qat
    --residual``, then the full U-Net under ``--quant_bits 8 16``, each
    trained through the kernels that cover it; the exports, the ROM and the
    integer datapath; step times against the float steps. Returns the phase
    line's fields."""
    import numpy as np
    from ofdmgan_tpu_torch.config import Config
    from ofdmgan_tpu_torch.ops import datagen_kernel as dk
    from ofdmgan_tpu_torch.quant import intsim, rom_codegen
    from ofdmgan_tpu_torch.signal import datagen as sdg
    from ofdmgan_tpu_torch.training.trainer import Trainer, build_models
    from ofdmgan_tpu_torch.verify import cosim

    out = {}
    steps = 20
    # QAT: autograd, and the module's forward
    kernels = {"datagen": "kernel", "critic": "kernel", "generator": "plain", "forward": "plain"}
    mini_launches = {"datagen": 2 * steps, "critic_grad": 2 * steps * 5, "generator_grad": 0,
                     "generator_forward": 0}
    runs = {}
    for name, kw, residual in (("qat", dict(qat=True), False),
                               ("rtl_qat_residual", dict(qat=True, rtl_faithful=True), True)):
        base = Config(checkpoint_dir=f"build/chip_smoke/quant/{name}/checkpoints",
                      log_dir=f"build/chip_smoke/quant/{name}/logs",
                      export_dir=f"build/chip_smoke/quant/{name}/export")
        cfg = dataclasses.replace(base, generator=dataclasses.replace(
            base.generator, input_residual=residual))
        g, d = build_models(cfg, "mini", seed=0, **kw)
        trainer = Trainer(cfg, samples_per_epoch=steps * cfg.training.batch_size,
                          val_samples=256, seed=0, device=dev, generator=g, discriminator=d)
        out[name] = trained(trainer, name, kernels, mini_launches)
        out[name]["export_layers"] = check_bundle(f"{cfg.export_dir}/generator")

        # the kernel step and the reference step on one batch, the kernel datagen's
        batch = dk.synthetic_batch_from_draws(sdg.make_draws(gen, MAIN_B, 16), trainer.dg_cfg)
        alphas = [torch.rand(MAIN_B, generator=gen, device=dev) for _ in range(5)]
        step_k, step_p = clone_step(trainer, False), clone_step(trainer, True)
        start = {n: p.detach().clone() for n, p in all_params(step_k).items()}
        step_k.run(batch, alphas)
        step_p.run(batch, alphas)
        out[name]["step_update_max_abs_diff"], out[name]["step_update_max_rel_diff"] = \
            updates_agree(start, all_params(step_k), all_params(step_p), STEP_RTOL,
                          f"{name} kernel and reference steps")
        runs[name] = trainer

    # the RTL-residual generator: its ROM, its integer datapath on the card
    # against the CPU and against fixsim, its float-against-integer L1
    trainer = runs["rtl_qat_residual"]
    g, d = trainer.generator, trainer.critic
    rom_path = "build/chip_smoke/quant/weight_rom.v"
    packed = rom_codegen.pack_rom_arrays(g, d)
    written = rom_codegen.generate_rom_verilog(g, d, rom_path)
    parsed = rom_codegen.parse_rom_verilog(rom_path)
    if written != (720, 43) or not all(np.array_equal(a, b.astype(np.int32))
                                       for a, b in zip(parsed, packed)):
        raise AssertionError("the Verilog ROM does not parse back to the packed ROM images")
    frames = dk.synthetic_batch(gen, QUANT_FRAMES, trainer.dg_cfg)
    x_q, c_q = intsim.float_to_q88(frames["noisy"]), intsim.float_to_q88(frames["clean"])
    ip, dp = intsim.quantize_weights_rtl(g), intsim.quantize_weights_rtl(d, "discriminator")
    y = intsim.generator_int_forward(ip, x_q, "rtl_residual")
    if y.device != x_q.device or not torch.equal(
            y.cpu(), intsim.generator_int_forward(ip, x_q.cpu(), "rtl_residual")):
        raise AssertionError("the integer generator on the card differs from the CPU's")
    x_ncl = x_q.transpose(1, 2).cpu().numpy().astype(np.int16)
    c_ncl = c_q.transpose(1, 2).cpu().numpy().astype(np.int16)
    t = time.perf_counter()
    y_fixsim = cosim.generator_forward(*packed, x_ncl, residual=True)
    fixsim_s = time.perf_counter() - t
    if not np.array_equal(y_fixsim, y.transpose(1, 2).cpu().numpy().astype(np.int16)):
        raise AssertionError("the integer generator differs from fixsim's")
    s = intsim.discriminator_int_forward(dp, c_q, x_q)
    if not np.array_equal(cosim.discriminator_forward(*packed, c_ncl, x_ncl),
                          s[:, 0].cpu().numpy().astype(np.int16)):
        raise AssertionError("the integer critic differs from fixsim's")
    with torch.no_grad():
        y_float = g(frames["noisy"])
    y_int = intsim.q88_to_float(y)
    int_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        intsim.generator_int_forward(ip, x_q, "rtl_residual")
        torch.cuda.synchronize()
        int_s.append(time.perf_counter() - t)
    out["int_datapath"] = {
        "frames": QUANT_FRAMES,
        "float_vs_int_l1": float((y_float - y_int).abs().mean()),
        "int_l1_vs_clean": float((y_int - frames["clean"]).abs().mean()),
        "float_l1_vs_clean": float((y_float - frames["clean"]).abs().mean()),
        "card_frames_per_s": QUANT_FRAMES / statistics.median(int_s),
        "fixsim_host_frames_per_s": QUANT_FRAMES / fixsim_s,
    }
    del frames, x_q, c_q, y, s, y_float, y_int

    # QAT against float mini steps in one process: float, QAT, QAT, float
    mini_ms = {"float": [], "qat": [], "rtl_qat_residual": []}
    for name in ("float", "qat", "rtl_qat_residual", "rtl_qat_residual", "qat", "float"):
        t_run = float_trainer if name == "float" else runs[name]
        mini_ms[name].append(timed_steps(t_run.step, t_run.rng, n=50, warmup=5)[0])
    out["mini_ms_per_step"] = mini_ms
    del runs, trainer

    # the full U-Net under --quant_bits 8 16 at full width
    base = Config(checkpoint_dir="build/chip_smoke/quant/full/checkpoints",
                  log_dir="build/chip_smoke/quant/full/logs",
                  export_dir="build/chip_smoke/quant/full/export")
    cfg = dataclasses.replace(base, frame_length=FULL_L,
                              training=dataclasses.replace(base.training, batch_size=FULL_B))
    g, d = build_models(cfg, "full", seed=0, quant_bits=QUANT_FULL_BITS)
    trainer = Trainer(cfg, samples_per_epoch=FULL_STEPS * FULL_B, val_samples=FULL_B, seed=0,
                      device=dev, generator=g, discriminator=d)
    full = trained(trainer, "full_quant_bits",
                   {"datagen": "kernel", "critic": "plain", "generator": "plain",
                    "forward": "plain"},
                   {"datagen": 2 * FULL_STEPS, "critic_grad": 0, "generator_grad": 0,
                    "generator_forward": 0})
    full["export_layers"] = check_bundle(f"{cfg.export_dir}/generator")
    if full["export_layers"] != FULL_EXPORT_LAYERS:
        raise AssertionError(f"the full export has {full['export_layers']} layers")
    ms, peak = timed_steps(trainer.step, trainer.rng)
    full["times"] = {"ms_per_step": ms, "max_memory_allocated_bytes": peak,
                     "float_ms_per_step": full_times["ms_per_step"]["unfused"],
                     "float_max_memory_allocated_bytes":
                         full_times["max_memory_allocated_bytes"]["unfused"]}
    # where the quantized step's time goes: device time by kind of kernel,
    # the same weights without quantization against it, in this process
    t_prof = time.time()
    float_step = clone_step(trainer, False)
    float_step.generator.weight_bits = float_step.generator.act_bits = 0
    prof = {"float": device_ms_by_kind(float_step, trainer.rng),
            "quant_bits": device_ms_by_kind(trainer.step, trainer.rng)}
    del float_step
    conv = {k: {n for n in v["by_kernel"] if kernel_kind(n) == "conv"} for k, v in prof.items()}
    wall = {"float": min(full_times["ms_per_step"]["unfused"]), "quant_bits": ms}
    full["device_ms_per_step"] = {
        k: {"total": v["total"], "idle_share": 1 - v["total"] / wall[k],
            "aten_calls": v["aten_calls"], "by_kind": v["by_kind"],
            "top_kernels": {n[:120]: t for n, t in
                            sorted(v["by_kernel"].items(), key=lambda kv: -kv[1])[:8]}}
        for k, v in prof.items()}
    full["conv_kernels_only_in"] = {
        k: {n[:120]: prof[k]["by_kernel"][n] for n in conv[k] - conv[other]}
        for k, other in (("float", "quant_bits"), ("quant_bits", "float"))}
    full["profile_s"] = round(time.time() - t_prof, 3)
    out["full_quant_bits"] = full
    return out



def quiet(fn, log_path: str):
    """``fn()`` with its standard output written to ``log_path``."""
    import contextlib
    from pathlib import Path
    Path(log_path).parent.mkdir(parents=True, exist_ok=True)
    with open(log_path, "w") as f, contextlib.redirect_stdout(f):
        return fn()


def wall(fn):
    """(``fn()``, its host seconds, ending in a synchronize)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def eval_phase(dev, mini_ckpt: str, full_ckpt: str) -> dict:
    """Phase ``eval``: the evaluation CLIs and modules on the card, each held
    against the CPU on the same draws, with the mini checkpoint of phase
    ``train`` and the full one of phase ``full``. Returns the phase line's
    fields; every CLI's printed output goes to ``build/chip_smoke/eval/``."""
    import itertools
    import numpy as np
    from ofdmgan_tpu_torch import (benchmark_comparison, distributional_report, enhance,
                                   eval_checkpoint)
    from ofdmgan_tpu_torch.eval import ber, distributional as dist, equalizers as eq
    from ofdmgan_tpu_torch.eval import benchmark as bm
    from ofdmgan_tpu_torch.eval.loading import build_generator
    from ofdmgan_tpu_torch.quant import intsim
    from ofdmgan_tpu_torch.signal import datagen as sdg
    from ofdmgan_tpu_torch.utils.params_io import load_params_tree
    from ofdmgan_tpu_torch.utils.profiling import device_us, kernel_events, traced

    d = "build/chip_smoke/eval"
    on_dev = ["--device", str(dev)]
    out, times = {}, {}
    g_cpu = build_generator(load_params_tree(mini_ckpt), "mini", 16)
    g_dev = copy.deepcopy(g_cpu).to(dev)
    ip = intsim.quantize_weights_rtl(g_cpu)

    # the mini sweep through the CLI at its defaults (100 trials, SNR 0-30
    # step 5, linear and nonlinear) with GAN-Q, in every protocol and
    # normalization
    sweeps = {}
    for protocol, norm in itertools.product(("oracle", "pilot"), ("independent", "joint")):
        name = f"{protocol}_{norm}"
        argv = on_dev + ["--checkpoint", mini_ckpt, "--quantized", "--protocol", protocol,
                "--normalization", norm, "--output_dir", f"{d}/bench_{name}"]
        (lin, nl), secs = wall(lambda: quiet(lambda: benchmark_comparison.main(argv),
                                             f"{d}/bench_{name}.log"))
        snrs = list(lin["NoEQ"])
        times[f"mini_sweep_{name}_ms_per_snr"] = secs / (2 * len(snrs)) * 1e3
        if len(snrs) != 7 or list(lin) != bm.METHODS:
            raise AssertionError(f"the mini sweep {name} ran {list(lin)} at {snrs}")
        if not all(math.isfinite(r[s][k]) for res in (lin, nl) for r in res.values()
                   for s in snrs for k in r[s]):
            raise AssertionError(f"non-finite mini sweep results ({name})")
        noeq = [lin["NoEQ"][s]["mse"] for s in snrs]
        if not all(a > b for a, b in zip(noeq, noeq[1:])) or \
                not nl["NoEQ"][snrs[0]]["mse"] > nl["NoEQ"][snrs[-1]]["mse"]:
            raise AssertionError(f"NoEQ's MSE does not fall with the SNR ({name}): {noeq}")
        if protocol == "oracle" and not max(lin["ZF"][s]["mse"] for s in snrs) < 1e-4:
            raise AssertionError(f"oracle ZF is not near perfect ({name})")
        sweeps[name] = {m: {"linear_30db_mse": lin[m][30.0]["mse"],
                            "nonlinear_30db_mse": nl[m][30.0]["mse"]} for m in lin}
    out["mini_sweeps"] = sweeps

    # the card against the CPU on the same draws (made on the CPU), two
    # SNRs of each protocol, normalization and front end: ZF, MMSE, Wiener,
    # NoEQ, GAN and LMS by element, DFE and RLS by mean MSE, GAN-Q bit for
    # bit against the CPU's integer datapath on the card's own noisy frames
    worst = {"by_element": 0.0, "dfe_rls_mean_mse_rel": 0.0}
    for (protocol, norm, nl), snr in itertools.product(
            itertools.product(("oracle", "pilot"), ("independent", "joint"), (False, True)),
            (0.0, 30.0)):
        draws = bm.make_snr_draws(torch.Generator().manual_seed(bm.seed_of(7, int(snr))), 100,
                                  16, "awgn", protocol)
        kw = dict(nonlinear=nl, pa_saturation=0.8, normalization=norm, int_params=ip,
                  protocol=protocol)
        clean_c, est_c = bm.estimates_from_draws({k: v.to(dev) for k, v in draws.items()},
                                                 snr, generator=g_dev, **kw)
        clean, est = bm.estimates_from_draws(draws, snr, generator=g_cpu, **kw)
        what = f"{protocol}/{norm}/nonlinear={nl}/{snr} dB"
        for m in ("ZF", "MMSE", "Wiener", "NoEQ", "GAN", "LMS"):
            err = float((est_c[m].cpu() - est[m]).abs().max())
            if not err <= EVAL_MINI_ATOL:
                raise AssertionError(f"{m} on the card is {err:.3e} from the CPU ({what})")
            worst["by_element"] = max(worst["by_element"], err)
        for m in ("DFE", "RLS"):
            a = float(((est_c[m] - clean_c) ** 2).mean())
            b = float(((est[m] - clean) ** 2).mean())
            rel = abs(a - b) / b
            if not rel <= EVAL_MEAN_MSE_RTOL:
                raise AssertionError(f"{m}'s mean MSE on the card {a:.6e}, CPU {b:.6e} ({what})")
            worst["dfe_rls_mean_mse_rel"] = max(worst["dfe_rls_mean_mse_rel"], rel)
        want = intsim.q88_to_float(intsim.generator_int_forward(
            ip, intsim.float_to_q88(est_c["NoEQ"].cpu())))
        if not torch.equal(est_c["GAN-Q"].cpu(), want):
            raise AssertionError(f"GAN-Q on the card differs from the CPU's ({what})")
    out["mini_card_vs_cpu"] = worst

    # the full-width sweep (L = 1024, 100 trials, 7 SNRs) with the full
    # generator and GAN-Q under the int8 export's quantization
    tree = load_params_tree(full_ckpt)
    f_cpu = build_generator(tree, "full", FULL_L)
    fq_cpu = build_generator(tree, "full", FULL_L, quant_bits=QUANT_FULL_BITS)
    f_dev, fq_dev = copy.deepcopy(f_cpu).to(dev), copy.deepcopy(fq_cpu).to(dev)
    snrs = [float(s) for s in range(0, 31, 5)]
    res, secs = wall(lambda: quiet(lambda: bm.run_benchmark(
        f_dev, n_trials=100, frame_length=FULL_L, snr_values=snrs, include_quantized=True,
        gen_q=fq_dev), f"{d}/full_sweep.log"))
    times["full_sweep_ms_per_snr"] = secs / len(snrs) * 1e3
    if list(res) != bm.METHODS or not all(math.isfinite(res[m][s]["mse"])
                                         for m in res for s in snrs):
        raise AssertionError(f"the full sweep gave {list(res)} or non-finite values")
    if not max(res["ZF"][s]["mse"] for s in snrs) < 1e-4:
        raise AssertionError("oracle ZF is not near perfect at L = 1024")
    out["full_sweep_mse"] = {m: {str(s): res[m][s]["mse"] for s in (0.0, 30.0)} for m in res}
    # held against the CPU by per-method mean MSE on the same draws, two
    # SNRs (EVAL_FULL_CPU_TRIALS trials: the CPU's full forward is slow)
    full_rel = {}
    for snr in (0.0, 30.0):
        draws = bm.make_snr_draws(torch.Generator().manual_seed(bm.seed_of(8, int(snr))),
                                  EVAL_FULL_CPU_TRIALS, FULL_L)
        r_dev = bm.snr_batch_from_draws({k: v.to(dev) for k, v in draws.items()}, snr,
                                        generator=f_dev, gen_q=fq_dev)
        r_cpu = bm.snr_batch_from_draws(draws, snr, generator=f_cpu, gen_q=fq_cpu)
        for m in r_cpu:
            a, b = float(r_dev[m][0].mean()), float(r_cpu[m][0].mean())
            diff = abs(a - b)
            if not diff <= EVAL_MEAN_MSE_RTOL * b + 1e-9:
                raise AssertionError(f"{m} at L = {FULL_L}, {snr} dB: mean MSE on the card "
                                     f"{a:.6e}, on the CPU {b:.6e}")
            full_rel[m] = max(full_rel.get(m, 0.0), diff / max(b, 1e-30))
    out["full_card_vs_cpu_mean_mse_rel"] = full_rel
    # each equalizer alone at L = 1024, 100 trials; then where one SNR's
    # batch spends its time: device time, idle share, kernel launches
    draws = {k: v.to(dev) for k, v in bm.make_snr_draws(torch.Generator().manual_seed(9), 100,
                                                        FULL_L).items()}
    clean, est = bm.estimates_from_draws(draws, 20.0)
    times["equalizer_ms_l1024"] = {
        name: statistics.median(wall(lambda: fn(est["NoEQ"], clean))[1] for _ in range(3)) * 1e3
        for name, fn in eq.EQUALIZERS.items()}
    # (device activity alone: tracing its ~200,000 host calls costs ~1 min)
    fn = lambda: bm.snr_batch_from_draws(draws, 20.0, generator=f_dev, gen_q=fq_dev)  # noqa: E731
    wall_s = min(wall(fn)[1] for _ in range(2))
    kernels = kernel_events(traced(fn, 1, host=False))
    device_ms = sum(device_us(e) for e in kernels) / 1e3
    prof = {"wall_ms": wall_s * 1e3, "device_ms": device_ms,
            "idle_share": 1 - device_ms / (wall_s * 1e3),
            "kernel_launches": sum(e.count for e in kernels)}
    out["full_sweep_profile_l1024"] = prof
    del draws
    del res, clean, est

    # eval_checkpoint at batch 512, L = 1024: the module, the serving forward
    # and --quant_bits 8 16; one batch of each held against the CPU
    # each form twice: the first run's rate includes cuDNN's first calls
    forms = {"module": [], "serving": ["--serving"], "quant_bits": ["--quant_bits", "8", "16"]}
    ev = {}
    for name, extra in forms.items():
        argv = on_dev + ["--model", "full", "--checkpoint", full_ckpt, "--batches",
                         str(EVAL_BATCHES)]
        rates = []
        for _ in range(2):
            r = quiet(lambda: eval_checkpoint.main(argv + extra),
                      f"{d}/eval_checkpoint_{name}.log")
            row = r[full_ckpt]
            if row["frames"] != EVAL_BATCHES * FULL_B or not math.isfinite(row["val_l1"]):
                raise AssertionError(f"eval_checkpoint {name}: {row}")
            rates.append(row["frames"] / row["seconds"])
        ev[name] = {"val_l1": row["val_l1"], "frames_per_s": rates}
        times[f"eval_checkpoint_{name}_frames_per_s"] = rates
    batch = sdg.synthetic_batch(torch.Generator(device=dev).manual_seed(1234), FULL_B,
                                sdg.DatagenConfig.make(frame_length=FULL_L))
    x = batch["noisy"][:EVAL_FULL_CPU_TRIALS]
    from ofdmgan_tpu_torch.models.unet_infer import make_unet_infer_apply
    serve = make_unet_infer_apply(levels=f_dev.levels, act_dtype=torch.bfloat16)
    with torch.no_grad():
        y_float = f_cpu(x.cpu())
        for name, fn_dev, fn_cpu in (
                ("module", f_dev, f_cpu),
                ("serving", lambda v: serve(f_dev, v).float(), lambda v: serve(f_cpu, v).float()),
                ("quant_bits", fq_dev, fq_cpu)):
            y_cpu = fn_cpu(x.cpu())
            err = float((fn_dev(x).cpu() - y_cpu).abs().max())
            # the bf16 and quantized forms: each device is some distance from
            # the float32 forward; the two may differ by the sum
            limit = EVAL_FULL_ATOL if name == "module" else \
                EVAL_FORM_FACTOR * float((y_cpu - y_float).abs().max())
            if not err <= limit:
                raise AssertionError(f"eval_checkpoint {name}: the card's forward is "
                                     f"{err:.3e} from the CPU's (limit {limit:.3e})")
            ev[name].update(card_vs_cpu_max_abs_err=err, limit=limit)
    out["eval_checkpoint"] = ev
    del batch, x

    # the distributional report at full width; the identity row on the CPU
    # from the same draws; the null floor against an independent
    # clean-vs-clean pair
    argv = on_dev + ["--model", "full", "--checkpoint", f"full={full_ckpt}", "--batches",
            str(EVAL_BATCHES), "--mmd_samples", "2048", "--json", f"{d}/distributional.json"]
    rep, secs = wall(lambda: quiet(lambda: distributional_report.main(argv),
                                   f"{d}/distributional.log"))
    times["distributional_report_s"] = secs
    dg = sdg.DatagenConfig.make(frame_length=FULL_L, snr_range=(0, 30))
    draw = dist.seeded_draws(1234, FULL_B, dg, dev)
    batches = [draw(i) for i in range(EVAL_BATCHES)]
    report = dist.make_report_fn(lambda v: v, dg, FULL_B, EVAL_BATCHES, 2048)
    r_dev = report(lambda i: batches[i])
    r_cpu = report(lambda i: tuple({k: v.cpu() for k, v in b.items()} for b in batches[i]))
    rep_err = {k: float((r_dev[k].cpu() - r_cpu[k]).abs().max()) for k in r_cpu}
    noisy = rep["rows"]["noisy (no enhancement)"]
    if not all(abs(float(r_dev[k].cpu().flatten()[0]) - v) <= 1e-6 * max(1.0, abs(v))
               for k, v in (("mmd2", noisy["mmd2"]), ("mmd2_null", noisy["mmd2_null_floor"]))):
        raise AssertionError("the report's noisy row is not the identity report's")
    for k in r_cpu:
        if not torch.allclose(r_dev[k].cpu(), r_cpu[k], rtol=EVAL_REPORT_RTOL, atol=1e-6):
            raise AssertionError(f"the report's {k} on the card differs from the CPU's: "
                                 f"{r_dev[k]} against {r_cpu[k]}")
    # the null floor is one draw of the unbiased estimator under the null;
    # so is MMD^2 between two independent clean sets of as many frames, with
    # the same bandwidth: the floor's ratio to the RMS of EVAL_NULL_PAIRS such
    # pairs is Student-t with that many degrees of freedom
    n_mmd = min(2048, EVAL_BATCHES * min(2048 // EVAL_BATCHES + 1, FULL_B))
    pairs = []
    for j in range(EVAL_NULL_PAIRS):
        a, b = (sdg.synthetic_batch(torch.Generator(device=dev).manual_seed(100 * k + j), n_mmd,
                                    dg)["clean"].reshape(n_mmd, -1) for k in (1, 2))
        pairs.append(float(dist.mmd2_unbiased(a, b, r_dev["bandwidth"])))
    rms = math.sqrt(sum(v * v for v in pairs) / len(pairs))
    null = noisy["mmd2_null_floor"]
    if not abs(null) <= EVAL_NULL_T * rms:
        raise AssertionError(f"the null floor {null:.3e} is more than {EVAL_NULL_T} times the "
                             f"RMS {rms:.3e} of {len(pairs)} clean-vs-clean pairs")
    out["distributional"] = {"rows": rep["rows"], "clean_pairs_mmd2": pairs,
                             "null_over_pairs_rms": null / rms,
                             "card_vs_cpu_max_abs_err": rep_err}
    del batches, a, b

    # BER at 2048 frames: the card against the CPU on the same draws; a
    # decision may differ only where a statistic is within 1e-6 of zero
    ber_out = {}
    snrs = (0.0, 5.0, 10.0)
    for name, make, stat in (("time_domain", ber.make_time_domain_draws,
                              ber.time_domain_estimate),
                             ("ofdm", ber.make_ofdm_draws, ber.ofdm_received_symbols)):
        curve = {}
        for i, snr in enumerate(snrs):
            draws = make(torch.Generator().manual_seed(bm.seed_of(11, i)), 2048, 16)
            for label, g_d, g_c in (("gan", g_dev, g_cpu), ("noisy", None, None)):
                s_dev = stat({k: v.to(dev) for k, v in draws.items()}, snr, g_d).cpu()
                s_cpu = stat(draws, snr, g_c)
                if s_cpu.is_complex():
                    s_dev, s_cpu = torch.view_as_real(s_dev), torch.view_as_real(s_cpu)
                differ = (s_dev > 0) != (s_cpu > 0)
                ties = (s_dev.abs() <= 1e-6) | (s_cpu.abs() <= 1e-6)
                if bool((differ & ~ties).any()):
                    raise AssertionError(f"BER {name} {label} {snr} dB: {int(differ.sum())} "
                                         "decisions differ between the card and the CPU")
            curve[snr] = (ber.ber_time_domain if name == "time_domain" else ber.ber_ofdm)(
                g_dev, [snr], n_frames=2048)[snr]
        ber_out[name] = curve
    out["ber_gan"] = ber_out

    # enhance on a .npy in each layout, float and integer, against the CPU
    frames = sdg.synthetic_batch(torch.Generator().manual_seed(5), 1000,
                                 sdg.DatagenConfig())["noisy"]
    enh = {}
    with torch.no_grad():
        want = {"float": g_cpu(frames).numpy(),
                "rtl": intsim.q88_to_float(intsim.generator_int_forward(
                    ip, intsim.float_to_q88(frames))).numpy()}
    for layout, arr in (("nlc", frames.numpy()), ("ncl", frames.numpy().transpose(0, 2, 1))):
        np.save(f"{d}/frames_{layout}.npy", arr)
        for mode, extra in (("float", []), ("rtl", ["--int_mode", "rtl"])):
            quiet(lambda: enhance.main(on_dev + ["--checkpoint", mini_ckpt, "--input",
                                        f"{d}/frames_{layout}.npy", "--output",
                                        f"{d}/enhanced.npy", "--batch_size", "256"] + extra),
                  f"{d}/enhance.log")
            got = np.load(f"{d}/enhanced.npy")
            got = got if layout == "nlc" else got.transpose(0, 2, 1)
            err = float(np.abs(got - want[mode]).max())
            if (mode == "rtl" and not np.array_equal(got, want[mode])) or not err <= 1e-5:
                raise AssertionError(f"enhance {layout} {mode}: {err:.3e} from the CPU")
            enh[f"{layout}_{mode}"] = err
    out["enhance_max_abs_err"] = enh
    out["times"] = times
    return out


def files_differ(a: str, b: str) -> list:
    """The relative paths of the files under ``a`` and ``b`` that are not
    byte-identical (or are in one tree only)."""
    from pathlib import Path
    ta = {p.relative_to(a): p for p in Path(a).rglob("*") if p.is_file()}
    tb = {p.relative_to(b): p for p in Path(b).rglob("*") if p.is_file()}
    return sorted(str(k) for k in ta.keys() | tb.keys()
                  if k not in ta or k not in tb or ta[k].read_bytes() != tb[k].read_bytes())


def verify_phase(dev, mini_ckpt: str, rtl_ckpt: str) -> dict:
    """Phase ``verify``: the hardware-verification and handoff slice on the
    card, each part held against the CPU, with the mini checkpoint of phase
    ``train`` and the RTL-residual one of phase ``quant``. Returns the
    phase line's fields; printed output goes to ``build/chip_smoke/verify/``."""
    import numpy as np
    from ofdmgan_tpu_torch import make_rtl_handoff, selfcheck
    from ofdmgan_tpu_torch import simplegan as sg
    from ofdmgan_tpu_torch.eval.loading import build_generator
    from ofdmgan_tpu_torch.models import MiniDiscriminator
    from ofdmgan_tpu_torch.simplegan import train_cli
    from ofdmgan_tpu_torch.utils.jax_params import from_jax_params
    from ofdmgan_tpu_torch.utils.params_io import load_params_tree
    from ofdmgan_tpu_torch.utils.profiling import kernel_events, traced
    from ofdmgan_tpu_torch.verify import arch_check, cosim, cosim_report, golden, proof

    d = "build/chip_smoke/verify"
    out, times = {}, {}
    g_cpu = build_generator(load_params_tree(mini_ckpt), "mini", 16)
    d_cpu = MiniDiscriminator()
    d_cpu.load_state_dict(from_jax_params(load_params_tree(f"{mini_ckpt}/params_d.npz")))
    g_dev, d_dev = copy.deepcopy(g_cpu).to(dev), copy.deepcopy(d_cpu).to(dev)

    # golden vectors on the card and on the CPU from one input: the floats
    # within GOLDEN_ATOL, the card's Q8.8 files its own floats' encoding, and
    # at most 1 LSB from the CPU's where the two floats straddle a Q8.8 step
    t = time.time()
    x = torch.randn(1, 2, 16, generator=torch.Generator().manual_seed(21)).numpy()
    for name, g in (("cuda", g_dev), ("cpu", g_cpu)):
        golden.generate_golden_vectors(g, x, f"{d}/golden_{name}")
    y_dev, y_cpu = (np.load(f"{d}/golden_{n}/output_float.npy") for n in ("cuda", "cpu"))
    q_dev, q_cpu = (np.load(f"{d}/golden_{n}/output_q88.npy") for n in ("cuda", "cpu"))
    straddle = golden.q88_int16(y_dev) != golden.q88_int16(y_cpu)
    if (not np.abs(y_dev - y_cpu).max() <= GOLDEN_ATOL
            or not np.array_equal(q_dev, golden.q88_int16(y_dev))
            or not np.array_equal(golden.read_hex(f"{d}/golden_cuda/output.hex"), q_dev.flatten())
            or np.abs(q_dev.astype(int) - q_cpu).max() > 1
            or not np.array_equal(q_dev[~straddle], q_cpu[~straddle])):
        raise AssertionError("the golden vectors on the card differ from the CPU's")
    differ = [f for f in ("input_float.npy", "input_q88.npy", "input.hex", "golden_metadata.json")
              if f in files_differ(f"{d}/golden_cuda", f"{d}/golden_cpu")]
    if differ:
        raise AssertionError(f"golden files {differ} differ between the card and the CPU")
    out["golden"] = {"output_float_max_abs_err": float(np.abs(y_dev - y_cpu).max()),
                     "q88_entries_straddling": int(straddle.sum())}
    times["golden_s"] = time.time() - t

    # the architecture contract on the card: every item passes
    t = time.time()
    res = quiet(lambda: arch_check.run_full_verification(g_dev, d_dev, f"{d}/arch", device=dev),
                f"{d}/arch.log")
    if not all(r.passed for r in res.values()):
        raise AssertionError(f"architecture check failed: "
                             f"{ {k: r.details for k, r in res.items() if not r.passed} }")
    out["arch"] = {k: r.passed for k, r in res.items()}
    out["arch"]["gp_value"] = res["gradient_penalty"].details["gp_value"]
    times["arch_s"] = time.time() - t

    # the reconstruction proof, float and integer, on one set of CPU draws
    t = time.time()
    draws = proof.make_proof_draws(torch.Generator().manual_seed(22))
    proof_err = {"float_mse_max_rel_err": 0.0}
    for snr in VERIFY_SNRS:
        for what, fn in (("float", proof.signal_enhancement_from_draws),
                         ("int", proof.int_datapath_enhancement_from_draws)):
            r_dev, r_cpu = fn(g_dev, draws, float(snr)), fn(g_cpu, draws, float(snr))
            for k in ("mse_before", "mse_after"):
                if what == "int" and r_dev[k] != r_cpu[k]:
                    raise AssertionError(f"proof {snr} dB integer {k}: {r_dev[k]} on the card, "
                                         f"{r_cpu[k]} on the CPU")
                rel = abs(r_dev[k] - r_cpu[k]) / abs(r_cpu[k])
                if not rel <= PROOF_RTOL:
                    raise AssertionError(f"proof {snr} dB {what} {k}: {rel:.3e} from the CPU")
                if what == "float":
                    proof_err["float_mse_max_rel_err"] = max(proof_err["float_mse_max_rel_err"],
                                                             rel)
            proof_err[f"{what}_{snr}dB_improvement_db"] = r_dev["snr_improvement_db"]
    out["proof"] = proof_err
    times["proof_s"] = time.time() - t

    # the integer-datapath suite on the card: every test passes, fixsim bit
    # for bit on every generator test
    t = time.time()
    res = quiet(lambda: cosim_report.run_cosim_verification(g_dev, d_dev, f"{d}/cosim",
                                                            device=dev), f"{d}/cosim.log")
    gen_tests = [r for r in res["tests"] if r["kind"].startswith("generator")]
    if (res["passed_tests"] != res["total_tests"] or not res["native_engine"]
            or not all(r["native_bitexact"] for r in gen_tests)):
        raise AssertionError(f"cosim report: {res['passed_tests']}/{res['total_tests']} passed")
    out["cosim"] = {"passed": res["passed_tests"], "total": res["total_tests"],
                    "native_bitexact_generator_tests": len(gen_tests)}
    times["cosim_s"] = time.time() - t

    # the RTL handoff bundle from phase quant's RTL-residual generator, on
    # the card and on the CPU: byte-identical; fixsim agrees on every vector
    t = time.time()
    for name in ("cuda", "cpu"):
        quiet(lambda: make_rtl_handoff.main([
            "--checkpoint", rtl_ckpt, "--out_dir", f"{d}/handoff_{name}/bundle",
            "--rom_file", f"{d}/handoff_{name}/weight_rom_rtl_residual.v",
            "--device", str(dev) if name == "cuda" else "cpu"]), f"{d}/handoff.log")
    differ = files_differ(f"{d}/handoff_cuda", f"{d}/handoff_cpu")
    if differ:
        raise AssertionError(f"handoff files {differ} differ between the card and the CPU")
    from ofdmgan_tpu_torch.quant.rom_codegen import parse_rom_verilog
    rom_w, rom_b = parse_rom_verilog(f"{d}/handoff_cuda/weight_rom_rtl_residual.v")
    manifest = json.loads(open(f"{d}/handoff_cuda/bundle/manifest.json").read())
    for name in manifest["vectors"]:
        x_in = golden.read_hex(f"{d}/handoff_cuda/bundle/vectors/{name}_in.hex")
        y_out = golden.read_hex(f"{d}/handoff_cuda/bundle/vectors/{name}_out.hex")
        y_fix = cosim.generator_forward(rom_w, rom_b, x_in.reshape(1, 2, 16), residual=True)
        if not np.array_equal(y_fix.flatten(), y_out):
            raise AssertionError(f"fixsim differs from the handoff vector {name}")
    out["handoff"] = {"vectors": len(manifest["vectors"]),
                      "out_crc32": {k: v["out_crc32"] for k, v in manifest["vectors"].items()}}
    times["handoff_s"] = time.time() - t

    # simpleGAN through its CLI at the default 30,000 steps (matlab): the
    # learning bar, the weight files, the integer path on the card against
    # the CPU
    t = time.time()
    (p_dev, losses), secs = wall(lambda: quiet(lambda: train_cli.main(
        ["--device", str(dev), "--output_dir", f"{d}/simplegan"]), f"{d}/simplegan.log"))
    steps = int(losses["loss_d"].shape[0])
    imgs = sg.generate_samples(p_dev, ngs=torch.randn(
        64, 2, generator=torch.Generator().manual_seed(2))).reshape(64, 9).cpu()
    dist = ((imgs[:, None] - sg.patterns()[None]) ** 2).mean(-1).min(1).values.mean()
    if not (steps == 30_000 and float(dist) < SIMPLEGAN_BAR):
        raise AssertionError(f"simpleGAN: {steps} steps, mean distance {float(dist)}")
    lines = {f: len(open(f"{d}/simplegan/{f}").read().splitlines())
             for f in SIMPLEGAN_FILE_LINES}
    if lines != SIMPLEGAN_FILE_LINES:
        raise AssertionError(f"simpleGAN weight files: {lines}")
    q_dev = sg.quantize_params(p_dev)
    q_cpu = sg.quantize_params(sg.SimpleGANParams(*(p.cpu() for p in p_dev)))
    ng = torch.arange(-2048, 2048, 4).reshape(-1, 2)   # Q8.8 latents over [-8, 8)
    img_dev = sg.generator_int_forward(q_dev, ng.to(dev))
    img_cpu = sg.generator_int_forward(q_cpu, ng)
    if not (torch.equal(img_dev.cpu(), img_cpu) and torch.equal(
            sg.discriminator_int_forward(q_dev, img_dev).cpu(),
            sg.discriminator_int_forward(q_cpu, img_cpu))):
        raise AssertionError("the simpleGAN integer path on the card differs from the CPU's")
    # its launches and ATen calls per step, from the profiler over 50 steps
    few = sg.make_train_draws(torch.Generator().manual_seed(3), 50)
    events = traced(lambda: sg.train_from_draws(p_dev, **few), 1)
    launches_per_step = sum(e.count for e in kernel_events(events)) / 50
    out["simplegan"] = {"steps": steps, "mean_distance_64": float(dist),
                        "final_loss_d": float(losses["loss_d"][-1]),
                        "final_loss_g": float(losses["loss_g"][-1]),
                        "ms_per_step": secs / steps * 1e3,
                        "launches_per_step": launches_per_step,
                        "aten_calls_per_step": sum(e.count for e in events
                                                   if e.key.startswith("aten::")) / 50,
                        "int_latents_checked": int(ng.shape[0])}
    times["simplegan_30000_steps_s"] = secs
    times["simplegan_s"] = time.time() - t

    # simpleGAN card against CPU: SIMPLEGAN_CMP_STEPS steps from one set of
    # CPU draws, both modes, in four legs, so that the difference's growth shows
    t = time.time()
    gen = torch.Generator().manual_seed(4)
    p0 = sg.init_params(gen)
    draws = sg.make_train_draws(gen, SIMPLEGAN_CMP_STEPS)
    leg = SIMPLEGAN_CMP_STEPS // 4   # even: the 1-based G schedule carries across legs
    cmp = {}
    for mode in ("matlab", "exact"):
        pd, pc, rels, secs_dev = sg.SimpleGANParams(*(p.to(dev) for p in p0)), p0, [], 0.0
        for i in range(0, SIMPLEGAN_CMP_STEPS, leg):
            part = {k: v[i:i + leg] for k, v in draws.items()}
            (pd, _), secs = wall(lambda: sg.train_from_draws(pd, **part, grad_mode=mode))
            pc, _ = sg.train_from_draws(pc, **part, grad_mode=mode)
            secs_dev += secs
            # each tensor's largest difference over its layer's largest entry
            # (weight and bias: a bias near zero has no scale of its own)
            scale = {f[1:]: max(float(pc[pc._fields.index(k + f[1:])].abs().max())
                                for k in "wb") for f in pc._fields}
            rel = {f: float((a.cpu() - b).abs().max()) / scale[f[1:]]
                   for f, a, b in zip(pc._fields, pd, pc)}
            rels.append(max(rel.values()))
            if not rels[-1] <= SIMPLEGAN_RTOL:
                raise AssertionError(f"simpleGAN {mode}: after {i + leg} steps the card's "
                                     f"parameters differ from the CPU's by {rel} of their "
                                     "layers' largest entries")
        cmp[mode] = {"max_rel_err_by_leg": rels,
                     "card_ms_per_step": secs_dev / SIMPLEGAN_CMP_STEPS * 1e3}
    out["simplegan_card_vs_cpu"] = cmp
    times["simplegan_vs_cpu_s"] = time.time() - t

    # selfcheck: in this process (its kernel launches counted here), then
    # through its CLI
    t = time.time()
    rc = quiet(lambda: selfcheck.main(["--device", str(dev), "--json", f"{d}/selfcheck_in.json"]),
               f"{d}/selfcheck_in.log")
    cli = subprocess.run([sys.executable, "-m", "ofdmgan_tpu_torch.selfcheck", "--device",
                          str(dev), "--json", f"{d}/selfcheck.json"],
                         capture_output=True, text=True, timeout=600)
    if rc != 0 or cli.returncode != 0 or "ALL PASSED" not in cli.stdout:
        raise AssertionError(f"selfcheck failed (in process {rc}, CLI {cli.returncode}):\n"
                             f"{cli.stdout[-3000:]}{cli.stderr[-3000:]}")
    report = json.loads(open(f"{d}/selfcheck.json").read())
    out["selfcheck"] = {"measured": report["pallas-datagen"].get("measured"),
                        "launches": {k: v["launches"] for k, v in report.items() if k != "_meta"},
                        "meta": report["_meta"]}
    times["selfcheck_s"] = time.time() - t
    out["times"] = times
    return out


TF32_PROBE = """
import json, sys
import numpy as np
import torch
before = [torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32]
from ofdmgan_tpu_torch.models import MiniGenerator
from ofdmgan_tpu_torch.verify import golden
g = MiniGenerator().cuda()
x = np.random.default_rng(0).standard_normal((1, 2, 16)).astype(np.float32)
golden.generate_golden_vectors(g, x, sys.argv[1])
print(json.dumps({"before_import": before,
                  "after": [torch.backends.cuda.matmul.allow_tf32,
                            torch.backends.cudnn.allow_tf32]}))
"""


def _bf16_draws(dev, seed: int) -> tuple:
    """One mini batch (the FFT datagen's) and its penalty uniforms on
    ``dev``, from ``seed``."""
    from ofdmgan_tpu_torch.signal import datagen as sdg
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = sdg.synthetic_batch_from_draws(sdg.make_draws(gen, MAIN_B, 16), sdg.DatagenConfig())
    return batch, [torch.rand(MAIN_B, generator=gen, device=dev) for _ in range(5)]


def serve_phase(dev, mini_ckpt: str, rtl_ckpt: str, full_ckpt: str) -> dict:
    """Phase ``serve``: the serving export of phase ``train``'s mini
    checkpoint, of phase ``quant``'s RTL-residual one (``--residual``) and of
    phase ``full``'s full U-Net (bf16), each with its selftest on the card
    and reloaded against the CPU's export of the same checkpoint; the
    inference bench at full width, datagen in the loop and resident, and the
    full model unfused; the repaired numerics (TF32 off in a fresh process
    that never calls ``resolve_device``; the bfloat16 mode's critic forward
    on the card against the CPU's and its routes); a ``--remat`` full step
    against the plain step, with the peak memory and time of each; and the
    image-transmission study on the card against the CPU. Returns the phase
    line's fields; printed output goes to ``build/chip_smoke/serve/``."""
    import numpy as np
    from ofdmgan_tpu_torch import bench_infer, export_serving
    from ofdmgan_tpu_torch.config import Config
    from ofdmgan_tpu_torch.eval.loading import build_generator
    from ofdmgan_tpu_torch.models import MiniDiscriminator, MiniGenerator
    from ofdmgan_tpu_torch.ops import datagen_kernel as dk
    from ofdmgan_tpu_torch.signal import datagen as sdg
    from ofdmgan_tpu_torch.training import wgan_gp
    from ofdmgan_tpu_torch.training.schedules import make_adam
    from ofdmgan_tpu_torch.training.trainer import Trainer, build_models
    from ofdmgan_tpu_torch.utils.params_io import load_params_tree
    from ofdmgan_tpu_torch.viz import image_transmission as it

    d = "build/chip_smoke/serve"
    out, times = {}, {}

    # the exports: each program reloaded in this process and run on one
    # CPU-made batch, the card's on the card, the CPU's on the CPU
    t = time.time()
    exports = {}
    for name, ckpt, model, extra in (("mini", mini_ckpt, "mini", []),
                                     ("mini_residual", rtl_ckpt, "mini", ["--residual"]),
                                     ("full", full_ckpt, "full", [])):
        meta = {}
        for where in ("cuda", "cpu"):
            argv = ["--device", "cuda:0" if where == "cuda" else "cpu", "--model", model,
                    "--checkpoint", ckpt, "--out", f"{d}/{name}_{where}", *extra]
            meta[where] = quiet(lambda: export_serving.main(argv), f"{d}/export_{name}_{where}.log")
        L = 1024 if model == "full" else 16
        x = torch.randn(8 if model == "full" else 4096, L, 2,
                        generator=torch.Generator().manual_seed(31))
        with torch.no_grad():
            y_card = torch.export.load(f"{d}/{name}_cuda.pt2").module()(x.to(dev)).cpu()
            y_cpu = torch.export.load(f"{d}/{name}_cpu.pt2").module()(x)
        err = float((y_card - y_cpu).abs().max())
        row = {"device": meta["cuda"]["device"], "artifact_bytes": meta["cuda"]["artifact_bytes"],
               "selftest_max_abs_diff": {k: m["selftest_max_abs_diff"] for k, m in meta.items()},
               "card_vs_cpu_max_abs_err": err}
        if model == "full":
            fwd32, _ = export_serving.build_forward("full", load_params_tree(ckpt), False,
                                                    "float32", L)
            with torch.no_grad():
                own = float((y_cpu - fwd32.eval()(x)).abs().max())
            limit = SERVE_FULL_FACTOR * own
            row.update(cpu_vs_float32_max_abs=own, within_bf16_atol=err <= SERVE_BF16_ATOL)
        else:
            limit = SERVE_MINI_ATOL
        if not err <= limit or not bool(torch.isfinite(y_card).all()):
            raise AssertionError(f"the {name} export on the card is {err:.3e} from the CPU's "
                                 f"(limit {limit:.3e})")
        exports[name] = row
    out["exports"] = exports
    times["export_s"] = time.time() - t

    # the inference bench: datagen in the loop (one datagen launch per
    # apply) and resident (none), for both families, and the full model
    # unfused; full-width batches, SERVE_SCAN_STEPS applies per window
    t = time.time()
    bench = {}
    for run, extra in (("datagen_in_loop", []), ("resident", ["--resident"]),
                       ("unfused", ["--models", "full", "--unfused"])):
        argv = ["--device", "cuda:0", "--scan_steps", str(SERVE_SCAN_STEPS),
                "--profile_dir", f"{d}/profile_{run}", *extra]
        for r in quiet(lambda: bench_infer.main(argv), f"{d}/bench_{run}.log"):
            row, st = r["row"], r["stats"]
            steps = (SERVE_SCAN_STEPS if row["model"].startswith("mini")
                     else max(SERVE_SCAN_STEPS // 2, 8))
            want = 0 if run == "resident" else steps
            if st["datagen_launches_per_window"] != want or st["idle_share"] is None:
                raise AssertionError(f"bench {run} {row['model']}: {st} (want {want} datagen "
                                     "launches a window and an idle share)")
            bench[f"{row['model']}_{row['input']}"] = {**row, **st}
    out["bench"] = bench
    times["bench_s"] = time.time() - t

    # C.2: TF32 is off once the port is imported, in a process that calls
    # no resolve_device (golden vectors of a bare .cuda() model)
    t = time.time()
    probe = subprocess.run([sys.executable, "-c", TF32_PROBE, f"{d}/golden_probe"],
                           capture_output=True, text=True, timeout=300)
    if probe.returncode != 0:
        raise AssertionError(f"the TF32 probe failed: {probe.stderr[-2000:]}")
    flags = json.loads(probe.stdout.strip().splitlines()[-1])
    if flags["after"] != [False, False]:
        raise AssertionError(f"TF32 is on after importing the port: {flags}")
    out["tf32_probe"] = flags

    # C.1: the bfloat16 mode's critic forward, card against CPU (bf16
    # products are exact in float32); its routes (both kernels, the critic
    # kernel in its bf16 form) and its kernel step against its reference
    # step on one batch (the second step from one state: Adam's first is a
    # sign), within STEP_RTOL of each tensor's largest update
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        critic = MiniDiscriminator()
    a, b = torch.randn(2, 4096, 16, 2, generator=torch.Generator().manual_seed(32)).unbind(0)
    with torch.no_grad():
        f32 = critic(a, b)
        with wgan_gp.matmul_precision("bfloat16"):
            y_cpu = critic(a, b)
            y_card = copy.deepcopy(critic).to(dev)(a.to(dev), b.to(dev)).cpu()
    # every score within SERVE_BF16_RTOL but where a layer-1 activation,
    # summed in another order, rounded to the other bf16 neighbour (1 in
    # 2,048 scores measured on one H100): at most 1 in 1,000, each within
    # one bf16 step of the scores' scale
    bf_diff = (y_card - y_cpu).abs()
    straddles = int((bf_diff > 1e-6 + SERVE_BF16_RTOL * y_cpu.abs()).sum())
    if (straddles > max(1, y_cpu.numel() // 1000)
            or not float(bf_diff.max()) <= 2 ** -8 * float(y_cpu.abs().max())):
        raise AssertionError(f"the bfloat16-mode critic on the card: {straddles} scores past "
                             f"rtol {SERVE_BF16_RTOL}, largest difference {float(bf_diff.max())}")
    bf_steps = {}
    for name, reference in (("kernel", False), ("reference", True)):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(3)
            g_bf, d_bf = MiniGenerator().to(dev), MiniDiscriminator().to(dev)
        bf_steps[name] = wgan_gp.TrainStep(
            g_bf, d_bf, make_adam(g_bf.parameters(), 2e-4), make_adam(d_bf.parameters(), 2e-4),
            sdg.DatagenConfig(), wgan_gp.LossConfig(), MAIN_B, reference=reference,
            matmul_precision="bfloat16")
    step = bf_steps["kernel"]
    before = _counts()
    metrics = step(torch.Generator(device=dev).manual_seed(33))
    bf_launches = {k: v - before[k] for k, v in _counts().items()}
    bf_routes = _routes(step)
    if (bf_routes != {"datagen": "kernel", "critic": "kernel", "generator": "plain",
                      "forward": "plain"}
            or bf_launches != {"datagen": 1, "critic_grad": step.loss_cfg.n_critic,
                               "generator_grad": 0, "generator_forward": 0}
            or not all(bool(torch.isfinite(v)) for v in metrics.values())):
        raise AssertionError(f"the bfloat16 step: routes {bf_routes}, launches {bf_launches}, "
                             f"metrics {metrics}")
    bf_steps["reference"].run(*_bf16_draws(dev, 33))   # the kernel step's first step
    step.generator.load_state_dict(bf_steps["reference"].generator.state_dict())
    step.critic.load_state_dict(bf_steps["reference"].critic.state_dict())
    for new, old in ((step.opt_g, bf_steps["reference"].opt_g),
                     (step.opt_d, bf_steps["reference"].opt_d)):
        new.opt.load_state_dict(copy.deepcopy(old.opt.state_dict()))
    start = {n: p.detach().clone() for n, p in all_params(step).items()}
    for s_ in bf_steps.values():
        s_.run(*_bf16_draws(dev, 34))
    bf_step_diff, bf_step_rel = updates_agree(
        start, all_params(step), all_params(bf_steps["reference"]), STEP_RTOL,
        "bfloat16 kernel and reference steps")
    out["bf16_mode"] = {"critic_card_vs_cpu_max_abs_err": float(bf_diff.max()),
                        "critic_scores_straddling": straddles,
                        "critic_bf16_vs_float32_max_abs": float((y_cpu - f32).abs().max()),
                        "routes": bf_routes, "launches": bf_launches,
                        "kernel_step_update_max_abs_diff": bf_step_diff,
                        "kernel_step_update_max_rel_diff": bf_step_rel}
    times["numerics_s"] = time.time() - t

    # --remat: phase full's trained state (parameters and Adam moments), one
    # step with recomputation and one without on one batch, with cuDNN's
    # deterministic algorithms; then the time and peak memory of each with
    # cuDNN's default algorithms, as phase full times its step
    t = time.time()
    base = Config(checkpoint_dir=f"{d}/full_checkpoints", log_dir=f"{d}/full_logs",
                  export_after_training=False)
    cfg = dataclasses.replace(base, frame_length=FULL_L,
                              training=dataclasses.replace(base.training, batch_size=FULL_B))
    g, dd = build_models(cfg, "full", seed=0)
    trainer = Trainer(cfg, samples_per_epoch=FULL_STEPS * FULL_B, val_samples=FULL_B, seed=0,
                      device=dev, generator=g, discriminator=dd)
    trainer.load_checkpoint(full_ckpt)
    gen = torch.Generator(device=dev).manual_seed(34)
    batch = dk.synthetic_batch(gen, FULL_B, trainer.dg_cfg)
    alphas = [torch.rand(FULL_B, generator=gen, device=dev)
              for _ in range(trainer.loss_cfg.n_critic)]
    steps = {"plain": clone_step(trainer, False), "remat": clone_step(trainer, False)}
    steps["remat"].remat = True
    start = {n: p.detach().clone() for n, p in all_params(steps["plain"]).items()}
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        m = {k: {n: float(v) for n, v in s.run(batch, alphas).items()} for k, s in steps.items()}
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = saved
    remat_abs, remat_rel = updates_agree(start, all_params(steps["remat"]),
                                         all_params(steps["plain"]), REMAT_RTOL,
                                         "remat and plain full steps")
    del batch
    ms, peak = {}, {}
    for name in ("plain", "remat", "remat", "plain"):
        t_ms, p = timed_steps(steps[name], trainer.rng)
        ms.setdefault(name, []).append(t_ms)
        peak[name] = max(peak.get(name, 0), p)
    out["remat"] = {"update_max_abs_diff": remat_abs, "update_max_rel_diff": remat_rel,
                    "metrics": m, "ms_per_step": ms,
                    "peak_memory_gb": {k: v / 1e9 for k, v in peak.items()},
                    "recorded_full_step_peak_gb": FULL_STEP_PEAK_GB}
    del steps, trainer
    times["remat_s"] = time.time() - t

    # the image-transmission study with phase train's mini generator, on
    # the card and on the CPU from one set of CPU draws
    t = time.time()
    g_cpu = build_generator(load_params_tree(mini_ckpt), "mini", 16)
    sims = {"cuda": it.ImageOFDMSimulator(generator=copy.deepcopy(g_cpu).to(dev), device=dev),
            "cpu": it.ImageOFDMSimulator(generator=g_cpu, device="cpu")}
    img, snrs = it.builtin_test_image(), [0.0, 10.0, 20.0, 30.0]
    draws = [sims["cpu"].make_draws(torch.Generator().manual_seed(40 + i))
             for i in range(len(snrs))]
    res = {k: [dataclasses.asdict(r) for r in s.evaluate_from_draws(img, snrs, draws)]
           for k, s in sims.items()}
    for rc, rp in zip(res["cuda"], res["cpu"]):
        for k, v in rp.items():
            if isinstance(v, float) and not math.isclose(rc[k], v, rel_tol=1e-4, abs_tol=1e-6):
                raise AssertionError(f"image transmission at {rp['snr_db']} dB: {k} {rc[k]} "
                                     f"on the card, {v} on the CPU")
    out["image_transmission"] = res["cuda"]
    times["viz_s"] = time.time() - t
    out["times"] = times
    return out


def _rank_device() -> torch.device:
    """The card of this rank (``distributed.initialize`` made it current)."""
    return torch.device("cuda", torch.cuda.current_device())


def _cpu_params(model) -> dict:
    return {n: p.detach().cpu().clone() for n, p in all_params(model).items()}


def _cpu_moments(trainer) -> dict:
    """Each trained parameter's Adam moments ``(exp_avg, exp_avg_sq)`` on
    the CPU, named as ``all_params``; with b1 = 0, ``exp_avg`` is the last
    gradient."""
    if trainer.config.training.betas[0] != 0:
        raise AssertionError(f"Adam's b1 is {trainer.config.training.betas[0]}, not 0: "
                             "its first moment is not the last gradient")
    out = {}
    for tag, module, opt in (("generator", trainer.generator, trainer.opt_g),
                             ("critic", trainer.critic, trainer.opt_d)):
        for n, p in module.named_parameters():
            st = opt.opt.state.get(p)
            if st:
                out[f"{tag}.{n}"] = (st["exp_avg"].detach().cpu().clone(),
                                     st["exp_avg_sq"].detach().cpu().clone())
    return out


def worst_update(start: dict, a: dict, b: dict, mom_a: dict, mom_b: dict) -> dict:
    """Where the update ``a - start`` lies farthest from ``b - start``, over
    that tensor's largest entry of ``b``'s update: the tensor, the entry and
    that share (``rel``); at the entry, ``b``'s update, last gradient and RMS
    gradient (the root of Adam's second moment) each over its tensor's
    largest, and the two last gradients' difference over ``b``'s there. And
    the two steps' last gradients compared before Adam divides each entry by
    its own RMS: the largest difference of any tensor over its largest
    gradient (``grad_rel``, in ``grad_tensor``)."""
    worst = {"rel": -1.0}
    for name, p0 in start.items():
        ua, ub = (a[name] - p0).reshape(-1), (b[name] - p0).reshape(-1)
        size = float(ub.abs().max())
        if not size:
            continue
        diff = (ua - ub).abs()
        i = int(diff.argmax())
        if not float(diff[i]) / size <= worst["rel"]:   # so that a NaN is kept
            worst = {"tensor": name, "entry": i, "rel": float(diff[i]) / size,
                     "update_over_largest": float(ub[i].abs()) / size}
    ga, gb = (m[worst["tensor"]][0].reshape(-1) for m in (mom_a, mom_b))
    rms = mom_b[worst["tensor"]][1].reshape(-1).sqrt()
    i = worst["entry"]
    worst.update(grad_over_largest=float(gb[i].abs() / gb.abs().max()),
                 rms_over_largest=float(rms[i] / rms.max()),
                 grad_rel_diff_at_entry=float((ga[i] - gb[i]).abs()
                                              / gb[i].abs().clamp_min(1e-30)))
    worst["grad_rel"], worst["grad_tensor"] = max(
        (float((mom_a[n][0] - m[0]).abs().max() / m[0].abs().max()), n)
        for n, m in mom_b.items() if n in mom_a and float(m[0].abs().max()))
    return worst


def _counts_reset() -> None:
    """Set the kernel wrappers' launch counts and the collectives' traffic to 0."""
    from ofdmgan_tpu_torch.ops import critic_kernel as ck, datagen_kernel as dk
    from ofdmgan_tpu_torch.ops import generator_kernel as gk
    from ofdmgan_tpu_torch.parallel import distributed
    dk.launches = ck.launches = gk.launches = gk.forward_launches = 0
    distributed.reset_traffic()


def _counts() -> dict:
    """The kernel wrappers' launches since ``_counts_reset``, by KERNELS."""
    from ofdmgan_tpu_torch.ops import critic_kernel as ck, datagen_kernel as dk
    from ofdmgan_tpu_torch.ops import generator_kernel as gk
    return {"datagen": dk.launches, "critic_grad": ck.launches, "generator_grad": gk.launches,
            "generator_forward": gk.forward_launches}


def _routes(step) -> dict:
    """A step's route of each kernel (a step without a route takes the plain one)."""
    return {k: getattr(step, f"{k}_route", "plain")
            for k in ("datagen", "critic", "generator", "forward")}


def _deterministic(fn):
    """``fn()`` with cuDNN's deterministic algorithms (ROADMAP trap 2)."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out = fn()
        torch.cuda.synchronize()
        return out
    finally:
        torch.backends.cudnn.deterministic = saved


def _mini_config(d: str):
    from ofdmgan_tpu_torch.config import Config
    return Config(checkpoint_dir=f"{d}/ck", log_dir=f"{d}/logs", export_after_training=False)


def parallel_rank_nccl(d: str) -> dict:
    """Leg a, on a world of one over NCCL: the mini recipe's data-parallel
    trainer, two epochs, through both kernels; then PAR_CHECK_STEPS steps
    bit for bit against the plain ``TrainStep`` on the same state and
    draws (a mean over one rank is exact); step times of both."""
    from ofdmgan_tpu_torch.parallel import distributed
    from ofdmgan_tpu_torch.parallel.mesh import ShardedTrainStep, draw_seed, replica_generator
    from ofdmgan_tpu_torch.training.trainer import Trainer
    dev = _rank_device()
    trainer = Trainer(_mini_config(f"{d}/a"), samples_per_epoch=PAR_MINI_STEPS * MAIN_B,
                      val_samples=256, seed=0, device=dev, data_parallel=1)
    if not isinstance(trainer.step, ShardedTrainStep):
        raise AssertionError(f"leg a did not take the data-parallel step: {type(trainer.step)}")
    _counts_reset()
    t = time.perf_counter()
    history = trainer.train(epochs=2, experiment_name="parallel_a")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    launches = _counts()
    traffic = dict(distributed.traffic)
    plain = clone_step(trainer, False)
    # a sharded step's generator update is autograd's, its forward the module's
    plain.generator_route = trainer.step.generator_route
    plain.forward_route = trainer.step.forward_route
    seeds_dp, seeds_plain = torch.Generator().manual_seed(99), torch.Generator().manual_seed(99)
    equal = []
    for _ in range(PAR_CHECK_STEPS):
        m_dp = _deterministic(lambda: trainer.step(seeds_dp))
        m_plain = _deterministic(
            lambda: plain(replica_generator(draw_seed(seeds_plain), 0, dev)))
        equal.append(all(torch.equal(a, b) for a, b in zip(all_params(trainer.step).values(),
                                                           all_params(plain).values()))
                     and all(torch.equal(m_dp[k], m_plain[k]) for k in m_plain))
    ms_dp, peak_dp = timed_steps(trainer.step, seeds_dp, n=20)
    ms_plain, _ = timed_steps(plain, torch.Generator(device=dev).manual_seed(5), n=20)
    return {"backend": torch.distributed.get_backend(), "world": distributed.world_size(),
            "routes": _routes(trainer.step),
            "launches": launches, "train_s": train_s, "history": history,
            "traffic_per_step": {k: v / (2 * PAR_MINI_STEPS) for k, v in traffic.items()},
            "bit_equal_steps": equal, "ms_per_step": {"dp_nccl": ms_dp, "plain": ms_plain},
            "peak_memory_gb": peak_dp / 1e9}


def _same_on_every_rank(model) -> bool:
    """Whether this rank's parameters equal rank 0's, bit for bit."""
    from ofdmgan_tpu_torch.parallel import distributed
    flat = torch.cat([p.detach().reshape(-1) for p in all_params(model).values()])
    ref = distributed.broadcast(flat.clone(), 0)
    return torch.equal(flat, ref)


def _leg_b(d: str) -> dict:
    """Leg b: the mini recipe's data-parallel trainer on two ranks that
    share the card over gloo: one epoch, PAR_CHECK_STEPS steps with both
    ranks' parameters compared after each, then one step (deterministic
    cuDNN) against a single-process step on both replicas' draws."""
    from ofdmgan_tpu_torch.parallel import distributed
    from ofdmgan_tpu_torch.parallel.mesh import draw_seed, replica_generator
    from ofdmgan_tpu_torch.training.trainer import Trainer
    dev = _rank_device()
    trainer = Trainer(_mini_config(f"{d}/b"), samples_per_epoch=PAR_MINI_STEPS * MAIN_B,
                      val_samples=256, seed=0, device=dev, data_parallel=2)
    _counts_reset()
    t = time.perf_counter()
    trainer.train(epochs=1, experiment_name="parallel_b")
    lockstep = []
    for _ in range(PAR_CHECK_STEPS):
        trainer.step(trainer.step_seeds)
        lockstep.append(_same_on_every_rank(trainer.step))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    single = clone_step(trainer, False)   # the global batch, one process
    start = {n: p.detach().clone() for n, p in all_params(single).items()}
    seeds = torch.Generator()
    seeds.set_state(trainer.step_seeds.get_state())
    seed = draw_seed(seeds)   # the seed the next step draws
    m_dp = _deterministic(lambda: trainer.step(trainer.step_seeds))
    launches = _counts()
    traffic = dict(distributed.traffic)
    lockstep.append(_same_on_every_rank(trainer.step))
    local = trainer.step.step   # this rank's TrainStep: global_batch / 2 frames
    parts = [local.draw(replica_generator(seed, i, dev)) for i in range(2)]
    batch = {k: torch.cat([p[0][k] for p in parts]) for k in parts[0][0]}
    alphas = [torch.cat([p[1][j] for p in parts]) for j in range(len(parts[0][1]))]
    m_single = _deterministic(lambda: single.run(batch, alphas))
    diff, rel = updates_agree(start, all_params(trainer.step), all_params(single), STEP_RTOL,
                              "the two-rank and the single-process mini steps")
    ms, _ = timed_steps(trainer.step, trainer.step_seeds, n=PAR_MINI_STEPS)
    steps = PAR_MINI_STEPS + PAR_CHECK_STEPS + 1
    return {"routes": _routes(trainer.step),
            "launches": launches, "steps": steps, "train_s": train_s,
            "traffic_per_step": {k: v / steps for k, v in traffic.items()},
            "lockstep": lockstep, "update_max_abs_diff": diff, "update_max_rel_diff": rel,
            "ms_per_step": ms,
            "metrics_dp": {k: float(v) for k, v in m_dp.items()},
            "metrics_single": {k: float(v) for k, v in m_single.items()}}


def _full_trainer(d: str, batch: int, supervised: bool, dev, quant_bits=None, **parallel):
    """A full-width trainer (levels 5, base 32, L = 1024, AWGN) at global
    ``batch``; ``supervised``: n_critic 0, adversarial weight 0;
    ``quant_bits`` the generator's; ``parallel`` the trainer's other
    settings."""
    from ofdmgan_tpu_torch.config import Config
    from ofdmgan_tpu_torch.training.trainer import Trainer, build_models
    base = Config(checkpoint_dir=f"{d}/ck", log_dir=f"{d}/logs", export_after_training=False)
    tr = dataclasses.replace(base.training, batch_size=batch,
                             **(dict(n_critic=0, adversarial_weight=0.0) if supervised else {}))
    cfg = dataclasses.replace(base, frame_length=FULL_L, training=tr)
    g, dd = build_models(cfg, "full", seed=0, quant_bits=quant_bits)
    return Trainer(cfg, samples_per_epoch=batch, val_samples=batch, seed=0, device=dev,
                   generator=g, discriminator=dd, **parallel)


def _leg_c(d: str, name: str, batch: int) -> dict:
    """One layout of leg c: the full-width trainer under it resumes from
    the warmed-up checkpoint (every rank loads it and places it under the
    layout), takes the compared step (deterministic cuDNN) on the global
    draws of PAR_SEED, then one untimed step and PAR_TIMED_STEPS timed
    steps."""
    from ofdmgan_tpu_torch.parallel import distributed
    dev = _rank_device()
    supervised = name == "pp2"
    trainer = _full_trainer(f"{d}/{name}", batch, supervised, dev, **PAR_LAYOUTS[name])
    trainer.load_checkpoint(f"{d}/{'sup' if supervised else 'gan'}_start")
    _counts_reset()
    m = _deterministic(lambda: trainer.step(torch.Generator(device=dev).manual_seed(PAR_SEED)))
    launches = _counts()
    trainer._gather_state()
    params, moments = _cpu_params(trainer), _cpu_moments(trainer)
    same = _same_on_every_rank(trainer)
    rng = torch.Generator(device=dev).manual_seed(3)
    trainer.step(rng)   # untimed: cuDNN's algorithm choice and workspaces
    distributed.reset_traffic()
    ms, peak = timed_steps(trainer.step, rng, n=PAR_TIMED_STEPS, warmup=0)
    traffic = {k: v / PAR_TIMED_STEPS for k, v in distributed.traffic.items()}
    main = distributed.rank() == 0
    return {"params": params if main else None, "moments": moments if main else None,
            "same_on_every_rank": same,
            "metrics": {k: float(v) for k, v in m.items()}, "launches": launches,
            "ms_per_step": ms, "peak_memory_gb": peak / 1e9, "traffic_per_step": traffic,
            "mesh": dict(zip(trainer.mesh.mesh_dim_names, trainer.mesh.shape))}


def parallel_rank_gloo(d: str, batch: int) -> dict:
    """Legs b and c on one of two ranks that share the card over gloo."""
    import gc
    out = {"b": _leg_b(d), "c": {}}
    for name in PAR_LAYOUTS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out["c"][name] = _leg_c(d, name, batch)
    return out


def parallel_phase(dev) -> dict:
    """Phase ``parallel``: the parallel strategies on the card. Leg a: the
    data-parallel mini trainer on a world of one over NCCL (NCCL refuses
    two ranks on one GPU), bit for bit against the plain step. Leg b: the
    same trainer on two ranks sharing the card over gloo, in lockstep and
    within STEP_RTOL of a single-process step on both ranks' draws. Leg c:
    the full U-Net at full width under gspmd {dp: 2}, {dp: 1, tp: 2},
    {dp: 1, sp: 2} and the pp = 2 pipeline (supervised, 8 microbatches),
    each within PAR_STEP_RTOL (metrics PAR_METRIC_RTOL) of the single-device
    step from the same warmed-up state on the same global draws (the
    datagen kernel's), the pipeline's loss within PAR_PP_RTOL. Returns the
    phase line's fields."""
    import gc
    from ofdmgan_tpu_torch.parallel import distributed
    d = "build/chip_smoke/parallel"
    out = {}
    t = time.time()
    out["a"] = distributed.launch(parallel_rank_nccl, 1, (d,), device="cuda:0",
                                  timeout_s=PAR_TIMEOUT_S)[0]
    a = out["a"]
    # a sharded step's generator update is autograd's, its forward the module's
    want = {"datagen": 2 * PAR_MINI_STEPS, "critic_grad": 2 * PAR_MINI_STEPS * 5,
            "generator_grad": 0, "generator_forward": 0}
    if a["backend"] != "nccl" or a["launches"] != want:
        raise AssertionError(f"leg a: backend {a['backend']}, launches {a['launches']}, "
                             f"not {want} (1 datagen and 5 critic launches a step)")
    if not all(a["bit_equal_steps"]):
        raise AssertionError(f"leg a: the NCCL world of one left the plain step: "
                             f"{a['bit_equal_steps']}")
    out["a_s"] = time.time() - t

    # leg c's single-device references: from seed 0, PAR_WARM_STEPS steps,
    # a checkpoint (the legs' start), then the compared step
    t = time.time()
    total = torch.cuda.get_device_properties(dev).total_memory

    def reference(kind: str, batch: int) -> dict:
        trainer = _full_trainer(f"{d}/ref_{kind}", batch, kind == "sup", dev)
        torch.cuda.reset_peak_memory_stats()
        for _ in range(PAR_WARM_STEPS):
            _deterministic(lambda: trainer.step(trainer.rng))
        peak = torch.cuda.max_memory_allocated()
        trainer.save_checkpoint(f"{d}/{kind}_start")
        start = _cpu_params(trainer)
        m = _deterministic(lambda: trainer.step(torch.Generator(device=dev).manual_seed(PAR_SEED)))
        ref = {"start": start, "params": _cpu_params(trainer), "moments": _cpu_moments(trainer),
               "peak_gb": peak / 1e9, "metrics": {k: float(v) for k, v in m.items()}}
        # the same step with cuDNN's default algorithms, whose weight
        # gradients add in another order: how far a change of summation
        # order alone moves the update (reported, not gated)
        trainer.load_checkpoint(f"{d}/{kind}_start")
        trainer.step(torch.Generator(device=dev).manual_seed(PAR_SEED))
        torch.cuda.synchronize()
        ref["default_cudnn"] = worst_update(start, _cpu_params(trainer), ref["params"],
                                            _cpu_moments(trainer), ref["moments"])
        # the control: the same step at a lower precision (TF32 operands,
        # deterministic cuDNN), which the gate must tell from a sound layout
        trainer.load_checkpoint(f"{d}/{kind}_start")
        trainer.step.matmul_precision = "tensorfloat32"
        _deterministic(lambda: trainer.step(torch.Generator(device=dev).manual_seed(PAR_SEED)))
        trainer.step.matmul_precision = "float32"
        ref["tf32"] = worst_update(start, _cpu_params(trainer), ref["params"],
                                   _cpu_moments(trainer), ref["moments"])
        trainer.step(trainer.rng)   # untimed: cuDNN's algorithm choice and workspaces
        ms, peak_timed = timed_steps(trainer.step, trainer.rng, n=PAR_TIMED_STEPS, warmup=0)
        ref["timed"] = {"ms_per_step": ms, "peak_memory_gb": peak_timed / 1e9}
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        return ref

    # 512 where two ranks, each at most at the single-rank step's peak (a
    # rank of every layout holds at most the single step's activations),
    # fit the card with a tenth to spare; else 256
    batch = FULL_B
    refs = {"gan": reference("gan", batch)}
    fits = 2 * refs["gan"]["peak_gb"] * 1e9 <= 0.9 * total
    if not fits:
        batch = FULL_B // 2
        refs["gan"] = reference("gan", batch)
    refs["sup"] = reference("sup", batch)
    reason = (f"two ranks at the single-rank step's peak of {refs['gan']['peak_gb']:.2f} GB "
              f"{'fit' if fits else 'do not fit'} 90 % of the card's {total / 1e9:.1f} GB")
    out["batch"] = {"global": batch, "cut": not fits, "reason": reason,
                    "parent_allocated_gb": torch.cuda.memory_allocated() / 1e9}
    print(f"parallel: full-width global batch {batch}: {reason}", flush=True)
    out["ref_s"] = time.time() - t

    t = time.time()
    ranks = distributed.launch(parallel_rank_gloo, 2, (d, batch), device="cuda:0",
                               backend="gloo", timeout_s=PAR_TIMEOUT_S)
    out["bc_s"] = time.time() - t
    b = [r["b"] for r in ranks]
    for r, leg in enumerate(b):
        # both ranks' steps are sharded: the generator update is autograd's,
        # its forward the module's
        if (not all(leg["lockstep"]) or not (leg["launches"]["datagen"]
                                             and leg["launches"]["critic_grad"])
                or leg["launches"]["generator_grad"] != 0
                or leg["launches"]["generator_forward"] != 0):
            raise AssertionError(f"leg b, rank {r}: lockstep {leg['lockstep']}, "
                                 f"launches {leg['launches']}")
    out["b"] = {"ranks": b}
    out["c"] = {}
    failed = []
    for name in PAR_LAYOUTS:
        legs = [r["c"][name] for r in ranks]
        kind = "sup" if name == "pp2" else "gan"
        ref = refs[kind]
        if not all(leg["same_on_every_rank"] for leg in legs):
            raise AssertionError(f"leg c {name}: the ranks' parameters differ")
        if not all(leg["launches"]["datagen"] > 0 for leg in legs):
            raise AssertionError(f"leg c {name}: the datagen kernel was not launched: "
                                 f"{[leg['launches'] for leg in legs]}")
        try:
            diff, rel = updates_agree(ref["start"], legs[0]["params"], ref["params"],
                                      PAR_STEP_RTOL[kind],
                                      f"leg c {name} and the single-device step")
        except AssertionError as e:   # every leg's numbers are logged before the phase fails
            failed.append(str(e))
            diff, rel = updates_agree(ref["start"], legs[0]["params"], ref["params"], None, "")
        metric_rel = {k: abs(legs[0]["metrics"][k] - v) / max(abs(v), 1e-12)
                      for k, v in ref["metrics"].items()}
        if not all(v <= PAR_METRIC_RTOL for v in metric_rel.values()):   # so that a NaN fails
            failed.append(f"leg c {name}: metrics {legs[0]['metrics']} against the single-device "
                          f"step's {ref['metrics']} (rtol {PAR_METRIC_RTOL})")
        if name == "pp2" and not metric_rel["rec_loss"] <= PAR_PP_RTOL:
            failed.append(f"leg c pp2: rec_loss {legs[0]['metrics']['rec_loss']} against "
                          f"{ref['metrics']['rec_loss']} (rtol {PAR_PP_RTOL})")
        worst = worst_update(ref["start"], legs[0]["params"], ref["params"],
                             legs[0]["moments"], ref["moments"])
        for leg in legs:
            leg.pop("params")
            leg.pop("moments")
        out["c"][name] = {"update_max_abs_diff": diff, "update_max_rel_diff": rel,
                          "worst": worst,
                          "metric_max_rel_diff": max(metric_rel.values()), "ranks": legs,
                          "single_device_metrics": ref["metrics"],
                          "single_device_timed": ref["timed"]}
    # the gate's power: the single-device step at TF32 lies beyond it
    out["controls"] = {kind: {"default_cudnn": ref["default_cudnn"], "tf32": ref["tf32"]}
                       for kind, ref in refs.items()}
    for kind, ref in refs.items():
        if not ref["tf32"]["rel"] > PAR_STEP_RTOL[kind]:
            failed.append(f"the {kind} step at TF32 lies within the gate ({ref['tf32']['rel']:.3e}"
                          f" of a largest update, limit {PAR_STEP_RTOL[kind]}): it cannot tell a "
                          f"lower-precision step from a sound layout")
    launches = {k: a["launches"][k] + sum(leg["launches"][k] for leg in b)
                + sum(r["c"][n]["launches"][k] for r in ranks for n in PAR_LAYOUTS)
                for k in KERNELS}
    out["launches"] = launches
    if failed:
        print(json.dumps({"phase": "parallel", "failed_gates": failed, **out}), flush=True)
        raise AssertionError("; ".join(failed))
    return out


def _train_state(trainer) -> dict:
    """Every tensor a chunk updates in place: both nets' parameters, both
    Adam states, the device rates and update counts; by name."""
    out = {f"p.{n}": p for n, p in all_params(trainer).items()}
    for tag, opt in (("g", trainer.opt_g), ("d", trainer.opt_d)):
        for i, st in enumerate(opt.opt.state.values()):
            out.update({f"{tag}.{i}.{k}": v for k, v in st.items()})
        out[f"{tag}.lr"], out[f"{tag}.count"] = opt.opt.param_groups[0]["lr"], opt.count
    return out


def _snapshot(trainer) -> tuple:
    return ({k: v.detach().clone() for k, v in _train_state(trainer).items()},
            trainer.rng.get_state())


def _restore(trainer, snap, rng: bool = True) -> None:
    """Copy a snapshot back in place (a graph keeps reading the same
    tensors); ``rng`` also restores the generator's state."""
    tensors, rng_state = snap
    with torch.no_grad():
        for k, v in _train_state(trainer).items():
            v.copy_(tensors[k])
    if rng:
        trainer.rng.set_state(rng_state)


def _chunk_profile(fn) -> dict:
    """ATen calls, kernel launches from the host, graph launches and
    kernels run on the device in one call of ``fn`` (``torch.profiler``)."""
    from ofdmgan_tpu_torch.utils.profiling import kernel_events, traced
    events = traced(fn, 1)
    count = lambda keys: sum(e.count for e in events if e.key in keys)  # noqa: E731
    return {"aten_calls": sum(e.count for e in events if e.key.startswith("aten::")),
            "host_kernel_launches": count({"cudaLaunchKernel", "cuLaunchKernel",
                                           "cudaLaunchKernelExC", "cuLaunchKernelEx"}),
            "graph_launches": count({"cudaGraphLaunch", "cuGraphLaunch"}),
            "device_kernels": sum(e.count for e in kernel_events(events))}


def ms_per_step_runs(fn, steps: int, runs: int = LAYOUT_TIMED_RUNS) -> dict:
    """Host ms per outer step of ``fn`` (``steps`` outer steps a call),
    each of ``runs`` calls timed alone, ending in a synchronize, after one
    untimed call: their median and spread."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) / steps * 1e3)
    return {"median": statistics.median(times), "min": min(times), "max": max(times),
            "runs": runs}


def _layout_cfg(name: str, **training):
    from ofdmgan_tpu_torch.config import Config
    base = Config(checkpoint_dir=f"build/chip_smoke/layout/{name}/checkpoints",
                  log_dir=f"build/chip_smoke/layout/{name}/logs", export_after_training=False)
    return dataclasses.replace(base, training=dataclasses.replace(base.training, **training))


def _grads_rel(a: dict, b: dict) -> float:
    """The largest difference of any tensor over its largest entry in ``b``."""
    return max(float((a[k] - b[k]).abs().max() / b[k].abs().max().clamp_min(1e-30)) for k in b)


def layout_phase(dev, gen) -> dict:
    """Phase ``layout``: the TPU layout variants. Leg a trains the mini
    default recipe through the flat step (both kernels) and holds one flat
    step against the module step; leg b runs the reference bench's headline
    flags at batch 65,536 (two graphed chunks of 32 steps through the
    datagen kernel), holds one step and ``tf32_matmul`` on the card against
    the CPU, and shows that the step with Hopper TF32 in the penalty chain
    fails that gate; leg c holds a replayed chunk of 26 steps against the
    same chunk run eagerly, shows that replays draw fresh batches, checks
    the launch counts under replay and times both. The measured gates are
    checked after every leg has run, so that the phase line carries all
    the numbers when one fails. Returns the phase line's fields."""
    from ofdmgan_tpu_torch.models.flat import make_critic_flat_apply, make_flat_step
    from ofdmgan_tpu_torch.models.critic import compute_gradient_penalty
    from ofdmgan_tpu_torch.ops import datagen_kernel as dk
    from ofdmgan_tpu_torch.signal import datagen as sdg
    from ofdmgan_tpu_torch.training.chunks import EagerChunk
    from ofdmgan_tpu_torch.training.trainer import Trainer

    out, failed = {}, []

    def gate(what: str, value: float, limit: float, beyond: bool = False) -> float:
        if not (value > limit if beyond else value <= limit):   # so that a NaN fails
            failed.append(f"{what}: {value:.3e} {'within' if beyond else 'beyond'} {limit:.1e}")
        return value

    # ---- a: the mini default recipe with --flat, both kernels, graphed chunks
    t = time.time()
    cfg = _layout_cfg("flat")
    trainer = Trainer(cfg, samples_per_epoch=LAYOUT_STEPS * MAIN_B, val_samples=256, seed=0,
                      device=dev, flat_step=True)
    leg = trained(trainer, "layout_flat",
                  {"datagen": "kernel", "critic": "kernel", "generator": "plain",
                   "forward": "plain"},
                  {"datagen": 2 * LAYOUT_STEPS, "critic_grad": 10 * LAYOUT_STEPS,
                   "generator_grad": 0, "generator_forward": 0})
    draws = sdg.make_draws(gen, MAIN_B, 16)
    alphas = [torch.rand(MAIN_B, generator=gen, device=dev) for _ in range(5)]
    batch = dk.synthetic_batch_from_draws(draws, trainer.dg_cfg)
    steps = {"flat": clone_step(trainer, False, flat=trainer.step.flat),
             "module": clone_step(trainer, False)}
    start = {n: p.detach().clone() for n, p in all_params(steps["flat"]).items()}
    for st in steps.values():
        _deterministic(lambda: st.run(batch, alphas))
    leg["flat_vs_module_max_rel_diff"] = gate("flat against module step", updates_agree(
        start, all_params(steps["flat"]), all_params(steps["module"]), None, "")[1], STEP_RTOL)
    leg["graphed"], leg["scan_steps"] = trainer.graphed, trainer.scan_steps
    leg["seconds"] = round(time.time() - t, 3)
    out["a_flat"] = leg
    del trainer, steps

    # ---- b: the headline flags at batch 65,536, two graphed chunks of 32
    t = time.time()
    cfg = _layout_cfg("headline", batch_size=LAYOUT_B)
    trainer = Trainer(cfg, samples_per_epoch=2 * LAYOUT_SCAN * LAYOUT_B, val_samples=LAYOUT_B,
                      seed=0, device=dev, scan_steps=LAYOUT_SCAN, **LAYOUT_HEADLINE)
    routes = _routes(trainer.step)
    if routes != {"datagen": "kernel", "critic": "plain", "generator": "plain",
                  "forward": "plain"} or not trainer.graphed:
        raise AssertionError(f"the headline run took {routes}, graphed {trainer.graphed}")
    torch.cuda.reset_peak_memory_stats()
    t_run = time.time()
    with counted_launches(trainer) as counted:
        metrics = trainer.train_epoch()
        torch.cuda.synchronize()
    leg = {"routes": routes, "run_s": round(time.time() - t_run, 3), "metrics": metrics,
           "launches": {k: counted[k] for k in KERNELS},
           "replays": counted["replays"], "replayed_launches": counted["replayed"]}
    if (leg["launches"] != {"datagen": 2 * LAYOUT_SCAN, "critic_grad": 0, "generator_grad": 0,
                            "generator_forward": 0}
            or leg["replays"] != 1):
        raise AssertionError(f"the headline run launched {leg['launches']} "
                             f"({leg['replayed_launches']} in {leg['replays']} replays)")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite headline metrics: {metrics}")
    leg["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    kw = dict(act_dtype=trainer.step.act_dtype, matmul_precision=trainer.step.matmul_precision)
    # one step from the state the run left, on one set of draws (made on
    # the CPU): the headline on the card and on the CPU, on the CPU from
    # parameters one float32 ulp up (the floor: how far a float32-level
    # difference moves this bf16 step in this state), and on the card the
    # control with Hopper TF32 in the penalty chain (mm ambient:
    # bf16_tf32gp's context) in place of the bf16x3 products
    cpu_gen = torch.Generator().manual_seed(PAR_SEED)
    draws = sdg.make_draws(cpu_gen, LAYOUT_B, 16)
    batch = dk.synthetic_batch_plain(draws, trainer.dg_cfg)
    alphas = [torch.rand(LAYOUT_B, generator=cpu_gen) for _ in range(5)]
    tf32_gp = make_flat_step(trainer.generator, trainer.critic, 16, "bfloat16", "ambient",
                             True)
    runs = {"cpu": clone_step(trainer, False, device="cpu", flat=trainer.step.flat, **kw),
            "card": clone_step(trainer, False, flat=trainer.step.flat, **kw),
            "card_tf32_gp": clone_step(trainer, False, flat=tf32_gp, **kw),
            "cpu_one_ulp": clone_step(trainer, False, device="cpu", flat=trainer.step.flat, **kw)}
    start = {n: p.detach().cpu().clone() for n, p in all_params(runs["cpu"]).items()}
    with torch.no_grad():
        for p in all_params(runs["cpu_one_ulp"]).values():
            p.copy_(torch.nextafter(p, torch.full_like(p, math.inf)))
    ulp_start = {n: p.detach().clone() for n, p in all_params(runs["cpu_one_ulp"]).items()}
    ends, step_metrics = {}, {}
    for name, st in runs.items():
        d = "cpu" if name.startswith("cpu") else dev
        t_step = time.time()
        m = _deterministic(lambda: st.run({k: v.to(d) for k, v in batch.items()},
                                          [a.to(d) for a in alphas]))
        step_metrics[name] = {k: float(v) for k, v in m.items()}
        step_metrics[name]["seconds"] = round(time.time() - t_step, 3)
        ends[name] = {n: p.detach().cpu() for n, p in all_params(st).items()}
    leg["step_metrics"] = step_metrics
    floor = leg["cpu_one_ulp_vs_cpu_max_rel_diff"] = max(
        float(((ends["cpu_one_ulp"][n] - ulp_start[n]) - (ends["cpu"][n] - p0)).abs().max()
              / (ends["cpu"][n] - p0).abs().max()) for n, p0 in start.items())
    limit = leg["card_vs_cpu_limit"] = LAYOUT_CPU_FACTOR * floor
    leg["card_vs_cpu_max_rel_diff"] = gate("headline step, card against CPU", updates_agree(
        start, ends["card"], ends["cpu"], None, "")[1], limit)
    leg["tf32_gp_vs_cpu_max_rel_diff"] = gate(
        "control: Hopper TF32 in the penalty chain against the CPU",
        updates_agree(start, ends["card_tf32_gp"], ends["cpu"], None, "")[1], limit,
        beyond=True)
    # tf32_matmul card against CPU: the flat critic's scores with every
    # product on it, and the penalty's gradients with respect to the
    # critic's parameters (its grad-of-grad)
    crit = make_critic_flat_apply(mm="tf32x3")
    tf32 = {}
    for d in ("cpu", dev):
        c = copy.deepcopy(runs["cpu"].critic).to(d)
        clean, noisy = batch["clean"].to(d), batch["noisy"].to(d)
        score = crit(c, clean, noisy)
        gp = compute_gradient_penalty(lambda a, b: crit(c, a, b), clean, batch["noisy"].roll(1, 0)
                                      .to(d), noisy, alphas[0].to(d))
        grads = torch.autograd.grad(gp, list(c.parameters()), allow_unused=True)
        tf32[str(d)] = {"score": score.detach().cpu(),
                        **{n: (torch.zeros_like(p) if g is None else g).cpu()
                           for (n, p), g in zip(c.named_parameters(), grads)}}
    card, cpu = tf32[str(dev)], tf32["cpu"]
    leg["tf32_matmul"] = {"score_max_rel_diff": _grads_rel({"s": card["score"]},
                                                          {"s": cpu["score"]}),
                          "gp_grads_max_rel_diff": _grads_rel(
                              {k: v for k, v in card.items() if k != "score"},
                              {k: v for k, v in cpu.items() if k != "score" and v.abs().max() > 0})}
    gate("tf32_matmul, card against CPU", max(leg["tf32_matmul"].values()), LAYOUT_TF32_RTOL)
    del runs
    # a replayed chunk, the same step eagerly, and the eager step as a
    # trainer without graphs runs it (its schedule on the host, Adam not capturable)
    host_sched = clone_step(trainer, False, flat=trainer.step.flat, **kw)
    for name, fn, k in (("graphed", trainer.chunk, LAYOUT_SCAN),
                        ("eager", EagerChunk(trainer.step, trainer.rng, LAYOUT_EAGER_STEPS),
                         LAYOUT_EAGER_STEPS),
                        ("eager_host_schedule",
                         EagerChunk(host_sched, trainer.rng, LAYOUT_EAGER_STEPS),
                         LAYOUT_EAGER_STEPS)):
        leg[f"{name}_ms_per_step"] = ms_per_step_runs(fn, k)
    del host_sched
    leg["seconds"] = round(time.time() - t, 3)
    out["b_headline"] = leg
    del trainer, batch, draws

    # ---- c: a graphed chunk of 26 steps against the same chunk run eagerly
    t = time.time()
    cfg = _layout_cfg("chunk")
    trainer = Trainer(cfg, samples_per_epoch=2 * LAYOUT_CHUNK * MAIN_B, val_samples=256, seed=0,
                      device=dev)
    if not trainer.graphed or trainer.scan_steps != LAYOUT_CHUNK:
        raise AssertionError(f"graphed {trainer.graphed}, chunk {trainer.scan_steps}")
    chunk = trainer.chunk
    leg = {}

    def compare():
        chunk()            # the warm-up chunk, eager on a side stream
        before = _counts()
        chunk.capture()
        snap = _snapshot(trainer)
        leg["wrapper_counts_moved"] = {"capture": _counts() != before}
        m_replay, leg["launches_per_replay"] = traced_replay(trainer, chunk.replay)
        m_replay = {k: float(v) for k, v in m_replay.items()}
        leg["wrapper_counts_moved"]["replay"] = _counts() != before
        replayed = {n: p.detach().clone() for n, p in all_params(trainer).items()}
        _restore(trainer, snap)
        m_eager = {k: float(v) for k, v in chunk.eager().items()}
        eager_end = {n: p.detach().clone() for n, p in all_params(trainer).items()}
        start = {k[2:]: v for k, v in snap[0].items() if k.startswith("p.")}
        leg["replay_vs_eager_max_rel_diff"] = gate(
            "replayed against eager chunk",
            updates_agree(start, replayed, eager_end, None, "")[1], GRAPH_RTOL)
        leg["metrics"] = {"replay": m_replay, "eager": m_eager}
        _restore(trainer, snap)   # the same state and draws: the same chunk again
        again = {k: float(v) for k, v in chunk.replay().items()}
        _restore(trainer, snap, rng=False)   # the same state, the generator moved on
        fresh = {k: float(v) for k, v in chunk.replay().items()}
        leg["metrics"].update(replay_again=again, replay_fresh_draws=fresh)
        if again != m_replay:
            raise AssertionError(f"two replays from one state and generator differ: {again}")
        if fresh["rec_loss"] == m_replay["rec_loss"] or fresh["d_loss"] == m_replay["d_loss"]:
            raise AssertionError("a replay after the generator moved on drew the same batch")

    _deterministic(compare)
    want = {"datagen": LAYOUT_CHUNK, "critic_grad": 5 * LAYOUT_CHUNK,
            "generator_grad": LAYOUT_CHUNK, "generator_forward": LAYOUT_CHUNK}
    if leg["launches_per_replay"] != want or any(leg["wrapper_counts_moved"].values()):
        raise AssertionError(f"a replay ran {leg['launches_per_replay']} launches by its trace, "
                             f"not {want}; wrapper counts moved {leg['wrapper_counts_moved']}")
    # a replayed chunk, the same chunk eagerly, and the eager chunk as a
    # trainer without graphs runs it (its schedule on the host, Adam not capturable)
    host_sched = EagerChunk(clone_step(trainer, False), trainer.rng, LAYOUT_CHUNK)
    for name, fn in (("graphed", chunk.replay), ("eager", chunk.eager),
                     ("eager_host_schedule", host_sched)):
        leg[f"{name}_ms_per_step"] = ms_per_step_runs(fn, LAYOUT_CHUNK)
        leg[f"{name}_per_chunk"] = _chunk_profile(fn)
    leg["seconds"] = round(time.time() - t, 3)
    out["c_chunk"] = leg
    # the phase's training runs (legs a and b)
    out["launches"] = {k: out["a_flat"]["launches"][k] + out["b_headline"]["launches"][k]
                       for k in KERNELS}
    if failed:
        print(json.dumps({"phase": "layout", "failed_gates": failed, **out}), flush=True)
        raise AssertionError(f"phase layout failed {failed}")
    return out


def _full_kind(name: str) -> str:
    return "quant" if name.endswith("quant") else "fused"


def _recording_amax(seen: list):
    """A stand-in for ``GSPMDTrainStep._amax`` that records each maximum
    it returns (the global one)."""
    from ofdmgan_tpu_torch.parallel.gspmd import GSPMDTrainStep
    inner = GSPMDTrainStep._amax

    def record(self, m, name):
        out = inner(self, m, name)
        seen.append((name, out.detach().reshape(-1).cpu().clone()))
        return out
    return record


def _comp_leg_b(d: str) -> dict:
    """Completion, leg b: the mini default under gspmd {dp: 1, sp: 2} on two
    ranks sharing the card over gloo: one epoch, then one step
    (deterministic cuDNN) against the single-process step on the same
    global draws."""
    from ofdmgan_tpu_torch.parallel import distributed
    from ofdmgan_tpu_torch.training.trainer import Trainer
    dev = _rank_device()
    trainer = Trainer(_mini_config(f"{d}/b"), samples_per_epoch=PAR_MINI_STEPS * MAIN_B,
                      val_samples=256, seed=0, device=dev, strategy="gspmd", data_parallel=1,
                      seq_parallel=2)
    _counts_reset()
    t = time.perf_counter()
    trainer.train(epochs=1, experiment_name="completion_b")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    single = clone_step(trainer, False)
    start = {n: p.detach().clone() for n, p in all_params(single).items()}
    draws = trainer.step.draw(torch.Generator(device=dev).manual_seed(PAR_SEED))
    m_sp = _deterministic(lambda: trainer.step.run(*draws))
    launches = _counts()
    traffic = dict(distributed.traffic)
    same = _same_on_every_rank(trainer)
    m_single = _deterministic(lambda: single.run(*draws))
    diff, rel = updates_agree(start, all_params(trainer), all_params(single), None, "")
    ms, _ = timed_steps(trainer.step, trainer.rng, n=PAR_MINI_STEPS)
    return {"routes": _routes(trainer.step),
            "launches": launches, "train_s": train_s, "same_on_every_rank": same,
            "traffic_per_step": {k: v / (PAR_MINI_STEPS + 1) for k, v in traffic.items()},
            "update_max_abs_diff": diff, "update_max_rel_diff": rel, "ms_per_step": ms,
            "metrics_sp": {k: float(v) for k, v in m_sp.items()},
            "metrics_single": {k: float(v) for k, v in m_single.items()}}


def _comp_leg_c(d: str, name: str, batch: int, start_ckpt: str) -> dict:
    """Completion, one layout of leg c: the full-width trainer under it
    resumes from phase ``parallel``'s warmed-up checkpoint; a quantized
    layout records every quantization point's global maximum on this
    rank's shard of the compared step's batch; then the compared step
    (deterministic cuDNN, the draws of PAR_SEED), one untimed and
    COMP_TIMED_STEPS timed steps."""
    from unittest import mock

    from ofdmgan_tpu_torch.parallel import distributed
    from ofdmgan_tpu_torch.parallel.gspmd import GSPMDTrainStep
    dev = _rank_device()
    seen = []
    with mock.patch.object(GSPMDTrainStep, "_amax", _recording_amax(seen)):
        trainer = _full_trainer(f"{d}/{name}", batch, False, dev, strategy="gspmd",
                                **COMP_LAYOUTS[name])
    trainer.load_checkpoint(start_ckpt)
    scales = None
    if _full_kind(name) == "quant":
        batch0, _, _ = trainer.step.draw(torch.Generator(device=dev).manual_seed(PAR_SEED))
        with torch.no_grad():
            trainer.step.forward(trainer.step.local(batch0)["noisy"])
        scales = list(seen)
    _counts_reset()
    m = _deterministic(lambda: trainer.step(torch.Generator(device=dev).manual_seed(PAR_SEED)))
    launches = _counts()
    trainer._gather_state()
    params, moments = _cpu_params(trainer), _cpu_moments(trainer)
    same = _same_on_every_rank(trainer)
    rng = torch.Generator(device=dev).manual_seed(3)
    trainer.step(rng)   # untimed: cuDNN's algorithm choice and workspaces
    distributed.reset_traffic()
    ms, peak = timed_steps(trainer.step, rng, n=COMP_TIMED_STEPS, warmup=0)
    traffic = {k: v / COMP_TIMED_STEPS for k, v in distributed.traffic.items()}
    main = distributed.rank() == 0
    return {"params": params if main else None, "moments": moments if main else None,
            "scales": scales, "same_on_every_rank": same,
            "metrics": {k: float(v) for k, v in m.items()}, "launches": launches,
            "ms_per_step": ms, "peak_memory_gb": peak / 1e9, "traffic_per_step": traffic,
            "mesh": dict(zip(trainer.mesh.mesh_dim_names, trainer.mesh.shape))}


def completion_rank_gloo(d: str, batch: int, start_ckpt: str) -> dict:
    """Legs b and c of phase ``completion`` on one of two ranks that share
    the card over gloo."""
    import gc
    out = {"b": _comp_leg_b(d), "c": {}}
    for name in COMP_LAYOUTS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out["c"][name] = _comp_leg_c(d, name, batch, start_ckpt)
    return out


def _scales_within(got: list, want: list, rank: int, n: int, rtol: float) -> float:
    """The largest relative distance of a rank's quantization-point maxima
    from the single-device step's (a column-parallel kernel's are its
    rank's output channels'); raises where the points differ."""
    if [a for a, _ in got] != [b for b, _ in want]:
        raise AssertionError("the quantization points differ from the single-device step's")
    worst = 0.0
    for (_, x), (_, y) in zip(got, want):
        y = y if x.numel() == y.numel() else y.chunk(n)[rank]
        worst = max(worst, float(((x - y).abs() / y.abs().clamp_min(1e-30)).max()))
    return worst


def completion_phase(dev, gen, par_batch: int) -> dict:
    """Phase ``completion``: what the last slice ported. Leg a trains the
    mini ``--rtl_qat --residual --act_dtype bfloat16`` recipe 2 x 20 steps
    through the datagen kernel, holds one step on the card against the same
    step on the CPU, and an e4m3fn QAT forward's NaN pattern on the card
    against the CPU's; leg b trains the mini default under gspmd ``sp = 2``
    on two ranks sharing the card and holds one step against the
    single-process step; leg c takes the full U-Net at full width under
    gspmd tp2 and sp2 with ``--quant_bits 8 16``, tp2 and sp2 with
    ``--fused_decoder`` and dp2 with ``--quant_bits 8 16`` from phase
    ``parallel``'s warmed-up checkpoint and holds each against the
    single-device step; leg d takes the packed step at batch 65,536, p = 4
    and 2, two chunks of 32 each, holds one packed step against the module
    step on the same batch and times both beside the flat step. Returns the
    phase line's fields."""
    import gc

    from ofdmgan_tpu_torch.config import Config
    from ofdmgan_tpu_torch.models import MiniGenerator
    from ofdmgan_tpu_torch.models.flat import make_flat_step
    from ofdmgan_tpu_torch.ops import datagen_kernel as dk
    from ofdmgan_tpu_torch.ops import packed_step as ps
    from ofdmgan_tpu_torch.parallel import distributed
    from ofdmgan_tpu_torch.signal import datagen as sdg
    from ofdmgan_tpu_torch.training.schedules import make_adam
    from ofdmgan_tpu_torch.training.trainer import Trainer, build_models
    from ofdmgan_tpu_torch.training.wgan_gp import LossConfig, TrainStep
    d = "build/chip_smoke/completion"
    out, failed = {}, []
    launches = dict.fromkeys(KERNELS, 0)

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    # ---- leg a: rtl_qat with bf16 storage
    t = time.time()
    base = Config(checkpoint_dir=f"{d}/a/checkpoints", log_dir=f"{d}/a/logs",
                  export_after_training=False)
    cfg = dataclasses.replace(base, generator=dataclasses.replace(base.generator,
                                                                  input_residual=True))
    g, dd = build_models(cfg, "mini", seed=0, act_dtype="bfloat16", qat=True, rtl_faithful=True)
    trainer = Trainer(cfg, samples_per_epoch=COMP_STEPS * MAIN_B, val_samples=256, seed=0,
                      device=dev, generator=g, discriminator=dd, act_dtype="bfloat16")
    a = trained(trainer, "completion_rtl_qat_bf16",
                {"datagen": "kernel", "critic": "plain", "generator": "plain",
                 "forward": "plain"},
                {"datagen": 2 * COMP_STEPS, "critic_grad": 0, "generator_grad": 0,
                 "generator_forward": 0})
    add(a["launches"])
    cpu = torch.device("cpu")
    cpu_gen = torch.Generator().manual_seed(41)
    batch = sdg.synthetic_batch_from_draws(sdg.make_draws(cpu_gen, MAIN_B, 16), trainer.dg_cfg)
    alphas = [torch.rand(MAIN_B, generator=cpu_gen) for _ in range(5)]
    on_card = clone_step(trainer, False, act_dtype="bfloat16")
    on_cpu = clone_step(trainer, False, device=cpu, act_dtype="bfloat16")
    start = {n: p.detach().cpu().clone() for n, p in all_params(on_cpu).items()}
    _deterministic(lambda: on_card.run({k: v.to(dev) for k, v in batch.items()},
                                       [x.to(dev) for x in alphas]))
    on_cpu.run(batch, alphas)
    lr = trainer.config.training.lr_generator
    got, ref = _cpu_params(on_card), _cpu_params(on_cpu)
    worst_param = max(float((got[n] - ref[n]).abs().max()) for n in ref)
    worst_norm = max(float((got[n] - ref[n]).norm() / (ref[n] - start[n]).norm().clamp_min(1e-30))
                     for n in ref)
    a["step_vs_cpu"] = {"param_max_abs_diff": worst_param, "param_limit": COMP_PARAM_LR * lr,
                        "update_norm_rel_diff": worst_norm, "norm_limit": COMP_NORM_RTOL}
    if not (worst_param <= COMP_PARAM_LR * lr and worst_norm <= COMP_NORM_RTOL):
        failed.append(f"leg a: the rtl_qat bf16 step on the card lies {worst_param:.3e} "
                      f"(limit {COMP_PARAM_LR * lr:.1e}) and {worst_norm:.3e} of an update's "
                      f"norm (limit {COMP_NORM_RTOL}) from the CPU's")
    # the e4m3fn QAT forward: NaN where the reference's is (everywhere under
    # qat, nowhere under rtl_faithful alone), on the card as on the CPU
    x = (torch.randn(MAIN_B, 16, 2, generator=cpu_gen) * 0.5).to(torch.float8_e4m3fn)
    nan_patterns = {}
    for mode, kw in (("qat", dict(qat=True)), ("rtl", dict(rtl_faithful=True))):
        m = MiniGenerator(act_dtype="float8_e4m3fn", input_residual=True, **kw)
        m.load_state_dict(trainer.generator.state_dict())
        with torch.no_grad():
            y_cpu = m(x)
            y_card = m.to(dev)(x.to(dev)).cpu()
        same = torch.equal(torch.isnan(y_card), torch.isnan(y_cpu))
        nan_patterns[mode] = {"nan_share": float(torch.isnan(y_cpu).float().mean()),
                              "same_on_card": same}
        want_all = mode == "qat"
        if not same or bool(torch.isnan(y_cpu).all()) != want_all \
                or bool(torch.isnan(y_cpu).any()) != want_all:
            failed.append(f"leg a: the e4m3fn {mode} forward's NaN pattern: {nan_patterns[mode]}")
    a["e4m3fn"] = nan_patterns
    a["leg_s"] = time.time() - t
    out["a"] = a
    del trainer, on_card, on_cpu
    gc.collect()
    torch.cuda.empty_cache()

    # ---- leg c's single-device references, from phase parallel's warmed-up
    # checkpoint: the compared step (deterministic cuDNN) and its timing; the
    # quantized reference's maxima on the global batch, the fused one's
    # TF32 control
    t = time.time()
    start_ckpt = "build/chip_smoke/parallel/gan_start"
    refs = {}
    for kind in ("quant", "fused"):
        kw = dict(quant_bits=(8, 16)) if kind == "quant" else dict(fused_decoder=True)
        trainer = _full_trainer(f"{d}/ref_{kind}", par_batch, False, dev, **kw)
        trainer.load_checkpoint(start_ckpt)
        ref = {"start": _cpu_params(trainer)}
        if kind == "quant":
            seen = []

            def record(m, name, seen=seen):
                seen.append((name, m.detach().reshape(-1).cpu().clone()))
                return m

            batch0, _, _ = trainer.step.draw(torch.Generator(device=dev).manual_seed(PAR_SEED))
            with torch.no_grad():
                trainer.generator(batch0["noisy"], amax=record)
            ref["scales"] = seen
        _counts_reset()
        m = _deterministic(lambda: trainer.step(torch.Generator(device=dev).manual_seed(PAR_SEED)))
        add(_counts())
        ref.update(params=_cpu_params(trainer), moments=_cpu_moments(trainer),
                   metrics={k: float(v) for k, v in m.items()})
        if kind == "fused":
            # how far a change of summation order alone moves the fused
            # step: the same step with cuDNN's default algorithms
            trainer.load_checkpoint(start_ckpt)
            trainer.step(torch.Generator(device=dev).manual_seed(PAR_SEED))
            torch.cuda.synchronize()
            ref["default_cudnn"] = worst_update(ref["start"], _cpu_params(trainer),
                                                ref["params"], _cpu_moments(trainer),
                                                ref["moments"])
            trainer.load_checkpoint(start_ckpt)
            trainer.step.matmul_precision = "tensorfloat32"
            _deterministic(lambda: trainer.step(
                torch.Generator(device=dev).manual_seed(PAR_SEED)))
            trainer.step.matmul_precision = "float32"
            ref["tf32"] = worst_update(ref["start"], _cpu_params(trainer), ref["params"],
                                       _cpu_moments(trainer), ref["moments"])
        trainer.step(trainer.rng)   # untimed
        ms, peak = timed_steps(trainer.step, trainer.rng, n=COMP_TIMED_STEPS, warmup=0)
        ref["timed"] = {"ms_per_step": ms, "peak_memory_gb": peak / 1e9}
        refs[kind] = ref
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    out["ref_s"] = time.time() - t

    # ---- legs b and c on two ranks sharing the card
    t = time.time()
    ranks = distributed.launch(completion_rank_gloo, 2, (d, par_batch, start_ckpt),
                               device="cuda:0", backend="gloo", timeout_s=PAR_TIMEOUT_S)
    out["bc_s"] = time.time() - t
    b = [r["b"] for r in ranks]
    for r, leg in enumerate(b):
        add(leg["launches"])
        if not leg["same_on_every_rank"] \
                or leg["routes"] != {"datagen": "kernel", "critic": "plain", "generator": "plain",
                                     "forward": "plain"} \
                or leg["launches"]["datagen"] != PAR_MINI_STEPS + 1 \
                or not leg["update_max_rel_diff"] <= STEP_RTOL:
            failed.append(f"leg b, rank {r}: same {leg['same_on_every_rank']}, routes "
                          f"{leg['routes']}, launches {leg['launches']}, "
                          f"{leg['update_max_rel_diff']:.3e} of a largest update from the "
                          f"single-process step (limit {STEP_RTOL})")
    out["b"] = {"ranks": b}
    out["c"] = {"batch": par_batch, "fused_default_cudnn": refs["fused"]["default_cudnn"]}
    for name in COMP_LAYOUTS:
        legs = [r["c"][name] for r in ranks]
        kind = _full_kind(name)
        ref = refs[kind]
        for leg in legs:
            add(leg["launches"])
        if not all(leg["same_on_every_rank"] for leg in legs) or \
                not all(leg["launches"]["datagen"] > 0 for leg in legs):
            failed.append(f"leg c {name}: ranks equal {[x['same_on_every_rank'] for x in legs]}, "
                          f"launches {[x['launches'] for x in legs]}")
        diff, rel = updates_agree(ref["start"], legs[0]["params"], ref["params"], None, "")
        metric_rel = {k: abs(legs[0]["metrics"][k] - v) / max(abs(v), 1e-12)
                      for k, v in ref["metrics"].items()}
        if not all(v <= PAR_METRIC_RTOL for v in metric_rel.values()):
            failed.append(f"leg c {name}: metrics {legs[0]['metrics']} against the single-device "
                          f"step's {ref['metrics']} (rtol {PAR_METRIC_RTOL})")
        entry = {"update_max_abs_diff": diff, "update_max_rel_diff": rel,
                 "metric_max_rel_diff": max(metric_rel.values()),
                 "worst": worst_update(ref["start"], legs[0]["params"], ref["params"],
                                       legs[0]["moments"], ref["moments"])}
        if kind == "fused":
            if not rel <= PAR_STEP_RTOL["gan"]:
                failed.append(f"leg c {name}: {rel:.3e} of a largest update from the "
                              f"single-device fused step (limit {PAR_STEP_RTOL['gan']})")
        else:
            n = legs[0]["mesh"].get("tp", 1)
            entry["scale_max_rel_diff"] = [_scales_within(leg["scales"], ref["scales"], r, n,
                                                          COMP_SCALE_RTOL)
                                           for r, leg in enumerate(legs)]
            if not all(v <= COMP_SCALE_RTOL for v in entry["scale_max_rel_diff"]):
                failed.append(f"leg c {name}: quantization-point maxima "
                              f"{entry['scale_max_rel_diff']} from the single-device step's "
                              f"(limit {COMP_SCALE_RTOL:.3e})")
        for leg in legs:
            for k in ("params", "moments", "scales"):
                leg.pop(k)
        entry["ranks"] = legs
        entry["single_device_timed"] = ref["timed"]
        out["c"][name] = entry
    out["c"]["tf32_control"] = refs["fused"]["tf32"]
    if not refs["fused"]["tf32"]["rel"] > PAR_STEP_RTOL["gan"]:
        failed.append(f"the fused step at TF32 lies within the gate "
                      f"({refs['fused']['tf32']['rel']:.3e})")

    # ---- leg d: the packed step at the reference bench's width
    t = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = Config()
    g0, d0 = build_models(cfg, "mini", seed=0)
    dg_cfg, loss_cfg = sdg.DatagenConfig(frame_length=16), LossConfig()

    def pair():
        gg, cc = copy.deepcopy(g0).to(dev), copy.deepcopy(d0).to(dev)
        return (gg, cc, make_adam(gg.parameters(), 2e-4, (0.0, 0.9)),
                make_adam(cc.parameters(), 2e-4, (0.0, 0.9)))

    _counts_reset()
    packed = {}
    for p in PACKED_PS:
        gg, cc, og, oc = pair()
        step = ps.PackedTrainStep(gg, cc, og, oc, dg_cfg, loss_cfg, PACKED_B, p=p,
                                  scan_steps=PACKED_SCAN, matmul_precision="float32")
        rng = torch.Generator(device=dev).manual_seed(5)
        t0 = time.perf_counter()
        step(rng)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        m = step(rng)
        torch.cuda.synchronize()
        packed[p] = {"ms_per_step": (time.perf_counter() - t0) / PACKED_SCAN * 1e3,
                     "first_chunk_ms_per_step": first / PACKED_SCAN * 1e3,
                     "metrics": {k: float(v) for k, v in m.items()},
                     "route": step.datagen_route}
        # from the state two chunks left: one packed step and one module step
        # on the same batch (the packed batch's [B, L, 2] view) and uniforms
        mod = TrainStep(copy.deepcopy(gg), copy.deepcopy(cc), None, None, dg_cfg, loss_cfg,
                        PACKED_B)
        mod.set_optimizers(*(make_adam(m_.parameters(), 2e-4, (0.0, 0.9))
                             for m_ in (mod.generator, mod.critic)))
        for new, old in ((mod.opt_g, og), (mod.opt_d, oc)):
            new.load_state_dict(*copy.deepcopy(old.state_dict()))
        start = {n: q.detach().clone() for n, q in all_params(mod).items()}
        batch0, alphas = step.draw(rng)
        step.run(batch0, alphas)
        _deterministic(lambda: mod.run({k: v.view(PACKED_B, 16, 2) for k, v in batch0.items()
                                        if k in ("noisy", "clean")}, alphas))
        try:
            packed[p]["update_max_abs_diff"], packed[p]["update_max_rel_diff"] = updates_agree(
                start, all_params(step), all_params(mod), STEP_RTOL,
                f"the packed (p = {p}) and module steps")
        except AssertionError as e:
            failed.append(str(e))
        del step, mod
    want = len(PACKED_PS) * (2 * PACKED_SCAN + 1)
    if dk.launches != want:
        failed.append(f"leg d: {dk.launches} datagen launches, not {want}")
    # the flat and module steps at the same batch, in this process
    times = {}
    for name in ("flat", "module"):
        gg, cc, og, oc = pair()
        flat = make_flat_step(gg, cc, 16) if name == "flat" else None
        step = TrainStep(gg, cc, og, oc, dg_cfg, loss_cfg, PACKED_B, flat=flat)
        rng = torch.Generator(device=dev).manual_seed(6)
        ms, _ = timed_steps(step, rng, n=PACKED_TIMED_STEPS, warmup=2)
        times[name] = {"ms_per_step": ms, "routes": (step.datagen_route, step.critic_route)}
    add(_counts())
    out["d"] = {"packed": packed, "others": times,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                "leg_s": time.time() - t}
    out["launches"] = launches
    if failed:
        print(json.dumps({"phase": "completion", "failed_gates": failed, **out}, default=str),
              flush=True)
        raise AssertionError("; ".join(failed))
    return out


def _bench_copy(b, act_dtype, flat_params: bool):
    """The bench's mini pair and per-parameter Adam states copied into new
    modules with storage ``act_dtype``, and their optimizers: per parameter,
    or with ``flat_params`` one flat tensor a net holding the same state."""
    from ofdmgan_tpu_torch.config import Config
    from ofdmgan_tpu_torch.models.flat import flat_adam_state, flatten_parameters
    from ofdmgan_tpu_torch.training.schedules import make_adam
    from ofdmgan_tpu_torch.training.trainer import build_models
    g, d = (m.to(b.dev) for m in build_models(Config(), "mini", 0, act_dtype))
    opts = []
    for mod, src, src_opt in ((g, b.generator, b.opt_g), (d, b.critic, b.opt_d)):
        mod.load_state_dict(src.state_dict())
        opt = make_adam(mod.parameters(), 2e-4)
        opt.load_state_dict(*copy.deepcopy(src_opt.state_dict()))
        if flat_params:
            t = flatten_parameters(mod)
            flat_opt = make_adam([t], 2e-4)
            flat_opt.opt.state[t] = flat_adam_state(opt, mod)
            opt = flat_opt
        opts.append(opt)
    return g, d, opts


class _KeepGrads:
    """An optimizer's stand-in for ``TrainStep``: its update leaves the
    parameters as they are, with the gradients on them."""

    def step(self) -> None:
        pass


def _critic_grads(step, batch, alpha) -> dict:
    """The gradients of one critic update of ``step`` (its route, its
    numerics, the batch cast to its storage format as ``run`` casts it) on
    ``batch`` and ``alpha``, by name; the parameters are left as they are."""
    from ofdmgan_tpu_torch.training.wgan_gp import matmul_precision
    if step.act_dtype is not None:
        batch = {k: v.to(step.act_dtype) for k, v in batch.items()}
    opt, step.opt_d = step.opt_d, _KeepGrads()
    try:
        with matmul_precision(step.matmul_precision):
            step.critic_update(batch, alpha)
    finally:
        step.opt_d = opt
    grads = {n: p.grad.detach().clone() for n, p in step.critic.named_parameters()}
    for p in step.critic.parameters():
        p.grad = None
    return grads


def _critic_grads_float64(step, batch, alpha) -> dict:
    """The float64 witness of ``_critic_grads`` for a step at float32
    numerics: the critic loss's gradient of a float64 copy of ``step``'s
    critic module (its convolutions, not the flat step's dense matrices) on
    the batch and the step's own fake frames, each cast to float64."""
    from ofdmgan_tpu_torch.training.wgan_gp import critic_loss_fn, matmul_precision
    critic = copy.deepcopy(step.critic).double()
    with torch.no_grad(), matmul_precision(step.matmul_precision):
        fake = step.forward(batch["noisy"]).double()
    loss, _ = critic_loss_fn(critic, lambda noisy: fake,
                             {k: v.double() for k, v in batch.items()}, alpha.double(),
                             step.loss_cfg)
    grads = torch.autograd.grad(loss, list(critic.parameters()))
    return {n: g for (n, _), g in zip(critic.named_parameters(), grads)}


def _grads_norm_rel(a: dict, b: dict) -> float:
    """The norm of the difference over the norm of ``b``, over all tensors."""
    num = sum(float((a[k].double() - b[k].double()).square().sum()) for k in b)
    den = sum(float(b[k].double().square().sum()) for k in b)
    return (num / max(den, 1e-300)) ** 0.5


def _bench_gates(b) -> dict:
    """From the headline leg's warmed state, on one batch and one set of
    penalty uniforms, at the bench's numerics and at float32 (flat,
    premapped, ``mm`` ambient, both routes plain, so that the fused critic
    is the one differentiated): the plain bench step (per parameter,
    unfused), the ``--fuse_realfake`` step, the ``--flat_params`` step and,
    as controls, the plain step on the same frames and uniforms in three
    other orders (BENCH_ORDERS: the same function, its batch sums taken in
    other orders). Each one's first critic gradient against the plain
    step's, by the largest difference over each tensor's largest entry
    (``_critic_grad``) and by the norm of the difference over the
    gradient's norm (``_critic_grad_norm``), and its update against the
    plain step's; at float32 each critic gradient also against its float64
    witness (``_critic_grads_float64``). Gated (``limits`` in the result):
    the fused critic gradient at float32 within BENCH_GATE_RTOL of the
    plain one's and within BENCH_FUSED_FACTOR times the largest distance of
    the plain and the control gradients from the witness; at the bench's
    numerics, by norm, within BENCH_FUSED_FACTOR times the controls'
    largest; the flat-parameter update at both numerics within
    BENCH_GATE_RTOL."""
    from ofdmgan_tpu_torch.models.flat import make_flat_step
    from ofdmgan_tpu_torch.signal.datagen import DatagenConfig
    from ofdmgan_tpu_torch.training.wgan_gp import LossConfig, TrainStep
    out = {}
    for numerics, act, mm, precision in (("bench", "bfloat16", "tf32x3_gp", "bf16_tf32gp"),
                                         ("float32", None, "ambient", "float32")):
        batch = alphas = start = witness = None
        updates, grads = {}, {}
        for variant in ("plain", *BENCH_ORDERS, "fuse_realfake", "flat_params"):
            g, d, (opt_g, opt_d) = _bench_copy(b, act, variant == "flat_params")
            step = TrainStep(g, d, opt_g, opt_d, DatagenConfig(), LossConfig(), b.batch,
                             reference=numerics == "float32", act_dtype=act,
                             matmul_precision=precision,
                             flat=make_flat_step(g, d, 16, act, mm, premap=True),
                             fuse_realfake=variant == "fuse_realfake",
                             flat_params=variant == "flat_params")
            if batch is None:
                batch, alphas, _ = step.draw(torch.Generator(device=b.dev).manual_seed(77))
                start = {n: p.detach().clone() for n, p in all_params(step).items()}
                if numerics == "float32":
                    witness = _critic_grads_float64(step, batch, alphas[0])
            run_batch, run_alphas = batch, alphas
            if variant in BENCH_ORDERS:
                order = BENCH_ORDERS[variant](b.batch, b.dev)
                run_batch = {k: v[order] for k, v in batch.items()}
                run_alphas = [a[order] for a in alphas]
            if variant != "flat_params":
                grads[variant] = _critic_grads(step, run_batch, run_alphas[0])
            step.run(run_batch, run_alphas)
            updates[variant] = {n: p.detach().clone() for n, p in all_params(step).items()}
        for variant in (*BENCH_ORDERS, "fuse_realfake"):
            out[f"{variant}_{numerics}_critic_grad"] = _grads_rel(grads[variant],
                                                                  grads["plain"])
            out[f"{variant}_{numerics}_critic_grad_norm"] = _grads_norm_rel(grads[variant],
                                                                            grads["plain"])
        if witness is not None:
            for variant in ("plain", *BENCH_ORDERS, "fuse_realfake"):
                out[f"{variant}_{numerics}_critic_grad_vs_float64"] = _grads_rel(
                    {k: v.double() for k, v in grads[variant].items()}, witness)
        for variant in (*BENCH_ORDERS, "fuse_realfake", "flat_params"):
            out[f"{variant}_{numerics}"] = updates_agree(start, updates[variant],
                                                         updates["plain"], None, "")[1]
    limits = {
        "fuse_realfake_float32_critic_grad": BENCH_GATE_RTOL,
        "fuse_realfake_float32_critic_grad_vs_float64": BENCH_FUSED_FACTOR * max(
            out[f"{v}_float32_critic_grad_vs_float64"] for v in ("plain", *BENCH_ORDERS)),
        "fuse_realfake_bench_critic_grad_norm": BENCH_FUSED_FACTOR * max(
            out[f"{v}_bench_critic_grad_norm"] for v in BENCH_ORDERS),
        "flat_params_float32": BENCH_GATE_RTOL,
        "flat_params_bench": BENCH_GATE_RTOL,
    }
    out["limits"] = limits
    failed = {k: (out[k], lim) for k, lim in limits.items() if not out[k] <= lim}
    if failed:
        raise AssertionError(f"bench steps beyond their limits (reading, limit): {failed} "
                             f"(readings {out})")
    return out


def _bench_storage_gate(b) -> dict:
    """From the ``kernels_bf16`` leg's trained state, on one draw of its
    step: the first critic gradient through the kernel (the batch stored in
    bf16, the generator's float32 output, the step's penalty uniforms)
    against the kernel's plain version on the same tensors, within
    BENCH_GATE_RTOL of each tensor's largest entry; and the uniforms on the
    bf16 grid k/128, every value taken (the reference's bf16 draws)."""
    from ofdmgan_tpu_torch.ops import critic_kernel as ck
    from ofdmgan_tpu_torch.training.wgan_gp import matmul_precision
    step = b.step
    batch, alphas, _ = step.draw(torch.Generator(device=b.dev).manual_seed(77))
    k = alphas[0] * 128
    on_grid = bool((k == k.round()).all()) and len(torch.unique(k)) == 128
    grads = _critic_grads(step, batch, alphas[0])
    stored = {n: v.to(step.act_dtype) for n, v in batch.items()}
    with torch.no_grad(), matmul_precision(step.matmul_precision):
        fake = step.forward(stored["noisy"])
    ref, _ = ck.critic_grad_packed(step.critic, stored["clean"], fake, stored["noisy"],
                                   alphas[0], step.loss_cfg.gp_weight, step.critic.leaky_slope)
    out = {"critic_grad": _grads_rel(grads, ref), "alpha_on_bf16_grid": on_grid,
           "limit": BENCH_GATE_RTOL}
    if not (out["critic_grad"] <= BENCH_GATE_RTOL and on_grid):
        raise AssertionError(f"the bf16-storage kernel leg's critic gradient or uniforms: {out}")
    return out


def bench_phase(dev) -> dict:
    """Phase ``bench``: ``ofdmgan_tpu_torch.bench`` in each of BENCH_LEGS
    and ``bench_full_train`` on BENCH_GRID, in this process, through their
    entry points; each line checked, each leg's launches counted, and the
    gates of ``_bench_gates`` and ``_bench_storage_gate``. Returns the phase
    line's fields."""
    import gc

    from ofdmgan_tpu_torch import bench, bench_full_train
    from ofdmgan_tpu_torch.device import card_name
    d = "build/chip_smoke/bench"
    card = card_name(dev)
    out = {"legs": {}, "launches": dict.fromkeys(KERNELS, 0)}
    for name, flags in BENCH_LEGS.items():
        t = time.time()
        leg_windows = BENCH_LEG_WINDOWS.get(name, BENCH_WINDOWS)
        ap = bench.build_parser()
        args = ap.parse_args(["--device", str(dev), "--scan_steps", str(BENCH_SCAN),
                              "--watchdog", "0", *flags])
        bench.check_args(ap, args)
        b = bench.Bench(args)
        replays = [0]
        if b.graphed:
            replay = b.chunk.replay

            def counting(replay=replay):
                replays[0] += 1
                return replay()

            b.chunk.replay = counting
        _counts_reset()
        line = json.loads(json.dumps(b.run(card, *leg_windows)))   # the line as it prints
        torch.cuda.synchronize()
        wrapped = _counts()
        # every replay replays the one captured graph: the launches of one
        # more replay, counted from its trace, are those of each
        per_replay = dict.fromkeys(KERNELS, 0)
        if b.graphed:
            del b.chunk.replay
            _, per_replay = traced_replay(b, b.chunk.replay)
        launches = {k: wrapped[k] + replays[0] * per_replay[k] for k in wrapped}
        steps = args.scan_steps * sum(leg_windows)
        kernel_critic = "--pallas_critic" in flags
        # the others store activations in bf16, or pack: the generator kernels'
        # routes only at float32 with no storage format
        kernel_gen = name == "kernels"
        want = {"datagen": steps, "critic_grad": steps * 5 if kernel_critic else 0,
                "generator_grad": steps if kernel_gen else 0,
                "generator_forward": steps if kernel_gen else 0}
        want_routes = {"datagen": "kernel", "critic": "kernel" if kernel_critic else "plain",
                       "generator": "kernel" if kernel_gen else "plain",
                       "forward": "kernel" if kernel_gen else "plain"}
        # the packed step's critic and generator are autograd: it has no such routes
        routes = {"datagen": line["datagen_route"], "critic": line["critic_route"],
                  "generator": _routes(b.step)["generator"],
                  "forward": _routes(b.step)["forward"]}
        if routes != want_routes or launches != want:
            raise AssertionError(f"bench leg {name} took {routes} and launched {launches} "
                                 f"({replays[0]} replays of {per_replay}), not {want_routes} "
                                 f"and {want}")
        if (line.get("metric") != bench.METRIC or line.get("unit") != bench.UNIT
                or line.get("device") != card or "vs_baseline" in line
                or not (math.isfinite(line["value"]) and line["value"] > 0)):
            raise AssertionError(f"bench leg {name} printed {line}")
        for k in launches:
            out["launches"][k] += launches[k]
        out["legs"][name] = {"value": line["value"], "windows_fps": line["windows_fps"],
                             "ms_per_step": args.batch / line["value"] * 1e3,
                             "chunk": line["chunk"], "chunks_per_window": line["chunks_per_window"],
                             "graphed": line["graphed"], "launches": launches,
                             "replays": replays[0], "per_replay": per_replay,
                             "seconds": round(time.time() - t, 3)}
        if name == "headline":
            t = time.time()
            out["gates"] = _bench_gates(b)
            out["gates"]["seconds"] = round(time.time() - t, 3)
        if name == "kernels_bf16":
            t = time.time()
            out["storage_gate"] = _bench_storage_gate(b)
            out["storage_gate"]["seconds"] = round(time.time() - t, 3)
        del b
        gc.collect()
        torch.cuda.empty_cache()
    t = time.time()
    _counts_reset()
    grid = bench_full_train.main(["--device", str(dev), "--configs", *BENCH_GRID,
                                  "--scan_steps", str(BENCH_GRID_SCAN),
                                  "--windows", str(BENCH_GRID_WINDOWS),
                                  "--out", f"{d}/full_train_speed.json"])
    launches = _counts()
    want = {"datagen": len(BENCH_GRID) * BENCH_GRID_SCAN
            * (bench_full_train.WARMUP_WINDOWS + BENCH_GRID_WINDOWS), "critic_grad": 0,
            "generator_grad": 0, "generator_forward": 0}
    if launches != want or list(grid["rows"]) != list(BENCH_GRID) or grid["device"] != card:
        raise AssertionError(f"bench_full_train launched {launches} (not {want}), rows "
                             f"{list(grid['rows'])}, device {grid['device']}")
    for row, r in grid["rows"].items():
        if not (math.isfinite(r["frames_per_sec"]) and r["frames_per_sec"] > 0):
            raise AssertionError(f"bench_full_train row {row}: {r}")
    for k in launches:
        out["launches"][k] += launches[k]
    out["grid"] = {"rows": {k: {"ms_per_step": r["ms_per_step"],
                                "frames_per_sec": r["frames_per_sec"],
                                "windows_fps": r["windows_fps"]} for k, r in grid["rows"].items()},
                   "launches": launches, "seconds": round(time.time() - t, 3)}
    out["device"] = card
    return out


def main() -> int:
    t0 = time.time()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run needs a GPU")
    from ofdmgan_tpu_torch.device import card_name

    card = card_name(torch.device("cuda", 0))
    kind = torch.cuda.get_device_name(0)
    log("device", t0, device=kind, count=torch.cuda.device_count(), nvidia_smi=card,
        torch=torch.__version__, cuda=torch.version.cuda)

    from ofdmgan_tpu_torch.config import Config
    from ofdmgan_tpu_torch.device import resolve_device
    from ofdmgan_tpu_torch.models import MiniDiscriminator, MiniGenerator
    from ofdmgan_tpu_torch.ops import build, critic_kernel as ck, datagen_kernel as dk
    from ofdmgan_tpu_torch.ops import generator_kernel as gk
    from ofdmgan_tpu_torch.signal import datagen as sdg
    from ofdmgan_tpu_torch.signal.impairments import ImpairmentConfig
    from ofdmgan_tpu_torch.training.trainer import Trainer
    from ofdmgan_tpu_torch.training.wgan_gp import (LossConfig, critic_loss_fn,
                                                    generator_loss_fn, matmul_precision)
    from ofdmgan_tpu_torch.utils import profiling
    from ofdmgan_tpu_torch.utils.kernel_checks import (assert_datagen_close,
                                                       assert_forward_close, assert_grads_close,
                                                       assert_metrics_close)
    from ofdmgan_tpu_torch.utils.profiling import device_us_per_call
    from perfbench import counts

    dev = resolve_device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)

    # ---- 1. build
    t = time.time()
    logs = build.build()
    for name, text in logs.items():
        for line in text.splitlines():
            if "ptxas" in line and ("registers" in line or "spill" in line or "Compiling" in line):
                print(f"[{name}] {line.strip()}", flush=True)
    log("build", t, built=[n for n, txt in logs.items() if txt], build_s=round(time.time() - t, 3))

    # ---- 2. the datagen kernel against its plain version at the main
    # path's shapes, both chains (utils/kernel_checks.py's tolerance;
    # tests/test_torch_cuda.py takes every length), and its times
    t = time.time()
    datagen_err = {}   # worst error over both chains, by batch
    for b in (MAIN_B, 1 << 20):
        for nl in (False, True):
            cfg = sdg.DatagenConfig(nonlinear=nl, impairments=ImpairmentConfig(pa_saturation=0.8))
            draws = sdg.make_draws(gen, b, 16)
            got = dk.synthetic_batch_from_draws(draws, cfg)
            ref = dk.synthetic_batch_plain(draws, cfg)
            assert_datagen_close(got, ref, f"datagen B={b} nonlinear={nl}")
            datagen_err[b] = max(datagen_err.get(b, 0.0), max_err(got, ref))
            del draws, got, ref
    dg_times = {}
    for L, b in DATAGEN_TIMED:
        cfg = sdg.DatagenConfig(frame_length=L)
        draws = sdg.make_draws(gen, b, L)
        call = lambda: dk.synthetic_batch(gen, b, cfg)  # noqa: E731
        row = dg_times[f"L{L}_B{b}"] = {
            "ms": time_ms(call), "device_us_per_launch": device_us_per_call(call, "datagen_kernel"),
            "plain_ms": time_ms(lambda: dk.synthetic_batch_plain(draws, cfg)),
            "bound_ms": counts.datagen_bound_ms(b, L)[0],
        }
        if b > MAIN_B:
            seed = torch.randint(0, 2 ** 62, (1,), dtype=torch.int64, generator=gen, device=dev)
            fn, args, _out = dk.prepare(cfg, b, dev, seed, None)
            row["back_to_back_us_per_launch"] = back_to_back_us_per_launch(fn, args)
            del _out
        del draws
    log("datagen", t, max_abs_err=datagen_err, times=dg_times)

    # ---- 3. the critic-gradient kernel against its plain version at the
    # timed batches (one frame a warp, two), float32 and the storage form,
    # and its times beside its plain version's and autograd's
    t = time.time()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(7)
        critic = MiniDiscriminator().to(dev)
        generator = MiniGenerator().to(dev)
    critic_err, cr_times = {"float32": {}, "storage": {}}, {}
    for b in KERNEL_BATCHES:
        clean = torch.randn(b, 16, 2, generator=gen, device=dev)
        noisy = clean + 0.3 * torch.randn(b, 16, 2, generator=gen, device=dev)
        alpha = torch.rand(b, generator=gen, device=dev)
        with torch.no_grad():
            fake = generator(noisy)   # a transposed view, as in the training step
        # the storage form: bf16 clean and noisy, float32 fake and alpha
        forms = {"float32": (clean, noisy), "storage": (clean.bfloat16(), noisy.bfloat16())}
        for form, (c_in, n_in) in forms.items():
            got, aux = ck.critic_grad(critic, c_in, fake, n_in, alpha, 10.0)
            ref, ref_aux = ck.critic_grad_packed(critic, c_in, fake, n_in, alpha, 10.0)
            assert_grads_close(got, ref, f"critic B={b} {form}")
            assert_metrics_close(aux, ref_aux, f"critic B={b} {form}")
            critic_err[form][b] = max_err(got, ref)

        def call(form, fn=ck.critic_grad, bf16=False):
            c_in, n_in = forms[form]
            return lambda: fn(critic, c_in, fake, n_in, alpha, 10.0, bf16=bf16)

        def autograd_step():
            loss, _ = critic_loss_fn(critic, generator, {"noisy": noisy, "clean": clean},
                                     alpha, LossConfig())
            torch.autograd.grad(loss, list(critic.parameters()))

        cr_times[b] = {
            "ms": time_ms(call("float32")),
            "device_us_per_launch": device_us_per_call(call("float32"), "critic_grad"),
            "plain_ms": time_ms(call("float32", ck.critic_grad_packed)),
            "autograd_ms": time_ms(autograd_step),
            "bound_ms": counts.critic_bound_ms(b)[0],
            "bf16_device_us_per_launch": device_us_per_call(call("float32", bf16=True),
                                                            "critic_grad"),
            "storage_ms": time_ms(call("storage")),
            "storage_device_us_per_launch": device_us_per_call(call("storage"), "critic_grad"),
            "storage_bf16_device_us_per_launch": device_us_per_call(call("storage", bf16=True),
                                                                    "critic_grad"),
            "storage_plain_ms": time_ms(call("storage", ck.critic_grad_packed)),
            "storage_bound_ms": critic_storage_bound_ms(b)[0],
        }
        if b > MAIN_B:
            for key, form in (("", "float32"), ("storage_", "storage")):
                fn, args, _out, _scratch = ck.prepare(critic, forms[form][0], fake,
                                                      forms[form][1], alpha, 10.0)
                cr_times[b][f"{key}back_to_back_us_per_launch"] = \
                    back_to_back_us_per_launch(fn, args)
                del _out, _scratch
    # the per-block kernel as built: registers and spills of each
    # instantiation (None where phase 1 found the library built), frames a
    # warp and blocks at the timed batches, resident blocks an SM of each
    # mapping (the variants of its tuning constants: scripts/critic_kernel_sweep.py)
    lib, sms = ck._library(), build.sm_count(dev)
    frames = {b: lib.ofdm_critic_grad_frames_per_warp(b, sms) for b in KERNEL_BATCHES}
    kernel_build = {"ptxas": ck.ptxas_summary(logs.get("critic_grad", "")) or None,
                    "blocks_per_sm": {f: lib.ofdm_critic_grad_blocks_per_sm(f) for f in (1, 2)},
                    "mapping": {b: {"frames_per_warp": f,
                                    "blocks": lib.ofdm_critic_grad_blocks(b, sms, f)}
                                for b, f in frames.items()}}
    log("critic", t, max_abs_err=critic_err, times=cr_times, kernel=kernel_build)

    # ---- 3b. the generator-gradient kernel against its plain version, and
    # its times beside its plain version's and autograd's generator update
    t = time.time()
    loss_cfg = LossConfig()
    weights = (loss_cfg.adv_weight, loss_cfg.rec_weight)
    gen_err, gen_times = {}, {}
    for b in KERNEL_BATCHES:
        clean = torch.randn(b, 16, 2, generator=gen, device=dev)
        noisy = clean + 0.3 * torch.randn(b, 16, 2, generator=gen, device=dev)

        def call(fn=gk.generator_grad):
            return lambda: fn(generator, critic, clean, noisy, *weights)

        def autograd_update():   # the generator update the kernel replaces
            loss, _ = generator_loss_fn(generator, critic, {"noisy": noisy, "clean": clean},
                                        loss_cfg)
            torch.autograd.grad(loss, list(generator.parameters()))

        (got, aux), (ref, ref_aux) = call()(), call(gk.generator_grad_plain)()
        assert_grads_close(got, ref, f"generator B={b}", floor=1e-8)
        assert_metrics_close(aux, ref_aux, f"generator B={b}")
        gen_err[b] = max_err(got, ref)
        bound, bound_by = generator_bound_ms(b)
        row = gen_times[b] = {
            "ms": time_ms(call()),
            "device_us_per_launch": device_us_per_call(call(), "generator_grad"),
            "plain_ms": time_ms(call(gk.generator_grad_plain)),
            "autograd_ms": time_ms(autograd_update), "bound_ms": bound, "bound_by": bound_by}
        row["roofline_pct"] = 100.0 * bound / (row["device_us_per_launch"] / 1e3)
        if b > MAIN_B:
            fn, args, _out, _keep = gk.prepare(generator, critic, clean, noisy, *weights)
            row["back_to_back_us_per_launch"] = back_to_back_us_per_launch(fn, args)
            del _out, _keep
    # the forward kernel (the critic updates' fake) against its plain
    # version, and its times beside its plain version's and cuDNN's forward
    fwd_err, fwd_times = {}, {}
    for b in KERNEL_BATCHES:
        noisy = torch.randn(b, 16, 2, generator=gen, device=dev)
        call = lambda fn=gk.generator_forward: fn(generator, noisy)  # noqa: E731

        def library():   # the module's forward through cuDNN and ATen, TF32 off
            with torch.no_grad(), matmul_precision("float32"):
                return generator(noisy)

        got, ref = call(), gk.generator_forward_plain(generator, noisy)
        assert_forward_close(got, ref, f"generator forward B={b}")
        fwd_err[b] = float((got - ref).abs().max())
        bound, bound_by = gk.forward_bound_ms(b, counts.FP32_FLOPS_PER_S, counts.HBM_BYTES_PER_S)
        row = fwd_times[b] = {
            "ms": time_ms(call),
            "device_us_per_launch": device_us_per_call(call, "generator_forward"),
            "plain_ms": time_ms(lambda: gk.generator_forward_plain(generator, noisy)),
            "library_ms": time_ms(library), "bound_ms": bound, "bound_by": bound_by}
        row["roofline_pct"] = 100.0 * bound / (row["device_us_per_launch"] / 1e3)
        if b > MAIN_B:
            fn, args, _out, _keep = gk.prepare_forward(generator, noisy)
            row["back_to_back_us_per_launch"] = back_to_back_us_per_launch(fn, args)
            del _out, _keep
    log("generator", t, max_abs_err=gen_err, times=gen_times,
        forward={"max_abs_err": fwd_err, "times": fwd_times})

    # ---- 4. train through the four kernels with the config defaults
    t = time.time()
    cfg = Config(checkpoint_dir="build/chip_smoke/checkpoints", log_dir="build/chip_smoke/logs",
                 export_dir="build/chip_smoke/export")
    steps = 20
    trainer = Trainer(cfg, samples_per_epoch=steps * cfg.training.batch_size, val_samples=256,
                      seed=0, device="cuda")
    t_train = time.time()
    with counted_launches(trainer) as counted:
        history = trainer.train(epochs=2, experiment_name="chip_smoke")
        torch.cuda.synchronize()
    train_s = time.time() - t_train
    launches = {k: counted[k] for k in KERNELS}
    want = {"datagen": 2 * steps, "critic_grad": 2 * steps * cfg.training.n_critic,
            "generator_grad": 2 * steps, "generator_forward": 2 * steps}
    if launches != want or not trainer.graphed or counted["replays"] != 1:
        raise AssertionError(f"the training run launched {launches} ({counted['replayed']} in "
                             f"{counted['replays']} replays), not {want}")
    if not all(math.isfinite(v) for rec in history for v in rec.values()) or len(history) != 2:
        raise AssertionError(f"non-finite or missing training metrics: {history}")
    routes = _routes(trainer.step)
    if routes != {"datagen": "kernel", "critic": "kernel", "generator": "kernel",
                  "forward": "kernel"}:
        raise AssertionError(f"the default recipe did not route the four kernels: {routes}")

    # one outer step from the trained state through the kernel path and the
    # plain path (FFT datagen, autograd critic and generator), on the same
    # draws and penalty uniforms; each tensor's update must agree within
    # STEP_RTOL of that update's largest entry
    draws = sdg.make_draws(gen, MAIN_B, 16)
    alphas = [torch.rand(MAIN_B, generator=gen, device=dev) for _ in range(5)]
    step_k, step_p = clone_step(trainer, False), clone_step(trainer, True)
    start = {n: p.detach().clone() for n, p in all_params(step_k).items()}
    m_k = step_k.run(dk.synthetic_batch_from_draws(draws, trainer.dg_cfg), alphas)
    m_p = step_p.run(sdg.synthetic_batch_from_draws(draws, trainer.dg_cfg), alphas)
    step_diff, step_rel = updates_agree(start, all_params(step_k), all_params(step_p),
                                        STEP_RTOL, "kernel and plain steps")
    log("train", t, launches=launches, replayed_launches=counted["replayed"],
        replays=counted["replays"], routes=routes, train_s=round(train_s, 3), history=history,
        step_update_max_abs_diff=step_diff, step_update_max_rel_diff=step_rel,
        step_metrics_kernel={k: float(v) for k, v in m_k.items()},
        step_metrics_plain={k: float(v) for k, v in m_p.items()})

    # ---- 5. configurations outside the datagen kernel's scope
    t = time.time()
    scope = train_scope(dev, gen, steps)
    log("train_scope", t, **scope)

    # ---- 6. the full U-Net family at full width through the datagen kernel
    t = time.time()
    full = full_phase(dev, gen)
    log("full", t, **full)

    # ---- 7. quantization-aware training, the export and the integer datapath
    t = time.time()
    quant = quant_phase(dev, gen, trainer, full["times"])
    log("quant", t, **quant)
    quant_launches = {k: sum(quant[run]["launches"][k] for run in
                             ("qat", "rtl_qat_residual", "full_quant_bits"))
                      for k in KERNELS}

    # ---- 8. evaluation: the sweeps, BER, the report and the CLIs, on the
    # checkpoints of phases train and full; no kernel is on this path
    t = time.time()
    _counts_reset()
    ev = eval_phase(dev, "build/chip_smoke/checkpoints/final_model",
                    "build/chip_smoke/full/checkpoints/final_model")
    eval_launches = _counts()
    if eval_launches != dict.fromkeys(KERNELS, 0):
        raise AssertionError(f"the evaluation path launched {eval_launches}")
    log("eval", t, launches=eval_launches, **ev)

    # ---- 9. hardware verification and the FPGA handoff, on the checkpoints
    # of phases train and quant; selfcheck's training step launches the
    # four kernels
    t = time.time()
    _counts_reset()
    ver = verify_phase(dev, "build/chip_smoke/checkpoints/final_model",
                       "build/chip_smoke/quant/rtl_qat_residual/checkpoints/final_model")
    verify_launches = _counts()
    if not all(verify_launches.values()):
        raise AssertionError(f"the verification path launched {verify_launches}")
    log("verify", t, launches=verify_launches, **ver)

    # ---- 10. serving: the exports, the inference bench, the repaired
    # numerics, --remat and the image study; the datagen kernel feeds the
    # bench's loop and the steps
    t = time.time()
    _counts_reset()
    srv = serve_phase(dev, "build/chip_smoke/checkpoints/final_model",
                      "build/chip_smoke/quant/rtl_qat_residual/checkpoints/final_model",
                      "build/chip_smoke/full/checkpoints/final_model")
    serve_launches = _counts()
    if serve_launches["datagen"] <= 0 or serve_launches["critic_grad"] <= 0:
        raise AssertionError(f"the serving path launched {serve_launches}")
    log("serve", t, launches=serve_launches, **srv)

    # ---- 11. parallelism: the data-parallel step over NCCL (a world of
    # one) and over gloo (two ranks on the card), and the full U-Net under
    # gspmd dp, tp, sp and the pp pipeline; counts are read in each rank
    t = time.time()
    par = parallel_phase(dev)
    log("parallel", t, **par)

    # ---- 12. the TPU layout variants: the flat step, the reference bench's
    # headline flags at full width, and graphed chunks
    t = time.time()
    lay = layout_phase(dev, gen)
    log("layout", t, **lay)

    # ---- 13. what the last slice ported: QAT with a storage format, mini
    # sp, the quantized and fused generators under tp and sp, the packed step
    t = time.time()
    comp = completion_phase(dev, gen, par["batch"]["global"])
    log("completion", t, **comp)

    # ---- 14. the two training benches through their entry points, and the
    # gates of the fused-real/fake and flat-parameter steps
    t = time.time()
    bnc = bench_phase(dev)
    log("bench", t, **bnc)

    # ---- 15. report
    db, dby = counts.datagen_bound_ms(MAIN_B, 16)
    cb, cby = counts.critic_bound_ms(MAIN_B)
    gb, gby = generator_bound_ms(MAIN_B)
    dg_main, cr_main, gn_main = dg_times[f"L16_B{MAIN_B}"], cr_times[MAIN_B], gen_times[MAIN_B]
    fw_main = fwd_times[MAIN_B]
    by_path = {"train": launches, "train_scope": scope["fading"]["launches"],
               "full": full["launches"], "quant": quant_launches, "eval": eval_launches,
               "verify": verify_launches, "serve": serve_launches, "parallel": par["launches"],
               "layout": lay["launches"], "completion": comp["launches"],
               "bench": bnc["launches"]}
    launches_by_path = {k: {path: n[k] for path, n in by_path.items()} for k in KERNELS}
    kernels = [
        {"name": "datagen", "route": "cuda", "source": "ofdmgan_tpu_torch/csrc/datagen.cu",
         "replaces": "ofdmgan_tpu/ops/pallas_datagen.py:200", "launches": launches["datagen"],
         "max_abs_err": datagen_err[MAIN_B], "ms": dg_main["ms"],
         "plain_ms": dg_main["plain_ms"], "bound_ms": db, "bound_by": dby,
         "library_ms": None, "device_us_per_launch": dg_main["device_us_per_launch"],
         "launches_by_path": launches_by_path["datagen"]},
        {"name": "critic_grad", "route": "cuda", "source": "ofdmgan_tpu_torch/csrc/critic_grad.cu",
         "replaces": "ofdmgan_tpu/ops/pallas_critic.py:195", "launches": launches["critic_grad"],
         "max_abs_err": critic_err["float32"][MAIN_B], "ms": cr_main["ms"],
         "plain_ms": cr_main["plain_ms"], "bound_ms": cb, "bound_by": cby,
         "library_ms": None, "device_us_per_launch": cr_main["device_us_per_launch"],
         # the storage form (bf16 clean and noisy), on the bench's kernels_bf16 leg
         "forms": {"storage_bf16": {
             "launches": bnc["legs"]["kernels_bf16"]["launches"]["critic_grad"],
             "max_abs_err": critic_err["storage"][MAIN_B], "ms": cr_main["storage_ms"],
             "plain_ms": cr_main["storage_plain_ms"], "bound_ms": cr_main["storage_bound_ms"],
             "bound_by": critic_storage_bound_ms(MAIN_B)[1],
             "device_us_per_launch": cr_main["storage_device_us_per_launch"]}},
         "launches_by_path": launches_by_path["critic_grad"]},
        # replaces no TPU kernel: the reference's generator update is autograd
        {"name": "generator_grad", "route": "cuda",
         "source": "ofdmgan_tpu_torch/csrc/generator_grad.cu", "replaces": None,
         "launches": launches["generator_grad"], "max_abs_err": gen_err[MAIN_B],
         "ms": gn_main["ms"], "plain_ms": gn_main["plain_ms"],
         "autograd_ms": gn_main["autograd_ms"], "bound_ms": gb, "bound_by": gby,
         "library_ms": None, "device_us_per_launch": gn_main["device_us_per_launch"],
         "launches_by_path": launches_by_path["generator_grad"]},
        # replaces no TPU kernel: the reference's forward is XLA's; its
        # library is the module's forward (cuDNN and ATen)
        {"name": "generator_forward", "route": "cuda",
         "source": "ofdmgan_tpu_torch/csrc/generator_forward.cu", "replaces": None,
         "launches": launches["generator_forward"], "max_abs_err": fwd_err[MAIN_B],
         "ms": fw_main["ms"], "plain_ms": fw_main["plain_ms"], "bound_ms": fw_main["bound_ms"],
         "bound_by": fw_main["bound_by"], "library_ms": fw_main["library_ms"],
         "device_us_per_launch": fw_main["device_us_per_launch"],
         "launches_by_path": launches_by_path["generator_forward"]},
    ]
    log("total", t0, retraced_windows={"timing": profiling.retraces, **RETRACED})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
