// The whole gradient of the mini generator's loss, in conv form, in one
// launch.
//
// Replaces no TPU kernel: the reference's generator update is XLA's autograd
// (ofdmgan_tpu/training/wgan_gp.py, generator_loss_fn and its
// value_and_grad). It was added because on the H100 the port's autograd
// update spent most of the outer step in cuDNN's weight gradients of the
// tiny convolutions (6.59 of 10.6 ms a step at B = 65,536): each is a sum
// over B * L positions into at most 96 numbers, the shape cuDNN's kernels
// are least built for.
//
// For every frame it runs the mini generator's forward
//     enc1 (2->4, s2) -> bottleneck (4->8, s2) -> nearest x2 -> dec1 (8->4)
//     -> + enc1 -> nearest x2 -> out_conv (4->2) -> tanh,
// the mini critic's forward on (fake, noisy) and its gradient with respect
// to fake alone (the critic's own parameter gradients are not needed), and
// the backward of
//     L_G = adv_weight * (-mean D(fake, noisy)) + rec_weight * mean|fake - clean|
// through the generator: the L1 term's cotangent rec_weight / (B L 2) *
// sgn(fake - clean), 0 at a tie as abs's backward; tanh's (1 - y^2); each
// LeakyReLU by the sign of its pre-activation (> 0, else the slope); nearest
// x2 as the sum of each pair; the skip into both branches. It writes the
// gradient of each of the 258 parameters in parameters() order, then the
// metrics g_loss, adv_loss and rec_loss.
//
// What bounds it on the H100: operations. A frame reads 2 * 32 floats and
// needs 8,592 float32 multiply-adds counting only the conv taps inside the
// frame (the generator's forward 1,608, its weight gradient 1,608, its data
// gradient below enc1 1,424, the critic's forward 2,160 and its gradient back
// to fake's 2 channels 1,792).
//
// Design: one warp owns one frame at a time. Each of the generator's four
// layers has exactly 32 outputs a frame (4 x 8, 8 x 4, 4 x 8, 2 x 16), so a
// lane owns one output of each, channel fastest: lane l is channel
// l % C at position l / C, the index of a channels-last [P][C] tile. The
// lane's output of enc1 and of dec1 (and so of the skip) are the same
// (channel, position), and its output of out_conv is the frame's sample
// (l / 2, l % 2), the one it loads; so the skip, the masks and the L1 term
// stay in registers. The data gradient of each layer has 32 entries too and
// falls on the lane that owns the matching forward output. The critic's
// layers have 64 outputs: a lane owns two of each, of one channel, as in
// csrc/critic_grad.cu. The lane keeps its output channels' forward weights
// in registers; the transposed products read the weights from shared
// memory, where a warp's lanes hit distinct banks. Activations and
// cotangents move between lanes through a 2 KB per-warp tile, with
// __syncwarp, never __syncthreads. Every lane keeps 18 sums in registers
// across a grid-stride loop over frames: three taps of one (out, in)
// channel pair of each layer (enc1's and out_conv's 8 pairs split over 4
// lanes each by position), its own cotangent of each layer (the biases),
// its part of the scores and of the L1 sum. A block then adds each layer's
// lanes and its warps in a fixed order into one slot of 264 floats; a
// second kernel, launched on the same stream by the same entry point, sums
// the slots in slot order and writes the gradients and metrics. Every sum
// is in a fixed order, so the result is deterministic for a given B and
// card. float32 FMA on CUDA cores only: no TF32, no tensor cores, no
// atomics.

#include <cuda_runtime.h>

namespace {

constexpr int WPB = 4;                 // warps per block
constexpr int NT = WPB * 32;
constexpr int BLOCKS_PER_SM = 3;
constexpr int SUM_WARPS = 8;           // second stage: warps per block
constexpr int CW1S = 12, CW2S = 25;    // the critic's padded per-output-channel weight strides
// output buffer, in parameters() order, then the metrics
constexpr int OUT_W1 = 0, OUT_B1 = 24, OUT_W2 = 28, OUT_B2 = 124, OUT_W3 = 132, OUT_B3 = 228,
              OUT_W4 = 232, OUT_B4 = 256, OUT_SUMS = 258, N_OUT = 261, SLOT = 264;
// per-warp tile, in floats; every array channels-last [position][channel]
constexpr int T_X = 0,   // noisy [16][2]
    T_A1 = 32,           // enc1 activations [8][4]
    T_A2 = 64,           // bottleneck activations [4][8]
    T_S = 96,            // skip = dec1 + enc1 activations [8][4]
    T_H = 128,           // the critic's input (fake, noisy) [16][4]
    T_C1 = 192,          // the critic's layer-1 activations [8][8]
    T_E2 = 256,          // m2 * w, the critic's layer-2 cotangent of a unit score [4][16]
    T_E1 = 320,          // m1 * (e2 W2^T) [8][8]
    T_D4 = 384,          // out_conv's pre-activation cotangent [16][2]
    T_D3 = 416,          // dec1's [8][4]
    T_D2 = 448,          // bottleneck's [4][8]
    T_D1 = 480,          // enc1's [8][4]
    TILE = 512;
static_assert(SLOT <= TILE, "the block reduction reuses the tiles");
constexpr unsigned FULL = 0xffffffffu;

struct Frames {
  const float* p;
  long long sb, st, sc;  // element strides of batch, time, component
};

// what both stages read
struct Args {
  int B, nblocks;
  float gslope, cslope;        // LeakyReLU slopes of the generator and the critic
  float adv_weight, rec_weight;
  float ds, rc;                // -adv_weight / B and rec_weight / (32 B)
  float inv_b, inv_n;          // 1 / B and 1 / (32 B)
  Frames clean, noisy;
  const float *w1, *b1, *w2, *b2, *w3, *b3, *w4, *b4;  // the generator's parameters
  const float *cw1, *cb1, *cw2, *cb2, *cwd, *cbd;      // the critic's
  float *slots, *out;  // slots: [nblocks][SLOT]
};

__device__ __forceinline__ float mask(float z, float slope) { return z > 0.0f ? 1.0f : slope; }

__device__ __forceinline__ float load(const Frames& fr, int f, int t, int c) {
  return fr.p[f * fr.sb + t * fr.st + c * fr.sc];
}

// sum over the lanes that share l's bits outside `keep` (a low mask), by xor
// shuffles from `keep + 1` up: a fixed order
__device__ __forceinline__ float lanes_sum(float v, int from) {
  for (int o = from; o < 32; o <<= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// the critic's layer 1 at output (t, o), without bias, from the lane's
// weights w[3i + k] = conv1.weight[o][i][k]; x is [16][4]
__device__ __forceinline__ float critic_conv1(const float* x, const float (&w)[12], int t) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int p = 2 * t - 1 + k;
    if (p < 0) continue;
    const float4 v = *reinterpret_cast<const float4*>(x + p * 4);
    acc = fmaf(w[k], v.x, acc);
    acc = fmaf(w[3 + k], v.y, acc);
    acc = fmaf(w[6 + k], v.z, acc);
    acc = fmaf(w[9 + k], v.w, acc);
  }
  return acc;
}

// the critic's layer 2 at output (t, o), without bias, from
// w[3i + k] = conv2.weight[o][i][k]; x is [8][8]
__device__ __forceinline__ float critic_conv2(const float* x, const float (&w)[24], int t) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int q = 2 * t - 1 + k;
    if (q < 0) continue;
    const float4 a = *reinterpret_cast<const float4*>(x + q * 8);
    const float4 b = *reinterpret_cast<const float4*>(x + q * 8 + 4);
    acc = fmaf(w[k], a.x, acc);
    acc = fmaf(w[3 + k], a.y, acc);
    acc = fmaf(w[6 + k], a.z, acc);
    acc = fmaf(w[9 + k], a.w, acc);
    acc = fmaf(w[12 + k], b.x, acc);
    acc = fmaf(w[15 + k], b.y, acc);
    acc = fmaf(w[18 + k], b.z, acc);
    acc = fmaf(w[21 + k], b.w, acc);
  }
  return acc;
}

// the critic's transposed layer 2 at input (q, i) of a [4][16] cotangent
__device__ __forceinline__ float critic_conv2_t(const float* d, const float* w2, int q, int i) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int u = q + 1 - k;
    if (u & 1) continue;
    u >>= 1;
    if (u < 0 || u >= 4) continue;
#pragma unroll
    for (int o4 = 0; o4 < 16; o4 += 4) {
      const float4 a = *reinterpret_cast<const float4*>(d + u * 16 + o4);
      const float* w = w2 + o4 * CW2S + 3 * i + k;
      acc = fmaf(w[0], a.x, acc);
      acc = fmaf(w[CW2S], a.y, acc);
      acc = fmaf(w[2 * CW2S], a.z, acc);
      acc = fmaf(w[3 * CW2S], a.w, acc);
    }
  }
  return acc;
}

// the critic's transposed layer 1 at input (p, i) of an [8][8] cotangent
__device__ __forceinline__ float critic_conv1_t(const float* d, const float* w1, int p, int i) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int u = p + 1 - k;
    if (u & 1) continue;
    u >>= 1;
    if (u < 0 || u >= 8) continue;
    const float4 a = *reinterpret_cast<const float4*>(d + u * 8);
    const float4 b = *reinterpret_cast<const float4*>(d + u * 8 + 4);
    const float* w = w1 + 3 * i + k;
    acc = fmaf(w[0], a.x, acc);
    acc = fmaf(w[CW1S], a.y, acc);
    acc = fmaf(w[2 * CW1S], a.z, acc);
    acc = fmaf(w[3 * CW1S], a.w, acc);
    acc = fmaf(w[4 * CW1S], b.x, acc);
    acc = fmaf(w[5 * CW1S], b.y, acc);
    acc = fmaf(w[6 * CW1S], b.z, acc);
    acc = fmaf(w[7 * CW1S], b.w, acc);
  }
  return acc;
}

__global__ void __launch_bounds__(NT, BLOCKS_PER_SM) generator_grad_kernel(Args a) {
  // the generator's weights as torch holds them, [o][i][k]: a warp's lanes
  // read them at distinct banks in every transposed product
  __shared__ float s_w2[96], s_w3[96], s_w4[24];
  __shared__ float s_cw1[8 * CW1S], s_cw2[16 * CW2S];
  __shared__ __align__(16) float s_tile[WPB * TILE];
  const int tid = threadIdx.x, l = tid & 31, warp = tid >> 5;
  for (int i = tid; i < 96; i += NT) {
    s_w2[i] = a.w2[i];
    s_w3[i] = a.w3[i];
    s_cw1[i / 12 * CW1S + i % 12] = a.cw1[i];
  }
  if (tid < 24) s_w4[tid] = a.w4[tid];
  for (int i = tid; i < 384; i += NT) s_cw2[i / 24 * CW2S + i % 24] = a.cw2[i];
  __syncthreads();

  float* T = s_tile + warp * TILE;
  float *sx = T + T_X, *sa1 = T + T_A1, *sa2 = T + T_A2, *ss = T + T_S, *sh = T + T_H;
  float *sc1 = T + T_C1, *se2 = T + T_E2, *se1 = T + T_E1;
  float *sd4 = T + T_D4, *sd3 = T + T_D3, *sd2 = T + T_D2, *sd1 = T + T_D1;
  // the lane's outputs: enc1 and dec1 (o4, t8), bottleneck (o8, t4),
  // out_conv and the frame's sample (o2, t16); the critic's layer 1 (co1 at
  // ct1, ct1 + 4) and layer 2 (co2 at ct2, ct2 + 2)
  const int o4 = l & 3, t8 = l >> 2, o8 = l & 7, t4 = l >> 3, o2 = l & 1, t16 = l >> 1;
  const int co1 = l & 7, ct1 = l >> 3, co2 = l & 15, ct2 = l >> 4;
  const float gslope = a.gslope, cslope = a.cslope;

  float rw1[6], rw2[12], rw3[24], rw4[12], rc1[12], rc2[24];  // [i][k] of the lane's channel
#pragma unroll
  for (int j = 0; j < 6; ++j) rw1[j] = a.w1[o4 * 6 + j];
#pragma unroll
  for (int j = 0; j < 12; ++j) rw2[j] = s_w2[o8 * 12 + j];
#pragma unroll
  for (int j = 0; j < 24; ++j) rw3[j] = s_w3[o4 * 24 + j];
#pragma unroll
  for (int j = 0; j < 12; ++j) rw4[j] = s_w4[o2 * 12 + j];
#pragma unroll
  for (int j = 0; j < 12; ++j) rc1[j] = s_cw1[co1 * CW1S + j];
#pragma unroll
  for (int j = 0; j < 24; ++j) rc2[j] = s_cw2[co2 * CW2S + j];
  const float b1 = a.b1[o4], b2 = a.b2[o8], b3 = a.b3[o4], b4 = a.b4[o2];
  const float cb1 = a.cb1[co1], cb2 = a.cb2[co2], wd = a.cwd[co2];

  // the lane's weight-gradient sums, three taps each: enc1 pair p8 = l & 7
  // (o p8 / 2, i p8 % 2) at positions 2 q, 2 q + 1, and out_conv pair p8 (o
  // p8 / 4, i p8 % 4) at positions 4 q .. 4 q + 3, for q = l / 8; the
  // bottleneck (o l % 8, i l / 8); dec1 (o l % 4, i l / 4)
  const int p8 = l & 7, q = l >> 3;
  const int i1 = p8 & 1, g1o = p8 >> 1, i4 = p8 & 3, g4o = p8 >> 2;
  float acc1[3] = {0.0f, 0.0f, 0.0f}, acc2[3] = {0.0f, 0.0f, 0.0f};
  float acc3[3] = {0.0f, 0.0f, 0.0f}, acc4[3] = {0.0f, 0.0f, 0.0f};
  float accB1 = 0.0f, accB2 = 0.0f, accB3 = 0.0f, accB4 = 0.0f;  // the lane's own cotangents
  float accY = 0.0f, accR = 0.0f;  // its part of the scores (no bias) and of sum |fake - clean|

  for (int f = blockIdx.x * WPB + warp; f < a.B; f += gridDim.x * WPB) {
    __syncwarp();  // the previous frame's reads of the tile are done
    const float nz = load(a.noisy, f, t16, o2), cl = load(a.clean, f, t16, o2);
    sx[l] = nz;
    sh[t16 * 4 + 2 + o2] = nz;
    __syncwarp();

    // the generator's forward
    float z1 = b1;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int p = 2 * t8 - 1 + k;
      if (p < 0) continue;
      const float2 v = *reinterpret_cast<const float2*>(sx + p * 2);
      z1 = fmaf(rw1[k], v.x, z1);
      z1 = fmaf(rw1[3 + k], v.y, z1);
    }
    const float a1 = z1 * mask(z1, gslope);
    sa1[l] = a1;
    __syncwarp();

    float z2 = b2;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int p = 2 * t4 - 1 + k;
      if (p < 0) continue;
      const float4 v = *reinterpret_cast<const float4*>(sa1 + p * 4);
      z2 = fmaf(rw2[k], v.x, z2);
      z2 = fmaf(rw2[3 + k], v.y, z2);
      z2 = fmaf(rw2[6 + k], v.z, z2);
      z2 = fmaf(rw2[9 + k], v.w, z2);
    }
    sa2[l] = z2 * mask(z2, gslope);
    __syncwarp();

    float z3 = b3;  // dec1 on the bottleneck upsampled: position s reads s / 2
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int s = t8 - 1 + k;
      if (s < 0 || s >= 8) continue;
      const float4 v = *reinterpret_cast<const float4*>(sa2 + (s >> 1) * 8);
      const float4 w = *reinterpret_cast<const float4*>(sa2 + (s >> 1) * 8 + 4);
      z3 = fmaf(rw3[k], v.x, z3);
      z3 = fmaf(rw3[3 + k], v.y, z3);
      z3 = fmaf(rw3[6 + k], v.z, z3);
      z3 = fmaf(rw3[9 + k], v.w, z3);
      z3 = fmaf(rw3[12 + k], w.x, z3);
      z3 = fmaf(rw3[15 + k], w.y, z3);
      z3 = fmaf(rw3[18 + k], w.z, z3);
      z3 = fmaf(rw3[21 + k], w.w, z3);
    }
    ss[l] = z3 * mask(z3, gslope) + a1;
    __syncwarp();

    float z4 = b4;  // out_conv on the skip upsampled
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int s = t16 - 1 + k;
      if (s < 0 || s >= 16) continue;
      const float4 v = *reinterpret_cast<const float4*>(ss + (s >> 1) * 4);
      z4 = fmaf(rw4[k], v.x, z4);
      z4 = fmaf(rw4[3 + k], v.y, z4);
      z4 = fmaf(rw4[6 + k], v.z, z4);
      z4 = fmaf(rw4[9 + k], v.w, z4);
    }
    const float y = tanhf(z4);  // fake[t16][o2]
    sh[t16 * 4 + o2] = y;
    const float diff = y - cl;
    accR += fabsf(diff);
    __syncwarp();

    // the critic's forward on (fake, noisy)
    const float zc1a = critic_conv1(sh, rc1, ct1) + cb1;
    const float zc1b = critic_conv1(sh, rc1, ct1 + 4) + cb1;
    sc1[l] = zc1a * mask(zc1a, cslope);
    sc1[32 + l] = zc1b * mask(zc1b, cslope);
    __syncwarp();
    const float zc2a = critic_conv2(sc1, rc2, ct2) + cb2;
    const float zc2b = critic_conv2(sc1, rc2, ct2 + 2) + cb2;
    // lanes l and l ^ 16 hold the same channel at the other two positions
    accY = fmaf(zc2a * mask(zc2a, cslope) + zc2b * mask(zc2b, cslope), wd, accY);
    se2[l] = mask(zc2a, cslope) * wd;
    se2[32 + l] = mask(zc2b, cslope) * wd;
    __syncwarp();

    // its gradient back to fake: e1 = m1 * (e2 W2^T), g = e1 W1^T on the
    // candidate inputs, one a lane: the lane's own sample
    se1[l] = critic_conv2_t(se2, s_cw2, ct1, co1) * mask(zc1a, cslope);
    se1[32 + l] = critic_conv2_t(se2, s_cw2, ct1 + 4, co1) * mask(zc1b, cslope);
    __syncwarp();
    const float g = critic_conv1_t(se1, s_cw1, t16, o2);

    // the cotangent of out_conv's pre-activation
    const float sgn = diff > 0.0f ? 1.0f : (diff < 0.0f ? -1.0f : 0.0f);
    const float d4 = fmaf(a.ds, g, a.rc * sgn) * (1.0f - y * y);
    sd4[l] = d4;
    accB4 += d4;
    __syncwarp();

    // dec1's: the skip's cotangent (out_conv transposed, each upsampled pair
    // summed) through dec1's mask
    float dskip = 0.0f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int t = 2 * t8 + j + 1 - k;
        if (t < 0 || t >= 16) continue;
        const float2 v = *reinterpret_cast<const float2*>(sd4 + t * 2);
        dskip = fmaf(s_w4[o4 * 3 + k], v.x, dskip);
        dskip = fmaf(s_w4[12 + o4 * 3 + k], v.y, dskip);
      }
    }
    const float d3 = dskip * mask(z3, gslope);
    sd3[l] = d3;
    accB3 += d3;
    __syncwarp();

    // the bottleneck's: dec1 transposed, each upsampled pair summed
    float da2 = 0.0f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int t = 2 * t4 + j + 1 - k;
        if (t < 0 || t >= 8) continue;
        const float4 v = *reinterpret_cast<const float4*>(sd3 + t * 4);
        da2 = fmaf(s_w3[o8 * 3 + k], v.x, da2);
        da2 = fmaf(s_w3[24 + o8 * 3 + k], v.y, da2);
        da2 = fmaf(s_w3[48 + o8 * 3 + k], v.z, da2);
        da2 = fmaf(s_w3[72 + o8 * 3 + k], v.w, da2);
      }
    }
    const float d2 = da2 * mask(z2, gslope);
    sd2[l] = d2;
    accB2 += d2;
    __syncwarp();

    // enc1's: the skip's cotangent plus the bottleneck transposed
    float da1 = dskip;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      int t = t8 + 1 - k;  // 2 t
      if ((t & 1) || t < 0 || t >= 8) continue;
      t >>= 1;
      const float4 v = *reinterpret_cast<const float4*>(sd2 + t * 8);
      const float4 w = *reinterpret_cast<const float4*>(sd2 + t * 8 + 4);
      da1 = fmaf(s_w2[o4 * 3 + k], v.x, da1);
      da1 = fmaf(s_w2[12 + o4 * 3 + k], v.y, da1);
      da1 = fmaf(s_w2[24 + o4 * 3 + k], v.z, da1);
      da1 = fmaf(s_w2[36 + o4 * 3 + k], v.w, da1);
      da1 = fmaf(s_w2[48 + o4 * 3 + k], w.x, da1);
      da1 = fmaf(s_w2[60 + o4 * 3 + k], w.y, da1);
      da1 = fmaf(s_w2[72 + o4 * 3 + k], w.z, da1);
      da1 = fmaf(s_w2[84 + o4 * 3 + k], w.w, da1);
    }
    const float d1 = da1 * mask(z1, gslope);
    sd1[l] = d1;
    accB1 += d1;
    __syncwarp();

    // the weight gradients: sum over positions of cotangent x input, taps
    // inside the frame only
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // enc1 (g1o, i1) at t = 2 q + j
      const int t = 2 * q + j;
      const float d = sd1[t * 4 + g1o];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int p = 2 * t - 1 + k;
        if (p >= 0) acc1[k] = fmaf(d, sx[p * 2 + i1], acc1[k]);
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {  // bottleneck (o8, i = l / 8)
      const float d = sd2[t * 8 + o8];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int p = 2 * t - 1 + k;
        if (p >= 0) acc2[k] = fmaf(d, sa1[p * 4 + t4], acc2[k]);
      }
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {  // dec1 (o4, i = l / 4) on the bottleneck upsampled
      const float d = sd3[t * 4 + o4];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int s = t - 1 + k;
        if (s >= 0 && s < 8) acc3[k] = fmaf(d, sa2[(s >> 1) * 8 + t8], acc3[k]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // out_conv (g4o, i4) at t = 4 q + j on the skip upsampled
      const int t = 4 * q + j;
      const float d = sd4[t * 2 + g4o];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int s = t - 1 + k;
        if (s >= 0 && s < 16) acc4[k] = fmaf(d, ss[(s >> 1) * 4 + i4], acc4[k]);
      }
    }
  }

  // the warp's sums: each layer's lanes by xor shuffles, then the warps in
  // warp order into this block's slot
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    acc1[k] = lanes_sum(acc1[k], 8);
    acc4[k] = lanes_sum(acc4[k], 8);
  }
  accB1 = lanes_sum(accB1, 4);
  accB2 = lanes_sum(accB2, 8);
  accB3 = lanes_sum(accB3, 4);
  accB4 = lanes_sum(accB4, 2);
  accY = lanes_sum(accY, 1);
  accR = lanes_sum(accR, 1);
  __syncthreads();
  float* red = s_tile + warp * SLOT;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    red[OUT_W2 + o8 * 12 + t4 * 3 + k] = acc2[k];
    red[OUT_W3 + o4 * 24 + t8 * 3 + k] = acc3[k];
    if (l < 8) {
      red[OUT_W1 + l * 3 + k] = acc1[k];
      red[OUT_W4 + l * 3 + k] = acc4[k];
    }
  }
  if (l < 4) {
    red[OUT_B1 + l] = accB1;
    red[OUT_B3 + l] = accB3;
  }
  if (l < 8) red[OUT_B2 + l] = accB2;
  if (l < 2) red[OUT_B4 + l] = accB4;
  if (l < SLOT - OUT_SUMS) red[OUT_SUMS + l] = l == 0 ? accY : l == 1 ? accR : 0.0f;
  __syncthreads();
  float* slot = a.slots + (size_t)blockIdx.x * SLOT;
  for (int idx = tid; idx < SLOT; idx += NT) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < WPB; ++w) s += s_tile[w * SLOT + idx];
    slot[idx] = s;
  }
}

// The second stage: the slots summed in a fixed order, then the gradients
// and the metrics written. Block x owns slot entries 32x..32x+31; warp w
// adds slots [w n / SUM_WARPS, (w + 1) n / SUM_WARPS) in slot order, and
// warp 0 adds the warps in warp order.
__global__ void __launch_bounds__(SUM_WARPS * 32) generator_grad_sum_kernel(Args a) {
  __shared__ float part[SUM_WARPS][32];
  const int l = threadIdx.x & 31, w = threadIdx.x >> 5, idx = blockIdx.x * 32 + l;
  const int n = a.nblocks, lo = w * n / SUM_WARPS, hi = (w + 1) * n / SUM_WARPS;
  float s = 0.0f;
  if (idx < SLOT)
    for (int b = lo; b < hi; ++b) s += a.slots[(size_t)b * SLOT + idx];
  part[w][l] = s;
  __syncthreads();
  if (w != 0) return;
  float t = 0.0f;
#pragma unroll
  for (int i = 0; i < SUM_WARPS; ++i) t += part[i][l];
  if (idx < OUT_SUMS) a.out[idx] = t;
  if (blockIdx.x != OUT_SUMS / 32) return;
  // this block holds the sums of the scores (without the dense bias) and of |fake - clean|
  const int m = OUT_SUMS % 32;
  const float y_sum = __shfl_sync(FULL, t, m), r_sum = __shfl_sync(FULL, t, m + 1);
  if (l == 0) {
    const float adv = -(y_sum * a.inv_b + *a.cbd), rec = r_sum * a.inv_n;
    a.out[OUT_SUMS] = a.adv_weight * adv + a.rec_weight * rec;
    a.out[OUT_SUMS + 1] = adv;
    a.out[OUT_SUMS + 2] = rec;
  }
}

}  // namespace

// Blocks for a batch of B frames on a card with `sms` SMs; the scratch
// buffer holds one slot per block.
extern "C" int ofdm_generator_grad_blocks(int B, int sms) {
  const int n = (B + WPB - 1) / WPB, cap = sms * BLOCKS_PER_SM;
  return n < cap ? n : cap;
}

extern "C" int ofdm_generator_grad_slot_floats() { return SLOT; }

extern "C" int ofdm_generator_grad_out_floats() { return N_OUT; }

// Launches both stages on `stream`. `gen` holds the generator's eight
// parameter pointers in parameters() order, `critic` the critic's six.
extern "C" int ofdm_generator_grad_launch(
    int B, int nblocks, float gen_slope, float critic_slope, float adv_weight, float rec_weight,
    const void* clean, long long c_sb, long long c_st, long long c_sc,
    const void* noisy, long long n_sb, long long n_st, long long n_sc,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* w3, const void* b3, const void* w4, const void* b4,
    const void* cw1, const void* cb1, const void* cw2, const void* cb2,
    const void* cwd, const void* cbd, void* scratch, void* out, void* stream) {
  if (B <= 0 || nblocks <= 0) return (int)cudaErrorInvalidValue;
  Args a;
  a.B = B;
  a.nblocks = nblocks;
  a.gslope = gen_slope;
  a.cslope = critic_slope;
  a.adv_weight = adv_weight;
  a.rec_weight = rec_weight;
  a.ds = -adv_weight / (float)B;
  a.rc = rec_weight / (float)(32LL * B);
  a.inv_b = 1.0f / (float)B;
  a.inv_n = 1.0f / (float)(32LL * B);
  a.clean = Frames{(const float*)clean, c_sb, c_st, c_sc};
  a.noisy = Frames{(const float*)noisy, n_sb, n_st, n_sc};
  a.w1 = (const float*)w1;
  a.b1 = (const float*)b1;
  a.w2 = (const float*)w2;
  a.b2 = (const float*)b2;
  a.w3 = (const float*)w3;
  a.b3 = (const float*)b3;
  a.w4 = (const float*)w4;
  a.b4 = (const float*)b4;
  a.cw1 = (const float*)cw1;
  a.cb1 = (const float*)cb1;
  a.cw2 = (const float*)cw2;
  a.cb2 = (const float*)cb2;
  a.cwd = (const float*)cwd;
  a.cbd = (const float*)cbd;
  a.slots = (float*)scratch;
  a.out = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  generator_grad_kernel<<<nblocks, NT, 0, s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  generator_grad_sum_kernel<<<(SLOT + 31) / 32, SUM_WARPS * 32, 0, s>>>(a);
  return (int)cudaGetLastError();
}
