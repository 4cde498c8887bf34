// The mini generator's forward in one launch: the no-grad fake that the
// critic updates of an outer step read.
//
// Replaces no TPU kernel: the reference computes this forward with XLA
// (ofdmgan_tpu/training/wgan_gp.py, the generator apply inside each critic
// update). It was added because on the H100 the port's forward of the
// deployed generator ran through four cuDNN convolutions and about a dozen
// ATen kernels (a transpose, the bias adds, the LeakyReLUs, two upsamples,
// the skip add and the tanh), ~0.28 ms a step at B = 65,536 against a
// least time of ~5 us.
//
// For every frame it computes
//     enc1 (2->4, k3, s2) -> LeakyReLU -> bottleneck (4->8, s2) -> LeakyReLU
//     -> nearest x2 -> dec1 (8->4) -> LeakyReLU -> + enc1 -> nearest x2
//     -> out_conv (4->2) -> tanh,
// every conv with padding 1, the bias first and then each tap that falls
// inside the frame, as one float32 FMA; LeakyReLU as z * (z > 0 ? 1 : slope);
// tanhf (not a fast approximation). It reads noisy [B, 16, 2] float32 by its
// strides and writes the fake [B, 16, 2] float32, contiguous. No TF32, no
// tensor cores, no atomics: every output is a function of its own frame
// alone, so two calls are bit for bit equal whatever the batch.
//
// What bounds it on the H100: bytes. A frame reads 128 B and writes 128 B;
// its 1,608 multiply-adds (the taps inside the frame) take less time at
// 67 TFLOP/s than its bytes at 3.35 TB/s.
//
// One thread a frame. The block stages its TPB frames through shared memory
// with a padded row of ROW floats, so the global reads and writes stay
// coalesced whatever the frame's strides and a thread reads its own row
// without bank conflicts. The activations stay in the thread's registers;
// the weights are the block's, in shared memory, read as warp-wide
// broadcasts once an output channel (a layer's weights then serve every
// position of the frame), so a frame takes 258 shared loads against its
// 1,608 multiply-adds. (One warp a frame, as the forward half of
// csrc/generator_grad.cu, was timed against it: faster below ~141 frames an
// SM, 1.9 against 5.2-5.5 us at B = 64 on an H100, slower above; no
// benchmark cell runs such a batch, so only this mapping is kept.)

#include <cuda_runtime.h>

namespace {

constexpr int TPB = 128;               // threads (frames) a block
constexpr int BLOCKS_PER_SM = 4;
constexpr int ROW = 33;                // a frame's padded row in the staging tile
constexpr int FRAME = 32;              // floats of a frame, [16][2]

struct Frames {
  const float* p;
  long long sb, st, sc;  // element strides of batch, time, component
};

struct Args {
  int B;
  float slope;
  Frames noisy;
  const float *w1, *b1, *w2, *b2, *w3, *b3, *w4, *b4;  // parameters() order
  float* out;                                          // [B][16][2]
};

__device__ __forceinline__ float leaky(float z, float slope) { return z * (z > 0.0f ? 1.0f : slope); }

__device__ __forceinline__ float load(const Frames& fr, long long f, int t, int c) {
  return fr.p[f * fr.sb + t * fr.st + c * fr.sc];
}

// The frame x [16][2] (registers, sample t, channel c at x[2 t + c]) ->
// the fake y [16][2], with the block's weights in shared memory.
__device__ __forceinline__ void thread_frame(const float (&x)[FRAME], float (&y)[FRAME],
                                             const float* w1, const float* b1,
                                             const float* w2, const float* b2,
                                             const float* w3, const float* b3,
                                             const float* w4, const float* b4, float slope) {
  float a1[32];  // enc1 [8][4]
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    float w[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) w[j] = w1[o * 6 + j];
    const float b = b1[o];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      float z = b;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int p = 2 * t - 1 + k;
        if (p < 0) continue;
        z = fmaf(w[k], x[p * 2], z);
        z = fmaf(w[3 + k], x[p * 2 + 1], z);
      }
      a1[t * 4 + o] = leaky(z, slope);
    }
  }
  float a2[32];  // bottleneck [4][8]
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    float w[12];
#pragma unroll
    for (int j = 0; j < 12; ++j) w[j] = w2[o * 12 + j];
    const float b = b2[o];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      float z = b;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int p = 2 * t - 1 + k;
        if (p < 0) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) z = fmaf(w[i * 3 + k], a1[p * 4 + i], z);
      }
      a2[t * 8 + o] = leaky(z, slope);
    }
  }
  float s[32];  // the skip, dec1 on the bottleneck upsampled + enc1 [8][4]
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    float w[24];
#pragma unroll
    for (int j = 0; j < 24; ++j) w[j] = w3[o * 24 + j];
    const float b = b3[o];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      float z = b;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int q = t - 1 + k;   // position q of the upsampled input reads q / 2
        if (q < 0 || q >= 8) continue;
#pragma unroll
        for (int i = 0; i < 8; ++i) z = fmaf(w[i * 3 + k], a2[(q >> 1) * 8 + i], z);
      }
      s[t * 4 + o] = leaky(z, slope) + a1[t * 4 + o];
    }
  }
#pragma unroll
  for (int o = 0; o < 2; ++o) {  // out_conv on the skip upsampled, then tanh
    float w[12];
#pragma unroll
    for (int j = 0; j < 12; ++j) w[j] = w4[o * 12 + j];
    const float b = b4[o];
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      float z = b;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int q = t - 1 + k;
        if (q < 0 || q >= 16) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) z = fmaf(w[i * 3 + k], s[(q >> 1) * 4 + i], z);
      }
      y[t * 2 + o] = tanhf(z);
    }
  }
}

__global__ void __launch_bounds__(TPB, BLOCKS_PER_SM) generator_forward_kernel(Args a) {
  __shared__ __align__(16) float s_w1[24], s_b1[4], s_w2[96], s_b2[8], s_w3[96], s_b3[4],
      s_w4[24], s_b4[4];
  __shared__ float s_tile[TPB * ROW];
  const int tid = threadIdx.x;
  for (int i = tid; i < 96; i += TPB) {
    s_w2[i] = a.w2[i];
    s_w3[i] = a.w3[i];
  }
  if (tid < 24) {
    s_w1[tid] = a.w1[tid];
    s_w4[tid] = a.w4[tid];
  }
  if (tid < 8) s_b2[tid] = a.b2[tid];
  if (tid < 4) {
    s_b1[tid] = a.b1[tid];
    s_b3[tid] = a.b3[tid];
  }
  if (tid < 2) s_b4[tid] = a.b4[tid];
  const int nbase = (a.B + TPB - 1) / TPB;  // groups of TPB frames
  for (int g = blockIdx.x; g < nbase; g += gridDim.x) {
    const long long base = (long long)g * TPB;
    const int n = a.B - base < TPB ? (int)(a.B - base) : TPB;  // frames of this group
    __syncthreads();  // the weights are in; the previous group's tile was written out
    // stage the group's frames, each a padded row: a warp reads 32
    // consecutive floats of the batch where noisy is contiguous
    for (int i = tid; i < n * FRAME; i += TPB) {
      const int r = i / FRAME, e = i % FRAME;
      s_tile[r * ROW + e] = load(a.noisy, base + r, e >> 1, e & 1);
    }
    __syncthreads();
    if (tid < n) {
      float x[FRAME], y[FRAME];
#pragma unroll
      for (int e = 0; e < FRAME; ++e) x[e] = s_tile[tid * ROW + e];
      thread_frame(x, y, s_w1, s_b1, s_w2, s_b2, s_w3, s_b3, s_w4, s_b4, a.slope);
#pragma unroll
      for (int e = 0; e < FRAME; ++e) s_tile[tid * ROW + e] = y[e];
    }
    __syncthreads();
    float* out = a.out + base * FRAME;
    for (int i = tid; i < n * FRAME; i += TPB) out[i] = s_tile[(i / FRAME) * ROW + i % FRAME];
  }
}

}  // namespace

// Blocks of a launch: enough for the batch, at most the blocks the card
// holds at once; the blocks walk the rest in a grid-stride loop.
extern "C" int ofdm_generator_forward_blocks(int B, int sms) {
  const int n = (B + TPB - 1) / TPB, cap = sms * BLOCKS_PER_SM;
  return n < cap ? n : cap;
}

// Launches the forward on `stream`: noisy by its element strides, the
// generator's eight parameters in parameters() order, out [B][16][2].
extern "C" int ofdm_generator_forward_launch(
    int B, int nblocks, float slope,
    const void* noisy, long long n_sb, long long n_st, long long n_sc,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* w3, const void* b3, const void* w4, const void* b4, void* out, void* stream) {
  if (B <= 0 || nblocks <= 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.B = B;
  a.slope = slope;
  a.noisy = Frames{(const float*)noisy, n_sb, n_st, n_sc};
  a.w1 = (const float*)w1;
  a.b1 = (const float*)b1;
  a.w2 = (const float*)w2;
  a.b2 = (const float*)b2;
  a.w3 = (const float*)w3;
  a.b3 = (const float*)b3;
  a.w4 = (const float*)w4;
  a.b4 = (const float*)b4;
  a.out = (float*)out;
  generator_forward_kernel<<<nblocks, TPB, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
