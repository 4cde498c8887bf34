// The whole WGAN-GP critic-loss gradient of the mini critic in two launches.
//
// Replaces the Pallas TPU kernel critic_grad_pallas
// (ofdmgan_tpu/ops/pallas_critic.py:195, body _kernel :106-192). For every
// frame it runs one stacked forward over [real; fake; eps-interpolate]
// through the dense Toeplitz layers A1, A2 (64x64) with leaky masks, the
// Wasserstein-term backward, and the hand-derived second-order
// gradient-penalty chain (pallas_critic.py:15-27), and sums dA1, dA2, db1,
// db2, dw and the sums of y_real, y_fake and the penalty over the batch.
//
// What bounds it on the H100: operations. Each frame costs about 147 kFLOP
// of 64-wide float32 products against 33 KB of weights, and reads only
// 2 * 64 + 1 floats; the design keeps the weights and every activation in
// shared memory so device memory sees the inputs once.
//
// Design: the TPU grid runs in order on one core and carries the sums in
// its output blocks from one grid step to the next. On Hopper blocks run in
// no order, so stage 1 gives each block a fixed, strided set of R-row tiles
// and lets it keep its share of the 64x64 gradients in registers (16 + 16
// per thread) across its tiles; each block then writes its partial sums to
// its own slot of a scratch buffer. Stage 2 sums the slots in slot order.
// The result is deterministic for a given B: no atomics. Products are fp32
// FMA on CUDA cores (no TF32, no tensor cores), since the default numerics
// are full float32; the padded row stride (65) keeps transposed reads of
// A1 and A2 free of bank conflicts. Rows past B load zeros and carry zero
// upstream gradient, so a ragged last tile adds nothing. The leaky mask of a
// layer is read back from the sign of its activation (a = m * z with m > 0),
// so masks take no storage.

#include <cuda_runtime.h>

namespace {

constexpr int R = 16;       // rows per tile
constexpr int NT = 256;     // threads per block
constexpr int LDA = 65;     // padded row stride of A1, A2 in shared memory
constexpr int kMaxBlocks = 264;
// partial-sum slot: gA1[4096] gA2[4096] gb1[64] gb2[64] gw[16] y_r y_f gp
constexpr int kOut = 8339;
constexpr int kSlot = 8448;
constexpr int OFF_GA2 = 4096, OFF_GB1 = 8192, OFF_GB2 = 8256, OFF_GW = 8320, OFF_M = 8336;
// shared-memory layout, in floats
constexpr int S_A1 = 0, S_A2 = 64 * LDA, S_B1 = 2 * 64 * LDA, S_B2 = S_B1 + 64, S_Q2 = S_B2 + 64;
constexpr int S_H = S_Q2 + 64;             // h0 rows [3R, 64]: real, fake, interp
constexpr int S_X1 = S_H + 3 * R * 64;     // layer-1 activations [3R, 64]
constexpr int S_X2 = S_X1 + 3 * R * 64;    // layer-2 activations [3R, 64]
constexpr int S_D2 = S_X2 + 3 * R * 64;    // dz2 [2R, 64]
constexpr int S_D1 = S_D2 + 2 * R * 64;    // dz1 [2R, 64]
constexpr int S_E2 = S_D1 + 2 * R * 64;    // e2 [R, 64]
constexpr int S_E1 = S_E2 + R * 64;        // e1 [R, 64]
constexpr int S_C = S_E1 + R * 64;         // candidate-masked dy/dh0, then c [R, 64]
constexpr int S_C1 = S_C + R * 64;         // c1 [R, 64]
constexpr int S_C2 = S_C1 + R * 64;        // c2 * m2 [R, 64]
constexpr int S_Y = S_C2 + R * 64;         // per-row score without bias [2R]
constexpr int S_N = S_Y + 2 * R;           // per-row gradient norm [R]
constexpr int S_DY = S_N + R;              // per-row upstream dL/dy [2R]
constexpr int kSmemFloats = S_DY + 2 * R;

struct Args {
  int B;
  float slope, gp_coef, inv_b;  // gp_coef = 2 * gp_weight / B
  const float *h0r, *h0f, *eps, *a1, *a2, *b1, *b2, *q2;
  float* partial;
};

// sum_k in[k] * M[k][j]  (or M[j][k] when TRANS)
template <bool TRANS>
__device__ __forceinline__ float dot_row(const float* in, const float* M, int j) {
  float acc = 0.0f;
#pragma unroll 16
  for (int k = 0; k < 64; ++k) acc += in[k] * (TRANS ? M[j * LDA + k] : M[k * LDA + j]);
  return acc;
}

__device__ __forceinline__ float leaky_mask(float a, float slope) {
  return a > 0.0f ? 1.0f : slope;
}

// acc[m] += sum_r X[r][i_m] * Y[r][j] with i_m = t/64 + 4m, j = t%64
__device__ __forceinline__ void accum_outer(float (&acc)[16], const float* X, const float* Y,
                                            int rows, int t) {
  const int j = t & 63, i0 = t >> 6;
  for (int r = 0; r < rows; ++r) {
    const float y = Y[r * 64 + j];
#pragma unroll
    for (int m = 0; m < 16; ++m) acc[m] += X[r * 64 + i0 + 4 * m] * y;
  }
}

// one warp's sum over row r of x*x (SQUARE) or of x*q
template <bool SQUARE>
__device__ __forceinline__ float row_sum(const float* X, const float* q, int r, int lane) {
  const float x0 = X[r * 64 + lane], x1 = X[r * 64 + lane + 32];
  float v = SQUARE ? x0 * x0 + x1 * x1 : x0 * q[lane] + x1 * q[lane + 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(NT) critic_stage1(Args a) {
  extern __shared__ float sm[];
  float *sA1 = sm + S_A1, *sA2 = sm + S_A2, *sb1 = sm + S_B1, *sb2 = sm + S_B2, *sq2 = sm + S_Q2;
  float *sH = sm + S_H, *sX1 = sm + S_X1, *sX2 = sm + S_X2, *sD2 = sm + S_D2, *sD1 = sm + S_D1;
  float *sE2 = sm + S_E2, *sE1 = sm + S_E1, *sC = sm + S_C, *sC1 = sm + S_C1, *sC2 = sm + S_C2;
  float *sY = sm + S_Y, *sN = sm + S_N, *sDY = sm + S_DY;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float slope = a.slope;

  for (int idx = t; idx < 64 * 64; idx += NT) {
    const int k = idx >> 6, j = idx & 63;
    sA1[k * LDA + j] = a.a1[idx];
    sA2[k * LDA + j] = a.a2[idx];
  }
  if (t < 64) { sb1[t] = a.b1[t]; sb2[t] = a.b2[t]; sq2[t] = a.q2[t]; }

  float gA1[16], gA2[16];
#pragma unroll
  for (int m = 0; m < 16; ++m) { gA1[m] = 0.0f; gA2[m] = 0.0f; }
  float gvec = 0.0f;                     // gb1 (t<64), gb2 (t<128), gw (t<144)
  float y_r = 0.0f, y_f = 0.0f, gp = 0.0f;  // thread 144

  const int ntiles = (a.B + R - 1) / R;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * R;
    __syncthreads();  // the weights are in; the previous tile is finished
    for (int idx = t; idx < R * 64; idx += NT) {
      const int g = row0 + (idx >> 6), k = idx & 63;
      float hr = 0.0f, hf = 0.0f, e = 0.0f;
      if (g < a.B) {
        hr = a.h0r[(size_t)g * 64 + k];
        hf = a.h0f[(size_t)g * 64 + k];
        e = a.eps[g];
      }
      sH[idx] = hr;
      sH[R * 64 + idx] = hf;
      sH[2 * R * 64 + idx] = e * hr + (1.0f - e) * hf;
    }
    if (t < 2 * R) sDY[t] = row0 + t % R < a.B ? (t < R ? -a.inv_b : a.inv_b) : 0.0f;
    __syncthreads();

    // stacked forward: a1 = leaky(h A1 + b1), a2 = leaky(a1 A2 + b2)
    for (int idx = t; idx < 3 * R * 64; idx += NT) {
      const int r = idx >> 6, j = idx & 63;
      const float z = dot_row<false>(sH + r * 64, sA1, j) + sb1[j];
      sX1[idx] = z * leaky_mask(z, slope);
    }
    __syncthreads();
    for (int idx = t; idx < 3 * R * 64; idx += NT) {
      const int r = idx >> 6, j = idx & 63;
      const float z = dot_row<false>(sX1 + r * 64, sA2, j) + sb2[j];
      sX2[idx] = z * leaky_mask(z, slope);
    }
    __syncthreads();

    // Wasserstein term: dz2 = dy * q2 * m2; penalty chain: e2 = m2 * q2
    for (int idx = t; idx < 2 * R * 64; idx += NT)
      sD2[idx] = sDY[idx >> 6] * sq2[idx & 63] * leaky_mask(sX2[idx], slope);
    for (int idx = t; idx < R * 64; idx += NT)
      sE2[idx] = leaky_mask(sX2[2 * R * 64 + idx], slope) * sq2[idx & 63];
    for (int r = warp; r < 2 * R; r += NT / 32) {
      const float v = row_sum<false>(sX2, sq2, r, lane);
      if (lane == 0) sY[r] = v;
    }
    __syncthreads();

    // dz1 = (dz2 A2^T) * m1;  e1 = m1 * (e2 A2^T)
    for (int idx = t; idx < 2 * R * 64; idx += NT) {
      const int r = idx >> 6, i = idx & 63;
      sD1[idx] = dot_row<true>(sD2 + r * 64, sA2, i) * leaky_mask(sX1[idx], slope);
    }
    for (int idx = t; idx < R * 64; idx += NT) {
      const int r = idx >> 6, i = idx & 63;
      sE1[idx] = leaky_mask(sX1[2 * R * 64 + idx], slope) * dot_row<true>(sE2 + r * 64, sA2, i);
    }
    __syncthreads();

    // g = e1 A1^T = dy/dh0 at the interpolate, kept on the candidate lanes
    for (int idx = t; idx < R * 64; idx += NT) {
      const int r = idx >> 6, i = idx & 63;
      const float g = dot_row<true>(sE1 + r * 64, sA1, i);
      sC[idx] = (i & 3) < 2 ? g : 0.0f;
    }
    __syncthreads();
    for (int r = warp; r < R; r += NT / 32) {
      const float v = row_sum<true>(sC, nullptr, r, lane);
      if (lane == 0) sN[r] = sqrtf(v + 1e-12f);
    }
    __syncthreads();

    // c = 2 lambda (n - 1) / (n B) * gc, zero on rows past B
    for (int idx = t; idx < R * 64; idx += NT) {
      const int r = idx >> 6;
      const float n = sN[r];
      const float coef = row0 + r < a.B ? (a.gp_coef * (n - 1.0f)) / n : 0.0f;
      sC[idx] = coef * sC[idx];
    }
    __syncthreads();
    // c1 = (c A1) * m1
    for (int idx = t; idx < R * 64; idx += NT) {
      const int r = idx >> 6, j = idx & 63;
      sC1[idx] = dot_row<false>(sC + r * 64, sA1, j) * leaky_mask(sX1[2 * R * 64 + idx], slope);
    }
    __syncthreads();
    // c2 * m2 = (c1 A2) * m2
    for (int idx = t; idx < R * 64; idx += NT) {
      const int r = idx >> 6, j = idx & 63;
      sC2[idx] = dot_row<false>(sC1 + r * 64, sA2, j) * leaky_mask(sX2[2 * R * 64 + idx], slope);
    }
    __syncthreads();

    // parameter gradients of this tile
    accum_outer(gA2, sX1, sD2, 2 * R, t);
    accum_outer(gA2, sC1, sE2, R, t);
    accum_outer(gA1, sH, sD1, 2 * R, t);
    accum_outer(gA1, sC, sE1, R, t);
    if (t < 64) {
      for (int r = 0; r < 2 * R; ++r) gvec += sD1[r * 64 + t];
    } else if (t < 128) {
      for (int r = 0; r < 2 * R; ++r) gvec += sD2[r * 64 + t - 64];
    } else if (t < 128 + 16) {
      const int c = t - 128;
      for (int r = 0; r < 2 * R; ++r) {
        const float* x = sX2 + r * 64 + c;
        gvec += sDY[r] * (((x[0] + x[16]) + x[32]) + x[48]);
      }
      for (int r = 0; r < R; ++r) {
        const float* x = sC2 + r * 64 + c;
        gvec += ((x[0] + x[16]) + x[32]) + x[48];
      }
    } else if (t == 144) {
      for (int r = 0; r < R && row0 + r < a.B; ++r) {
        y_r += sY[r];
        y_f += sY[R + r];
        const float d = sN[r] - 1.0f;
        gp += d * d;
      }
    }
  }

  float* slot = a.partial + (size_t)blockIdx.x * kSlot;
  const int j = t & 63, i0 = t >> 6;
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    slot[(i0 + 4 * m) * 64 + j] = gA1[m];
    slot[OFF_GA2 + (i0 + 4 * m) * 64 + j] = gA2[m];
  }
  if (t < 64) slot[OFF_GB1 + t] = gvec;
  else if (t < 128) slot[OFF_GB2 + t - 64] = gvec;
  else if (t < 144) slot[OFF_GW + t - 128] = gvec;
  else if (t == 144) { slot[OFF_M] = y_r; slot[OFF_M + 1] = y_f; slot[OFF_M + 2] = gp; }
}

// out[i] = sum of the slots' i-th entries, in slot order
__global__ void critic_stage2(const float* partial, int nblocks, float* out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= kOut) return;
  float s = 0.0f;
  for (int b = 0; b < nblocks; ++b) s += partial[(size_t)b * kSlot + idx];
  out[idx] = s;
}

}  // namespace

// Blocks of stage 1 for a batch of B rows; the scratch buffer holds this
// many slots of ofdm_critic_grad_slot_floats() floats.
extern "C" int ofdm_critic_grad_blocks(int B) {
  const int ntiles = (B + R - 1) / R;
  return ntiles < kMaxBlocks ? ntiles : kMaxBlocks;
}

extern "C" int ofdm_critic_grad_slot_floats() { return kSlot; }

extern "C" int ofdm_critic_grad_out_floats() { return kOut; }

extern "C" int ofdm_critic_grad_launch(
    int B, float slope, float gp_coef, float inv_b,
    const void* h0r, const void* h0f, const void* eps, const void* a1, const void* a2,
    const void* b1, const void* b2, const void* q2, void* partial, void* out,
    void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kSmemFloats;
  cudaError_t err = cudaFuncSetAttribute(
      critic_stage1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  Args a{B, slope, gp_coef, inv_b,
         (const float*)h0r, (const float*)h0f, (const float*)eps, (const float*)a1,
         (const float*)a2, (const float*)b1, (const float*)b2, (const float*)q2,
         (float*)partial};
  const int nblocks = ofdm_critic_grad_blocks(B);
  cudaStream_t s = (cudaStream_t)stream;
  critic_stage1<<<nblocks, NT, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  critic_stage2<<<(kOut + 255) / 256, 256, 0, s>>>((const float*)partial, nblocks, (float*)out);
  return (int)cudaGetLastError();
}
