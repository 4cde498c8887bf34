// The whole WGAN-GP critic-loss gradient of the mini critic, in conv form,
// in one launch.
//
// Replaces the Pallas TPU kernel critic_grad_pallas
// (ofdmgan_tpu/ops/pallas_critic.py:195, body _kernel :106-192) together
// with its host map dense_grads_to_params (:90-103). For every frame it runs
// the forward pass over [real; fake; eps-interpolate], the Wasserstein-term
// backward and the hand-derived second-order gradient-penalty chain
// (pallas_critic.py:15-27), and writes the gradient of
//     L_D = mean D(fake) - mean D(real) + gp_weight * GP
// with respect to each of the critic's 521 parameters (named_parameters()
// order), then the metrics d_loss, wasserstein_distance, gradient_penalty,
// d_real_mean and d_fake_mean.
//
// What bounds it on the H100: operations. A frame reads 3 * 32 + 1 floats
// and needs 19,968 float32 multiply-adds (the conv taps inside the frame,
// 736 for layer 1 and 1,408 for layer 2 per product). The TPU kernel worked
// on dense 64 x 64 block-Toeplitz matrices made for its matrix unit, 3.7x
// the work; here only the taps are walked, t_in = 2 t_out - 1 + k, and the
// padding tap t_in = -1 is skipped in the forward and the transposed
// direction alike.
//
// Design: one warp owns one frame at a time, with its real/fake/interpolate
// triple (they share the condition). Each lane owns two of the 64 layer-1
// outputs (8 positions x 8 channels) and two of the 64 layer-2 outputs
// (4 x 16); the channel of both is the same, so the lane keeps that
// channel's 12 + 24 weights in registers for every forward product, of all
// three rows and of the penalty chain. The 521 weights (2 KB) also sit in
// shared memory, padded so that a warp's reads hit distinct banks, for the
// transposed products. Activations move between lanes through a 3.4 KB
// per-warp tile, read as 16-byte vectors, with __syncwarp, never
// __syncthreads. The leaky mask of a layer is read from the sign of its
// activation. Every lane keeps 20 of the gradient sums in registers across
// a grid-stride loop over frames: conv1.weight[o][i][:] and
// conv2.weight[o][4h..4h+3][:] for its channels, so that it reads the
// activations those sums need as 16-byte vectors. A block then adds its
// warps in warp order in shared memory and writes one 528-float slot. A
// second kernel, launched on the same stream by the same entry point, sums
// the slots: its block x owns entries 32x..32x+31 of a slot, each of its 8
// warps adds a fixed run of slots in slot order, then warp 0 adds the warps
// in order and writes the gradients and metrics. Every sum is in a fixed
// order, so the result is deterministic for a given B and card. float32 FMA
// on CUDA cores only: no TF32, no tensor cores.
//
// bf16 matmul precision (the step's matmul_precision="bfloat16", the
// instantiation BF16 = true): every operand of a conv, a transposed conv, a
// weight-gradient sum and the dense layer is rounded to bfloat16, as the
// autograd route computes it under ops/bf16_dots.py, and the products are
// summed in float32 (a product of two bf16 values is exact in float32).
// The host passes the three weight tensors rounded; the kernel rounds the
// activations and cotangents where it stores them for the products: h0,
// the layer-1 activations, dz2, e2, dz1, e1, c and c1, the pooled layer-2
// activations of the score and of the Wasserstein dense gradient, the
// penalty's pooled dense gradient and dy = 1/B. The bias gradients sum
// unrounded values, as autograd's do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WPB = 4;                 // warps per block
constexpr int NT = WPB * 32;
constexpr int BLOCKS_PER_SM = 3;
constexpr int SUM_WARPS = 8;           // second stage: warps per block
constexpr int W1S = 12, W2S = 25;      // padded per-output-channel weight strides
// output buffer, in named_parameters() order, then the metrics
constexpr int OUT_W1 = 0, OUT_B1 = 96, OUT_W2 = 104, OUT_B2 = 488, OUT_BD = 520,
              OUT_SUMS = 521, N_OUT = 526, SLOT = 528;
// per-warp tile, in floats
constexpr int T_H = 0,      // h0 of real, fake, interpolate [3][16 pos][4 ch]
    T_X1 = 192,             // layer-1 activations [3][8][8]
    T_DZ2 = 384,            // Wasserstein dz2 of real, fake [2][4][16]
    T_E2 = 512,             // e2 = m2 * w [4][16]
    T_DZ1 = 576,            // Wasserstein dz1 of real, fake [2][8][8]
    T_E1 = 704,             // e1 [8][8]
    T_C = 768,              // penalty c on the candidate inputs [16][2]
    T_C1 = 800,             // c1 [8][8]
    TILE = 864;
static_assert(SLOT <= TILE, "the block reduction reuses the tiles");
constexpr unsigned FULL = 0xffffffffu;

struct Frames {
  const float* p;
  long long sb, st, sc;  // element strides of batch, time, component
};

struct Args {
  int B, nblocks;
  float slope, gp_weight, gp_coef, inv_b;  // gp_coef = 2 * gp_weight / B
  Frames clean, fake, noisy;
  const float *alpha, *w1, *b1, *w2, *b2, *wd, *bd;
  float *slots, *out;  // slots: [nblocks][SLOT]
};

__device__ __forceinline__ float mask(float x, float slope) { return x > 0.0f ? 1.0f : slope; }

// x rounded to the nearest bfloat16 under BF16, else x
template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

__device__ __forceinline__ float load(const Frames& fr, int f, int t, int c) {
  return fr.p[f * fr.sb + t * fr.st + c * fr.sc];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// layer 1 at output (t, o) without bias, from the lane's own weights
// w[3i + k] = conv1.weight[o][i][k]; x is [16][CI] with CI = 4 (h0) or 2
// (the candidate-only penalty vector c)
template <int CI>
__device__ __forceinline__ float conv1(const float* x, const float (&w)[12], int t) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int p = 2 * t - 1 + k;
    if (p < 0) continue;
    if (CI == 4) {
      const float4 v = *reinterpret_cast<const float4*>(x + p * 4);
      acc = fmaf(w[k], v.x, acc);
      acc = fmaf(w[3 + k], v.y, acc);
      acc = fmaf(w[6 + k], v.z, acc);
      acc = fmaf(w[9 + k], v.w, acc);
    } else {
      const float2 v = *reinterpret_cast<const float2*>(x + p * 2);
      acc = fmaf(w[k], v.x, acc);
      acc = fmaf(w[3 + k], v.y, acc);
    }
  }
  return acc;
}

// layer 2 at output (t, o) without bias, from w[3i + k] = conv2.weight[o][i][k];
// x is [8][8]
__device__ __forceinline__ float conv2(const float* x, const float (&w)[24], int t) {
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

// transposed layer 2 at input (q, i) of three [4][16] vectors at once
__device__ __forceinline__ void conv2_t(const float* d0, const float* d1, const float* d2,
                                        const float* w2, int q, int i,
                                        float& r0, float& r1, float& r2) {
  r0 = r1 = r2 = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int u = q + 1 - k;
    if (u & 1) continue;
    u >>= 1;
    if (u < 0 || u >= 4) continue;
#pragma unroll
    for (int o4 = 0; o4 < 16; o4 += 4) {
      const float4 a = *reinterpret_cast<const float4*>(d0 + u * 16 + o4);
      const float4 b = *reinterpret_cast<const float4*>(d1 + u * 16 + o4);
      const float4 c = *reinterpret_cast<const float4*>(d2 + u * 16 + o4);
      const float* w = w2 + o4 * W2S + 3 * i + k;
      r0 = fmaf(w[0], a.x, r0);
      r1 = fmaf(w[0], b.x, r1);
      r2 = fmaf(w[0], c.x, r2);
      r0 = fmaf(w[W2S], a.y, r0);
      r1 = fmaf(w[W2S], b.y, r1);
      r2 = fmaf(w[W2S], c.y, r2);
      r0 = fmaf(w[2 * W2S], a.z, r0);
      r1 = fmaf(w[2 * W2S], b.z, r1);
      r2 = fmaf(w[2 * W2S], c.z, r2);
      r0 = fmaf(w[3 * W2S], a.w, r0);
      r1 = fmaf(w[3 * W2S], b.w, r1);
      r2 = fmaf(w[3 * W2S], c.w, r2);
    }
  }
}

// transposed layer 1 at input (p, i) of one [8][8] vector
__device__ __forceinline__ float conv1_t(const float* d, const float* w1, int p, int i) {
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
    acc = fmaf(w[W1S], a.y, acc);
    acc = fmaf(w[2 * W1S], a.z, acc);
    acc = fmaf(w[3 * W1S], a.w, acc);
    acc = fmaf(w[4 * W1S], b.x, acc);
    acc = fmaf(w[5 * W1S], b.y, acc);
    acc = fmaf(w[6 * W1S], b.z, acc);
    acc = fmaf(w[7 * W1S], b.w, acc);
  }
  return acc;
}

template <bool BF16>
__global__ void __launch_bounds__(NT, BLOCKS_PER_SM) critic_grad_kernel(Args a) {
  __shared__ float s_w1[8 * W1S], s_b1[8], s_w2[16 * W2S], s_b2[16], s_wd[16];
  __shared__ __align__(16) float s_tile[WPB * TILE];
  const int tid = threadIdx.x, l = tid & 31, warp = tid >> 5;
  for (int i = tid; i < 96; i += NT) s_w1[i / 12 * W1S + i % 12] = a.w1[i];
  for (int i = tid; i < 384; i += NT) s_w2[i / 24 * W2S + i % 24] = a.w2[i];
  if (tid < 8) s_b1[tid] = a.b1[tid];
  if (tid < 16) { s_b2[tid] = a.b2[tid]; s_wd[tid] = a.wd[tid]; }
  __syncthreads();

  float* T = s_tile + warp * TILE;
  float *sh = T + T_H, *sx1 = T + T_X1, *sdz2 = T + T_DZ2, *se2 = T + T_E2;
  float *sdz1 = T + T_DZ1, *se1 = T + T_E1, *sc = T + T_C, *sc1 = T + T_C1;
  const int t1a = l >> 3, t1b = t1a + 4, o1 = l & 7;   // layer-1 outputs l, l + 32
  const int t2a = l >> 4, t2b = t2a + 2, o2 = l & 15;  // layer-2 outputs l, l + 32
  const int pc = l >> 1, ic = l & 1;                   // the lane's candidate input
  const int i1 = l >> 3, h2 = l >> 4;  // its conv1.weight[o1][i1][:], conv2.weight[o2][4h2..][:]
  const float slope = a.slope, inv_b = rnd<BF16>(a.inv_b), wd = s_wd[o2];
  float rw1[12], rw2[24];  // the lane's output channels' weights, [i][k]
#pragma unroll
  for (int j = 0; j < 12; ++j) rw1[j] = s_w1[o1 * W1S + j];
#pragma unroll
  for (int j = 0; j < 24; ++j) rw2[j] = s_w2[o2 * W2S + j];

  float accW1[3], accW2[12];  // conv1.weight[o1][i1][k]; conv2.weight[o2][4 h2 + j][k] at 3j + k
#pragma unroll
  for (int m = 0; m < 3; ++m) accW1[m] = 0.0f;
#pragma unroll
  for (int m = 0; m < 12; ++m) accW2[m] = 0.0f;
  float accB1 = 0.0f;  // conv1.bias[l], lanes < 8
  float accV = 0.0f;   // conv2.bias[l] (l < 16), dense.weight[l - 16] (l >= 16)
  float yR = 0.0f, yF = 0.0f, gpS = 0.0f;  // the same in every lane

  for (int f = blockIdx.x * WPB + warp; f < a.B; f += gridDim.x * WPB) {
    __syncwarp();  // the previous frame's reads of the tile are done
    const float cl = load(a.clean, f, pc, ic), fk = load(a.fake, f, pc, ic);
    const float ns = load(a.noisy, f, pc, ic), al = a.alpha[f];
    const float nr = rnd<BF16>(ns);
    sh[pc * 4 + ic] = rnd<BF16>(cl);
    sh[64 + pc * 4 + ic] = rnd<BF16>(fk);
    sh[128 + pc * 4 + ic] = rnd<BF16>(al * cl + (1.0f - al) * fk);
    sh[pc * 4 + 2 + ic] = nr;
    sh[64 + pc * 4 + 2 + ic] = nr;
    sh[128 + pc * 4 + 2 + ic] = nr;
    __syncwarp();

    // forward, layer 1
    float x1a[3], x1b[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float za = conv1<4>(sh + 64 * r, rw1, t1a) + s_b1[o1];
      const float zb = conv1<4>(sh + 64 * r, rw1, t1b) + s_b1[o1];
      x1a[r] = za * mask(za, slope);
      x1b[r] = zb * mask(zb, slope);
      sx1[64 * r + l] = rnd<BF16>(x1a[r]);
      sx1[64 * r + 32 + l] = rnd<BF16>(x1b[r]);
    }
    __syncwarp();

    // forward, layer 2; scores; Wasserstein dz2 = dy * w * m2; e2 = m2 * w
    float x2a[3], x2b[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float za = conv2(sx1 + 64 * r, rw2, t2a) + s_b2[o2];
      const float zb = conv2(sx1 + 64 * r, rw2, t2b) + s_b2[o2];
      x2a[r] = za * mask(za, slope);
      x2b[r] = zb * mask(zb, slope);
    }
    // lanes l and l ^ 16 hold the same channel at the other two positions
    float poolR = x2a[0] + x2b[0], poolF = x2a[1] + x2b[1];
    if constexpr (BF16) {  // the dense layer reads the pooled vector rounded
      poolR = rnd<BF16>(poolR + __shfl_xor_sync(FULL, poolR, 16));
      poolF = rnd<BF16>(poolF + __shfl_xor_sync(FULL, poolF, 16));
      yR += warp_sum(l < 16 ? poolR * wd : 0.0f);
      yF += warp_sum(l < 16 ? poolF * wd : 0.0f);
    } else {
      yR += warp_sum(poolR * wd);
      yF += warp_sum(poolF * wd);
    }
    const float m2Ia = mask(x2a[2], slope), m2Ib = mask(x2b[2], slope);
    const float dRa = -inv_b * wd * mask(x2a[0], slope), dRb = -inv_b * wd * mask(x2b[0], slope);
    const float dFa = inv_b * wd * mask(x2a[1], slope), dFb = inv_b * wd * mask(x2b[1], slope);
    sdz2[l] = rnd<BF16>(dRa);
    sdz2[32 + l] = rnd<BF16>(dRb);
    sdz2[64 + l] = rnd<BF16>(dFa);
    sdz2[96 + l] = rnd<BF16>(dFb);
    se2[l] = rnd<BF16>(m2Ia * wd);
    se2[32 + l] = rnd<BF16>(m2Ib * wd);
    {
      float sb = (dRa + dRb) + (dFa + dFb);
      sb += __shfl_xor_sync(FULL, sb, 16);
      float sw = inv_b * (poolF - poolR);
      if constexpr (!BF16) sw += __shfl_xor_sync(FULL, sw, 16);  // BF16: whole channels
      accV += l < 16 ? sb : sw;
    }
    __syncwarp();

    // transposed layer 2: dz1 = (dz2 W2^T) * m1, e1 = m1 * (e2 W2^T)
    float dz1Ra, dz1Fa, e1a, dz1Rb, dz1Fb, e1b;
    conv2_t(sdz2, sdz2 + 64, se2, s_w2, t1a, o1, dz1Ra, dz1Fa, e1a);
    conv2_t(sdz2, sdz2 + 64, se2, s_w2, t1b, o1, dz1Rb, dz1Fb, e1b);
    dz1Ra *= mask(x1a[0], slope);
    dz1Fa *= mask(x1a[1], slope);
    e1a *= mask(x1a[2], slope);
    dz1Rb *= mask(x1b[0], slope);
    dz1Fb *= mask(x1b[1], slope);
    e1b *= mask(x1b[2], slope);
    sdz1[l] = rnd<BF16>(dz1Ra);
    sdz1[32 + l] = rnd<BF16>(dz1Rb);
    sdz1[64 + l] = rnd<BF16>(dz1Fa);
    sdz1[96 + l] = rnd<BF16>(dz1Fb);
    se1[l] = rnd<BF16>(e1a);
    se1[32 + l] = rnd<BF16>(e1b);
    {  // lanes l, l ^ 8, l ^ 16, l ^ 24 hold the same channel
      float s = (dz1Ra + dz1Rb) + (dz1Fa + dz1Fb);
      s += __shfl_xor_sync(FULL, s, 8);
      s += __shfl_xor_sync(FULL, s, 16);
      if (l < 8) accB1 += s;
    }
    __syncwarp();

    // penalty: g = dy/dh0 at the interpolate on the candidate inputs (one
    // per lane), n = |g|, c = 2 lambda (n - 1) / (n B) * g
    const float g = conv1_t(se1, s_w1, pc, ic);
    const float n = sqrtf(warp_sum(g * g) + 1e-12f);
    sc[l] = rnd<BF16>((a.gp_coef * (n - 1.0f)) / n * g);
    gpS += (n - 1.0f) * (n - 1.0f);
    __syncwarp();

    // c1 = (c W1) * m1 on the interpolate
    sc1[l] = rnd<BF16>(conv1<2>(sc, rw1, t1a) * mask(x1a[2], slope));
    sc1[32 + l] = rnd<BF16>(conv1<2>(sc, rw1, t1b) * mask(x1b[2], slope));
    __syncwarp();

    {  // dense.weight += pool(c2 * m2), c2 = c1 W2
      float s = conv2(sc1, rw2, t2a) * m2Ia + conv2(sc1, rw2, t2b) * m2Ib;
      s += __shfl_xor_sync(FULL, s, 16);
      if (l >= 16) accV += rnd<BF16>(s);
    }

    // conv1.weight[o1][i1][k] += sum_t dz1[t][o1] h0[2t-1+k][i1] (real, fake)
    //                            + c[2t-1+k][i1] e1[t][o1] (candidate inputs)
    {
      float dR[8], dF[8], dE[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        dR[t] = sdz1[t * 8 + o1];
        dF[t] = sdz1[64 + t * 8 + o1];
        dE[t] = se1[t * 8 + o1];
      }
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        const float hR = sh[p * 4 + i1], hF = sh[64 + p * 4 + i1];
        const float cv = i1 < 2 ? sc[p * 2 + i1] : 0.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int t2 = p + 1 - k;  // 2 t
          if ((t2 & 1) || t2 < 0 || t2 >= 16) continue;
          const int t = t2 >> 1;
          accW1[k] = fmaf(dR[t], hR, accW1[k]);
          accW1[k] = fmaf(dF[t], hF, accW1[k]);
          accW1[k] = fmaf(cv, dE[t], accW1[k]);
        }
      }
    }
    // conv2.weight[o2][i][k] += sum_t dz2[t][o2] x1[2t-1+k][i] (real, fake)
    //                           + e2[t][o2] c1[2t-1+k][i], for i = 4 h2 + j
    {
      float dR[4], dF[4], dE[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        dR[t] = sdz2[t * 16 + o2];
        dF[t] = sdz2[64 + t * 16 + o2];
        dE[t] = se2[t * 16 + o2];
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 xR = *reinterpret_cast<const float4*>(sx1 + q * 8 + 4 * h2);
        const float4 xF = *reinterpret_cast<const float4*>(sx1 + 64 + q * 8 + 4 * h2);
        const float4 xc = *reinterpret_cast<const float4*>(sc1 + q * 8 + 4 * h2);
        const float vR[4] = {xR.x, xR.y, xR.z, xR.w}, vF[4] = {xF.x, xF.y, xF.z, xF.w};
        const float vc[4] = {xc.x, xc.y, xc.z, xc.w};
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int t2 = q + 1 - k;  // 2 t
          if ((t2 & 1) || t2 < 0 || t2 >= 8) continue;
          const int t = t2 >> 1;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float& acc = accW2[3 * j + k];
            acc = fmaf(dR[t], vR[j], acc);
            acc = fmaf(dF[t], vF[j], acc);
            acc = fmaf(dE[t], vc[j], acc);
          }
        }
      }
    }
  }

  // the block's sums: warps in warp order, into this block's slot
  __syncthreads();
  float* red = s_tile + warp * SLOT;
#pragma unroll
  for (int k = 0; k < 3; ++k) red[OUT_W1 + o1 * 12 + i1 * 3 + k] = accW1[k];
#pragma unroll
  for (int m = 0; m < 12; ++m) red[OUT_W2 + o2 * 24 + 12 * h2 + m] = accW2[m];
  if (l < 8) red[OUT_B1 + l] = accB1;
  red[OUT_B2 + l] = accV;  // conv2.bias then dense.weight
  if (l < SLOT - OUT_BD) red[OUT_BD + l] = l == 1 ? yR : l == 2 ? yF : l == 3 ? gpS : 0.0f;
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
__global__ void __launch_bounds__(SUM_WARPS * 32) critic_grad_sum_kernel(Args a) {
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
  // this block holds the sums of y_real, y_fake and (n - 1)^2
  const int m = OUT_SUMS % 32;
  const float y_real = __shfl_sync(FULL, t, m), y_fake = __shfl_sync(FULL, t, m + 1);
  const float gp_sum = __shfl_sync(FULL, t, m + 2);
  if (l == 0) {
    const float bd = *a.bd;
    const float d_real = y_real * a.inv_b + bd, d_fake = y_fake * a.inv_b + bd;
    const float gp = gp_sum * a.inv_b;
    a.out[OUT_SUMS] = d_fake - d_real + a.gp_weight * gp;
    a.out[OUT_SUMS + 1] = d_real - d_fake;
    a.out[OUT_SUMS + 2] = gp;
    a.out[OUT_SUMS + 3] = d_real;
    a.out[OUT_SUMS + 4] = d_fake;
  }
}

}  // namespace

// Blocks for a batch of B frames on a card with `sms` SMs; the scratch
// buffer holds one slot per block.
extern "C" int ofdm_critic_grad_blocks(int B, int sms) {
  const int n = (B + WPB - 1) / WPB, cap = sms * BLOCKS_PER_SM;
  return n < cap ? n : cap;
}

extern "C" int ofdm_critic_grad_slot_floats() { return SLOT; }

extern "C" int ofdm_critic_grad_out_floats() { return N_OUT; }

// Launches both stages on `stream`; `bf16` selects bf16 matmul precision
// (the weights `w1`, `w2`, `wd` then arrive rounded to bfloat16).
extern "C" int ofdm_critic_grad_launch(
    int B, int nblocks, float slope, float gp_weight, int bf16,
    const void* clean, long long c_sb, long long c_st, long long c_sc,
    const void* fake, long long f_sb, long long f_st, long long f_sc,
    const void* noisy, long long n_sb, long long n_st, long long n_sc,
    const void* alpha, const void* w1, const void* b1, const void* w2, const void* b2,
    const void* wd, const void* bd, void* scratch, void* out, void* stream) {
  if (B <= 0 || nblocks <= 0) return (int)cudaErrorInvalidValue;
  Args a;
  a.B = B;
  a.nblocks = nblocks;
  a.slope = slope;
  a.gp_weight = gp_weight;
  a.gp_coef = 2.0f * gp_weight / (float)B;
  a.inv_b = 1.0f / (float)B;
  a.clean = Frames{(const float*)clean, c_sb, c_st, c_sc};
  a.fake = Frames{(const float*)fake, f_sb, f_st, f_sc};
  a.noisy = Frames{(const float*)noisy, n_sb, n_st, n_sc};
  a.alpha = (const float*)alpha;
  a.w1 = (const float*)w1;
  a.b1 = (const float*)b1;
  a.w2 = (const float*)w2;
  a.b2 = (const float*)b2;
  a.wd = (const float*)wd;
  a.bd = (const float*)bd;
  a.slots = (float*)scratch;
  a.out = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    critic_grad_kernel<true><<<nblocks, NT, 0, s>>>(a);
  else
    critic_grad_kernel<false><<<nblocks, NT, 0, s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  critic_grad_sum_kernel<<<(SLOT + 31) / 32, SUM_WARPS * 32, 0, s>>>(a);
  return (int)cudaGetLastError();
}
