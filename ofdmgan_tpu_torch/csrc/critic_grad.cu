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
// 736 for layer 1 and 1,408 for layer 2 per product): 0.0391 ms at B =
// 65,536. The TPU kernel worked on dense 64 x 64 block-Toeplitz matrices
// made for its matrix unit, 3.7x the work; here only the taps are walked,
// t_in = 2 t_out - 1 + k.
//
// What limits it in practice, by count (ncu does not run on the card's
// machine: its counter library does not load): shared-memory loads. A
// warp's 16-byte load takes four passes of the shared-memory pipe however
// many lanes read one address, so a lane's floats loaded a frame cost about
// that many cycles of an SM's pipe. A one-frame-a-warp design that loaded
// ~700 of them a frame (its transposed products half idle) took 172 us a
// call at B = 65,536, ~690 cycles of an SM a frame; this one loads ~410
// and takes 104-107 us, ~420 cycles a frame, at 36-37 % of the bound,
// while its multiply-adds need ~160. Two blocks of 4 warps an SM, 255
// registers; ptxas spills nothing at two frames a warp and 16-60 bytes at
// one. The sweep (scripts/critic_kernel_sweep.py; 2, 3 or 4 blocks of 4
// warps, 1 or 2 of 8, padded rows or not) read 100-115 us at two frames a
// warp and 109-128 at one, so the block shape is not the limit.
//
// Design: a warp owns F frames at a time (F = 2 where the batch fills the
// card with two frames a warp, else 1: at 64 frames one frame a warp takes
// 5.96 us and two 6.93, as a warp's two frames take longer than one and
// the card has warps to spare), each with its real/fake/interpolate
// triple (they share the condition), and walks them through seven phases
// together, so that one shared-memory weight read, one __syncwarp and one
// shuffle serve every frame in flight and the frames' independent chains
// fill each other's latency. Each lane owns one channel at two adjacent
// positions of each layer: layer 1 channel l % 8 at positions 2 (l / 8) and
// 2 (l / 8) + 1, layer 2 channel l % 16 at 2 (l / 16) and 2 (l / 16) + 1.
// It keeps that channel's 12 + 24 weights in registers for every forward
// product, of all three rows and of the penalty chain, and its two
// positions share a tap row, so a row-pair reads five tap rows, not six.
// The transposed products need the weights by input channel: they read them
// from shared memory in that layout as 16-byte vectors, one vector feeding
// 4 x 3 x F multiply-adds (the registers hold no room for their 48 + 24).
// Positions are paired even with odd, so every tap is the same for all
// lanes of a warp: no lane idles on a tap that misses its position.
// Activations move between lanes through a 4.56 KB tile per frame (36.5 KB
// a block at two frames a warp), read as 16-byte vectors, with __syncwarp,
// never __syncthreads; each activation has a zero row where a tap falls off
// the frame (t_in = -1, or a transposed tap past the last position), so no
// tap takes a branch. The leaky mask of a layer is read from the sign of its
// pre-activation.
//
// The weight gradients are summed where their operands already are: every
// lane keeps, in registers across a grid-stride loop over frames, the sums
// of conv1.weight[o][:][:] and conv2.weight[o][:][:] of its channels over
// its own two positions (12 + 24 sums), fed by the cotangents it computed
// and the tap rows its forward and penalty products just read. The
// Wasserstein cotangents add into conv2.weight inside the layer-2 forward
// and into conv1.weight beside the transposed layer 2; the penalty's into
// both inside its own products. The biases, the pooled scores and the dense
// weight are summed per lane too; after the loop the lanes of a channel add
// their sums with shuffles in a fixed order. A block then adds its warps in
// warp order in shared memory and writes one 528-float slot. A second
// kernel, launched on the same stream by the same entry point, sums the
// slots: its block x owns entries 32x..32x+31 of a slot, each of its 8 warps
// adds a fixed run of slots in slot order, then warp 0 adds the warps in
// order and writes the gradients and metrics. Every sum is in a fixed
// order, so the result is deterministic for a given B and card. float32
// FMA on CUDA cores only: no TF32, no tensor cores. A frame slot past B
// computes on zero frames with dy = 0 and a zero penalty coefficient, so it
// adds exact zeros to every sum, and its scores and penalty are left out.
//
// bf16 matmul precision (the step's matmul_precision="bfloat16", the
// instantiation BF16 = true): every operand of a conv, a transposed conv, a
// weight-gradient sum and the dense layer is rounded to bfloat16, as the
// autograd route computes it under ops/bf16_dots.py, and the products are
// summed in float32 (a product of two bf16 values is exact in float32).
// The host passes the three weight tensors rounded; the kernel rounds the
// activations and cotangents where it makes them for the products: h0,
// the layer-1 activations, dz2, e2, dz1, e1, c and c1, the pooled layer-2
// activations of the score and of the Wasserstein dense gradient, the
// penalty's pooled dense gradient and dy = 1/B. The bias gradients sum
// unrounded values, as autograd's do.
//
// Storage format (the reference's act_dtype="bfloat16" step, the
// instantiations S = __nv_bfloat16): clean and noisy arrive in bfloat16,
// fake and alpha in float32, as the reference's step hands them to its
// kernel (the generator's output is float32 whatever the batch's storage).
// Each bf16 value is widened to float32 where it is loaded, which is exact,
// and the frame is then the float32 kernel's: no cast pass before the
// launch, and a frame reads 2 * 64 + 128 + 4 = 260 bytes in place of 388.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WPB = 4;                 // warps per block
constexpr int NT = WPB * 32;
constexpr int BLOCKS_PER_SM = 2;
constexpr int SUM_WARPS = 8;           // second stage: warps per block
constexpr int W2T = 20;                // padded stride of the transposed conv2 weights
// output buffer, in named_parameters() order, then the metrics
constexpr int OUT_W1 = 0, OUT_B1 = 96, OUT_W2 = 104, OUT_B2 = 488, OUT_WD = 504, OUT_BD = 520,
              OUT_SUMS = 521, N_OUT = 526, SLOT = 528;
// A frame's tile, in floats: "1 +" is a zero row before position 0, "+ 1"
// one after the last. Row strides are padded past the channels so that the
// lanes' stores of a row pair fall in distinct banks.
constexpr int X1S = 12, D2S = 24, E1S = 12;
constexpr int H_ROWS = (1 + 16) * 4, X1_ROWS = (1 + 8) * X1S, D2_ROWS = (4 + 1) * D2S;
constexpr int T_H = 0,                    // h0 of real, fake, interpolate [3][1 + 16 pos][4 ch]
    T_X1 = T_H + 3 * H_ROWS,              // layer-1 activations [3][1 + 8][8 of X1S]
    T_D2 = T_X1 + 3 * X1_ROWS,            // dz2 of real, fake and e2 = m2 * w [3][4 + 1][16 of D2S]
    T_E1 = T_D2 + 3 * D2_ROWS,            // e1 [8 + 1][8 of E1S]
    T_C = T_E1 + (8 + 1) * E1S,           // penalty c on the candidate inputs [1 + 16][2], padded
    T_C1 = T_C + 36,                      // c1 [1 + 8][8 of X1S]
    TILE = T_C1 + X1_ROWS;
static_assert(SLOT <= TILE, "the block reduction reuses the tiles");
constexpr unsigned FULL = 0xffffffffu;

template <typename S>
struct Frames {
  const S* p;
  long long sb, st, sc;  // element strides of batch, time, component
};

// what both stages read
struct Common {
  int B, nblocks;
  float slope, gp_weight, gp_coef, inv_b;  // gp_coef = 2 * gp_weight / B
  const float *alpha, *w1, *b1, *w2, *b2, *wd, *bd;
  float *slots, *out;  // slots: [nblocks][SLOT]
};

// the first stage's: clean and noisy in the storage type S, fake in float32
template <typename S>
struct Args : Common {
  Frames<S> clean, noisy;
  Frames<float> fake;
};

__device__ __forceinline__ float mask(float x, float slope) { return x > 0.0f ? 1.0f : slope; }

// x rounded to the nearest bfloat16 under BF16, else x
template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename S>
__device__ __forceinline__ float load(const Frames<S>& fr, int f, int t, int c) {
  return widen(fr.p[f * fr.sb + t * fr.st + c * fr.sc]);
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }

// acc + w . x, in component order
__device__ __forceinline__ float dot4(float4 w, float4 x, float acc) {
  acc = fmaf(w.x, x.x, acc);
  acc = fmaf(w.y, x.y, acc);
  acc = fmaf(w.z, x.z, acc);
  return fmaf(w.w, x.w, acc);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// layer 1 at one output without bias, from the lane's weights w[3i + k] =
// conv1.weight[o][i][k] and the output's three tap rows v[j0 + k] of h0
__device__ __forceinline__ float conv1(const float (&w)[12], const float4 (&v)[5], int j0) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float4 x = v[j0 + k];
    acc = fmaf(w[k], x.x, acc);
    acc = fmaf(w[3 + k], x.y, acc);
    acc = fmaf(w[6 + k], x.z, acc);
    acc = fmaf(w[9 + k], x.w, acc);
  }
  return acc;
}

// the same on the candidate-only penalty vector c (two input channels)
__device__ __forceinline__ float conv1c(const float (&w)[12], const float2 (&v)[5], int j0) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    acc = fmaf(w[k], v[j0 + k].x, acc);
    acc = fmaf(w[3 + k], v[j0 + k].y, acc);
  }
  return acc;
}

// layer 2 at one output without bias, from w[3i + k] = conv2.weight[o][i][k]
// and the tap rows lo[j0 + k] (channels 0-3), hi[j0 + k] (4-7)
__device__ __forceinline__ float conv2(const float (&w)[24], const float4 (&lo)[5],
                                       const float4 (&hi)[5], int j0) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float4 a = lo[j0 + k], b = hi[j0 + k];
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

// acc[3i + k] += d_a x[2 t_a - 1 + k][i] + d_b x[2 t_b - 1 + k][i]: a weight
// gradient at the lane's two positions, from their five tap rows
__device__ __forceinline__ void wgrad1(float (&acc)[12], const float4 (&v)[5], float da, float db) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float d = h ? db : da;
      const float4 x = v[2 * h + k];
      acc[k] = fmaf(d, x.x, acc[k]);
      acc[3 + k] = fmaf(d, x.y, acc[3 + k]);
      acc[6 + k] = fmaf(d, x.z, acc[6 + k]);
      acc[9 + k] = fmaf(d, x.w, acc[9 + k]);
    }
  }
}

__device__ __forceinline__ void wgrad2(float (&acc)[24], const float4 (&lo)[5],
                                       const float4 (&hi)[5], float da, float db) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float d = h ? db : da;
      const float4 a = lo[2 * h + k], b = hi[2 * h + k];
      acc[k] = fmaf(d, a.x, acc[k]);
      acc[3 + k] = fmaf(d, a.y, acc[3 + k]);
      acc[6 + k] = fmaf(d, a.z, acc[6 + k]);
      acc[9 + k] = fmaf(d, a.w, acc[9 + k]);
      acc[12 + k] = fmaf(d, b.x, acc[12 + k]);
      acc[15 + k] = fmaf(d, b.y, acc[15 + k]);
      acc[18 + k] = fmaf(d, b.z, acc[18 + k]);
      acc[21 + k] = fmaf(d, b.w, acc[21 + k]);
    }
  }
}

// a per-frame value of frame fr (a lane's own frame in the penalty phase)
template <int F>
__device__ __forceinline__ float of_frame(const float (&v)[F], int fr) {
  if constexpr (F == 2) return fr ? v[1] : v[0];
  return v[0];
}

template <int F, bool BF16, typename S>
__global__ void __launch_bounds__(NT, BLOCKS_PER_SM) critic_grad_kernel(Args<S> a) {
  __shared__ __align__(16) float s_w2t[8 * 3 * W2T];  // conv2.weight[o][i][k] at (3i + k) W2T + o
  __shared__ __align__(16) float s_w1t[2 * 3 * 8];    // conv1.weight[o][i][k], i < 2, at (3i + k) 8 + o
  extern __shared__ __align__(16) float s_tile[];     // a warp's F tiles; then the block's sums
  const int tid = threadIdx.x, l = tid & 31, warp = tid >> 5;
  for (int i = tid; i < 384; i += NT) s_w2t[(i % 24) * W2T + i / 24] = a.w2[i];
  for (int i = tid; i < 96; i += NT)
    if (i % 12 < 6) s_w1t[(i % 12) * 8 + i / 12] = a.w1[i];
  float* T = s_tile + warp * F * TILE;
  for (int i = l; i < F * TILE; i += 32) T[i] = 0.0f;  // the zero rows are never written again

  const int o1 = l & 7, m1 = l >> 3;   // layer 1: channel o1 at positions 2 m1, 2 m1 + 1
  const int o2 = l & 15, m2 = l >> 4;  // layer 2: channel o2 at positions 2 m2, 2 m2 + 1
  const int pc = l >> 1, ic = l & 1;   // the sample and component the lane loads
  // penalty: candidate channel ic at inputs 2 mp, 2 mp + 1 of frame fr (with
  // F = 1 lanes l and l ^ 2 compute the same, and the first writes it)
  const int mp = l >> 2, fr = F == 2 ? (l >> 1) & 1 : 0;
  const bool c_writer = F == 2 || !((l >> 1) & 1);
  const float slope = a.slope, inv_b = rnd<BF16>(a.inv_b);
  const float b1 = a.b1[o1], b2 = a.b2[o2], wd = a.wd[o2];
  float rw1[12], rw2[24];  // the lane's output channels' weights, [i][k]
#pragma unroll
  for (int j = 0; j < 12; ++j) rw1[j] = a.w1[o1 * 12 + j];
#pragma unroll
  for (int j = 0; j < 24; ++j) rw2[j] = a.w2[o2 * 24 + j];

  // sums over the lane's positions: conv1.weight[o1][i][k], conv2.weight[o2][i][k] at 3i + k
  float accW1[12], accW2[24];
#pragma unroll
  for (int j = 0; j < 12; ++j) accW1[j] = 0.0f;
#pragma unroll
  for (int j = 0; j < 24; ++j) accW2[j] = 0.0f;
  float accB1 = 0.0f, accB2 = 0.0f;   // conv1.bias[o1], conv2.bias[o2]
  float accWd = 0.0f;                 // dense.weight[o2]
  float poolR = 0.0f, poolF = 0.0f;   // pooled layer-2 activations of real and fake
  float gpS = 0.0f;                   // sum of (n - 1)^2, the same in every lane
  __syncthreads();

  for (int g = blockIdx.x * WPB + warp; g * F < a.B; g += gridDim.x * WPB) {
    bool ok[F];            // a frame, not a slot past B
    float dy[F], gpc[F];   // 1/B and 2 gp_weight / B, 0 on a slot past B
    __syncwarp();          // the previous frames' reads of the tiles are done
#pragma unroll
    for (int s = 0; s < F; ++s) {
      const int f = g * F + s;
      ok[s] = f < a.B;
      dy[s] = ok[s] ? inv_b : 0.0f;
      gpc[s] = ok[s] ? a.gp_coef : 0.0f;
      float cl = 0.0f, fk = 0.0f, ns = 0.0f, al = 0.0f;
      if (ok[s]) {
        cl = load(a.clean, f, pc, ic);
        fk = load(a.fake, f, pc, ic);
        ns = load(a.noisy, f, pc, ic);
        al = a.alpha[f];
      }
      float* h = T + s * TILE + T_H + (pc + 1) * 4;
      const float nr = rnd<BF16>(ns);
      h[ic] = rnd<BF16>(cl);
      h[H_ROWS + ic] = rnd<BF16>(fk);
      h[2 * H_ROWS + ic] = rnd<BF16>(al * cl + (1.0f - al) * fk);
      h[2 + ic] = nr;
      h[H_ROWS + 2 + ic] = nr;
      h[2 * H_ROWS + 2 + ic] = nr;
    }
    __syncwarp();

    // forward, layer 1, at the lane's positions; tap rows 4 m1 .. 4 m1 + 4
    float mk1[F][3][2];
#pragma unroll
    for (int s = 0; s < F; ++s) {
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const float* h = T + s * TILE + T_H + r * H_ROWS + 16 * m1;
        float4 v[5];
#pragma unroll
        for (int j = 0; j < 5; ++j) v[j] = ld4(h + 4 * j);
        const float za = conv1(rw1, v, 0) + b1, zb = conv1(rw1, v, 2) + b1;
        mk1[s][r][0] = mask(za, slope);
        mk1[s][r][1] = mask(zb, slope);
        float* x = T + s * TILE + T_X1 + r * X1_ROWS + (2 * m1 + 1) * X1S + o1;
        x[0] = rnd<BF16>(za * mk1[s][r][0]);
        x[X1S] = rnd<BF16>(zb * mk1[s][r][1]);
      }
    }
    __syncwarp();

    // forward, layer 2; pooled scores; the Wasserstein dz2 = dy * w * m2, its
    // share of conv2.weight and conv2.bias; e2 = m2 * w on the interpolate
    float mk2[F][2];
#pragma unroll
    for (int s = 0; s < F; ++s) {
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const float* x = T + s * TILE + T_X1 + r * X1_ROWS + 4 * X1S * m2;
        float4 lo[5], hi[5];
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          lo[j] = ld4(x + X1S * j);
          hi[j] = ld4(x + X1S * j + 4);
        }
        const float za = conv2(rw2, lo, hi, 0) + b2, zb = conv2(rw2, lo, hi, 2) + b2;
        const float ma = mask(za, slope), mb = mask(zb, slope);
        float* d = T + s * TILE + T_D2 + r * D2_ROWS + 2 * D2S * m2 + o2;
        if (r == 2) {
          mk2[s][0] = ma;
          mk2[s][1] = mb;
          d[0] = rnd<BF16>(ma * wd);
          d[D2S] = rnd<BF16>(mb * wd);
          continue;
        }
        const float sg = r == 0 ? -dy[s] : dy[s];   // dy: -1/B on real, 1/B on fake
        const float da = sg * wd * ma, db = sg * wd * mb;
        const float ra = rnd<BF16>(da), rb = rnd<BF16>(db);
        d[0] = ra;
        d[D2S] = rb;
        accB2 += da + db;
        // lanes l and l ^ 16 hold the channel's other two positions
        float pool = za * ma + zb * mb;
        if constexpr (BF16) pool = rnd<BF16>(pool + __shfl_xor_sync(FULL, pool, 16));
        if (ok[s]) (r == 0 ? poolR : poolF) += pool;
        accWd += sg * pool;   // dense.weight: dy * pool
        wgrad2(accW2, lo, hi, ra, rb);   // dz2[t][o2] x1[2t - 1 + k][i]
      }
    }
    __syncwarp();

    // transposed layer 2 at the lane's layer-1 positions: dz1 = (dz2 W2^T) * m1,
    // e1 = m1 * (e2 W2^T); the even position takes tap 1 from row m1, the odd
    // taps 0 and 2 from rows m1 + 1 and m1. dz1's share of conv1.weight and
    // conv1.bias.
    float e1[F][2];
    {
      float ev[F][3], od[F][3];
#pragma unroll
      for (int s = 0; s < F; ++s)
#pragma unroll
        for (int v = 0; v < 3; ++v) ev[s][v] = od[s][v] = 0.0f;
      const float* w = s_w2t + 3 * o1 * W2T;
#pragma unroll
      for (int o4 = 0; o4 < 16; o4 += 4) {
        const float4 w0 = ld4(w + o4), w1 = ld4(w + W2T + o4), w2 = ld4(w + 2 * W2T + o4);
#pragma unroll
        for (int s = 0; s < F; ++s) {
#pragma unroll
          for (int v = 0; v < 3; ++v) {
            const float* d = T + s * TILE + T_D2 + v * D2_ROWS + D2S * m1 + o4;
            const float4 row = ld4(d), next = ld4(d + D2S);
            ev[s][v] = dot4(w1, row, ev[s][v]);
            od[s][v] = dot4(w2, row, dot4(w0, next, od[s][v]));
          }
        }
      }
#pragma unroll
      for (int s = 0; s < F; ++s) {
        const float dRe = ev[s][0] * mk1[s][0][0], dRo = od[s][0] * mk1[s][0][1];
        const float dFe = ev[s][1] * mk1[s][1][0], dFo = od[s][1] * mk1[s][1][1];
        e1[s][0] = rnd<BF16>(ev[s][2] * mk1[s][2][0]);
        e1[s][1] = rnd<BF16>(od[s][2] * mk1[s][2][1]);
        float* e = T + s * TILE + T_E1 + 2 * E1S * m1 + o1;
        e[0] = e1[s][0];
        e[E1S] = e1[s][1];
        accB1 += (dRe + dRo) + (dFe + dFo);
        // dz1[t][o1] h0[2t - 1 + k][i] of real and fake: tap rows 4 m1 .. 4 m1 + 4
        const float* h = T + s * TILE + T_H + 16 * m1;
        float4 vR[5], vF[5];
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          vR[j] = ld4(h + 4 * j);
          vF[j] = ld4(h + H_ROWS + 4 * j);
        }
        wgrad1(accW1, vR, rnd<BF16>(dRe), rnd<BF16>(dRo));
        wgrad1(accW1, vF, rnd<BF16>(dFe), rnd<BF16>(dFo));
      }
    }
    __syncwarp();

    // penalty: g = dy/dh0 at the interpolate on the candidate inputs, n = |g|,
    // c = 2 lambda (n - 1) / (n B) * g; lane: inputs 2 mp (tap 1 of row mp)
    // and 2 mp + 1 (taps 0 and 2 of rows mp + 1 and mp) of channel ic
    {
      const float* e = T + fr * TILE + T_E1 + E1S * mp;
      const float4 r0 = ld4(e), r1 = ld4(e + 4), n0 = ld4(e + E1S), n1 = ld4(e + E1S + 4);
      const float* w = s_w1t + 24 * ic;
      const float ge = dot4(ld4(w + 12), r1, dot4(ld4(w + 8), r0, 0.0f));
      const float go = dot4(ld4(w + 20), r1, dot4(ld4(w + 16), r0,
                            dot4(ld4(w + 4), n1, dot4(ld4(w), n0, 0.0f))));
      float ss = fmaf(go, go, ge * ge);
      ss += __shfl_xor_sync(FULL, ss, 1);   // the lanes of frame fr
      ss += __shfl_xor_sync(FULL, ss, 4);
      ss += __shfl_xor_sync(FULL, ss, 8);
      ss += __shfl_xor_sync(FULL, ss, 16);
      const float n = sqrtf(ss + 1e-12f);
      const float coef = (of_frame<F>(gpc, fr) * (n - 1.0f)) / n;
      if (c_writer) {
        float* c = T + fr * TILE + T_C + (2 * mp + 1) * 2 + ic;
        c[0] = rnd<BF16>(coef * ge);
        c[2] = rnd<BF16>(coef * go);
      }
      if constexpr (F == 2) {   // (n - 1)^2 in frame order
        const float other = __shfl_xor_sync(FULL, n, 2);
        const float na = fr ? other : n, nb = fr ? n : other;
        if (ok[0]) gpS += (na - 1.0f) * (na - 1.0f);
        if (ok[1]) gpS += (nb - 1.0f) * (nb - 1.0f);
      } else if (ok[0]) {
        gpS += (n - 1.0f) * (n - 1.0f);
      }
    }
    __syncwarp();

    // c1 = (c W1) * m1 on the interpolate at the lane's layer-1 positions, and
    // c[2t - 1 + k][i] e1[t][o1] into conv1.weight (i < 2): tap rows 4 m1 .. 4 m1 + 4
#pragma unroll
    for (int s = 0; s < F; ++s) {
      const float* c = T + s * TILE + T_C + 8 * m1;
      float2 cv[5];
#pragma unroll
      for (int j = 0; j < 5; ++j) cv[j] = ld2(c + 2 * j);
      float* x = T + s * TILE + T_C1 + (2 * m1 + 1) * X1S + o1;
      x[0] = rnd<BF16>(conv1c(rw1, cv, 0) * mk1[s][2][0]);
      x[X1S] = rnd<BF16>(conv1c(rw1, cv, 2) * mk1[s][2][1]);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          accW1[k] = fmaf(cv[2 * h + k].x, e1[s][h], accW1[k]);
          accW1[3 + k] = fmaf(cv[2 * h + k].y, e1[s][h], accW1[3 + k]);
        }
      }
    }
    __syncwarp();

    // c2 = c1 W2 at the lane's layer-2 positions: dense.weight += pool(c2 * m2),
    // and e2[t][o2] c1[2t - 1 + k][i] into conv2.weight: tap rows 4 m2 .. 4 m2 + 4
#pragma unroll
    for (int s = 0; s < F; ++s) {
      const float* x = T + s * TILE + T_C1 + 4 * X1S * m2;
      float4 lo[5], hi[5];
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        lo[j] = ld4(x + X1S * j);
        hi[j] = ld4(x + X1S * j + 4);
      }
      float sd = conv2(rw2, lo, hi, 0) * mk2[s][0] + conv2(rw2, lo, hi, 2) * mk2[s][1];
      if constexpr (BF16) sd = rnd<BF16>(sd + __shfl_xor_sync(FULL, sd, 16));
      accWd += sd;
      wgrad2(accW2, lo, hi, rnd<BF16>(mk2[s][0] * wd), rnd<BF16>(mk2[s][1] * wd));
    }
  }

  // the lanes of a channel add their positions' sums: layer 1 over l ^ 8,
  // l ^ 16, layer 2 over l ^ 16 (under BF16 the dense weight's pooled terms
  // are whole channels already, the same in both lanes)
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    accW1[j] += __shfl_xor_sync(FULL, accW1[j], 8);
    accW1[j] += __shfl_xor_sync(FULL, accW1[j], 16);
  }
  accB1 += __shfl_xor_sync(FULL, accB1, 8);
  accB1 += __shfl_xor_sync(FULL, accB1, 16);
#pragma unroll
  for (int j = 0; j < 24; ++j) accW2[j] += __shfl_xor_sync(FULL, accW2[j], 16);
  accB2 += __shfl_xor_sync(FULL, accB2, 16);
  if constexpr (!BF16) accWd += __shfl_xor_sync(FULL, accWd, 16);
  float yR, yF;  // sums of the scores without the dense bias
  if constexpr (BF16) {  // the dense layer reads the rounded pooled vector
    yR = warp_sum(l < 16 ? poolR * wd : 0.0f);
    yF = warp_sum(l < 16 ? poolF * wd : 0.0f);
  } else {
    yR = warp_sum(poolR * wd);
    yF = warp_sum(poolF * wd);
  }

  // the block's sums: warps in warp order, into this block's slot
  __syncthreads();
  float* red = s_tile + warp * SLOT;
  if (m1 == 0) {
#pragma unroll
    for (int j = 0; j < 12; ++j) red[OUT_W1 + o1 * 12 + j] = accW1[j];
    red[OUT_B1 + o1] = accB1;
  }
  if (m2 == 0) {
#pragma unroll
    for (int j = 0; j < 24; ++j) red[OUT_W2 + o2 * 24 + j] = accW2[j];
    red[OUT_B2 + o2] = accB2;
    red[OUT_WD + o2] = accWd;
  }
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
__global__ void __launch_bounds__(SUM_WARPS * 32) critic_grad_sum_kernel(Common a) {
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

// a block's tiles at F frames a warp, in dynamic shared memory
template <int F>
constexpr int tile_bytes() {
  constexpr int bytes = WPB * F * TILE * (int)sizeof(float);
  static_assert(bytes <= 48 * 1024, "a block's tiles fit the default dynamic shared memory");
  return bytes;
}

// the first stage with F frames a warp
template <int F, bool BF16, typename S>
cudaError_t first_stage(const Args<S>& a, cudaStream_t s) {
  auto kernel = critic_grad_kernel<F, BF16, S>;
  kernel<<<a.nblocks, NT, tile_bytes<F>(), s>>>(a);
  return cudaGetLastError();
}

// both stages, with clean and noisy read as S
template <typename S>
int launch(const Common& c, int frames, int bf16, const void* clean, const long long* cs,
           const void* noisy, const long long* ns, const Frames<float>& fake, cudaStream_t s) {
  Args<S> a;
  static_cast<Common&>(a) = c;
  a.clean = Frames<S>{(const S*)clean, cs[0], cs[1], cs[2]};
  a.noisy = Frames<S>{(const S*)noisy, ns[0], ns[1], ns[2]};
  a.fake = fake;
  cudaError_t err;
  if (frames == 2)
    err = bf16 ? first_stage<2, true>(a, s) : first_stage<2, false>(a, s);
  else
    err = bf16 ? first_stage<1, true>(a, s) : first_stage<1, false>(a, s);
  if (err != cudaSuccess) return (int)err;
  critic_grad_sum_kernel<<<(SLOT + 31) / 32, SUM_WARPS * 32, 0, s>>>(c);
  return (int)cudaGetLastError();
}

// resident blocks an SM of the first stage at F frames a warp (float32)
template <int F>
int blocks_per_sm() {
  auto kernel = critic_grad_kernel<F, false, float>;
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, NT, tile_bytes<F>()) ==
                 cudaSuccess ? n : -1;
}

}  // namespace

// Resident blocks an SM of the per-block kernel at `frames` frames a warp,
// by the CUDA occupancy calculator; -1 where it fails.
extern "C" int ofdm_critic_grad_blocks_per_sm(int frames) {
  return frames == 2 ? blocks_per_sm<2>() : blocks_per_sm<1>();
}

// Frames a warp for a batch of B frames on a card with `sms` SMs: two where
// two frames a warp still fill every warp the card holds, else one.
extern "C" int ofdm_critic_grad_frames_per_warp(int B, int sms) {
  return B >= 2 * sms * BLOCKS_PER_SM * WPB ? 2 : 1;
}

// Blocks for a batch of B frames at `frames` frames a warp on a card with
// `sms` SMs; the scratch buffer holds one slot per block.
extern "C" int ofdm_critic_grad_blocks(int B, int sms, int frames) {
  const int warps = (B + frames - 1) / frames;
  const int n = (warps + WPB - 1) / WPB, cap = sms * BLOCKS_PER_SM;
  return n < cap ? n : cap;
}

extern "C" int ofdm_critic_grad_slot_floats() { return SLOT; }

extern "C" int ofdm_critic_grad_out_floats() { return N_OUT; }

// Launches both stages on `stream`; `frames` (1 or 2) the frames a warp,
// `bf16` selects bf16 matmul precision (the weights `w1`, `w2`, `wd` then
// arrive rounded to bfloat16), `storage` the element type of `clean` and
// `noisy`: 0 float32, 1 bfloat16 (`fake` and `alpha` are float32 either way).
extern "C" int ofdm_critic_grad_launch(
    int B, int nblocks, int frames, float slope, float gp_weight, int bf16, int storage,
    const void* clean, long long c_sb, long long c_st, long long c_sc,
    const void* fake, long long f_sb, long long f_st, long long f_sc,
    const void* noisy, long long n_sb, long long n_st, long long n_sc,
    const void* alpha, const void* w1, const void* b1, const void* w2, const void* b2,
    const void* wd, const void* bd, void* scratch, void* out, void* stream) {
  if (B <= 0 || nblocks <= 0 || frames < 1 || frames > 2 || storage < 0 || storage > 1)
    return (int)cudaErrorInvalidValue;
  Common c;
  c.B = B;
  c.nblocks = nblocks;
  c.slope = slope;
  c.gp_weight = gp_weight;
  c.gp_coef = 2.0f * gp_weight / (float)B;
  c.inv_b = 1.0f / (float)B;
  c.alpha = (const float*)alpha;
  c.w1 = (const float*)w1;
  c.b1 = (const float*)b1;
  c.w2 = (const float*)w2;
  c.b2 = (const float*)b2;
  c.wd = (const float*)wd;
  c.bd = (const float*)bd;
  c.slots = (float*)scratch;
  c.out = (float*)out;
  const long long cs[3] = {c_sb, c_st, c_sc}, ns[3] = {n_sb, n_st, n_sc};
  const Frames<float> fk{(const float*)fake, f_sb, f_st, f_sc};
  cudaStream_t s = (cudaStream_t)stream;
  if (storage == 1) return launch<__nv_bfloat16>(c, frames, bf16, clean, cs, noisy, ns, fk, s);
  return launch<float>(c, frames, bf16, clean, cs, noisy, ns, fk, s);
}
