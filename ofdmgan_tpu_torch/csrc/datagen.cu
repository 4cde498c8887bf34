// Synthetic OFDM training frames, one thread per frame.
//
// Replaces the Pallas TPU kernel synthetic_batch_pallas
// (ofdmgan_tpu/ops/pallas_datagen.py:200, body :110-197) and the joint
// max-normalisation that follows it (:273). Per frame: Philox normals ->
// CN(0,1) spectrum -> inverse DFT * sqrt(L) -> optionally Rapp PA, IQ
// imbalance and Wiener phase noise -> per-frame power of the distorted signal
// -> SNR ~ U(snr_min, snr_max) -> AWGN -> joint max-normalisation of
// (noisy, clean). The clean target is the pre-impairment frame.
//
// What bounds it on the H100: the bytes it writes (2 * L * 2 floats of frames
// plus two floats per frame; nothing is read in Philox mode). The L-point DFT
// is L^2 complex multiply-adds per frame, far below the card's float32 rate
// at L = 16.
//
// Design: the TPU packs 128/L frames per 128-lane row and does the IDFT and
// the phase-noise prefix sum as block-diagonal matmuls on its matrix unit.
// None of that carries over: here a frame lives in one thread's registers
// (L is a template parameter, so every array index is static), the IDFT is a
// direct sum with twiddles in __constant__ memory, and the Wiener phase is a
// running sum. Random numbers come from a counter-based Philox4x32-10 keyed
// by the seed (a fresh one for every call) and counted by (frame, stream,
// index), so every frame's draws are independent of the launch shape. One
// SNR uniform is drawn per frame (the TPU drew one per sample and kept the
// first: the same distribution).
// Stores are 16-byte vectors; coalescing them through shared memory is left
// for a later change.
//
// Injected-draws mode: when zr is non-null the kernel reads the standard
// normals zr, zi, pn, nr, ni [B, L] and the uniforms u [B] instead of
// drawing them, so that it can be held exactly against its plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxL = 32;
constexpr float kTwoPi = 6.283185307179586f;
// cos and sin of 2 pi j / 32, rounded to float32; an L-point twiddle
// 2 pi m / L is entry m * (32 / L) for every L that divides 32
__constant__ float c_cos[kMaxL] = {
    1.0f, 0.980785251f, 0.923879504f, 0.831469595f, 0.707106769f, 0.555570245f,
    0.382683426f, 0.195090324f, 6.12323426e-17f, -0.195090324f, -0.382683426f,
    -0.555570245f, -0.707106769f, -0.831469595f, -0.923879504f, -0.980785251f,
    -1.0f, -0.980785251f, -0.923879504f, -0.831469595f, -0.707106769f, -0.555570245f,
    -0.382683426f, -0.195090324f, -1.83697015e-16f, 0.195090324f, 0.382683426f,
    0.555570245f, 0.707106769f, 0.831469595f, 0.923879504f, 0.980785251f};
__constant__ float c_sin[kMaxL] = {
    0.0f, 0.195090324f, 0.382683426f, 0.555570245f, 0.707106769f, 0.831469595f,
    0.923879504f, 0.980785251f, 1.0f, 0.980785251f, 0.923879504f, 0.831469595f,
    0.707106769f, 0.555570245f, 0.382683426f, 0.195090324f, 1.22464685e-16f,
    -0.195090324f, -0.382683426f, -0.555570245f, -0.707106769f, -0.831469595f,
    -0.923879504f, -0.980785251f, -1.0f, -0.980785251f, -0.923879504f, -0.831469595f,
    -0.707106769f, -0.555570245f, -0.382683426f, -0.195090324f};

struct Params {
  int B;
  int nonlinear;
  const unsigned long long* seed;  // [1], Philox mode
  float snr_min, snr_max;
  float pa_inv_sat2, pa_p, iq_g, iq_cos, iq_sin, pn_sigma;
  const float *zr, *zi, *pn, *nr, *ni, *u;  // injected draws (or all null)
  float *noisy, *clean, *snr, *scale;
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// (0, 1) uniform from 32 random bits: the 23 top bits, offset by half a step,
// as the TPU kernel's _uniform01 does.
__device__ __forceinline__ float uniform01(unsigned bits) {
  return (float)(bits >> 9) * (1.0f / 8388608.0f) + (0.5f / 8388608.0f);
}

// Box-Muller: two independent standard normals from two uniforms.
__device__ __forceinline__ void box_muller(unsigned b1, unsigned b2, float& n1, float& n2) {
  const float r = sqrtf(-2.0f * logf(uniform01(b1)));
  const float a = kTwoPi * uniform01(b2);
  n1 = r * cosf(a);
  n2 = r * sinf(a);
}

// L/2 Philox calls give L complex normals: (re[k], im[k]) for k < L.
template <int L>
__device__ __forceinline__ void philox_pairs(uint2 key, unsigned f, unsigned stream,
                                             float* re, float* im) {
#pragma unroll
  for (int i = 0; i < L / 2; ++i) {
    const uint4 b = philox4x32_10(make_uint4(f, 0u, stream, (unsigned)i), key);
    box_muller(b.x, b.y, re[2 * i], im[2 * i]);
    box_muller(b.z, b.w, re[2 * i + 1], im[2 * i + 1]);
  }
}

template <int L>
__device__ __forceinline__ void load_row(const float* src, int f, float* dst) {
  const float4* s = reinterpret_cast<const float4*>(src + (size_t)f * L);
#pragma unroll
  for (int i = 0; i < L / 4; ++i) {
    const float4 v = s[i];
    dst[4 * i] = v.x; dst[4 * i + 1] = v.y; dst[4 * i + 2] = v.z; dst[4 * i + 3] = v.w;
  }
}

// Interleaved I/Q frame [L, 2] scaled by 1/m, as float4 stores.
template <int L>
__device__ __forceinline__ void store_iq(float* dst, int f, const float* re,
                                         const float* im, float m) {
  float4* d = reinterpret_cast<float4*>(dst + (size_t)f * 2 * L);
#pragma unroll
  for (int i = 0; i < L / 2; ++i)
    d[i] = make_float4(re[2 * i] / m, im[2 * i] / m, re[2 * i + 1] / m, im[2 * i + 1] / m);
}

template <int L>
__global__ void __launch_bounds__(128) datagen_kernel(Params p) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= p.B) return;
  const bool injected = p.zr != nullptr;
  uint2 key = make_uint2(0u, 0u);
  if (!injected) {
    const unsigned long long s = *p.seed;
    key = make_uint2((unsigned)s, (unsigned)(s >> 32));
  }

  // spectrum: standard normals; the 1/sqrt(2) of CN(0,1) and the
  // sqrt(L)/L of ifft*sqrt(L) are one scale after the sum
  float zr[L], zi[L];
  if (injected) {
    load_row<L>(p.zr, f, zr);
    load_row<L>(p.zi, f, zi);
  } else {
    philox_pairs<L>(key, (unsigned)f, 0u, zr, zi);
  }
  const float idft_scale = 1.0f / sqrtf(2.0f * L);
  float cr[L], ci[L];
#pragma unroll
  for (int t = 0; t < L; ++t) {
    float ar = 0.0f, ai = 0.0f;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int m = (t * k) % L * (kMaxL / L);
      const float c = c_cos[m], s = c_sin[m];
      ar += zr[k] * c - zi[k] * s;
      ai += zr[k] * s + zi[k] * c;
    }
    cr[t] = ar * idft_scale;
    ci[t] = ai * idft_scale;
  }

  float xr[L], xi[L];
#pragma unroll
  for (int t = 0; t < L; ++t) { xr[t] = cr[t]; xi[t] = ci[t]; }
  if (p.nonlinear) {
    float w[L];
    if (injected) {
      load_row<L>(p.pn, f, w);
    } else {
      float w2[L];
      philox_pairs<L / 2>(key, (unsigned)f, 1u, w, w2);
#pragma unroll
      for (int i = 0; i < L / 2; ++i) w[L / 2 + i] = w2[i];
    }
    float theta = 0.0f;
#pragma unroll
    for (int t = 0; t < L; ++t) {
      // Rapp PA: gain = (1 + (|x|^2/A^2)^p)^(-1/(2p))
      const float a2 = (xr[t] * xr[t] + xi[t] * xi[t]) * p.pa_inv_sat2;
      const float up = p.pa_p == 3.0f ? a2 * a2 * a2
                                      : expf(p.pa_p * logf(fmaxf(a2, 1e-30f)));
      const float gain = expf(-0.5f / p.pa_p * log1pf(up));
      const float gr = xr[t] * gain, gi = xi[t] * gain;
      // IQ imbalance: Q' = g (cos(phi) Q + sin(phi) I)
      const float qi = p.iq_g * (p.iq_cos * gi + p.iq_sin * gr);
      // Wiener phase noise: theta is the running sum of the increments
      theta += p.pn_sigma * w[t];
      const float c = cosf(theta), s = sinf(theta);
      xr[t] = gr * c - qi * s;
      xi[t] = gr * s + qi * c;
    }
  }

  float power = 0.0f;
#pragma unroll
  for (int t = 0; t < L; ++t) power += xr[t] * xr[t] + xi[t] * xi[t];
  power *= 1.0f / L;

  float u, nr[L], ni[L];
  if (injected) {
    u = p.u[f];
    load_row<L>(p.nr, f, nr);
    load_row<L>(p.ni, f, ni);
  } else {
    u = uniform01(philox4x32_10(make_uint4((unsigned)f, 0u, 3u, 0u), key).x);
    philox_pairs<L>(key, (unsigned)f, 2u, nr, ni);
  }
  const float snr = p.snr_min + (p.snr_max - p.snr_min) * u;
  // 10^(-snr/10) as exp2(-snr * log2(10) / 10), as the TPU kernel does
  const float sigma_n = sqrtf(power * exp2f(-snr * 0.33219280948873623f) * 0.5f);
  float m = 1e-12f;
#pragma unroll
  for (int t = 0; t < L; ++t) {
    xr[t] += sigma_n * nr[t];
    xi[t] += sigma_n * ni[t];
    m = fmaxf(m, fmaxf(fmaxf(fabsf(xr[t]), fabsf(xi[t])), fmaxf(fabsf(cr[t]), fabsf(ci[t]))));
  }
  store_iq<L>(p.noisy, f, xr, xi, m);
  store_iq<L>(p.clean, f, cr, ci, m);
  p.snr[f] = snr;
  p.scale[f] = m;
}

template <int L>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int threads = 128;
  datagen_kernel<L><<<(p.B + threads - 1) / threads, threads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ofdm_datagen_launch(
    int B, int L, int nonlinear, const void* seed, float snr_min, float snr_max,
    float pa_inv_sat2, float pa_p, float iq_g, float iq_cos, float iq_sin, float pn_sigma,
    const void* zr, const void* zi, const void* pn, const void* nr, const void* ni,
    const void* u, void* noisy, void* clean, void* snr, void* scale, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  if (zr == nullptr ? seed == nullptr
                    : (zi == nullptr || nr == nullptr || ni == nullptr || u == nullptr ||
                       (nonlinear && pn == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p{B, nonlinear, (const unsigned long long*)seed, snr_min, snr_max,
           pa_inv_sat2, pa_p, iq_g, iq_cos, iq_sin, pn_sigma,
           (const float*)zr, (const float*)zi, (const float*)pn,
           (const float*)nr, (const float*)ni, (const float*)u,
           (float*)noisy, (float*)clean, (float*)snr, (float*)scale};
  cudaStream_t s = (cudaStream_t)stream;
  switch (L) {
    case 8: return (int)launch<8>(p, s);
    case 16: return (int)launch<16>(p, s);
    case 32: return (int)launch<32>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
