// Synthetic OFDM training frames, one lane per two consecutive samples.
//
// Replaces the Pallas TPU kernel synthetic_batch_pallas
// (ofdmgan_tpu/ops/pallas_datagen.py:200, body :110-197) and the joint
// max-normalisation that follows it (:273). Per frame: Philox normals ->
// CN(0,1) spectrum -> inverse DFT * sqrt(L) -> optionally Rapp PA, IQ
// imbalance and Wiener phase noise -> per-frame power of the distorted signal
// -> SNR ~ U(snr_min, snr_max) -> AWGN -> joint max-normalisation of
// (noisy, clean). The clean target is the pre-impairment frame. Frame
// lengths: every L that the TPU kernel's _pack takes (the divisors of 128,
// the multiples of 128) from 2 up to 1024.
//
// What bounds it on the H100: the bytes it writes (2 * L * 2 floats of
// frames plus two floats per frame; nothing is read in Philox mode), at
// every length. An inverse DFT needs about 5 L log2 L operations a frame
// (FFT-structured), which stays below the bytes' time. The direct sum below
// does 8 L^2 a frame, the same order as the TPU kernel's basis matmul: at
// L <= 64 that still costs less than the stores, but at L = 1024 (8.4 MFLOP
// a frame, 160x an FFT's count) it makes the kernel operation-limited far
// above its bound.
//
// Design: the TPU packs 128/L frames per 128-lane row and does the IDFT and
// the phase-noise prefix sum as block-diagonal matmuls on its matrix unit.
// Here lane i of a frame owns samples 2i and 2i + 1, so a frame spans L/2
// lanes: 128/(L/2) frames per 128-thread block up to L = 64 (L a template
// parameter, up to 16 blocks per SM, each walking its frames grid-stride
// with the twiddles loaded once), one frame per block of L/2 threads from
// L = 128. The spectrum goes to shared memory. The inverse DFT is a direct
// sum over k, ascending, with twiddles from an L-entry float32 table (built
// on the host in float64, antisymmetric: tw[m + L/2] = -tw[m] exactly) that
// the plain version uses too; lane i sums samples i and i + L/2, which share
// every twiddle up to sign, and the clean frame goes through shared memory
// to the lanes that own the sample pairs. The Wiener phase is an exclusive scan of the
// lanes' increment pairs (__shfl_up_sync inside a warp, shared memory across
// warps); the frame's power and joint max are shuffle reductions over the
// same lanes. Lane i stores its two I/Q pairs of noisy and of clean as one
// 16-byte vector each, so a warp writes consecutive addresses; snr and scale
// are stored by the frame's lane 0.
//
// Random numbers: counter-based Philox4x32-10 keyed by a per-call seed and
// counted by (frame, 0, stream, index), so a frame's draws do not depend on
// the launch shape. Streams 0 (spectrum) and 2 (channel noise): lane i makes
// call i, whose two Box-Muller pairs are its two complex samples. Stream 1
// (phase-noise increments, L reals) keeps the layout of one call per four
// reals: call j gives re[2j], im[2j], re[2j+1], im[2j+1], and sample t takes
// re[t] for t < L/2 and im[t - L/2] after. Lanes i < L/4 make the calls and
// pass the imaginary halves to lanes i + L/4 through shared memory; no call
// is made twice. Stream 3 call 0, made by lane 0, is the frame's SNR uniform.
//
// Injected-draws mode: when zr is non-null the kernel reads the standard
// normals zr, zi, pn, nr, ni [B, L] and the uniforms u [B] instead of
// drawing them, so that it can be held exactly against its plain version.

#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxL = 1024;
constexpr int kSmallThreads = 128;  // threads per block up to L = 64
constexpr int kBlocksPerSM = 16;    // resident blocks per SM up to L = 64
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  int B, L, nonlinear;
  const unsigned long long* seed;  // [1], Philox mode
  float snr_min, snr_max;
  float pa_inv_sat2, pa_p, iq_g, iq_cos, iq_sin, pn_sigma;
  const float2* tw;                          // [L]: cos, sin of 2 pi m / L
  const float *zr, *zi, *pn, *nr, *ni, *u;   // injected draws (or all null)
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

// Box-Muller: two independent standard normals from two uniforms. The
// radius uses the hardware log2 and reciprocal square root (a few ulp; the
// draws are random numbers, held to their distribution), and the angle
// 2 pi u goes in as u: sincospif needs no range reduction. At the top
// uniform, 1 - 2^-24, |log2 u| is below __log2f's absolute error, so the
// log can come out 0 or positive: e is clamped at 0 and the square root
// taken of at least FLT_MIN, which gives a radius of 0, never a NaN.
__device__ __forceinline__ float2 box_muller(unsigned b1, unsigned b2) {
  const float e = fmaxf(-1.3862943611198906f * __log2f(uniform01(b1)), 0.0f);  // -2 ln(u)
  const float r = e * rsqrtf(fmaxf(e, FLT_MIN));
  float s, c;
  sincospif(2.0f * uniform01(b2), &s, &c);
  return make_float2(r * c, r * s);
}

// The frame's lanes: all P of them in one warp (P <= 32, `multi` false) or
// P / 32 whole warps of one block. Every thread of the block calls these.
struct Frame {
  int P, lane, warp, nwarps;
  bool multi;
  float* red;  // [32] shared scratch, one entry per warp
};

__device__ __forceinline__ float frame_sum(const Frame& fr, float v) {
  const int w = fr.multi ? 32 : fr.P;
  for (int o = w >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  if (!fr.multi) return v;
  __syncthreads();
  if (fr.lane == 0) fr.red[fr.warp] = v;
  __syncthreads();
  float s = 0.0f;
  for (int i = 0; i < fr.nwarps; ++i) s += fr.red[i];
  return s;
}

__device__ __forceinline__ float frame_max(const Frame& fr, float v) {
  const int w = fr.multi ? 32 : fr.P;
  for (int o = w >> 1; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  if (!fr.multi) return v;
  __syncthreads();
  if (fr.lane == 0) fr.red[fr.warp] = v;
  __syncthreads();
  float m = fr.red[0];
  for (int i = 1; i < fr.nwarps; ++i) m = fmaxf(m, fr.red[i]);
  return m;
}

// sum of v over the frame's lanes before this one
__device__ __forceinline__ float frame_exclusive_scan(const Frame& fr, float v) {
  const int w = fr.multi ? 32 : fr.P, li = fr.lane % w;
  float incl = v;
  for (int d = 1; d < w; d <<= 1) {
    const float y = __shfl_up_sync(FULL, incl, d, w);
    if (li >= d) incl += y;
  }
  float excl = __shfl_up_sync(FULL, incl, 1, w);
  if (li == 0) excl = 0.0f;
  if (!fr.multi) return excl;
  __syncthreads();
  if (fr.lane == 31) fr.red[fr.warp] = incl;
  __syncthreads();
  float off = 0.0f;
  for (int i = 0; i < fr.warp; ++i) off += fr.red[i];
  return off + excl;
}

// the value of the frame's lane 0
__device__ __forceinline__ float frame_broadcast(const Frame& fr, float v, int i) {
  if (!fr.multi) return __shfl_sync(FULL, v, 0, fr.P);
  __syncthreads();
  if (i == 0) fr.red[0] = v;
  __syncthreads();
  return fr.red[0];
}

// Rapp PA, IQ imbalance and the phase rotation of one sample
__device__ __forceinline__ void impair(const Params& p, float& xr, float& xi, float theta) {
  // Rapp PA: gain = (1 + (|x|^2/A^2)^p)^(-1/(2p))
  const float a2 = (xr * xr + xi * xi) * p.pa_inv_sat2;
  const float up = p.pa_p == 3.0f ? a2 * a2 * a2 : expf(p.pa_p * logf(fmaxf(a2, 1e-30f)));
  const float gain = expf(-0.5f / p.pa_p * log1pf(up));
  const float gr = xr * gain, gi = xi * gain;
  // IQ imbalance: Q' = g (cos(phi) Q + sin(phi) I)
  const float qi = p.iq_g * (p.iq_cos * gi + p.iq_sin * gr);
  const float c = cosf(theta), s = sinf(theta);
  xr = gr * c - qi * s;
  xi = gr * s + qi * c;
}

__device__ __forceinline__ void frame_sync(const Frame& fr) {
  if (fr.multi) __syncthreads();
  else __syncwarp();
}

// LT is the frame length where a frame fits in one warp (L <= 64), fixed at
// compile time; 0 for one frame per block (L >= 128), with L from p.L. A
// block loads the twiddle table once and walks its frames grid-stride.
template <int LT>
__global__ void __launch_bounds__(LT ? kSmallThreads : kMaxL / 2) datagen_kernel(Params p) {
  extern __shared__ float4 smem[];
  const int L = LT ? LT : p.L, P = L >> 1, tid = threadIdx.x;
  Frame fr;
  fr.P = P;
  fr.multi = LT == 0;
  fr.lane = tid & 31;
  fr.warp = tid >> 5;
  fr.nwarps = blockDim.x >> 5;
  const int fpb = LT ? kSmallThreads / P : 1;  // frames per block
  const int fb = LT ? tid / P : 0;             // frame within the block
  const int i = LT ? tid % P : tid;            // lane within the frame
  const int S = fpb * L;                       // samples per block
  float* sm = reinterpret_cast<float*>(smem);
  float2* xbuf = reinterpret_cast<float2*>(sm) + fb * L;          // its clean frame [L]
  float2* spec = reinterpret_cast<float2*>(sm + 2 * S) + fb * L;  // the frame's spectrum [L]
  float* winc = sm + 4 * S + fb * L;                              // its phase increments [L]
  float2* tbl = reinterpret_cast<float2*>(sm + 5 * S);            // twiddles [L]
  fr.red = sm + 5 * S + 2 * L;
  for (int m = tid; m < L; m += blockDim.x) tbl[m] = p.tw[m];
  __syncthreads();

  const bool injected = p.zr != nullptr;
  uint2 key = make_uint2(0u, 0u);
  if (!injected) {
    const unsigned long long s = *p.seed;
    key = make_uint2((unsigned)s, (unsigned)(s >> 32));
  }
  const int s0 = 2 * i;
  const int ngroups = (p.B + fpb - 1) / fpb;
  for (int grp = blockIdx.x; grp < ngroups; grp += gridDim.x) {
    const int f = grp * fpb + fb;
    const bool valid = f < p.B;
    const size_t row = (size_t)(valid ? f : 0) * L + s0;  // this lane's first sample
    frame_sync(fr);  // the previous frame's reads of the buffers are done

    // spectrum: standard normals; the 1/sqrt(2) of CN(0,1) and the
    // sqrt(L)/L of ifft*sqrt(L) are one scale after the sum
    float2 z0 = make_float2(0.0f, 0.0f), z1 = z0;
    if (injected) {
      if (valid) {
        const float2 r = *reinterpret_cast<const float2*>(p.zr + row);
        const float2 m = *reinterpret_cast<const float2*>(p.zi + row);
        z0 = make_float2(r.x, m.x);
        z1 = make_float2(r.y, m.y);
      }
    } else {
      const uint4 b = philox4x32_10(make_uint4((unsigned)f, 0u, 0u, (unsigned)i), key);
      z0 = box_muller(b.x, b.y);
      z1 = box_muller(b.z, b.w);
    }
    spec[s0] = z0;
    spec[s0 + 1] = z1;

    float w0 = 0.0f, w1 = 0.0f;  // phase-noise increments of the two samples
    if (p.nonlinear) {
      if (injected) {
        if (valid) {
          const float2 v = *reinterpret_cast<const float2*>(p.pn + row);
          w0 = v.x;
          w1 = v.y;
        }
      } else if (4 * i < L) {
        const uint4 b = philox4x32_10(make_uint4((unsigned)f, 0u, 1u, (unsigned)i), key);
        const float2 a = box_muller(b.x, b.y), c = box_muller(b.z, b.w);
        winc[s0] = a.x;
        if (s0 + 1 < P) winc[s0 + 1] = c.x;
        winc[P + s0] = a.y;
        if (P + s0 + 1 < L) winc[P + s0 + 1] = c.y;
      }
    }
    frame_sync(fr);
    if (p.nonlinear && !injected) {
      w0 = winc[s0];
      w1 = winc[s0 + 1];
    }

    // inverse DFT, summed over k ascending. The lane computes samples i and
    // i + L/2, whose twiddles differ only in sign at odd k (the table is
    // antisymmetric: tw[m + L/2] = -tw[m] exactly), so one table read serves
    // both; the clean frame then goes through shared memory to the lane that
    // owns each pair of samples.
    float ar0 = 0.0f, ai0 = 0.0f, ar1 = 0.0f, ai1 = 0.0f;
    int mt = 0;  // twiddle index i * k mod L
#pragma unroll
    for (int k = 0; k < L; k += 2) {
      const float2 za = spec[k], ca = tbl[mt];
      mt += i;
      if (LT) mt &= LT - 1;
      else if (mt >= L) mt -= L;
      const float2 zb = spec[k + 1], cb = tbl[mt];
      mt += i;
      if (LT) mt &= LT - 1;
      else if (mt >= L) mt -= L;
      const float ra = za.x * ca.x - za.y * ca.y, ia = za.x * ca.y + za.y * ca.x;
      const float rb = zb.x * cb.x - zb.y * cb.y, ib = zb.x * cb.y + zb.y * cb.x;
      ar0 += ra;
      ai0 += ia;
      ar1 += ra;
      ai1 += ia;
      ar0 += rb;
      ai0 += ib;
      ar1 -= rb;
      ai1 -= ib;
    }
    const float idft_scale = 1.0f / sqrtf(2.0f * L);
    xbuf[i] = make_float2(ar0 * idft_scale, ai0 * idft_scale);
    xbuf[i + P] = make_float2(ar1 * idft_scale, ai1 * idft_scale);
    frame_sync(fr);
    const float4 cx = reinterpret_cast<const float4*>(xbuf)[i];
    const float cr0 = cx.x, ci0 = cx.y, cr1 = cx.z, ci1 = cx.w;

    float xr0 = cr0, xi0 = ci0, xr1 = cr1, xi1 = ci1;
    if (p.nonlinear) {
      // Wiener phase noise: theta is the running sum of the increments
      const float d0 = p.pn_sigma * w0, d1 = p.pn_sigma * w1;
      const float theta0 = frame_exclusive_scan(fr, d0 + d1) + d0;
      impair(p, xr0, xi0, theta0);
      impair(p, xr1, xi1, theta0 + d1);
    }

    const float power =
        frame_sum(fr, (xr0 * xr0 + xi0 * xi0) + (xr1 * xr1 + xi1 * xi1)) * (1.0f / L);

    float u = 0.0f;
    float2 n0 = make_float2(0.0f, 0.0f), n1 = n0;
    if (injected) {
      if (valid) {
        u = p.u[f];
        const float2 r = *reinterpret_cast<const float2*>(p.nr + row);
        const float2 m = *reinterpret_cast<const float2*>(p.ni + row);
        n0 = make_float2(r.x, m.x);
        n1 = make_float2(r.y, m.y);
      }
    } else {
      if (i == 0) u = uniform01(philox4x32_10(make_uint4((unsigned)f, 0u, 3u, 0u), key).x);
      u = frame_broadcast(fr, u, i);
      const uint4 b = philox4x32_10(make_uint4((unsigned)f, 0u, 2u, (unsigned)i), key);
      n0 = box_muller(b.x, b.y);
      n1 = box_muller(b.z, b.w);
    }
    const float snr = p.snr_min + (p.snr_max - p.snr_min) * u;
    // 10^(-snr/10) as exp2(-snr * log2(10) / 10), as the TPU kernel does
    const float sigma_n = sqrtf(power * exp2f(-snr * 0.33219280948873623f) * 0.5f);
    xr0 += sigma_n * n0.x;
    xi0 += sigma_n * n0.y;
    xr1 += sigma_n * n1.x;
    xi1 += sigma_n * n1.y;
    float m = fmaxf(fmaxf(fmaxf(fabsf(xr0), fabsf(xi0)), fmaxf(fabsf(cr0), fabsf(ci0))),
                    fmaxf(fmaxf(fabsf(xr1), fabsf(xi1)), fmaxf(fabsf(cr1), fabsf(ci1))));
    m = fmaxf(frame_max(fr, m), 1e-12f);
    if (valid) {
      const float inv = 1.0f / m;
      reinterpret_cast<float4*>(p.noisy)[row >> 1] =
          make_float4(xr0 * inv, xi0 * inv, xr1 * inv, xi1 * inv);
      reinterpret_cast<float4*>(p.clean)[row >> 1] =
          make_float4(cr0 * inv, ci0 * inv, cr1 * inv, ci1 * inv);
      if (i == 0) {
        p.snr[f] = snr;
        p.scale[f] = m;
      }
    }
  }
}

// box_muller on given random words, for tests: out[i] from bits[2i], bits[2i + 1]
__global__ void box_muller_kernel(int n, const unsigned* bits, float2* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = box_muller(bits[2 * i], bits[2 * i + 1]);
}

template <int LT>
cudaError_t launch(const Params& p, int sms, cudaStream_t stream) {
  const int L = p.L, P = L / 2;
  const int threads = LT ? kSmallThreads : P;
  const int fpb = LT ? kSmallThreads / P : 1;
  const int ngroups = (p.B + fpb - 1) / fpb;
  // small frames: enough resident blocks to fill every SM, each walking
  // many frames; long frames: one block per frame
  const int cap = sms * kBlocksPerSM;
  const int blocks = LT ? (ngroups < cap ? ngroups : cap) : ngroups;
  const size_t smem = sizeof(float) * (5 * fpb * L + 2 * L + 32);
  datagen_kernel<LT><<<blocks, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// 1 when the kernel takes frames of L samples: the lengths the TPU kernel's
// _pack takes (divisors and multiples of 128), from 2 up to 1024
extern "C" int ofdm_datagen_supports(int L) {
  return L >= 2 && L <= kMaxL && (L <= 128 ? 128 % L == 0 : L % 128 == 0);
}

extern "C" int ofdm_datagen_launch(
    int B, int L, int sms, int nonlinear, const void* seed, float snr_min, float snr_max,
    float pa_inv_sat2, float pa_p, float iq_g, float iq_cos, float iq_sin, float pn_sigma,
    const void* tw, const void* zr, const void* zi, const void* pn, const void* nr,
    const void* ni, const void* u, void* noisy, void* clean, void* snr, void* scale,
    void* stream) {
  if (B <= 0 || sms <= 0 || !ofdm_datagen_supports(L) || tw == nullptr)
    return (int)cudaErrorInvalidValue;
  if (zr == nullptr ? seed == nullptr
                    : (zi == nullptr || nr == nullptr || ni == nullptr || u == nullptr ||
                       (nonlinear && pn == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p{B, L, nonlinear, (const unsigned long long*)seed, snr_min, snr_max,
           pa_inv_sat2, pa_p, iq_g, iq_cos, iq_sin, pn_sigma, (const float2*)tw,
           (const float*)zr, (const float*)zi, (const float*)pn,
           (const float*)nr, (const float*)ni, (const float*)u,
           (float*)noisy, (float*)clean, (float*)snr, (float*)scale};
  cudaStream_t s = (cudaStream_t)stream;
  switch (L) {
    case 2: return (int)launch<2>(p, sms, s);
    case 4: return (int)launch<4>(p, sms, s);
    case 8: return (int)launch<8>(p, sms, s);
    case 16: return (int)launch<16>(p, sms, s);
    case 32: return (int)launch<32>(p, sms, s);
    case 64: return (int)launch<64>(p, sms, s);
    default: return (int)launch<0>(p, sms, s);
  }
}

// The kernel's Box-Muller on n pairs of random words `bits` [n][2] (uint32)
// into `out` [n][2] (float32), for tests of the draws at chosen uniforms.
extern "C" int ofdm_datagen_box_muller(int n, const void* bits, void* out, void* stream) {
  if (n <= 0 || bits == nullptr || out == nullptr) return (int)cudaErrorInvalidValue;
  box_muller_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      n, (const unsigned*)bits, (float2*)out);
  return (int)cudaGetLastError();
}
