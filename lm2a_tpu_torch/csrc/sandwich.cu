// Fused anti-aliased Snake sandwich for Hopper (sm_90a):
//   z = downsample2x(snake_{alpha,beta}(upsample2x(x)))
//
// Replaces the Pallas TPU kernel lm2a_tpu/vocoder/pallas_sandwich.py:
// _sandwich_kernel (fused_snake_sandwich), the BigVGAN anti-alias
// activation that runs 109 times per vocode at the 22 kHz / 80-band width.
//
// Polyphase algebra (12 Kaiser-sinc taps f, unit DC gain, passed in from
// the host):
//   y_even[p] = 2 sum_a f[2a]   x[clamp(p + a - 3)]
//   y_odd[p]  = 2 sum_a f[2a+1] x[clamp(p + a - 2)]
//   s = y + sin(alpha y)^2 / (beta + 1e-9)
//   z[t] = sum_a f[2a] s_odd[t + a - 3] + sum_a f[2a+1] s_even[t + a - 2]
// with the downsampler's edge clamp on the interleaved signal: a phase index
// p < 0 reads s[0] = snake(y_even[0]) and p >= T reads s[2T-1] =
// snake(y_odd[T-1]), for both phases (pallas_sandwich.py:71-83).
//
// Bound on the H100: bytes. Each output reads one input and writes one
// output (4 bytes in bf16) for ~60 fp32 operations, far under the card's
// operations-per-byte ridge. So the kernel reads x once and writes z once:
// one block takes SBT = 2048 outputs of one channel, stages the input with a
// halo of 6 per side (edge-clamped) in shared memory, computes the phases it
// needs there once, and runs the down filter from shared memory. All
// arithmetic is fp32. Tensors are addressed through strides, so the
// vocoder's channels-first activations are read along time, coalesced.
// Every sandwich of the 22 kHz vocoder moves only ~6 MB, so the time goes to
// memory latency, not bandwidth: each thread issues all of its loads (nine)
// before any is used, and a tile of 2048 keeps the grid to one or two waves
// of blocks at every vocoder stage.

#include "common.cuh"

namespace {

constexpr int NT = 256;           // threads per block
constexpr int PER = 8;            // outputs per thread
constexpr int SBT = NT * PER;     // outputs per block
constexpr int HALO = 6;           // input reach of up + down filters per side
constexpr int NX = SBT + 2 * HALO;  // staged inputs
constexpr int NPH = SBT + 6;      // even/odd phases the outputs read

// the 12 taps by value: they sit in the kernel's parameter bank, which the
// FMAs read directly, with no load per use
struct Taps {
  float f[12];
};

template <typename T>
__global__ void __launch_bounds__(NT)
snake_sandwich_kernel(const T* __restrict__ x, T* __restrict__ z,
                      const float* __restrict__ alpha, const float* __restrict__ beta,
                      const Taps taps, int Tlen, long long sxb,
                      long long sxt, long long sxc, long long szb, long long szt,
                      long long szc) {
  __shared__ float xs[NX];
  __shared__ float se[NPH], so[NPH];
  const int t0 = blockIdx.x * SBT, c = blockIdx.y, b = blockIdx.z;
  const int n = min(SBT, Tlen - t0);  // outputs of this block
  const T* xp = x + b * sxb + c * sxc;
  // xs[j] = x[clamp(t0 - HALO + j)]; so X(g) below is x[clamp(g)] for any g
  // the phases of this block need
#pragma unroll
  for (int r = 0; r < (NX + NT - 1) / NT; ++r) {
    const int j = threadIdx.x + r * NT;
    if (j < n + 2 * HALO) {
      const int g = min(max(t0 - HALO + j, 0), Tlen - 1);
      xs[j] = to_f(xp[g * sxt]);
    }
  }
  __syncthreads();

  const float al = alpha[c], be = beta[c];
  auto X = [&](int g) { return xs[g - t0 + HALO]; };
  auto y_even = [&](int p) {
    float acc = 0.f;
#pragma unroll
    for (int a = 0; a < 6; ++a) acc += (2.f * taps.f[2 * a]) * X(p + a - 3);
    return acc;
  };
  auto y_odd = [&](int p) {
    float acc = 0.f;
#pragma unroll
    for (int a = 0; a < 6; ++a) acc += (2.f * taps.f[2 * a + 1]) * X(p + a - 2);
    return acc;
  };
  auto snake = [&](float v) {
    const float s = sinf(al * v);
    return v + s * s / (be + 1e-9f);
  };

  // phases p = t0 - 3 + j, j in [0, n + 6)
  for (int j = threadIdx.x; j < n + 6; j += NT) {
    const int p = t0 - 3 + j;
    float ve, vo;
    if (p < 0) {
      ve = vo = snake(y_even(0));
    } else if (p >= Tlen) {
      ve = vo = snake(y_odd(Tlen - 1));
    } else {
      ve = snake(y_even(p));
      vo = snake(y_odd(p));
    }
    se[j] = ve;
    so[j] = vo;
  }
  __syncthreads();

  T* zp = z + b * szb + c * szc;
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int j = threadIdx.x + r * NT;
    if (j >= n) break;
    float lo = 0.f, hi = 0.f;
#pragma unroll
    for (int a = 0; a < 6; ++a) lo += taps.f[2 * a] * so[j + a];  // s_odd[t + a - 3]
#pragma unroll
    for (int a = 0; a < 6; ++a) hi += taps.f[2 * a + 1] * se[j + a + 1];  // s_even[t + a - 2]
    zp[(t0 + j) * szt] = from_f<T>(lo + hi);
  }
}

}  // namespace

extern "C" int lm2a_snake_sandwich(const void* x, void* z, int is_f32,
                                   const float* alpha, const float* beta,
                                   const float* taps, int B, int T, int C,
                                   long long sxb, long long sxt, long long sxc,
                                   long long szb, long long szt, long long szc,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Taps tp;
  for (int i = 0; i < 12; ++i) tp.f[i] = taps[i];
  dim3 grid((T + SBT - 1) / SBT, C, B);
  if (is_f32)
    snake_sandwich_kernel<float><<<grid, NT, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(z), alpha, beta, tp, T,
        sxb, sxt, sxc, szb, szt, szc);
  else
    snake_sandwich_kernel<bf16><<<grid, NT, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<bf16*>(z), alpha, beta, tp, T,
        sxb, sxt, sxc, szb, szt, szc);
  return (int)cudaGetLastError();
}
