// Fused FiLM-resblock forward for Hopper (sm_90a), in two kernel functions.
//
// Replaces the Pallas TPU kernels of lm2a_tpu/ops/pallas_resblock.py:
// _resblock_kernel (fused_resblock_chain) and the split pair _half1_kernel /
// _half2_kernel (_fused_chain_split, the 2048->1024 up block). On the TPU the
// whole chain GN1+SiLU -> conv3 -> FiLM -> GN2+SiLU -> conv3 (+1x1 skip,
// +residual) stays in one core's VMEM, with the grid walking rows in order.
// On Hopper blocks run in parallel with no state carried between them, and
// GroupNorm reduces over all of T, so one design covers both TPU variants as
// four launches of the two functions below:
//
//   gn_stats(x)                      -> per (row, group) mean, rstd (fp32)
//   conv3_fused(x;  GN1+SiLU, FiLM)  -> f (fp32 intermediate, as _half1)
//   gn_stats(f)
//   conv3_fused(f;  GN2+SiLU, skip GEMM over x, residual) -> out (bf16)
//
// conv3_fused is an implicit GEMM, M = T rows of one batch row, N = Cout,
// K = 3*Cin (the three SAME-conv taps) plus an optional second K segment for
// the 1x1 skip over x. Its prologue applies GroupNorm + SiLU to each A tile
// as it is loaded and rounds to bf16; rows outside [0, T) are zero, because
// SAME padding comes after the activation. The weights are pre-arranged as
// (Cout, 3*Cin) so that each B tile is one contiguous run per output
// channel. bf16 tensor-core MMA (wmma 16x16x16) accumulates in fp32; the
// epilogue adds the bias and FiLM (conv 1) or skip bias and residual (conv 2).
//
// Bound on the H100: at the flagship widths (2-4 rows, T 64..516, C 256..2048)
// each conv does 0.2-3.3 GFLOP against a few MB of traffic, so it is bound by
// tensor-core operations; gn_stats is bound by bytes. This first version
// uses wmma with a register prefetch of the next K tile (global loads overlap
// the MMAs of the current one) and 64x64 output tiles; wgmma, TMA, and folding
// the GN2 partial sums into the conv-1 epilogue are later work.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

// ---------------------------------------------------------------- gn_stats
// One block per (group, row): fp32 sum and sum of squares over T x C/G,
// then fast variance E[x^2] - E[x]^2 as in the TPU kernel.
template <typename In>
__global__ void __launch_bounds__(1024)
gn_stats_kernel(const In* __restrict__ x, float* __restrict__ mean,
                float* __restrict__ rstd, int T, int C, int G, float eps) {
  const int g = blockIdx.x, b = blockIdx.y;
  const int cg = C / G;
  const In* xb = x + (size_t)b * T * C + (size_t)g * cg;
  const int n = T * cg;
  float s = 0.f, ss = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int t = i / cg, c = i - t * cg;
    const float v = to_f(xb[(size_t)t * C + c]);
    s += v;
    ss += v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  __shared__ float sh_s[32], sh_ss[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sh_s[warp] = s;
    sh_ss[warp] = ss;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    s = lane < nw ? sh_s[lane] : 0.f;
    ss = lane < nw ? sh_ss[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    if (lane == 0) {
      const float m = s / (float)n;
      const float var = ss / (float)n - m * m;
      mean[b * G + g] = m;
      rstd[b * G + g] = rsqrtf(var + eps);
    }
  }
}

// ------------------------------------------------------------- conv3_fused
constexpr int BM = 64;   // output rows (time) per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 32;   // K per tile; Cin % BK == 0 keeps a tile inside one tap
constexpr int LDS = BK + 8;  // bf16 smem row stride (multiple of 8, 80 bytes)
constexpr int LDC = BN + 4;  // fp32 epilogue row stride
constexpr int NTHREADS = 128;  // 4 warps, each a 32x32 quarter of the tile

struct ConvArgs {
  const void* a;       // (B, T, cin), bf16 or fp32: the GN+SiLU input
  const float* mean;   // (B, groups)
  const float* rstd;
  const float* gamma;  // (cin,)
  const float* beta;
  const bf16* w;       // (cout, 3*cin): w[n, k*cin + c] = conv tap k
  const float* bias;   // (cout,)
  const float* film_scale;  // (B, cout) or null
  const float* film_shift;
  const bf16* x2;      // (B, T, cin2) skip input or null
  const bf16* w2;      // (cout, cin2)
  const float* bias2;  // (cout,)
  const bf16* res;     // (B, T, cout) identity residual or null
  void* out;           // (B, T, cout), bf16 or fp32
  bf16* out2;          // (B, T, cout) skip projection kept apart, or null
  float* out_pre;      // (B, T, cout) conv + bias before FiLM (training), or null
  int B, T, cin, cout, cin2, groups;
};

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ void mma_tile(const bf16* As, const bf16* Bs,
                                         FragC (&acc)[2][2], int wm, int wn) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    FragA fa[2];
    FragB fb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::load_matrix_sync(fa[i], As + (wm + 16 * i) * LDS + kk, LDS);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::load_matrix_sync(fb[j], Bs + (wn + 16 * j) * LDS + kk, LDS);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
  }
}

// 16 fp32 values -> 16 bf16 (round to nearest even) at a 16-byte aligned dst
__device__ __forceinline__ void store16(bf16* dst, const float* v) {
  uint4 u[2];
  uint32_t* w = reinterpret_cast<uint32_t*>(u);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);  // .x low
    w[j] = *reinterpret_cast<uint32_t*>(&h);
  }
  reinterpret_cast<uint4*>(dst)[0] = u[0];
  reinterpret_cast<uint4*>(dst)[1] = u[1];
}

template <typename In, typename Out>
__global__ void __launch_bounds__(NTHREADS) conv3_fused_kernel(const ConvArgs p) {
  __shared__ __align__(128) bf16 As[BM * LDS];
  __shared__ __align__(128) bf16 Bs[BN * LDS];
  __shared__ __align__(128) float Cs[BM * LDC];
  __shared__ __align__(128) float Cs2[BM * LDC];

  const int t0 = blockIdx.x * BM, n0 = blockIdx.y * BN, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  // loader mapping: each thread fills 16 consecutive K of one A row and one B row
  const int lr = tid >> 1, lk = (tid & 1) * 16;
  const int T = p.T, cin = p.cin, cout = p.cout;
  const int Ktot = 3 * cin, cg = cin / p.groups;
  const In* a = static_cast<const In*>(p.a) + (size_t)b * T * cin;

  FragC acc[2][2], acc2[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc[i][j], 0.f);
      wmma::fill_fragment(acc2[i][j], 0.f);
    }

  // ---- segment 1: conv3 over GN+SiLU(a), register prefetch of the next tile
  float ra[16];
  uint4 rb[2];
  bool ra_ok = false;
  int ra_c0 = 0;
  const int t_row = t0 + lr;
  auto fetch = [&](int k0) {
    const int tap = k0 / cin;
    ra_c0 = k0 - tap * cin + lk;
    const int src = t_row + tap - 1;
    ra_ok = t_row < T && src >= 0 && src < T;
    if (ra_ok) load16(a + (size_t)src * cin + ra_c0, ra);
    const bf16* wp = p.w + (size_t)(n0 + lr) * Ktot + k0 + lk;
    rb[0] = reinterpret_cast<const uint4*>(wp)[0];
    rb[1] = reinterpret_cast<const uint4*>(wp)[1];
  };
  auto commit = [&]() {
    float v[16];
    if (ra_ok) {
      const int g = ra_c0 / cg;
      const float m = p.mean[b * p.groups + g], rs = p.rstd[b * p.groups + g];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float y = (ra[j] - m) * rs * p.gamma[ra_c0 + j] + p.beta[ra_c0 + j];
        v[j] = y / (1.f + expf(-y));  // SiLU
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = 0.f;
    }
    store16(As + lr * LDS + lk, v);
    reinterpret_cast<uint4*>(Bs + lr * LDS + lk)[0] = rb[0];
    reinterpret_cast<uint4*>(Bs + lr * LDS + lk)[1] = rb[1];
  };

  fetch(0);
  for (int k0 = 0; k0 < Ktot; k0 += BK) {
    commit();
    __syncthreads();
    if (k0 + BK < Ktot) fetch(k0 + BK);
    mma_tile(As, Bs, acc, wm, wn);
    __syncthreads();
  }

  // ---- segment 2: the 1x1 skip GEMM over the block input, own accumulator
  if (p.x2) {
    const bf16* x2 = p.x2 + (size_t)b * T * p.cin2;
    uint4 xa[2];
    auto fetch2 = [&](int k0) {
      if (t_row < T) {
        const bf16* xp = x2 + (size_t)t_row * p.cin2 + k0 + lk;
        xa[0] = reinterpret_cast<const uint4*>(xp)[0];
        xa[1] = reinterpret_cast<const uint4*>(xp)[1];
      } else {
        xa[0] = make_uint4(0, 0, 0, 0);
        xa[1] = make_uint4(0, 0, 0, 0);
      }
      const bf16* wp = p.w2 + (size_t)(n0 + lr) * p.cin2 + k0 + lk;
      rb[0] = reinterpret_cast<const uint4*>(wp)[0];
      rb[1] = reinterpret_cast<const uint4*>(wp)[1];
    };
    fetch2(0);
    for (int k0 = 0; k0 < p.cin2; k0 += BK) {
      reinterpret_cast<uint4*>(As + lr * LDS + lk)[0] = xa[0];
      reinterpret_cast<uint4*>(As + lr * LDS + lk)[1] = xa[1];
      reinterpret_cast<uint4*>(Bs + lr * LDS + lk)[0] = rb[0];
      reinterpret_cast<uint4*>(Bs + lr * LDS + lk)[1] = rb[1];
      __syncthreads();
      if (k0 + BK < p.cin2) fetch2(k0 + BK);
      mma_tile(As, Bs, acc2, wm, wn);
      __syncthreads();
    }
  }

  // ---- epilogue
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * LDC + wn + 16 * j, acc[i][j], LDC,
                              wmma::mem_row_major);
      if (p.x2)
        wmma::store_matrix_sync(Cs2 + (wm + 16 * i) * LDC + wn + 16 * j, acc2[i][j],
                                LDC, wmma::mem_row_major);
    }
  __syncthreads();

  Out* out = static_cast<Out*>(p.out);
  for (int e = tid; e < BM * BN; e += NTHREADS) {
    const int r = e / BN, n = e - r * BN;
    const int t = t0 + r;
    if (t >= T) break;  // rows only grow with e
    const int gn = n0 + n;
    const size_t o = ((size_t)b * T + t) * cout + gn;
    float h = Cs[r * LDC + n] + p.bias[gn];
    if (p.out_pre) p.out_pre[o] = h;  // z1, for the FiLM-scale gradient
    if (p.film_scale)
      h = h * (1.f + p.film_scale[b * cout + gn]) + p.film_shift[b * cout + gn];
    if (p.x2) {
      const float xs = Cs2[r * LDC + n] + p.bias2[gn];
      if (p.out2) {
        out[o] = from_f<Out>(h);
        p.out2[o] = from_f<bf16>(xs);
      } else {
        out[o] = from_f<Out>(xs + h);
      }
    } else if (p.res) {
      out[o] = from_f<Out>(to_f(p.res[o]) + h);
    } else {
      out[o] = from_f<Out>(h);
    }
  }
}

template <typename In>
void launch_gn(const void* x, float* mean, float* rstd, int B, int T, int C, int G,
               float eps, cudaStream_t s) {
  gn_stats_kernel<In><<<dim3(G, B), 1024, 0, s>>>(static_cast<const In*>(x), mean,
                                                  rstd, T, C, G, eps);
}

template <typename In, typename Out>
void launch_conv(const ConvArgs& p, cudaStream_t s) {
  dim3 grid((p.T + BM - 1) / BM, p.cout / BN, p.B);
  conv3_fused_kernel<In, Out><<<grid, NTHREADS, 0, s>>>(p);
}

}  // namespace

extern "C" int lm2a_gn_stats(const void* x, int x_is_f32, float* mean, float* rstd,
                             int B, int T, int C, int G, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_f32)
    launch_gn<float>(x, mean, rstd, B, T, C, G, eps, s);
  else
    launch_gn<bf16>(x, mean, rstd, B, T, C, G, eps, s);
  return (int)cudaGetLastError();
}

extern "C" int lm2a_conv3_fused(
    const void* a, int a_is_f32, const float* mean, const float* rstd,
    const float* gamma, const float* beta, const void* w, const float* bias,
    const float* film_scale, const float* film_shift, const void* x2,
    const void* w2, const float* bias2, const void* res, void* out, int out_is_f32,
    void* out2, float* out_pre, int B, int T, int cin, int cout, int cin2, int groups,
    void* stream) {
  ConvArgs p;
  p.a = a;
  p.mean = mean;
  p.rstd = rstd;
  p.gamma = gamma;
  p.beta = beta;
  p.w = static_cast<const bf16*>(w);
  p.bias = bias;
  p.film_scale = film_scale;
  p.film_shift = film_shift;
  p.x2 = static_cast<const bf16*>(x2);
  p.w2 = static_cast<const bf16*>(w2);
  p.bias2 = bias2;
  p.res = static_cast<const bf16*>(res);
  p.out = out;
  p.out2 = static_cast<bf16*>(out2);
  p.out_pre = out_pre;
  p.B = B;
  p.T = T;
  p.cin = cin;
  p.cout = cout;
  p.cin2 = cin2;
  p.groups = groups;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the chain's two convs: bf16 block input -> fp32 intermediate (conv 1),
  // fp32 intermediate -> bf16 block output (conv 2)
  if (!a_is_f32 && out_is_f32)
    launch_conv<bf16, float>(p, s);
  else if (a_is_f32 && !out_is_f32)
    launch_conv<float, bf16>(p, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
