// Fused FiLM-resblock backward for Hopper (sm_90a), in three kernel functions.
//
// Replaces the Pallas TPU kernel _resblock_bwd_kernel of
// lm2a_tpu/ops/pallas_resblock.py (the custom VJP of fused_resblock_train).
// On the TPU one grid step per batch row recomputes the chain in VMEM and
// emits every gradient, carrying the fp32 weight-gradient sums from row to
// row. A Hopper block can hold neither a row's chain nor a (3*Cin, Cout)
// fp32 accumulator, GroupNorm's backward needs sums over all of T before
// dx, and blocks run in no order, so the backward is a sequence of launches
// that exchange fp32 partial sums (per row, channel and 64-frame tile;
// written, never accumulated with atomics, so every run gives the same
// bits) and the forward's saved tensors (x, the conv-1 output z1 before FiLM
// and f after it, GroupNorm statistics):
//
//   conv3_wgrad(GN2+SiLU(f), g)         -> dW2 partials, db2 partials
//   conv3_dgrad(g; W2; SiLU' of GN2(f)) -> d_y2 (fp32) + partials of d_y2, d_y2*xhat2
//   gn_bwd(d_y2; GN2; FiLM)             -> d_z1 (compute dtype) + partials of
//                                          d_f, d_f*z1, d_z1 (dshift, dscale, db1)
//   conv3_wgrad(GN1+SiLU(x), d_z1)      -> dW1 partials
//   conv3_dgrad(d_z1; W1; SiLU' of GN1(x)) -> d_y1 + partials
//   [conv3_dgrad(gx; Wskip), 1 tap]     -> gx Wskip^T (fp32)
//   [conv3_wgrad(x, gx), 1 tap]         -> dWskip, dbskip partials
//   gn_bwd(d_y1; GN1; + skip term)      -> dx (compute dtype)
//
// The wrapper (ops/resblock_grad.py) sums the partials (split-K slices of a
// weight gradient, T tiles of a channel sum) in a fixed order.
//
// conv3_dgrad is an implicit GEMM d_in[t] = sum_k g[t+1-k] W_k^T: M = T rows
// of one batch row, N = Cin, K = taps*Cout. conv3_wgrad is
// dW_k = sum_{b,t} a[b,t+k-1]^T g[b,t]: M = taps*Cin, N = Cout, K = B*T,
// split over K into slices so the grid fills the card; its prologue forms
// silu(gn(.)) rounded to bf16 as conv3_fused's does. Both use bf16 wmma
// 16x16x16 with fp32 accumulation and a register prefetch of the next K
// tile. Bound on the H100 at the flagship's training shapes (B=16, T 516 or
// 258, C 256/512): each conv gradient is 0.8-3.3 GFLOP against 10-40 MB,
// so operations bound it at peak; at this design's rates (tens of TFLOP/s)
// the MMAs and the prologue's per-element GroupNorm+SiLU dominate. gn_bwd
// is elementwise and bound by bytes. wgmma/TMA are later work.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64;   // output tile rows
constexpr int BN = 64;   // output tile columns
constexpr int BK = 32;   // K per tile
constexpr int TT = 64;   // frames per partial-sum tile (= BM of conv3_dgrad)
constexpr int NTHREADS = 128;
constexpr int LDR = BK + 8;  // bf16 stride of a row-major (64 x 32) tile: 80 bytes
constexpr int LDW = BN + 8;  // bf16 stride of a (32 x 64) tile: 144 bytes
constexpr int LDC = BN + 4;  // fp32 epilogue stride

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragAr;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAc;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ void store16(bf16* dst, const float* v) {
  uint4 u[2];
  uint32_t* w = reinterpret_cast<uint32_t*>(u);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    w[j] = *reinterpret_cast<uint32_t*>(&h);
  }
  reinterpret_cast<uint4*>(dst)[0] = u[0];
  reinterpret_cast<uint4*>(dst)[1] = u[1];
}

__device__ __forceinline__ void copy16(bf16* dst, const uint4* src) {
  reinterpret_cast<uint4*>(dst)[0] = src[0];
  reinterpret_cast<uint4*>(dst)[1] = src[1];
}

__device__ __forceinline__ void fill_zero(FragC (&acc)[2][2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
}

// ------------------------------------------------------------ conv3_dgrad
struct DgradArgs {
  const bf16* g;       // (B, T, cout): gradient of the conv output
  const bf16* w;       // (cout, taps*cin): w[n, k*cin + c] = tap k
  const void* pre;     // (B, T, cin) GroupNorm input (bf16 or fp32), or null: raw
  const float* mean;   // (B, groups)
  const float* rstd;
  const float* gamma;  // (cin,)
  const float* beta;
  float* out;          // (B, T, cin): d_y (act) or the raw product
  float* part;         // (2, B, nT, cin): sums over each tile of d_y and d_y*xhat
  int B, T, cin, cout, taps, groups, nT;
};

template <typename Pre>
__global__ void __launch_bounds__(NTHREADS) conv3_dgrad_kernel(const DgradArgs p) {
  __shared__ __align__(128) bf16 As[BM * LDR];
  __shared__ __align__(128) bf16 Bs[BK * LDW];
  __shared__ __align__(128) float Cs[BM * LDC];
  __shared__ __align__(128) float Xs[BM * LDC];

  const int t0 = blockIdx.x * BM, c0 = blockIdx.y * BN, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int T = p.T, cin = p.cin, cout = p.cout;
  const int Ktot = p.taps * cout;
  const bf16* g = p.g + (size_t)b * T * cout;
  // A loader: 16 consecutive K of one frame; B loader: 16 channels of one K row
  const int ar = tid >> 1, ak = (tid & 1) * 16;
  const int br = tid >> 2, bc = (tid & 3) * 16;

  FragC acc[2][2];
  fill_zero(acc);
  uint4 ra[2], rb[2];
  auto fetch = [&](int k0) {
    {
      const int kk = k0 + ak;
      const int tap = kk / cout, n = kk - tap * cout;
      const int src = t0 + ar + (p.taps == 3 ? 1 - tap : 0);
      if (t0 + ar < T && src >= 0 && src < T) {
        const uint4* q = reinterpret_cast<const uint4*>(g + (size_t)src * cout + n);
        ra[0] = q[0];
        ra[1] = q[1];
      } else {
        ra[0] = ra[1] = make_uint4(0, 0, 0, 0);
      }
    }
    {
      const int kk = k0 + br;
      const int tap = kk / cout, n = kk - tap * cout;
      const uint4* q = reinterpret_cast<const uint4*>(
          p.w + (size_t)n * p.taps * cin + (size_t)tap * cin + c0 + bc);
      rb[0] = q[0];
      rb[1] = q[1];
    }
  };

  fetch(0);
  for (int k0 = 0; k0 < Ktot; k0 += BK) {
    copy16(As + ar * LDR + ak, ra);
    copy16(Bs + br * LDW + bc, rb);
    __syncthreads();
    if (k0 + BK < Ktot) fetch(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragAr fa[2];
      FragB fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], As + (wm + 16 * i) * LDR + kk, LDR);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], Bs + kk * LDW + wn + 16 * j, LDW);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * LDC + wn + 16 * j, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();

  if (p.pre == nullptr) {  // raw product (the 1x1 skip's input gradient)
    for (int e = tid; e < BM * BN; e += NTHREADS) {
      const int r = e / BN, n = e - r * BN, t = t0 + r;
      if (t >= T) break;
      p.out[((size_t)b * T + t) * cin + c0 + n] = Cs[r * LDC + n];
    }
    return;
  }

  // SiLU backward through y = xhat * gamma + beta, xhat from the saved input
  const Pre* pre = static_cast<const Pre*>(p.pre) + (size_t)b * T * cin;
  const int cg = cin / p.groups;
  for (int e = tid; e < BM * BN; e += NTHREADS) {
    const int r = e / BN, n = e - r * BN, t = t0 + r, c = c0 + n;
    float dy = 0.f, xh = 0.f;
    if (t < T) {
      const int gi = b * p.groups + c / cg;
      xh = (to_f(pre[(size_t)t * cin + c]) - p.mean[gi]) * p.rstd[gi];
      const float y = xh * p.gamma[c] + p.beta[c];
      const float sig = 1.f / (1.f + expf(-y));
      dy = Cs[r * LDC + n] * (sig * (1.f + y * (1.f - sig)));
      p.out[((size_t)b * T + t) * cin + c] = dy;
    }
    Cs[r * LDC + n] = dy;
    Xs[r * LDC + n] = dy * xh;
  }
  __syncthreads();
  // one column sum per thread, rows in order
  const int n = tid & 63;
  const float* src = tid < 64 ? Cs : Xs;
  float s = 0.f;
  for (int r = 0; r < BM; ++r) s += src[r * LDC + n];
  const int which = tid < 64 ? 0 : 1;
  p.part[(((size_t)which * p.B + b) * p.nT + blockIdx.x) * cin + c0 + n] = s;
}

// ------------------------------------------------------------ conv3_wgrad
struct WgradArgs {
  const void* src;     // (B, T, cin): GroupNorm input (bf16 or fp32), or bf16 x (raw)
  const float* mean;   // (B, groups), null: raw
  const float* rstd;
  const float* gamma;  // (cin,)
  const float* beta;
  const bf16* g;       // (B, T, cout): gradient of the conv output
  float* out;          // (splits, taps*cin, cout): dW[k, c, n] per K slice
  float* bias_out;     // (splits, cout): sums of g per K slice, or null
  int B, T, cin, cout, taps, groups, split_len;
};

template <typename Src, bool ACT>
__global__ void __launch_bounds__(NTHREADS) conv3_wgrad_kernel(const WgradArgs p) {
  __shared__ __align__(128) bf16 As[BK * LDW];  // K-major: As[k][m]
  __shared__ __align__(128) bf16 Bs[BK * LDW];  // Bs[k][n]

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int T = p.T, cin = p.cin, cout = p.cout;
  const int tap = m0 / cin, c0 = m0 - tap * cin;
  const int shift = p.taps == 3 ? tap - 1 : 0;
  const long long BT = (long long)p.B * T;
  const long long kbeg = (long long)s * p.split_len;
  const long long kend = kbeg + p.split_len < BT ? kbeg + p.split_len : BT;
  const Src* src = static_cast<const Src*>(p.src);
  const int cg = ACT ? cin / p.groups : 1;
  // loaders: 16 consecutive channels of one (b, t) row, for A and for B
  const int lr = tid >> 2, lc = (tid & 3) * 16;

  FragC acc[2][2];
  fill_zero(acc);
  float ra[16];
  uint4 rb[2];
  bool a_ok = false;
  int a_b = 0;
  auto fetch = [&](long long k0) {
    const long long q = k0 + lr;
    a_ok = false;
    if (q < kend) {
      const int bb = (int)(q / T), t = (int)(q - (long long)bb * T);
      const int st = t + shift;
      if (st >= 0 && st < T) {
        a_ok = true;
        a_b = bb;
        load16(src + ((size_t)bb * T + st) * cin + c0 + lc, ra);
      }
      const uint4* gp = reinterpret_cast<const uint4*>(p.g + (size_t)q * cout + n0 + lc);
      rb[0] = gp[0];
      rb[1] = gp[1];
    } else {
      rb[0] = rb[1] = make_uint4(0, 0, 0, 0);
    }
  };
  auto commit = [&]() {
    float v[16];
    if (a_ok) {
      if (ACT) {
        const int c = c0 + lc;
        const int gi = a_b * p.groups + c / cg;
        const float m = p.mean[gi], rs = p.rstd[gi];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float y = (ra[j] - m) * rs * p.gamma[c + j] + p.beta[c + j];
          v[j] = y / (1.f + expf(-y));  // SiLU
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) v[j] = ra[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = 0.f;
    }
    store16(As + lr * LDW + lc, v);
    copy16(Bs + lr * LDW + lc, rb);
  };

  const bool do_bias = p.bias_out != nullptr && blockIdx.x == 0;
  float bacc = 0.f;
  fetch(kbeg);
  for (long long k0 = kbeg; k0 < kend; k0 += BK) {
    commit();
    __syncthreads();
    if (k0 + BK < kend) fetch(k0 + BK);
    if (do_bias && tid < BN) {
      for (int r = 0; r < BK; ++r) bacc += __bfloat162float(Bs[r * LDW + tid]);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragAc fa[2];
      FragB fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], As + kk * LDW + wm + 16 * i, LDW);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], Bs + kk * LDW + wn + 16 * j, LDW);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = p.out + (size_t)s * p.taps * cin * cout;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(out + (size_t)(m0 + wm + 16 * i) * cout + n0 + wn + 16 * j,
                              acc[i][j], cout, wmma::mem_row_major);
  if (do_bias && tid < BN) p.bias_out[(size_t)s * cout + n0 + tid] = bacc;
}

// ------------------------------------------------------------ gn_bwd
struct GnBwdArgs {
  const float* dy;     // (B, T, C): gradient of the GroupNorm output (d_y)
  const void* pre;     // (B, T, C): GroupNorm input, bf16 or fp32
  const float* mean;   // (B, G)
  const float* rstd;
  const float* gamma;  // (C,)
  const float* part;   // (2, B, nT, C) from conv3_dgrad
  const float* extra;  // (B, T, C) added to the input gradient, or null
  const float* film_scale;  // (B, C): FiLM mode (GN2) when set
  const float* z1;     // (B, T, C) conv-1 output before FiLM (FiLM mode)
  void* out;           // (B, T, C): dx, or d_z1 = d_f * (1 + scale)
  float* part_out;     // (3, B, nT, C): tile sums of d_f, d_f*z1, d_z1 (FiLM mode)
  int B, T, C, G, nT;
};

constexpr int GN_THREADS = 256;

template <typename Pre, typename Out>
__global__ void __launch_bounds__(GN_THREADS) gn_bwd_kernel(const GnBwdArgs p) {
  __shared__ float sm1[BN], sm2[BN];
  __shared__ float red[3][GN_THREADS / BN][BN];
  const int tile = blockIdx.x, c0 = blockIdx.y * BN, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int T = p.T, C = p.C, cg = C / p.G;
  const size_t plane = (size_t)p.B * p.nT * C;

  // m1, m2 of each channel's group: sum over the group's channels and all
  // tiles of gamma * (tile sums of d_y, d_y * xhat), over T * C/G
  if (tid < BN) {
    const int c = c0 + tid, gs = (c / cg) * cg;
    float s1 = 0.f, s2 = 0.f;
    for (int cc = gs; cc < gs + cg; ++cc) {
      float a1 = 0.f, a2 = 0.f;
      for (int k = 0; k < p.nT; ++k) {
        const size_t o = ((size_t)b * p.nT + k) * C + cc;
        a1 += p.part[o];
        a2 += p.part[plane + o];
      }
      s1 += p.gamma[cc] * a1;
      s2 += p.gamma[cc] * a2;
    }
    const float n = (float)T * (float)cg;
    sm1[tid] = s1 / n;
    sm2[tid] = s2 / n;
  }
  __syncthreads();

  const int j = tid & (BN - 1), rg = tid / BN;
  const int c = c0 + j;
  const int gi = b * p.G + c / cg;
  const float mu = p.mean[gi], rs = p.rstd[gi], ga = p.gamma[c];
  const float m1 = sm1[j], m2 = sm2[j];
  const bool film = p.film_scale != nullptr;
  const float sc1 = film ? 1.f + p.film_scale[b * C + c] : 1.f;
  const Pre* pre = static_cast<const Pre*>(p.pre);
  Out* out = static_cast<Out*>(p.out);
  float q0 = 0.f, q1 = 0.f, q2 = 0.f;
  for (int r = rg; r < TT; r += GN_THREADS / BN) {
    const int t = tile * TT + r;
    if (t >= T) break;
    const size_t o = ((size_t)b * T + t) * C + c;
    const float xh = (to_f(pre[o]) - mu) * rs;
    float d = rs * (p.dy[o] * ga - m1 - xh * m2);
    if (p.extra) d += p.extra[o];
    if (film) {
      const float dz = d * sc1;
      out[o] = from_f<Out>(dz);
      q0 += d;
      q1 += d * p.z1[o];
      q2 += dz;
    } else {
      out[o] = from_f<Out>(d);
    }
  }
  if (!film) return;
  red[0][rg][j] = q0;
  red[1][rg][j] = q1;
  red[2][rg][j] = q2;
  __syncthreads();
  if (tid < 3 * BN) {
    const int w = tid / BN, jj = tid - w * BN;
    float s = 0.f;
    for (int k = 0; k < GN_THREADS / BN; ++k) s += red[w][k][jj];
    p.part_out[(size_t)w * plane + ((size_t)b * p.nT + tile) * C + c0 + jj] = s;
  }
}

}  // namespace

extern "C" int lm2a_conv3_dgrad(const void* g, const void* w, const void* pre, int pre_is_f32,
                                const float* mean, const float* rstd, const float* gamma,
                                const float* beta, float* out, float* part, int B, int T,
                                int cin, int cout, int taps, int groups, int nT,
                                void* stream) {
  DgradArgs a;
  a.g = static_cast<const bf16*>(g);
  a.w = static_cast<const bf16*>(w);
  a.pre = pre;
  a.mean = mean;
  a.rstd = rstd;
  a.gamma = gamma;
  a.beta = beta;
  a.out = out;
  a.part = part;
  a.B = B;
  a.T = T;
  a.cin = cin;
  a.cout = cout;
  a.taps = taps;
  a.groups = groups;
  a.nT = nT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((T + BM - 1) / BM, cin / BN, B);
  if (pre_is_f32)
    conv3_dgrad_kernel<float><<<grid, NTHREADS, 0, s>>>(a);
  else
    conv3_dgrad_kernel<bf16><<<grid, NTHREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int lm2a_conv3_wgrad(const void* src, int src_is_f32, const float* mean,
                                const float* rstd, const float* gamma, const float* beta,
                                const void* g, float* out, float* bias_out, int B, int T,
                                int cin, int cout, int taps, int groups, int split_len,
                                int splits, void* stream) {
  WgradArgs a;
  a.src = src;
  a.mean = mean;
  a.rstd = rstd;
  a.gamma = gamma;
  a.beta = beta;
  a.g = static_cast<const bf16*>(g);
  a.out = out;
  a.bias_out = bias_out;
  a.B = B;
  a.T = T;
  a.cin = cin;
  a.cout = cout;
  a.taps = taps;
  a.groups = groups;
  a.split_len = split_len;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(taps * cin / BM, cout / BN, splits);
  if (mean == nullptr) {
    if (src_is_f32) return (int)cudaErrorInvalidValue;  // raw mode reads bf16 x
    conv3_wgrad_kernel<bf16, false><<<grid, NTHREADS, 0, s>>>(a);
  } else if (src_is_f32) {
    conv3_wgrad_kernel<float, true><<<grid, NTHREADS, 0, s>>>(a);
  } else {
    conv3_wgrad_kernel<bf16, true><<<grid, NTHREADS, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

extern "C" int lm2a_gn_bwd(const float* dy, const void* pre, int pre_is_f32, const float* mean,
                           const float* rstd, const float* gamma, const float* part,
                           const float* extra, const float* film_scale, const float* z1,
                           void* out, int out_is_f32, float* part_out, int B, int T, int C,
                           int G, int nT, void* stream) {
  GnBwdArgs a;
  a.dy = dy;
  a.pre = pre;
  a.mean = mean;
  a.rstd = rstd;
  a.gamma = gamma;
  a.part = part;
  a.extra = extra;
  a.film_scale = film_scale;
  a.z1 = z1;
  a.out = out;
  a.part_out = part_out;
  a.B = B;
  a.T = T;
  a.C = C;
  a.G = G;
  a.nT = nT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(nT, C / BN, B);
  if (pre_is_f32 && out_is_f32)
    gn_bwd_kernel<float, float><<<grid, GN_THREADS, 0, s>>>(a);
  else if (pre_is_f32)
    gn_bwd_kernel<float, bf16><<<grid, GN_THREADS, 0, s>>>(a);
  else if (out_is_f32)
    gn_bwd_kernel<bf16, float><<<grid, GN_THREADS, 0, s>>>(a);
  else
    gn_bwd_kernel<bf16, bf16><<<grid, GN_THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
