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
//   conv3_wgrad(GN2+SiLU(f), g)         -> dW2, db2
//   conv3_dgrad(g; W2; SiLU' of GN2(f)) -> d_y2 (fp32) + partials of d_y2, d_y2*xhat2
//   gn_bwd(d_y2; GN2; FiLM)             -> d_z1 (compute dtype) + partials of
//                                          d_f, d_f*z1, d_z1 (dshift, dscale, db1)
//   conv3_wgrad(GN1+SiLU(x), d_z1)      -> dW1
//   conv3_dgrad(d_z1; W1; SiLU' of GN1(x)) -> d_y1 + partials
//   [conv3_dgrad(gx; Wskip), 1 tap]     -> gx Wskip^T (fp32)
//   [conv3_wgrad(x, gx), 1 tap]         -> dWskip, dbskip
//   gn_bwd(d_y1; GN1; + skip term)      -> dx (compute dtype)
//
// The wrapper (ops/resblock_grad.py) sums the partials (T tiles of a
// channel sum) in a fixed order.
//
// conv3_dgrad is an implicit GEMM d_in[t] = sum_k g[t+1-k] W_k^T: M = T rows
// of one batch row, N = Cin, K = taps*Cout, bf16 wmma 16x16x16 with fp32
// accumulation and a register prefetch of the next K tile (the first design;
// it shares conv3_wgrad's loaders but not yet its wgmma main loop).
//
// conv3_wgrad, dW_k = sum_{b,t} act(a)[b,t+k-1]^T g[b,t] (the weight-gradient
// part of _resblock_bwd_kernel), is an implicit GEMM whose K is the
// flattened time axis B*T. Bound on the H100 at the training shapes (B=16,
// T 516 or 258, C 256/512): 0.8-3.3 GFLOP a call against 10-40 MB, so
// tensor-core operations at peak (0.0698 ms over a step's 7 gated blocks).
// The first design (wmma, one tile, the taps in different blocks re-reading
// and re-activating the same rows, a serial bias loop in the main loop,
// split-K partials summed by torch.sum) ran at 22-38 TFLOP/s. This design
// (below, from sm90_gemm.cuh): wgmma with M = Cout (g^T in registers via
// ldmatrix.trans from a 3-stage cp.async ring, one or two consumer
// warpgroups and a helper that shares the copies and the activation), N =
// all three taps of 64 input channels (one m64n192k16 a k16 step), each
// input element activated once per block and written to the tap tiles that
// read it (zero where a tap leaves its batch row), the bias sum taken from
// the g fragments already in registers and reduced in the epilogue, and K
// split over a cluster where the output tiles are few (wgrad_plan, the
// same measured cost model as conv3_fused's), summed in rank order from
// distributed shared memory straight into the (taps*Cin, Cout) gradient.
// Like conv3_fused it is bound by each block's serial chain per 64-frame
// chunk, not by the tensor cores.
// gn_bwd is elementwise and bound by bytes.

#include <mma.h>

#include "common.cuh"
#include "sm90_gemm.cuh"

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
// dW_k[c, n] = sum_q act(src)[q + k - 1, c] g[q, n] over the flattened
// q = (b, t), computed transposed: M = Cout (A = g^T, 64*MW rows per block,
// ldmatrix.trans fragments from a cp.async ring of 64-frame g tiles), N =
// taps x 64 channels (B = the activated window, one 64 x 64 K-major tile
// per tap, written once per K chunk from one GN+SiLU of each element), K =
// 64 frames per chunk. One wgmma m64n192k16 (m64n64k16 for one tap) per k16
// step covers all taps; a tap's frame outside [0, T) of its batch row is a
// zero in its tile. The bias gradient sum_q g[q, n] is summed from the A
// fragments already in registers and reduced in the epilogue. The K split
// (a cluster along z) sums the fp32 tiles in rank order.
constexpr int WG_STAGES = 3;

struct WgradArgs {
  const void* src;     // (B, T, cin): GroupNorm input (bf16 or fp32), or bf16 x (raw)
  const float* mean;   // (B, groups), null: raw
  const float* rstd;
  const float* gamma;  // (cin,)
  const float* beta;
  const bf16* g;       // (B, T, cout): gradient of the conv output
  float* out;          // (parts, taps*cin, cout): dW[k, c, n] of each part of K
  float* bias_out;     // (parts, cout): sums of g, or null
  int B, T, cin, cout, groups;
  int splits;          // blocks of a cluster along z; gridDim.z = splits * parts
};

template <typename Src, bool ACT, int TAPS, int MW>
__global__ void __launch_bounds__(128 * (MW + 1)) conv3_wgrad_kernel(const WgradArgs p) {
  // MW consumer warpgroups and one helper: all share the copies and the
  // activation, the consumers issue the wgmmas and hold the tile
  constexpr int NT = 128 * (MW + 1), BMN = 64 * MW, NW = TAPS * 64;
  constexpr int LDG = BMN + 8;  // bf16 row stride of a g tile (odd multiple of 16 bytes)
  constexpr int ACT_BYTES = TAPS * 64 * 128, G_BYTES = 64 * LDG * 2;
  constexpr int ROWS = TAPS == 3 ? 66 : 64, LO = TAPS == 3 ? -1 : 0;  // source frames
  constexpr int RAW_LD = 64 * (int)sizeof(Src) + 16;  // bytes a staged source row
  constexpr int RAW_BYTES = ROWS * RAW_LD;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* act = smem;                    // 2 x ACT_BYTES, swizzled K-major tiles
  uint8_t* gring = smem + 2 * ACT_BYTES;  // WG_STAGES x G_BYTES
  uint8_t* raw = gring + WG_STAGES * G_BYTES;  // WG_STAGES x RAW_BYTES

  const int tid = threadIdx.x, wg = tid >> 7, tid_wg = tid & 127, lane = tid & 31;
  const int T = p.T, cin = p.cin, cout = p.cout;
  const int BT = p.B * T;
  const int n0 = blockIdx.x * BMN, c0 = blockIdx.y * 64;
  const int nch = (BT + 63) / 64;
  // K: the chunks are split over gridDim.z ranks; a cluster of S along z
  // sums its ranks in the kernel, each of the parts writes its own partial
  const int S = p.splits, part = blockIdx.z / S;
  const int NR = gridDim.z;
  const int ch_beg = (int)((long long)nch * blockIdx.z / NR);
  const int ch_end = (int)((long long)nch * (blockIdx.z + 1) / NR);
  const int L = ch_end - ch_beg;
  const bool do_bias = p.bias_out != nullptr && blockIdx.y == 0;
  __shared__ float gb[128];  // this block's 64 channels of gamma, then beta
  if (ACT && tid < 128) gb[tid] = tid < 64 ? p.gamma[c0 + tid] : p.beta[c0 + tid - 64];
  __syncthreads();

  // chunk j into stage s: the g tile (64 frames x BMN channels) and the
  // source frames q0 + LO .. q0 + LO + ROWS - 1 of this block's 64 input
  // channels. Consecutive threads take consecutive frames of one 8-channel
  // group (unit u: frame u % ROWS, group u / ROWS), and each thread copies
  // exactly the source elements it later activates.
  auto load_chunk = [&](int j, int s) {
    const uint32_t base = sm90::smem_u32(gring + s * G_BYTES);
    for (int u = tid; u < 64 * (BMN / 8); u += NT) {
      const int r = u / (BMN / 8), c = u % (BMN / 8);
      const int q = j * 64 + r;
      const bool ok = q < BT;
      sm90::cp_async16(base + (r * LDG + c * 8) * 2,
                       p.g + (ok ? (size_t)q * cout + n0 + c * 8 : 0), ok ? 16 : 0);
    }
    const uint32_t rbase = sm90::smem_u32(raw + s * RAW_BYTES);
    const Src* src = static_cast<const Src*>(p.src);
    for (int u = tid; u < ROWS * 8; u += NT) {
      const int rr = u % ROWS, cl = (u / ROWS) * 8;
      const int q = j * 64 + LO + rr;
      const bool ok = q >= 0 && q < BT;
      const Src* sp = src + (ok ? (size_t)q * cin + c0 + cl : 0);
#pragma unroll
      for (int h = 0; h < (int)sizeof(Src) / 2; ++h)
        sm90::cp_async16(rbase + rr * RAW_LD + cl * (int)sizeof(Src) + 16 * h,
                         sp + h * 16 / (int)sizeof(Src), ok ? 16 : 0);
    }
  };

  // this thread's source units (frame rr, 8 channels from cl) are the same
  // in every chunk: their frame offsets and GroupNorm groups, computed once
  constexpr int ITER = (ROWS * 8 + NT - 1) / NT;
  int u_rr[ITER], u_cl[ITER], u_gi[ITER];
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int u = tid + it * NT;
    u_rr[it] = u < ROWS * 8 ? u % ROWS : -1;
    u_cl[it] = (u / ROWS) * 8;
    u_gi[it] = ACT ? (c0 + u_cl[it]) / (cin / p.groups) : 0;
  }

  // the tap tiles of chunk j: tile k, row c (channel), column jc (frame
  // q0 + jc) holds act(q0 + jc + k - 1) when that frame lies in the same
  // batch row, else 0. Each source frame is activated once and written to
  // every tap that reads it.
  auto activate = [&](int j, int s, int buf) {
    uint8_t* tiles = act + buf * ACT_BYTES;
    const uint8_t* rs_ = raw + s * RAW_BYTES;
    const int q0 = j * 64;
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
      const int rr = u_rr[it], cl = u_cl[it];
      if (rr < 0) continue;
      const int q = q0 + LO + rr;  // source frame
      const bool in = q >= 0 && q < BT;
      const int b = in ? q / T : 0, tq = q - b * T;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
      if (in) {
        load8(reinterpret_cast<const Src*>(rs_ + rr * RAW_LD) + cl, v);
        if (ACT) {
          const float* ga = gb + cl;
          const float* be = gb + 64 + cl;
          const int si = b * p.groups + u_gi[it];
          const float mu = __ldg(p.mean + si), rstd = __ldg(p.rstd + si);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = sm90::silu_fast((v[e] - mu) * rstd * ga[e] + be[e]);
        }
      }
      bf16 h[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) h[e] = __float2bfloat16_rn(v[e]);
      const bf16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
      for (int k = 0; k < TAPS; ++k) {
        // output frame q - (k - 1) reads this source frame through tap k:
        // a zero where the two lie in different batch rows
        const int jc = TAPS == 3 ? rr - k : rr;
        if (jc < 0 || jc >= 64) continue;
        const bool ok = TAPS == 1 || k == 1 || (k == 0 ? tq <= T - 2 : tq >= 1);
        uint8_t* tile = tiles + k * 64 * 128;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          *reinterpret_cast<bf16*>(tile + sm90::sw128_offset(cl + e, jc >> 3) + (jc & 7) * 2) =
              ok ? h[e] : zero;
      }
    }
  };

  float acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
  float bsum[2] = {0.f, 0.f};

#pragma unroll
  for (int s = 0; s < WG_STAGES - 1; ++s) {
    if (s < L) load_chunk(ch_beg + s, s);
    sm90::cp_async_commit();
  }
  if (L > 0) {
    sm90::cp_async_wait<WG_STAGES - 2>();
    activate(ch_beg, 0, 0);
  }

  // ldmatrix.trans lane address inside a g tile: frame row, output-channel column
  const int a_row = (lane & 7) + ((lane >> 4) << 3);
  const int a_col = wg * 64 + (tid_wg >> 5) * 16 + ((lane >> 3) & 1) * 8;

  // per chunk: one barrier; the next chunk's copies go out, this chunk's
  // product goes to the tensor cores, and the next chunk's tap tiles are
  // activated while it runs
  for (int i = 0; i < L; ++i) {
    const int j = ch_beg + i;
    sm90::cp_async_wait<WG_STAGES - 2>();  // this thread's copies of chunk j landed
    sm90::fence_proxy_async();
    __syncthreads();  // every thread's g rows and tap tiles of chunk j are in
    if (i + WG_STAGES - 1 < L) load_chunk(j + WG_STAGES - 1, (i + WG_STAGES - 1) % WG_STAGES);
    sm90::cp_async_commit();
    const uint32_t gbase = sm90::smem_u32(gring + (i % WG_STAGES) * G_BYTES);
    const uint32_t tiles = sm90::smem_u32(act + (i & 1) * ACT_BYTES);
    uint32_t fr[4][4];
    if (wg < MW) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::ldmatrix_x4_trans(fr[kk], gbase + ((kk * 16 + a_row) * LDG + a_col) * 2);
      if (do_bias) {  // before wgmma reads them; rows lane/4 (regs 0, 2), lane/4 + 8 (1, 3)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&fr[kk][r]));
            bsum[r & 1] += f.x + f.y;
          }
      }
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs<NW>(acc, fr[kk], sm90::desc_sw128(tiles + kk * 32));
      sm90::wgmma_commit();
    }
    if (i + 1 < L) {
      sm90::cp_async_wait<WG_STAGES - 2>();  // chunk j + 1's source rows (this thread's)
      activate(j + 1, (i + 1) % WG_STAGES, (i + 1) & 1);
    }
    if (wg < MW) sm90::wgmma_wait<0>();
  }
  sm90::cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the quad's four lanes hold one row's columns
    bsum[r] += __shfl_xor_sync(0xffffffffu, bsum[r], 1);
    bsum[r] += __shfl_xor_sync(0xffffffffu, bsum[r], 2);
  }
  const int brow = wg * 64 + (tid_wg >> 5) * 16 + ((tid_wg & 31) >> 2);

  // the tile goes through shared memory transposed, [tap*64 + channel][n],
  // then the bias [n], so the gradient leaves in float4 rows of n
  __syncthreads();  // the last activation and wgmma are done with shared memory
  float* red = reinterpret_cast<float*>(smem);
  if (wg < MW) {
#pragma unroll
    for (int i = 0; i < NW / 2; ++i)
      red[sm90::acc_col(i, tid_wg) * BMN + wg * 64 + sm90::acc_row(i, tid_wg)] = acc[i];
    if ((lane & 3) == 0) {
      red[NW * BMN + brow] = bsum[0];
      red[NW * BMN + brow + 8] = bsum[1];
    }
  }
  float* out = p.out + (size_t)part * TAPS * cin * cout;
  auto store4 = [&](int e, float4 v) {
    if (e < NW * BMN) {  // four neighbouring output channels of one (tap, channel)
      const int k = (e / BMN) >> 6;
      *reinterpret_cast<float4*>(out + ((size_t)k * cin + c0 + ((e / BMN) & 63)) * cout +
                                 n0 + e % BMN) = v;
    } else if (do_bias) {
      *reinterpret_cast<float4*>(p.bias_out + (size_t)part * cout + n0 + e - NW * BMN) = v;
    }
  };
  if (S == 1) {
    __syncthreads();
    for (int e = 4 * tid; e < (NW + 1) * BMN; e += 4 * NT)
      store4(e, *reinterpret_cast<const float4*>(red + e));
  } else {
    sm90::cluster_reduce(red, (NW + 1) * BMN, store4);
  }
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

namespace {

template <typename Src, bool ACT, int TAPS, int MW>
cudaError_t launch_wgrad(const WgradArgs& a, int parts, int smem, cudaStream_t s) {
  static bool attr_set = false;
  return sm90::launch_cluster(conv3_wgrad_kernel<Src, ACT, TAPS, MW>, attr_set,
                              dim3(a.cout / (64 * MW), a.cin / 64, a.splits * parts),
                              128 * (MW + 1), smem, a.splits, s, a);
}

template <typename Src, bool ACT, int TAPS>
cudaError_t launch_wgrad_mw(const WgradArgs& a, int mw, int parts, int smem, cudaStream_t s) {
  if (mw == 1) return launch_wgrad<Src, ACT, TAPS, 1>(a, parts, smem, s);
  if (mw == 2) return launch_wgrad<Src, ACT, TAPS, 2>(a, parts, smem, s);
  return cudaErrorInvalidValue;
}

template <typename Src, bool ACT>
cudaError_t launch_wgrad_taps(const WgradArgs& a, int taps, int mw, int parts, int smem,
                              cudaStream_t s) {
  if (taps == 3) return launch_wgrad_mw<Src, ACT, 3>(a, mw, parts, smem, s);
  if (taps == 1) return launch_wgrad_mw<Src, ACT, 1>(a, mw, parts, smem, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int lm2a_conv3_wgrad(const void* src, int src_is_f32, const float* mean,
                                const float* rstd, const float* gamma, const float* beta,
                                const void* g, float* out, float* bias_out, int B, int T,
                                int cin, int cout, int taps, int groups, int mw, int splits,
                                int parts, int smem, void* stream) {
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
  a.groups = groups;
  a.splits = splits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (mean == nullptr) {
    if (src_is_f32) return (int)cudaErrorInvalidValue;  // raw mode reads bf16 x
    e = launch_wgrad_taps<bf16, false>(a, taps, mw, parts, smem, s);
  } else if (src_is_f32) {
    e = launch_wgrad_taps<float, true>(a, taps, mw, parts, smem, s);
  } else {
    e = launch_wgrad_taps<bf16, true>(a, taps, mw, parts, smem, s);
  }
  if (e != cudaSuccess) return (int)e;
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
