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
//                                       (or, the sums form, sum and sum of squares)
//   conv3_fused(x;  GN1+SiLU, FiLM)  -> f (fp32 intermediate, as _half1)
//   gn_stats(f)
//   conv3_fused(f;  GN2+SiLU, skip GEMM over x, residual) -> out (bf16)
//
// conv3_fused is an implicit GEMM over the flattened (B*T) time axis: M =
// B*T frames, N = Cout, K = 3*Cin (the three SAME-conv taps) plus, for a
// skip summed into the output, a second K segment over the block input.
// Its prologue applies GroupNorm + SiLU and rounds to bf16; frames outside
// [0, T) of their own batch row are zero, because SAME padding comes after
// the activation. The weights are (Cout, 3*Cin), each B tile one contiguous
// run per output channel. The epilogue adds the bias and FiLM (conv 1) or
// the skip bias and residual (conv 2) in fp32.
//
// Bound on the H100 at the main path's shapes: 2-4 rows give M = 128-2064,
// so the weights (0.4-12.6 MB a conv) are the traffic that counts, and at
// M = 128 the conv does 128 FLOP per weight byte, below the card's ~295:
// those convs are bound by weight bytes, the larger-M ones by tensor-core
// operations. The first design (wmma 16x16x16, one tile in shared memory, 64x64
// tiles on 32-96 blocks, GN+SiLU recomputed per tap and per N tile) ran at
// 3-14 TFLOP/s there. This design:
//  - wgmma.mma_async m64nNk16 (N = 64 or 128) from one or two consumer
//    warpgroups, A in registers (ldmatrix from a padded window), B (the
//    weights) in shared memory behind a 128-byte-swizzle descriptor, and a
//    helper warpgroup that shares the copies and the activation;
//  - a 3-stage ring filled by cp.async (each chunk's weights and raw input
//    rows), two chunks in flight while the tensor cores run the third;
//  - each chunk of 64 input channels activated once per block: a window of
//    BM+2 frames, which the three taps read shifted by one frame (a lane's
//    row address; the zero row where a tap leaves its batch row), the next
//    chunk's window activated while this chunk's wgmmas run;
//  - a grid planned in Python (ops/resblock.py conv3_plan: the candidate of
//    least time under a cost model measured on the card), with a K split
//    over the blocks of a thread-block cluster; the ranks' fp32 tiles are
//    summed from distributed shared memory in rank order (the same bits
//    every run, no atomics, no partial tensor in device memory). A
//    kept-apart skip doubles N: its tiles are blocks of their own.
// Widths: Cin, Cin2 and Cout any positive count and any C/G. A last K chunk
// narrower than 64 channels comes in zero-filled (weights and activation
// window alike), so the wgmma K loop runs over zeros there; a last N tile
// past Cout loads zero weights and stores nothing; where a thread's 8
// channels straddle GroupNorm groups (C/G 1, 2, 4, 6, 12, ...) its prologue
// reads each channel's own statistics. These masks live in the NARROW
// form (FORM 1) alone, which the launch picks from the shape: the
// flagship's widths (multiples of 64 and of BN, C/G a multiple of 8) run
// the kernel without them. A width off the 8-channel unit (a row stride off
// the 16-byte unit cp.async moves: 12, 20, 21, ...) takes the ODD form
// (FORM 2): each 16-byte unit of a row comes in by the widest access the
// row's stride allows (sm90::copy16_any: cp.async of 8 or 4 bytes, or 2-byte
// loads), only its channels inside the tensor, into the same zero-filled
// shared tiles, so the wgmma K loop and its descriptors are the same; the
// prologue reads gamma and beta and the epilogue stores one channel at a
// time.
// What bounds it now, measured: not the tensor cores (a chunk's 12 wgmmas
// take a fraction of its ~3 us) but each block's serial chain per chunk of
// copy issue, barrier, activation and wgmma, and the waves of a grid that
// holds one block per SM (PERF.md).
// gn_stats is one pass over its input, bound by bytes in principle (0.0134
// ms a 4-row forward's 30 launches) and in practice by a launch's own floor
// (about 5 us each on the H100 under chip_smoke.py's timer). The first
// design, one block per (row, group) walking T x C/G one scalar at a time
// with a division per element, took 14 us a launch at 4 rows and 180 us at
// T=12920, where 16 blocks ran on 132 SMs. This one (below) splits T over a
// cluster so the grid comes near one block an SM at every row count, loads
// 16-byte vectors several at a time, and sums the cluster's ranks in order.

#include <type_traits>

#include "common.cuh"
#include "sm90_gemm.cuh"

namespace {

// ---------------------------------------------------------------- gn_stats
// Per (row, group): fp32 sum and sum of squares over T x C/G, then fast
// variance E[x^2] - E[x]^2 as in the TPU kernel. Grid (G, B, S): the S
// blocks of a thread-block cluster along z split T (rank r takes frames
// [T*r/S, T*(r+1)/S)), so the grid fills the card where B*G blocks would not
// (ops/resblock.py gn_stats_plan). A block reads its frames' runs of the
// group's C/G channels in VW-element vectors (16 bytes, or scalars where a
// run is not a whole number of them), GN_UNROLL in flight a thread; each
// thread walks its (frame, vector) units by fixed steps, so no division per
// element. Warps reduce by shuffles, the block's warps in order through
// shared memory, and the cluster's ranks in rank order in rank 0's shared
// memory, which the others write remotely: the same bits on every launch,
// no atomics, one cluster barrier.
constexpr int GN_THREADS = 512;
constexpr int GN_UNROLL = 4;
constexpr int GN_SPLIT_MAX = 8;  // the portable cluster size

template <int VW, typename In>
__device__ __forceinline__ void load_vw(const In* p, float* v) {
  if constexpr (VW == 1) {
    v[0] = to_f(*p);
  } else if constexpr (std::is_same<In, float>::value) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    load8(p, v);
  }
}

struct GnStatsArgs {
  const void* x;  // (B, T, C), bf16 or fp32
  float* mean;    // (B, G)
  float* rstd;
  int T, C, G;
  float eps;
};

// SUMS: the sums form for a sequence-sharded tensor (parallel/sequence.py):
// the fp32 sum and sum of squares of this shard's frames go to mean and rstd
// as they are, for the caller to add over the shards and finish as below
template <typename In, int VW, bool SUMS>
__global__ void __launch_bounds__(GN_THREADS) gn_stats_kernel(const GnStatsArgs p) {
  const int g = blockIdx.x, b = blockIdx.y, S = gridDim.z, rank = blockIdx.z;
  const int T = p.T, C = p.C, G = p.G;
  const int cg = C / G, V = cg / VW;  // vectors a frame of the group
  const int f0 = (int)((long long)T * rank / S), nf = (int)((long long)T * (rank + 1) / S) - f0;
  const In* xg = static_cast<const In*>(p.x) + ((size_t)b * T + f0) * C + (size_t)g * cg;
  // unit u = tid + k * GN_THREADS is (frame u / V, vector u % V); a step of
  // GN_THREADS units is df frames and dv vectors
  const int df = GN_THREADS / V, dv = GN_THREADS - df * V;
  int f = threadIdx.x / V, v = threadIdx.x - f * V;
  float s = 0.f, ss = 0.f;
  while (f < nf) {
    float e[GN_UNROLL][VW];
#pragma unroll
    for (int u = 0; u < GN_UNROLL; ++u) {
      if (f < nf) {
        load_vw<VW>(xg + (size_t)f * C + v * VW, e[u]);
      } else {
#pragma unroll
        for (int i = 0; i < VW; ++i) e[u][i] = 0.f;
      }
      f += df;
      v += dv;
      if (v >= V) {
        v -= V;
        ++f;
      }
    }
#pragma unroll
    for (int u = 0; u < GN_UNROLL; ++u)
#pragma unroll
      for (int i = 0; i < VW; ++i) {
        s += e[u][i];
        ss += e[u][i] * e[u][i];
      }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  __shared__ float sh_s[GN_THREADS / 32], sh_ss[GN_THREADS / 32];
  __shared__ float2 rank_sums[GN_SPLIT_MAX];  // rank 0's: every rank's block sums
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sh_s[warp] = s;
    sh_ss[warp] = ss;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < GN_THREADS / 32 ? sh_s[lane] : 0.f;
    ss = lane < GN_THREADS / 32 ? sh_ss[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
  }
  if (S > 1) {
    // each rank writes its sums into rank 0's shared memory; after the
    // barrier rank 0 adds them in rank order and the others may leave
    namespace cgrp = cooperative_groups;
    cgrp::cluster_group cluster = cgrp::this_cluster();
    if (threadIdx.x == 0) *cluster.map_shared_rank(&rank_sums[rank], 0) = make_float2(s, ss);
    cluster.sync();
    if (rank == 0 && threadIdx.x == 0) {
      s = ss = 0.f;
      for (int r = 0; r < S; ++r) {
        s += rank_sums[r].x;
        ss += rank_sums[r].y;
      }
    }
  }
  if (SUMS && rank == 0 && threadIdx.x == 0) {
    p.mean[b * G + g] = s;
    p.rstd[b * G + g] = ss;
  } else if (rank == 0 && threadIdx.x == 0) {
    const float n = (float)T * (float)cg;
    const float m = s / n;
    const float var = ss / n - m * m;
    p.mean[b * G + g] = m;
    p.rstd[b * G + g] = rsqrtf(var + p.eps);
  }
}

__global__ void empty_kernel() {}

// ------------------------------------------------------------- conv3_fused
constexpr int NSTAGE = 3;    // weight ring depth (chunks in flight)
constexpr int LDW = 72;      // bf16 row stride of the activation window (144 bytes)

// the kernel's shared-memory layout; smem(splits) is what the launch must
// give it (ops/resblock.py _conv3_smem computes the same)
template <typename In, int MW, int BN>
struct ConvGeo {
  static constexpr int BM = 64 * MW;
  static constexpr int TAP_BYTES = BN * 128, STAGE_BYTES = 3 * TAP_BYTES;
  static constexpr int WIN_BYTES = (BM + 3) * LDW * 2;
  static constexpr int RAW_LD = 64 * (int)sizeof(In) + 16;  // bytes a staged raw row
  static constexpr int RAW_BYTES = (BM + 2) * RAW_LD;
  static constexpr int BODY = NSTAGE * STAGE_BYTES + 2 * WIN_BYTES + NSTAGE * RAW_BYTES;
  // alignment slack, then the rings and windows, or a split's fp32 tile
  static constexpr int smem(int splits) {
    return 1024 + (splits > 1 && BM * BN * 4 > BODY ? BM * BN * 4 : BODY);
  }
};

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
  int col_lo, col_hi;  // PART: this rank's output columns [col_lo, col_hi)
};

// Block: MW consumer warpgroups, BM = 64*MW output rows of the flattened
// (B*T) time axis by BN output channels; grid (M tiles, N tiles, K split),
// the split being the cluster's z extent. With a kept-apart skip the N
// axis is doubled: tiles at n0 >= cout run the 1x1 skip GEMM into out2.
// K walks in chunks of 64 input channels. A chunk's weights (3 taps, or 1
// for a skip chunk) and its BM+2 raw input rows come in by cp.async, NSTAGE
// - 1 chunks ahead; each thread copies exactly the raw elements it later
// activates, so its own wait suffices. All MW+1 warpgroups share the copies
// and the activation; the first MW issue the wgmmas and hold the tile. (The
// helper doubles the threads of the latency-bound copy and activation
// work, which otherwise outlasts the chunk's tensor-core work.) A conv chunk activates the window of
// BM+2 frames once (GN+SiLU, bf16) and feeds three taps (12 wgmma k16
// steps); a skip chunk copies its rows and feeds one.
// FORM 3-5 are forms 0-2 in the PART form (tensor parallelism's
// row-parallel conv 2, parallel/tensor.py): the input channels are this
// rank's share of the conv's, w its (cout, 3*cin) shard, and the fp32
// output a partial sum over the ranks; the bias, the residual and the skip
// (w2 the rank's (col_hi - col_lo, cin2) shard) are added in this rank's
// columns [col_lo, col_hi) alone, so one all-reduce of the outputs adds each
// once. A kept-apart skip writes its (B, T, col_hi - col_lo) columns. Forms
// 0-2 do not read col_lo/col_hi.
template <typename In, typename Out, int MW, int BN, int FORM>
__global__ void __launch_bounds__(128 * (MW + 1)) conv3_fused_kernel(const ConvArgs p) {
  // FORM % 3 == 0: every width whole tiles; 1 (NARROW): partial K chunks and
  // N tiles, per-channel groups; 2 (ODD): besides, rows off the 16-byte unit
  constexpr bool NARROW = FORM % 3 >= 1, ODD = FORM % 3 == 2, PART = FORM >= 3;
  using D = ConvGeo<In, MW, BN>;
  constexpr int NT = 128 * (MW + 1), BM = D::BM;  // MW consumers and one helper
  constexpr int ZROW = BM + 2;  // an all-zero window row: taps outside [0, T)
  constexpr int TAP_BYTES = D::TAP_BYTES, STAGE_BYTES = D::STAGE_BYTES;
  constexpr int WIN_BYTES = D::WIN_BYTES, RAW_LD = D::RAW_LD, RAW_BYTES = D::RAW_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem;
  bf16* win = reinterpret_cast<bf16*>(smem + NSTAGE * STAGE_BYTES);
  uint8_t* raw = smem + NSTAGE * STAGE_BYTES + 2 * WIN_BYTES;

  const int tid = threadIdx.x, wg = tid >> 7, tid_wg = tid & 127, lane = tid & 31;
  const int T = p.T, cin = p.cin, cout = p.cout, M = p.B * T;
  const int m0 = blockIdx.x * BM;
  // N tiles: the conv's ceil(Cout / BN), then (kept-apart skip) as many
  // again for the skip projection; wrow0 is the tile's first output channel
  const int ntc = (cout + BN - 1) / BN;
  const bool skip_tile = p.out2 != nullptr && (int)blockIdx.y >= ntc;
  const int wrow0 = (skip_tile ? (int)blockIdx.y - ntc : (int)blockIdx.y) * BN;
  const int nconv = skip_tile ? 0 : (cin + 63) / 64;
  // PART: the skip's rows are this rank's columns (the conv's from scol0,
  // a kept-apart tile's from 0); a summed skip's chunks run in the tiles
  // that meet them
  const int srows = PART ? p.col_hi - p.col_lo : cout, scol0 = PART && !skip_tile ? p.col_lo : 0;
  const bool skip_k = PART ? skip_tile || (p.x2 != nullptr && p.out2 == nullptr &&
                                           wrow0 < p.col_hi && wrow0 + BN > p.col_lo)
                           : skip_tile || (p.x2 != nullptr && p.out2 == nullptr);
  const int nskip = skip_k ? (p.cin2 + 63) / 64 : 0;
  const int nch = nconv + nskip;
  const int S = gridDim.z, rank = blockIdx.z;
  const int ch_beg = nch * rank / S, ch_end = nch * (rank + 1) / S;
  const int L = ch_end - ch_beg;
  const int cg = cin / p.groups;
  const int g8 = tid & 7;  // this thread's 8 channels of every chunk

  // chunk j into ring stage s: weights, and the raw rows q = m0 - 1 + jr
  auto load_chunk = [&](int j, int s) {
    const uint32_t base = sm90::smem_u32(ring + s * STAGE_BYTES);
    const uint32_t rbase = sm90::smem_u32(raw + s * RAW_BYTES);
    // units past Cout (rows) or past Cin (channels) are zero-filled
    if (j < nconv) {
      for (int u = tid; u < 3 * BN * 8; u += NT) {
        const int tap = u / (BN * 8), r = (u >> 3) % BN, c = u & 7, ch = j * 64 + c * 8;
        const bool ok = !NARROW || (wrow0 + r < cout && ch < cin);
        const bf16* src = p.w + (ok ? (size_t)(wrow0 + r) * 3 * cin + tap * cin + ch : 0);
        const uint32_t dst = base + tap * TAP_BYTES + sm90::sw_offset<128>(r, c);
        if constexpr (ODD)
          sm90::copy16_any(dst, src, ok ? 2 * (cin - ch) : 0, sm90::access_bytes(2 * cin));
        else
          sm90::cp_async16(dst, src, ok ? 16 : 0);
      }
      const In* a = static_cast<const In*>(p.a);
      const int ch = j * 64 + g8 * 8;
      const bool cok = !NARROW || ch < cin;
      for (int jr = tid >> 3; jr < BM + 2; jr += NT / 8) {
        const int q = m0 - 1 + jr;
        const bool ok = q >= 0 && q < M && cok;
        const In* src = a + (ok ? (size_t)q * cin + ch : 0);
        const uint32_t dst = rbase + jr * RAW_LD + g8 * 8 * (int)sizeof(In);
#pragma unroll
        for (int h = 0; h < (int)sizeof(In) / 2; ++h) {
          if constexpr (ODD) {
            const int vb = ok ? (cin - ch) * (int)sizeof(In) - 16 * h : 0;
            sm90::copy16_any(dst + 16 * h, vb > 0 ? src + h * 16 / (int)sizeof(In) : a, vb,
                             sm90::access_bytes(cin * (int)sizeof(In)));
          } else
            sm90::cp_async16(dst + 16 * h, src + h * 16 / (int)sizeof(In), ok ? 16 : 0);
        }
      }
    } else {
      const int cin2 = p.cin2;
      for (int u = tid; u < BN * 8; u += NT) {
        const int r = u >> 3, c = u & 7, ch = (j - nconv) * 64 + c * 8;
        const int sr = PART ? wrow0 + r - scol0 : wrow0 + r;  // the skip weight's row
        const bool ok = PART ? sr >= 0 && sr < srows && ch < cin2
                             : !NARROW || (wrow0 + r < cout && ch < cin2);
        const bf16* src = p.w2 + (ok ? (size_t)sr * cin2 + ch : 0);
        const uint32_t dst = base + sm90::sw_offset<128>(r, c);
        if constexpr (ODD)
          sm90::copy16_any(dst, src, ok ? 2 * (cin2 - ch) : 0, sm90::access_bytes(2 * cin2));
        else
          sm90::cp_async16(dst, src, ok ? 16 : 0);
      }
      const int ch = (j - nconv) * 64 + g8 * 8;
      const bool cok = !NARROW || ch < cin2;
      for (int jr = tid >> 3; jr < BM + 2; jr += NT / 8) {
        const int q = m0 - 1 + jr;
        const bool ok = q >= 0 && q < M && cok;
        const bf16* src = p.x2 + (ok ? (size_t)q * cin2 + ch : 0);
        if constexpr (ODD)
          sm90::copy16_any(rbase + jr * RAW_LD + g8 * 16, src, ok ? 2 * (cin2 - ch) : 0,
                           sm90::access_bytes(2 * cin2));
        else
          sm90::cp_async16(rbase + jr * RAW_LD + g8 * 16, src, ok ? 16 : 0);
      }
    }
  };

  // this thread's window rows jr = tid/8 + it*NT/8 and their batch rows
  // (-1 outside [0, M)), computed once: the chunks differ only in channels
  constexpr int ITER = (BM + 2 + NT / 8 - 1) / (NT / 8);
  int brow[ITER];
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int jr = (tid >> 3) + it * (NT / 8), q = m0 - 1 + jr;
    brow[it] = (jr < BM + 2 && q >= 0 && q < M) ? q / T : -1;
  }

  // window rows jr = 0..BM+1 hold frames q = m0 - 1 + jr, from the staged
  // raw rows of stage s (the elements this thread copied itself)
  auto activate = [&](int j, int s, int buf) {
    bf16* wb = win + buf * (WIN_BYTES / 2);
    const uint8_t* rs_ = raw + s * RAW_BYTES;
    if (j < nconv) {
      // channels past Cin stay zero; where this thread's 8 channels straddle
      // groups, each reads its own group's statistics
      const int c = j * 64 + g8 * 8, gi = c / cg;
      const bool cok = !NARROW || c < cin, mixed = NARROW && cok && (c + 7) / cg != gi;
      float ga[8], be[8];
      if constexpr (ODD) {  // the channels inside Cin, one at a time
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          ga[e] = c + e < cin ? __ldg(p.gamma + c + e) : 0.f;
          be[e] = c + e < cin ? __ldg(p.beta + c + e) : 0.f;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; e += 4) {
          const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
          *reinterpret_cast<float4*>(ga + e) =
              cok ? __ldg(reinterpret_cast<const float4*>(p.gamma + c + e)) : z4;
          *reinterpret_cast<float4*>(be + e) =
              cok ? __ldg(reinterpret_cast<const float4*>(p.beta + c + e)) : z4;
        }
      }
#pragma unroll
      for (int it = 0; it < ITER; ++it) {
        const int jr = (tid >> 3) + it * (NT / 8);
        if (jr < BM + 2) {
          uint4 o = make_uint4(0, 0, 0, 0);
          if (brow[it] >= 0 && cok) {
            float v[8];
            load8(reinterpret_cast<const In*>(rs_ + jr * RAW_LD) + g8 * 8, v);
            const int s0 = brow[it] * p.groups;
            uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
            if (!mixed) {
              const float mu = __ldg(p.mean + s0 + gi), rstd = __ldg(p.rstd + s0 + gi);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float y0 = (v[2 * e] - mu) * rstd * ga[2 * e] + be[2 * e];
                const float y1 = (v[2 * e + 1] - mu) * rstd * ga[2 * e + 1] + be[2 * e + 1];
                ow[e] = sm90::pack_bf16x2(sm90::silu_fast(y0), sm90::silu_fast(y1));
              }
            } else {
#pragma unroll
              for (int e = 0; e < 8; ++e) {
                // ODD: a channel past Cin (zero, gamma and beta 0) reads the last group's
                const int si = s0 + (ODD ? min((c + e) / cg, p.groups - 1) : (c + e) / cg);
                v[e] = sm90::silu_fast((v[e] - __ldg(p.mean + si)) * __ldg(p.rstd + si) * ga[e] +
                                       be[e]);
              }
#pragma unroll
              for (int e = 0; e < 4; ++e) ow[e] = sm90::pack_bf16x2(v[2 * e], v[2 * e + 1]);
            }
          }
          *reinterpret_cast<uint4*>(wb + jr * LDW + g8 * 8) = o;
        }
      }
    } else {
#pragma unroll
      for (int it = 0; it < ITER; ++it) {
        const int jr = (tid >> 3) + it * (NT / 8);
        if (jr < BM + 2)
          *reinterpret_cast<uint4*>(wb + jr * LDW + g8 * 8) =
              *reinterpret_cast<const uint4*>(rs_ + jr * RAW_LD + g8 * 16);
      }
    }
  };

  // this lane's ldmatrix row for each tap: window row r + tap, or the zero
  // row where frame t + tap - 1 leaves [0, T) (never the neighbouring
  // batch row) or the output row is past M
  int arow[3];
  {
    const int r = wg * 64 + (tid_wg >> 5) * 16 + (lane & 15);
    const int m = m0 + r, t = m % T;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      arow[k] = (m < M && t + k - 1 >= 0 && t + k - 1 < T) ? r + k : ZROW;
  }
  const uint32_t acol = (lane >> 4) * 16;  // bytes: k 0-7 or 8-15 of a k16 step

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  if (tid < 16) {  // the zero row of both windows
    *reinterpret_cast<uint4*>(win + (tid >> 3) * (WIN_BYTES / 2) + ZROW * LDW + (tid & 7) * 8) =
        make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < L) load_chunk(ch_beg + s, s);
    sm90::cp_async_commit();
  }
  if (L > 0) {
    sm90::cp_async_wait<NSTAGE - 2>();
    activate(ch_beg, 0, 0);
  }

  // one tap: 4 k16 steps of A fragments (ldmatrix) and wgmma against tile
  auto tap_mma = [&](uint32_t (&fr)[4][4], uint32_t wbase, int row, uint32_t tile) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::ldmatrix_x4(fr[kk], wbase + row * (LDW * 2) + acol + kk * 32);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_rs<BN>(acc, fr[kk], sm90::desc_kmajor<128>(tile + kk * 32));
    sm90::wgmma_commit();
  };

  // per chunk: one barrier; the next chunk's copies go out, this chunk's
  // taps go to the tensor cores, and the next chunk's window is activated
  // while they run
  for (int i = 0; i < L; ++i) {
    const int j = ch_beg + i, s = i % NSTAGE;
    sm90::cp_async_wait<NSTAGE - 2>();  // this thread's copies of chunk j landed
    sm90::fence_proxy_async();
    __syncthreads();  // every thread's weights and window rows of chunk j are in
    if (i + NSTAGE - 1 < L) load_chunk(j + NSTAGE - 1, (i + NSTAGE - 1) % NSTAGE);
    sm90::cp_async_commit();
    const uint32_t wbase = sm90::smem_u32(win + (i & 1) * (WIN_BYTES / 2));
    const uint32_t stage = sm90::smem_u32(ring + s * STAGE_BYTES);
    uint32_t fa[4][4], fb[4][4];
    if (wg < MW) {
      if (j < nconv) {
        tap_mma(fa, wbase, arow[0], stage);
        tap_mma(fb, wbase, arow[1], stage + TAP_BYTES);
      } else {
        tap_mma(fa, wbase, arow[1], stage);
      }
    }
    if (i + 1 < L) {
      sm90::cp_async_wait<NSTAGE - 2>();  // chunk j + 1's raw rows (this thread's)
      activate(j + 1, (i + 1) % NSTAGE, (i + 1) & 1);
    }
    if (wg < MW) {
      if (j < nconv) {
        sm90::wgmma_wait<1>();  // tap 0 done: its fragment registers are free
        tap_mma(fa, wbase, arow[2], stage + 2 * TAP_BYTES);
      }
      sm90::wgmma_wait<0>();
    }
  }
  sm90::cp_async_wait<0>();

  // the epilogue, two neighbouring output channels n, n + 1 at a time (n
  // even; Cout a multiple of 8, so a pair is wholly inside Cout or past it),
  // or in the ODD form one channel at a time
  Out* out = static_cast<Out*>(p.out);
  // PART: channel n (< srows in a kept-apart skip tile, else < cout)
  auto store_part = [&](int m, int n, float v) {
    if (skip_tile) {
      p.out2[(size_t)m * srows + n] = from_f<bf16>(v + __ldg(p.bias2 + n));
      return;
    }
    const size_t o = (size_t)m * cout + n;
    float h = v;
    if (n >= p.col_lo && n < p.col_hi) {
      h += __ldg(p.bias + n);
      if (p.x2 && !p.out2)  // the summed skip
        h += __ldg(p.bias2 + n - p.col_lo);
      else if (p.res)
        h += to_f(p.res[o]);
    }
    out[o] = from_f<Out>(h);
  };
  auto store1 = [&](int m, int n, float v) {  // ODD: channel n < Cout
    const size_t o = (size_t)m * cout + n;
    if (skip_tile) {
      p.out2[o] = from_f<bf16>(v + __ldg(p.bias2 + n));
      return;
    }
    float h = v + __ldg(p.bias + n);
    if (p.out_pre) p.out_pre[o] = h;
    if (p.film_scale) {
      const int fo = (m / T) * cout + n;
      h = h * (1.f + __ldg(p.film_scale + fo)) + __ldg(p.film_shift + fo);
    }
    if (p.x2 && !p.out2)
      h += __ldg(p.bias2 + n);
    else if (p.res)
      h += to_f(p.res[o]);
    out[o] = from_f<Out>(h);
  };
  auto store2 = [&](int m, int n, float v0, float v1) {
    if constexpr (PART) {
      const int nmax = skip_tile ? srows : cout;
      if (n < nmax) store_part(m, n, v0);
      if (n + 1 < nmax) store_part(m, n + 1, v1);
      return;
    }
    if constexpr (ODD) {
      if (n < cout) store1(m, n, v0);
      if (n + 1 < cout) store1(m, n + 1, v1);
      return;
    }
    if (NARROW && n >= cout) return;  // a last N tile's columns past Cout
    if (skip_tile) {
      const float2 b2 = __ldg(reinterpret_cast<const float2*>(p.bias2 + n));
      sm90::store_pair(p.out2 + (size_t)m * cout + n, v0 + b2.x, v1 + b2.y);
      return;
    }
    const size_t o = (size_t)m * cout + n;
    const float2 bi = __ldg(reinterpret_cast<const float2*>(p.bias + n));
    float h0 = v0 + bi.x, h1 = v1 + bi.y;
    if (p.out_pre) sm90::store_pair(p.out_pre + o, h0, h1);  // z1, for the FiLM-scale gradient
    if (p.film_scale) {
      const int fo = (m / T) * cout + n;
      const float2 fs = __ldg(reinterpret_cast<const float2*>(p.film_scale + fo));
      const float2 fh = __ldg(reinterpret_cast<const float2*>(p.film_shift + fo));
      h0 = h0 * (1.f + fs.x) + fh.x;
      h1 = h1 * (1.f + fs.y) + fh.y;
    }
    if (p.x2 && !p.out2) {  // the skip GEMM summed into the same accumulator
      const float2 b2 = __ldg(reinterpret_cast<const float2*>(p.bias2 + n));
      h0 += b2.x;
      h1 += b2.y;
    } else if (p.res) {
      const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.res + o));
      h0 += r.x;
      h1 += r.y;
    }
    sm90::store_pair(out + o, h0, h1);
  };

  if (S == 1) {
    if (wg == MW) return;  // the helper holds no tile
    const int r0 = wg * 64 + (tid_wg >> 5) * 16 + ((tid_wg & 31) >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + r0 + 8 * h;
      if (m < M) {
#pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj)
          store2(m, wrow0 + 8 * jj + (tid_wg & 3) * 2, acc[4 * jj + 2 * h],
                 acc[4 * jj + 2 * h + 1]);
      }
    }
  } else {
    __syncthreads();  // every warpgroup's wgmma has left the ring
    float* red = reinterpret_cast<float*>(smem);
    if (wg < MW) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        red[(wg * 64 + sm90::acc_row(i, tid_wg)) * BN + sm90::acc_col(i, tid_wg)] = acc[i];
    }
    sm90::cluster_reduce(red, BM * BN, [&](int e, float4 v) {
      const int m = m0 + e / BN, n = wrow0 + e % BN;
      if (m < M) {
        store2(m, n, v.x, v.y);
        store2(m, n + 2, v.z, v.w);
      }
    });
  }
}

constexpr int ERR_PLAN = -3;  // a launch plan the kernel does not take (ops/_build.py)

template <typename In, int VW, bool SUMS>
int launch_gn(const void* x, float* mean, float* rstd, int B, int T, int C, int G, int splits,
              float eps, cudaStream_t s) {
  GnStatsArgs p{x, mean, rstd, T, C, G, eps};
  static bool attr_set = false;
  return (int)sm90::launch_cluster(gn_stats_kernel<In, VW, SUMS>, attr_set, dim3(G, B, splits),
                                   GN_THREADS, 0, splits, s, p);
}

// 16-byte vectors where every run of a group's channels is whole vectors
// from a 16-byte boundary, scalars otherwise
template <typename In, bool SUMS>
int launch_gn_vw(const void* x, float* mean, float* rstd, int B, int T, int C, int G,
                 int splits, float eps, cudaStream_t s) {
  constexpr int VW = 16 / (int)sizeof(In);
  if ((C / G) % VW == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    return launch_gn<In, VW, SUMS>(x, mean, rstd, B, T, C, G, splits, eps, s);
  return launch_gn<In, 1, SUMS>(x, mean, rstd, B, T, C, G, splits, eps, s);
}

// the plan's grid and shared memory must be this kernel's for the shape: too
// few M or N tiles would leave output unwritten, a split past the K chunks
// would give ranks nothing to sum, too little shared memory would overrun
// the ring. Any positive widths.
template <typename In, typename Out, int MW, int BN, bool PART>
int launch_conv(const ConvArgs& p, int mtiles, int ntiles, int splits, int smem,
                cudaStream_t s) {
  using D = ConvGeo<In, MW, BN>;
  if (p.cin < 1 || p.cin2 < 0 || p.cout < 1 || p.groups < 1 || p.cin % p.groups)
    return (int)cudaErrorInvalidValue;
  if (PART && (p.col_lo < 0 || p.col_hi <= p.col_lo || p.col_hi > p.cout))
    return (int)cudaErrorInvalidValue;
  const int srows = PART ? p.col_hi - p.col_lo : p.cout;
  const int ntot = (p.cout + BN - 1) / BN + (p.out2 ? (srows + BN - 1) / BN : 0);
  const int nconv = (p.cin + 63) / 64, nskip = (p.cin2 + 63) / 64;
  // a PART summed skip runs in some tiles only: the others have the conv's chunks
  const int kmin = p.out2 ? (nconv < nskip ? nconv : nskip) : PART ? nconv : nconv + nskip;
  if (mtiles != (p.B * p.T + D::BM - 1) / D::BM || ntiles != ntot || splits < 1 ||
      splits > 8 || splits > kmin || smem != D::smem(splits))
    return ERR_PLAN;
  // the masked form where a K chunk or N tile is partial, or a thread's 8
  // channels straddle groups; the ODD form where a width is off the
  // 8-channel unit (a row stride off the 16-byte unit)
  const bool odd = p.cin % 8 || p.cin2 % 8 || p.cout % 8;
  const bool narrow = p.cin % 64 || p.cin2 % 64 || p.cout % BN || (p.cin / p.groups) % 8;
  static bool attr_set[3] = {false, false, false};
  const dim3 grid(mtiles, ntiles, splits);
  constexpr int F0 = PART ? 3 : 0;  // the PART form's instantiations
  if (odd)
    return (int)sm90::launch_cluster(conv3_fused_kernel<In, Out, MW, BN, F0 + 2>, attr_set[2],
                                     grid, 128 * (MW + 1), smem, splits, s, p);
  if (narrow)
    return (int)sm90::launch_cluster(conv3_fused_kernel<In, Out, MW, BN, F0 + 1>, attr_set[1],
                                     grid, 128 * (MW + 1), smem, splits, s, p);
  return (int)sm90::launch_cluster(conv3_fused_kernel<In, Out, MW, BN, F0>, attr_set[0], grid,
                                   128 * (MW + 1), smem, splits, s, p);
}

template <typename In, typename Out, bool PART = false>
int launch_conv_plan(const ConvArgs& p, int mw, int bn, int mtiles, int ntiles, int splits,
                     int smem, cudaStream_t s) {
  if (bn == 64 && mw == 1)
    return launch_conv<In, Out, 1, 64, PART>(p, mtiles, ntiles, splits, smem, s);
  if (bn == 64 && mw == 2)
    return launch_conv<In, Out, 2, 64, PART>(p, mtiles, ntiles, splits, smem, s);
  if (bn == 128 && mw == 1)
    return launch_conv<In, Out, 1, 128, PART>(p, mtiles, ntiles, splits, smem, s);
  return ERR_PLAN;
}

}  // namespace

// splits: the cluster's blocks along T (1 to 8, at most T); sums: the sums
// form (sum and sum of squares into mean and rstd)
extern "C" int lm2a_gn_stats(const void* x, int x_is_f32, float* mean, float* rstd,
                             int B, int T, int C, int G, int splits, float eps, int sums,
                             void* stream) {
  if (B < 1 || T < 1 || G < 1 || C % G) return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > GN_SPLIT_MAX || splits > T) return ERR_PLAN;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e;
  if (sums)
    e = x_is_f32 ? launch_gn_vw<float, true>(x, mean, rstd, B, T, C, G, splits, eps, s)
                 : launch_gn_vw<bf16, true>(x, mean, rstd, B, T, C, G, splits, eps, s);
  else
    e = x_is_f32 ? launch_gn_vw<float, false>(x, mean, rstd, B, T, C, G, splits, eps, s)
                 : launch_gn_vw<bf16, false>(x, mean, rstd, B, T, C, G, splits, eps, s);
  if (e != 0) return e;
  return (int)cudaGetLastError();
}

// one launch of a kernel that does nothing: the floor of a launch's device time
extern "C" int lm2a_empty_kernel(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

extern "C" int lm2a_conv3_fused(
    const void* a, int a_is_f32, const float* mean, const float* rstd,
    const float* gamma, const float* beta, const void* w, const float* bias,
    const float* film_scale, const float* film_shift, const void* x2,
    const void* w2, const float* bias2, const void* res, void* out, int out_is_f32,
    void* out2, float* out_pre, int B, int T, int cin, int cout, int cin2, int groups,
    int col_lo, int col_hi, int mw, int bn, int mtiles, int ntiles, int splits, int smem,
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
  p.col_lo = col_lo;
  p.col_hi = col_hi;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the chain's two convs: bf16 block input -> fp32 intermediate (conv 1),
  // fp32 intermediate -> bf16 block output (conv 2), and conv 2's PART form
  // (col_hi > 0): fp32 intermediate -> fp32 partial sum
  int e;
  if (col_hi > 0) {
    if (!a_is_f32 || !out_is_f32 || film_scale || out_pre) return (int)cudaErrorInvalidValue;
    e = launch_conv_plan<float, float, true>(p, mw, bn, mtiles, ntiles, splits, smem, s);
  } else if (!a_is_f32 && out_is_f32)
    e = launch_conv_plan<bf16, float>(p, mw, bn, mtiles, ntiles, splits, smem, s);
  else if (a_is_f32 && !out_is_f32)
    e = launch_conv_plan<float, bf16>(p, mw, bn, mtiles, ntiles, splits, smem, s);
  else
    return (int)cudaErrorInvalidValue;
  if (e != 0) return e;
  return (int)cudaGetLastError();
}
