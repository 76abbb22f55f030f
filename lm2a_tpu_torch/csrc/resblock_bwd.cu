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
// conv3_dgrad's bucket sums come as head and tail pieces (below); gn_bwd
// reads them as they are, and the wrapper (ops/resblock_grad.py) sums the
// partials (T tiles of a channel sum) in a fixed order.
//
// conv3_dgrad, d_in[t] = sum_k g[t+1-k] W_k^T (the input-gradient part), is
// conv3_fused's implicit GEMM with the taps reversed, the weights read
// transposed and no activation prologue. At the training shapes its bound
// over a step's 7 gated blocks is the bytes' (0.0966 ms: g, W, the
// GroupNorm input and the fp32 d_y, against 0.4-1.6 GFLOP a call). It runs
// on the main loop of conv3_fused: M = the flattened B*T rows, wgmma with g
// in registers by ldmatrix from a cp.async ring, W behind a transposed
// (tnspB) descriptor, a cluster K split, a launch plan from the measured
// cost model (dgrad_plan). Measured per block (PERF.md), the fixed cost
// (the first loads, the SiLU backward, the bucket sums) outweighs the main
// loop at the gated shapes' 4-8 K chunks.
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
// gn_bwd is one pass over d_y, the GroupNorm input (and z1 or the skip
// term) and its output, bound by bytes (0.1083 ms over a step's 7 gated
// blocks). The first design spent most of its time before its first element:
// 64 threads of each block summed the partial planes of their channel's group
// serially (cg x nT loads each, the other threads waiting), every block of a
// (row, group) again, then scalar loads. This one (below): a block a 64-frame
// bucket and 64 or 128 channels, its tiles in flight to shared memory by
// cp.async while all its threads form the group means from coalesced loads
// of the pieces, then vector stores.

// A shard of a sequence-parallel step (ops/resblock_grad.py
// chain_backward_sharded) takes the halo form of conv3_dgrad (the gradient
// with one neighbour row at each inner end; conv3_dgrad_halo_kernel) and the
// totals form of gn_bwd (the group totals of the whole sequence in place of
// the pieces; gn_bwd_totals_kernel). Each is a kernel of its own around the
// same body (a compile-time HALO or TOTALS), so the local forms keep their
// instructions (scripts/torch_sass_diff.py). Its conv3_wgrad is the local
// kernel on the source with halo rows and the gradient zero-padded to match
// (the wrapper's halo form): a padded row adds nothing, and the zero row
// past a global end is the conv's own padding.

// Widths, as conv3_fused's: any positive channel count and any C/G. A last
// K chunk or channel tile narrower than 64 (or than the block's N) comes in
// zero-filled and stores nothing past the tensor; where a unit of channels
// straddles GroupNorm groups, each channel reads its own group's
// statistics; a width off the 8-channel unit (a row stride off the 16-byte
// unit) reads each 16-byte unit of a row by the widest access its stride
// allows (sm90::copy16_any), into the same zero-filled shared tiles, and
// what the unmasked form moves by vectors (gamma, FiLM, z1, the outputs)
// moves one channel at a time. All of this lives in the MASKED form
// (gn_bwd's per-channel groups in MIX), which the launch picks from the
// shape: the flagship's widths never take it.

#include <type_traits>

#include "common.cuh"
#include "sm90_gemm.cuh"

namespace {

constexpr int TT = 64;   // frames per partial-sum tile (bucket)

// ------------------------------------------------------------ conv3_dgrad
// d_in[m] = sum_k g[m+1-k] W_k^T over the flattened m = (b, t): M = B*T
// rows (64*MW a block), N = Cin (BN a block), K = taps x Cout in chunks of
// 64 output channels (the last one 32 wide when Cout % 64 == 32), all taps
// of a chunk together. A chunk's weights (taps tiles of 64 K rows x BN
// channels, MN-major: W's rows hold Cin contiguously, read with tnspB = 1
// behind a 128-byte-swizzle descriptor, atoms of 64 channels 8 KB apart)
// and its g window (frames m0 - 1 .. m0 + BM of the chunk's channels, raw
// bf16) come in by cp.async into a 3-stage ring, two chunks ahead; tap k of
// output row r reads window row r + 2 - k by ldmatrix, or the all-zero row
// where frame t + 1 - k leaves [0, T) of its batch row. MW consumer
// warpgroups issue the wgmmas; a helper warpgroup shares the copies. The K
// split (a cluster along z, dgrad_plan) sums the ranks' fp32 tiles from
// distributed shared memory in rank order, each rank a slice of the columns.
// The epilogue goes through shared memory: d_y = d * SiLU'(GN(pre)) in fp32,
// then per column the sums of d_y and d_y * xhat over each (b, t // 64)
// bucket, rows in order. A tile may hold the end of a bucket that began in
// the previous tile: the bucket's rows in the tile of its first row are its
// head piece, the rest its tail piece (zero when there is none); each is
// written by one block, and every reader adds head + tail in that order.
constexpr int DG_STAGES = 3;
constexpr int DG_LDW = 72;  // bf16 row stride of a g window (144 bytes)

struct DgradArgs {
  const bf16* g;       // (B, T, cout): gradient of the conv output
  const bf16* w;       // (cout, taps*cin): w[n, k*cin + c] = tap k
  const void* pre;     // (B, T, cin) GroupNorm input (bf16 or fp32), or null: raw
  const float* mean;   // (B, groups)
  const float* rstd;
  const float* gamma;  // (cin,)
  const float* beta;
  float* out;          // (B, T, cin): d_y (act) or the raw product
  float* pieces;       // (2, 2, B, nT, cin): head and tail pieces of each bucket's sums
  int B, T, cin, cout, groups, nT;
  int hl, hr;          // the halo form: g is (B, hl + T + hr, cout), its halo rows the
                       // neighbours' (hl, hr: 1 where the shard has that neighbour)
};

template <int TAPS, int MW, int BN_>
struct DgradGeo {
  static constexpr int BM = 64 * MW;
  static constexpr int TAP_BYTES = 64 * BN_ * 2;  // 64 K rows x BN channels
  static constexpr int WIN_BYTES = ((BM + 3) * DG_LDW * 2 + 1023) / 1024 * 1024;
  static constexpr int STAGE_BYTES = TAPS * TAP_BYTES + WIN_BYTES;
  static constexpr int LDR = BN_ + 4;  // fp32 stride of the epilogue tiles
  static constexpr int RING = DG_STAGES * STAGE_BYTES, EPILOGUE = 2 * BM * LDR * 4;
  // dynamic shared bytes: alignment slack, then the ring or the epilogue's tiles
  static constexpr int SMEM = 1024 + (RING > EPILOGUE ? RING : EPILOGUE);
};

// The halo form (HALO, a shard of a sequence-sharded tensor, 3 taps with the
// SiLU backward): g carries one row of the neighbours' output gradient at
// each inner end (hl, hr), so the frames t + 1 - k that leave [0, T) read
// those rows, and only frames outside [-hl, T + hr) are zero. The window is
// the halo-padded rows from the tile's first frame less one on, so a tile
// row of batch row b reads window row r + 2 - k + (b - b0)(hl + hr). Its M
// tiles run over the flattened B*T rows where 2T >= BM (a tile then meets
// at most 3 batch rows: BM + 6 window rows, inside the window's 1 KB
// rounding), else over each batch row apart (tpr tiles a row, the last one
// partial). out, pre and the bucket pieces keep the local rows.
template <typename Pre, bool ACT, int TAPS, int MW, int BN_, bool MASKED, bool HALO>
__device__ __forceinline__ void conv3_dgrad_body(const DgradArgs& p) {
  using D = DgradGeo<TAPS, MW, BN_>;
  constexpr int NT = 128 * (MW + 1), BM = D::BM;
  constexpr int WROWS = HALO ? BM + 6 : BM + 2;  // window rows loaded
  constexpr int ZROW = WROWS;
  static_assert((ZROW + 1) * DG_LDW * 2 <= D::WIN_BYTES, "the zero row lies in the window");
  constexpr int TAP_BYTES = D::TAP_BYTES, WIN_BYTES = D::WIN_BYTES;
  constexpr int STAGE_BYTES = D::STAGE_BYTES, LDR = D::LDR;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x, tid_wg = tid & 127, lane = tid & 31;
  // the warpgroup, warp-uniform as ptxas can see (else it serializes wgmma)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int T = p.T, cin = p.cin, cout = p.cout, M = p.B * T;
  // HALO: the tile starts at frame t0 of batch row b0; rowwise: it holds
  // frames t0 .. t0 + BM - 1 of that row only (tpr tiles a row)
  const bool rowwise = HALO && 2 * T < BM;
  const int tpr = rowwise ? (T + BM - 1) / BM : 1;
  const int bx = blockIdx.x, rb0 = bx / tpr;
  const int m0 = rowwise ? rb0 * T + (bx - rb0 * tpr) * BM : blockIdx.x * BM;
  const int b0 = HALO ? m0 / T : 0, t0 = HALO ? m0 - b0 * T : 0, hh = HALO ? p.hl + p.hr : 0;
  const int n0 = blockIdx.y * BN_;
  const int nch = (cout + 63) / 64;
  const int S = gridDim.z, rank = blockIdx.z;
  const int ch_beg = nch * rank / S, ch_end = nch * (rank + 1) / S;
  const int L = ch_end - ch_beg;

  auto stage_ptr = [&](int s) { return smem + s * STAGE_BYTES; };
  // chunk j into stage s: the taps' weight tiles, then the window
  auto load_chunk = [&](int j, int s) {
    // K rows past the chunk's channels, up to the k16 steps that read them
    // (32 or 64), and channels past Cin are zero-filled
    const int clen = min(64, cout - 64 * j), krows = clen > 32 ? 64 : 32;
    const uint32_t base = sm90::smem_u32(stage_ptr(s));
    for (int u = tid; u < TAPS * 64 * (BN_ / 8); u += NT) {
      const int tap = u / (64 * (BN_ / 8)), r = (u / (BN_ / 8)) & 63, cc = u % (BN_ / 8);
      if (r >= krows) continue;
      const bool ok = !MASKED || (r < clen && n0 + cc * 8 < cin);
      const bf16* src =
          p.w + (ok ? (size_t)(64 * j + r) * TAPS * cin + tap * cin + n0 + cc * 8 : 0);
      const uint32_t dst =
          base + tap * TAP_BYTES + (cc >> 3) * (64 * 128) + sm90::sw_offset<128>(r, cc & 7);
      if constexpr (MASKED)
        sm90::copy16_any(dst, src, ok ? 2 * (cin - n0 - cc * 8) : 0, sm90::access_bytes(2 * cin));
      else
        sm90::cp_async16(dst, src, ok ? 16 : 0);
    }
    const uint32_t wbase = base + TAPS * TAP_BYTES;
    for (int u = tid; u < WROWS * 8; u += NT) {
      // HALO: row q of the halo-padded g (B rows of T + hl + hr)
      const int jr = u >> 3, c8 = u & 7;
      const int q = HALO ? b0 * (T + hh) + p.hl + t0 - 1 + jr : m0 - 1 + jr;
      const bool ok = q >= 0 && q < (HALO ? p.B * (T + hh) : M) && 8 * c8 < clen;
      const bf16* src = p.g + (ok ? (size_t)q * cout + 64 * j + c8 * 8 : 0);
      if constexpr (MASKED)
        sm90::copy16_any(wbase + jr * (DG_LDW * 2) + c8 * 16, src, ok ? 2 * (clen - 8 * c8) : 0,
                         sm90::access_bytes(2 * cout));
      else
        sm90::cp_async16(wbase + jr * (DG_LDW * 2) + c8 * 16, src, ok ? 16 : 0);
    }
  };

  // this lane's ldmatrix row for each tap: window row r + 2 - k (frame
  // t + 1 - k; HALO: + (b - b0)(hl + hr)), or the zero row where that frame
  // leaves [0, T) of the row's batch row (HALO: [-hl, T + hr)) or the
  // output row is past M (rowwise: past its batch row)
  int arow[TAPS];
  {
    const int r = wg * 64 + (tid_wg >> 5) * 16 + (lane & 15);
    const int m = m0 + r, b = !HALO ? 0 : rowwise ? b0 : m / T;
    const int t = !HALO ? m % T : rowwise ? t0 + r : m - b * T;
#pragma unroll
    for (int k = 0; k < TAPS; ++k) {
      const int src_t = TAPS == 3 ? t + 1 - k : t;
      const bool in = HALO ? (rowwise ? t < T : m < M) && src_t >= -p.hl && src_t < T + p.hr
                           : m < M && src_t >= 0 && src_t < T;
      arow[k] = in ? r + (TAPS == 3 ? 2 - k : 1) + (b - b0) * hh : ZROW;
    }
  }
  const uint32_t acol = (lane >> 4) * 16;  // bytes: k 0-7 or 8-15 of a k16 step

  float acc[BN_ / 2];
#pragma unroll
  for (int i = 0; i < BN_ / 2; ++i) acc[i] = 0.f;

  if (tid < 8 * DG_STAGES) {  // the zero row of every stage's window
    uint8_t* wz = stage_ptr(tid >> 3) + TAPS * TAP_BYTES + ZROW * (DG_LDW * 2) + (tid & 7) * 16;
    *reinterpret_cast<uint4*>(wz) = make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int s = 0; s < DG_STAGES - 1; ++s) {
    if (s < L) load_chunk(ch_beg + s, s);
    sm90::cp_async_commit();
  }

  for (int i = 0; i < L; ++i) {
    const int j = ch_beg + i, s = i % DG_STAGES;
    sm90::cp_async_wait<DG_STAGES - 2>();  // this thread's copies of chunk j landed
    sm90::fence_proxy_async();
    __syncthreads();  // every thread's weights and window rows of chunk j are in
    if (i + DG_STAGES - 1 < L) load_chunk(j + DG_STAGES - 1, (i + DG_STAGES - 1) % DG_STAGES);
    sm90::cp_async_commit();
    if (wg < MW) {
      const uint32_t tiles = sm90::smem_u32(stage_ptr(s));
      const uint32_t wbase = tiles + TAPS * TAP_BYTES;
      // all taps of the chunk: NK k16 steps each (4, or 2 for a last chunk
      // of at most 32 channels; the rows past it are zeros)
      auto chunk_mma = [&](auto nk) {
        constexpr int NK = decltype(nk)::value;
        uint32_t fr[TAPS][NK][4];
#pragma unroll
        for (int k = 0; k < TAPS; ++k)
#pragma unroll
          for (int kk = 0; kk < NK; ++kk)
            sm90::ldmatrix_x4(fr[k][kk], wbase + arow[k] * (DG_LDW * 2) + acol + kk * 32);
        sm90::wgmma_fence();
#pragma unroll
        for (int k = 0; k < TAPS; ++k)
#pragma unroll
          for (int kk = 0; kk < NK; ++kk)
            sm90::wgmma_rs<BN_, 1>(acc, fr[k][kk],
                                   sm90::desc_mn<128>(tiles + k * TAP_BYTES + kk * 2048, 64 * 128));
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
      };
      if (cout - 64 * j > 32)
        chunk_mma(std::integral_constant<int, 4>());
      else
        chunk_mma(std::integral_constant<int, 2>());
    }
  }
  sm90::cp_async_wait<0>();
  __syncthreads();  // every warpgroup's wgmma has left the ring

  // the fp32 tile [BM][LDR] (then d_y), and d_y * xhat [BM][LDR] after it
  float* red = reinterpret_cast<float*>(smem);
  float* xs = red + BM * LDR;
  if (wg < MW) {
#pragma unroll
    for (int i = 0; i < BN_ / 2; ++i)
      red[(wg * 64 + sm90::acc_row(i, tid_wg)) * LDR + sm90::acc_col(i, tid_wg)] = acc[i];
  }
  __shared__ int rowb[BM];  // each tile row's batch row
  if (tid < BM) rowb[tid] = min(m0 + tid, M - 1) / T;
  // this block's columns of the tile: all of them, or its slice of a split
  int c_beg = 0, ncols = BN_;
  if (S > 1) {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every rank's tile written
    c_beg = BN_ * rank / S;
    ncols = BN_ * (rank + 1) / S - c_beg;
    for (int e = tid; e < BM * ncols; e += NT) {
      const int o = (e / ncols) * LDR + c_beg + e % ncols;
      float v = 0.f;
      for (int q = 0; q < S; ++q) v += cluster.map_shared_rank(red, q)[o];
      red[o] = v;  // peers read only their own columns of this tile
    }
  }
  __syncthreads();

  // a thread takes one column of the tile (its GroupNorm group computed
  // once) and every RSTEP-th row; each row's batch index comes from rowb,
  // so no integer division is left per element. EU rows a thread at a time,
  // their global loads issued together.
  constexpr int RSTEP = NT / BN_, EU = 8;
  const int nrow = rowwise ? min(BM, T - t0) : min(BM, M - m0);
  const int col = tid % BN_, gcc = n0 + col;
  if (col >= c_beg && col < c_beg + ncols && (!MASKED || gcc < cin)) {
    if (!ACT) {
      for (int r = tid / BN_; r < nrow; r += RSTEP)
        p.out[(size_t)(m0 + r) * cin + gcc] = red[r * LDR + col];
    } else {
      const Pre* pre = static_cast<const Pre*>(p.pre);
      const int gcol = gcc / (cin / p.groups);
      const float ga = __ldg(p.gamma + gcc), be = __ldg(p.beta + gcc);
      for (int r0 = tid / BN_; r0 < nrow; r0 += RSTEP * EU) {
        float xv[EU], mu[EU], rs[EU];
#pragma unroll
        for (int u = 0; u < EU; ++u) {
          const int r = min(r0 + u * RSTEP, nrow - 1), gi = rowb[r] * p.groups + gcol;
          xv[u] = to_f(pre[(size_t)(m0 + r) * cin + gcc]);
          mu[u] = __ldg(p.mean + gi);
          rs[u] = __ldg(p.rstd + gi);
        }
#pragma unroll
        for (int u = 0; u < EU; ++u) {
          const int r = r0 + u * RSTEP;
          if (r >= nrow) break;
          const float xh = (xv[u] - mu[u]) * rs[u];
          const float y = xh * ga + be;
          // sigmoid by the MUFU exponential and a rounded reciprocal (~1e-7
          // relative against torch.sigmoid, inside conv3_dgrad's 1e-5)
          const float sig = __frcp_rn(1.f + __expf(-y));
          const float dy = red[r * LDR + col] * (sig * (1.f + y * (1.f - sig)));
          p.out[(size_t)(m0 + r) * cin + gcc] = dy;
          red[r * LDR + col] = dy;
          xs[r * LDR + col] = dy * xh;
        }
      }
    }
  }
  if (ACT) {
    __syncthreads();
    // one column of one sum per thread, rows in order, a write at the end
    // of each bucket's piece
    const size_t plane = (size_t)p.B * p.nT * cin;
    for (int u = tid; u < 2 * ncols; u += NT) {
      const int which = u / ncols, c = c_beg + u % ncols, cc = n0 + c;
      if (MASKED && cc >= cin) continue;  // a last tile's columns past Cin
      const float* src = which == 0 ? red : xs;
      int b = m0 / T, t = m0 - b * T;
      float s = 0.f;
#pragma unroll 4
      for (int r = 0; r < nrow; ++r) {
        s += src[r * LDR + c];
        if (r == nrow - 1 || (t + 1) % TT == 0 || t + 1 == T) {  // a piece ends
          const int tt = t / TT;
          const int bs = b * T + tt * TT, be = b * T + min(tt * TT + TT, T);  // the bucket
          float* dst = p.pieces + (size_t)which * 2 * plane + ((size_t)b * p.nT + tt) * cin + cc;
          if (bs >= m0) {  // its head: the tail is the next block's, or nothing
            dst[0] = s;
            if (be <= m0 + BM) dst[plane] = 0.f;
          } else {
            dst[plane] = s;
          }
          s = 0.f;
        }
        if (++t == T) {
          t = 0;
          ++b;
        }
      }
    }
  }
  if (S > 1) cooperative_groups::this_cluster().sync();  // peers may still read this tile
}

template <typename Pre, bool ACT, int TAPS, int MW, int BN_, bool MASKED>
__global__ void __launch_bounds__(128 * (MW + 1)) conv3_dgrad_kernel(const DgradArgs p) {
  conv3_dgrad_body<Pre, ACT, TAPS, MW, BN_, MASKED, false>(p);
}

template <typename Pre, int MW, int BN_, bool MASKED>
__global__ void __launch_bounds__(128 * (MW + 1)) conv3_dgrad_halo_kernel(const DgradArgs p) {
  conv3_dgrad_body<Pre, true, 3, MW, BN_, MASKED, true>(p);
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
constexpr int WGRAD_PARTS = 4;  // partials of the whole gradient at most (ops/resblock_grad.py)

// the kernel's shared-memory layout; SMEM is what the launch must give it
// (ops/resblock_grad.py wgrad_candidates computes the same)
template <typename Src, int TAPS, int MW>
struct WgradGeo {
  static constexpr int BMN = 64 * MW, NW = TAPS * 64;
  static constexpr int LDG = BMN + 8;  // bf16 row stride of a g tile (odd multiple of 16 bytes)
  static constexpr int ACT_BYTES = TAPS * 64 * 128, G_BYTES = 64 * LDG * 2;
  static constexpr int ROWS = TAPS == 3 ? 66 : 64;  // source frames a chunk reads
  static constexpr int RAW_LD = 64 * (int)sizeof(Src) + 16;  // bytes a staged source row
  static constexpr int RAW_BYTES = ROWS * RAW_LD;
  static constexpr int BODY = 2 * ACT_BYTES + WG_STAGES * G_BYTES + WG_STAGES * RAW_BYTES;
  static constexpr int EPILOGUE = (NW + 1) * BMN * 4;  // the fp32 tile, transposed, and the bias
  // alignment slack, then the tap tiles and rings, or the epilogue's tile
  static constexpr int SMEM = 1024 + (BODY > EPILOGUE ? BODY : EPILOGUE);
};

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

template <typename Src, bool ACT, int TAPS, int MW, bool MASKED>
__global__ void __launch_bounds__(128 * (MW + 1)) conv3_wgrad_kernel(const WgradArgs p) {
  // MW consumer warpgroups and one helper: all share the copies and the
  // activation, the consumers issue the wgmmas and hold the tile
  using D = WgradGeo<Src, TAPS, MW>;
  constexpr int NT = 128 * (MW + 1), BMN = D::BMN, NW = D::NW, LDG = D::LDG;
  constexpr int ACT_BYTES = D::ACT_BYTES, G_BYTES = D::G_BYTES;
  constexpr int ROWS = D::ROWS, LO = TAPS == 3 ? -1 : 0;  // source frames
  constexpr int RAW_LD = D::RAW_LD, RAW_BYTES = D::RAW_BYTES;
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
  __shared__ float gb[128];  // this block's 64 channels of gamma, then beta (0 past Cin)
  if (ACT && tid < 128) {
    const int c = c0 + (tid & 63);
    gb[tid] = MASKED && c >= cin ? 0.f : tid < 64 ? p.gamma[c] : p.beta[c];
  }
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
      const bool ok = q < BT && (!MASKED || n0 + c * 8 < cout);
      const bf16* gp = p.g + (ok ? (size_t)q * cout + n0 + c * 8 : 0);
      if constexpr (MASKED)
        sm90::copy16_any(base + (r * LDG + c * 8) * 2, gp, ok ? 2 * (cout - n0 - c * 8) : 0,
                         sm90::access_bytes(2 * cout));
      else
        sm90::cp_async16(base + (r * LDG + c * 8) * 2, gp, ok ? 16 : 0);
    }
    const uint32_t rbase = sm90::smem_u32(raw + s * RAW_BYTES);
    const Src* src = static_cast<const Src*>(p.src);
    for (int u = tid; u < ROWS * 8; u += NT) {
      const int rr = u % ROWS, cl = (u / ROWS) * 8;
      const int q = j * 64 + LO + rr;
      const bool ok = q >= 0 && q < BT && (!MASKED || c0 + cl < cin);
      const Src* sp = src + (ok ? (size_t)q * cin + c0 + cl : 0);
#pragma unroll
      for (int h = 0; h < (int)sizeof(Src) / 2; ++h) {
        const uint32_t dst = rbase + rr * RAW_LD + cl * (int)sizeof(Src) + 16 * h;
        if constexpr (MASKED) {
          const int vb = ok ? (cin - c0 - cl) * (int)sizeof(Src) - 16 * h : 0;
          sm90::copy16_any(dst, vb > 0 ? sp + h * 16 / (int)sizeof(Src) : src, vb,
                           sm90::access_bytes(cin * (int)sizeof(Src)));
        } else {
          sm90::cp_async16(dst, sp + h * 16 / (int)sizeof(Src), ok ? 16 : 0);
        }
      }
    }
  };

  // this thread's source units (frame rr, 8 channels from cl) are the same
  // in every chunk: their frame offsets and GroupNorm groups, computed once.
  // A unit past Cin stays zero (-1 in u_gi); a unit whose 8 channels
  // straddle groups is marked (u_mixed) and reads each channel's group.
  constexpr int ITER = (ROWS * 8 + NT - 1) / NT;
  const int cg = cin / p.groups;
  int u_rr[ITER], u_cl[ITER], u_gi[ITER];
  bool u_mixed[ITER];
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int u = tid + it * NT;
    u_rr[it] = u < ROWS * 8 ? u % ROWS : -1;
    u_cl[it] = (u / ROWS) * 8;
    const int c = c0 + u_cl[it];
    u_gi[it] = !MASKED || c < cin ? (ACT ? c / cg : 0) : -1;
    u_mixed[it] = MASKED && ACT && c < cin && (c + 7) / cg != c / cg;
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
      if (in && (!MASKED || u_gi[it] >= 0)) {
        load8(reinterpret_cast<const Src*>(rs_ + rr * RAW_LD) + cl, v);
        if (ACT) {
          const float* ga = gb + cl;
          const float* be = gb + 64 + cl;
          if (!u_mixed[it]) {
            const int si = b * p.groups + u_gi[it];
            const float mu = __ldg(p.mean + si), rstd = __ldg(p.rstd + si);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              v[e] = sm90::silu_fast((v[e] - mu) * rstd * ga[e] + be[e]);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              // MASKED: a channel past Cin (zero, gamma and beta 0) reads the last group's
              const int ge = (c0 + cl + e) / cg;
              const int si = b * p.groups + (MASKED ? min(ge, p.groups - 1) : ge);
              v[e] = sm90::silu_fast((v[e] - __ldg(p.mean + si)) * __ldg(p.rstd + si) * ga[e] +
                                     be[e]);
            }
          }
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
          *reinterpret_cast<bf16*>(tile + sm90::sw_offset<128>(cl + e, jc >> 3) + (jc & 7) * 2) =
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
        sm90::wgmma_rs<NW>(acc, fr[kk], sm90::desc_kmajor<128>(tiles + kk * 32));
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
  // (unmasked, Cout a multiple of the tile: four neighbouring output
  // channels lie inside Cout; in the MASKED form each goes out on its own)
  auto store4 = [&](int e, float4 v) {
    if constexpr (MASKED) {
      const float vv[4] = {v.x, v.y, v.z, v.w};
      if (e < NW * BMN) {
        const int k = (e / BMN) >> 6, c = c0 + ((e / BMN) & 63), n = n0 + e % BMN;
        if (c < cin)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (n + i < cout) out[((size_t)k * cin + c) * cout + n + i] = vv[i];
      } else if (do_bias) {
        const int n = n0 + e - NW * BMN;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (n + i < cout) p.bias_out[(size_t)part * cout + n + i] = vv[i];
      }
      return;
    }
    if (e < NW * BMN) {  // four neighbouring output channels of one (tap, channel)
      const int k = (e / BMN) >> 6, c = c0 + ((e / BMN) & 63), n = n0 + e % BMN;
      *reinterpret_cast<float4*>(out + ((size_t)k * cin + c) * cout + n) = v;
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
// GroupNorm's input gradient, d = rstd * (gamma * d_y - m1 - xhat * m2) (+
// extra), m1 and m2 the group means of gamma * d_y and gamma * d_y * xhat;
// in FiLM mode (GN2) also d_z1 = d * (1 + scale) and the 64-frame bucket
// sums of d, d * z1 and d_z1. Grid (nT, C / CB, B): a block takes one
// bucket of one batch row, CB channels wide (ops/resblock_grad.py
// gn_bwd_plan). At its start every thread puts its share of the d_y and
// GroupNorm-input tiles in flight to shared memory by cp.async (no
// registers held while they come) and loads its own frames of the third
// input, z1 or extra, into registers, so a block's whole tile is requested
// at once and three or four blocks fit an SM. Meanwhile the block forms m1
// and m2 of every group its channels touch from conv3_dgrad's bucket-sum
// pieces (head + tail, then over the buckets): all threads load channels
// side by side (coalesced), the buckets split among the threads of a
// channel where the channels are fewer than the threads, then one warp a
// group sums its channels in a fixed order. The pass over the tile gives
// each thread 4 neighbouring channels and every RP-th frame, and stores by
// vectors; the FiLM sums go through shared memory and are added in row
// order. No atomics: two launches give the same bits. The MASKED
// instantiation (blocks of 64 channels only; the launch picks it from the
// shape) takes C not a multiple of 64, whose last block stages, reads and
// stores only its channels, and C/G not a multiple of 4 (C/G 1, 2, 6,
// ...), where a thread's 4 channels may straddle groups and each reads its
// own group's statistics and means.
constexpr int GB_THREADS = 256;
constexpr int GB_CPT = 4;  // channels a thread (load4, store4)

struct GnBwdArgs {
  const float* dy;      // (B, T, C): gradient of the GroupNorm output (d_y)
  const void* pre;      // (B, T, C): GroupNorm input, bf16 or fp32
  const float* mean;    // (B, G)
  const float* rstd;
  const float* gamma;   // (C,)
  const float* pieces;  // (2, 2, B, nT, C): head and tail pieces of the bucket
                        // sums of d_y and d_y * xhat, from conv3_dgrad
  const float* extra;   // (B, T, C) added to the input gradient, or null
  const float* film_scale;  // (B, C): FiLM mode (GN2)
  const float* z1;      // (B, T, C) conv-1 output before FiLM (FiLM mode)
  void* out;            // (B, T, C): dx, or d_z1 = d * (1 + scale)
  float* part_out;      // (3, B, nT, C): bucket sums of d, d * z1, d_z1 (FiLM mode)
  int B, T, C, G, nT;
  const float* totals;  // the totals form: (2, B, G) group totals of gamma * d_y and
                        // gamma * d_y * xhat over the whole sequence (pieces unread)
  int count;            // ... over count values a group (the sequence's n * C/G)
};

// the channels of the whole groups that channels [c0, c0 + cb) touch
__host__ __device__ inline int gn_bwd_window(int c0, int cb, int cg) {
  return ((c0 + cb - 1) / cg - c0 / cg + 1) * cg;
}

// rows [0, nrows) of a TT x CB tile of a (rows, C) tensor into shared
// memory by cp.async, 16 bytes a copy (MASKED: channels [0, ncols) only, by
// the widest access C's row stride allows); the rest is zero
template <int CB, bool MASKED, typename E>
__device__ __forceinline__ void gn_bwd_stage(E* dst, const E* src, int nrows, int ncols, int C) {
  constexpr int CH = CB * (int)sizeof(E) / 16;  // copies a row
  constexpr int VE = 16 / (int)sizeof(E);       // elements a copy
  for (int u = threadIdx.x; u < TT * CH; u += GB_THREADS) {
    const int r = u / CH, k = u - r * CH;
    const bool ok = r < nrows && (!MASKED || k * VE < ncols);
    const E* sp = src + (ok ? (size_t)r * C + k * VE : 0);
    if constexpr (MASKED)
      sm90::copy16_any(sm90::smem_u32(dst + r * CB) + 16 * k, sp,
                       ok ? (ncols - k * VE) * (int)sizeof(E) : 0,
                       sm90::access_bytes(C * (int)sizeof(E)));
    else
      sm90::cp_async16(sm90::smem_u32(dst + r * CB) + 16 * k, sp, ok ? 16 : 0);
  }
}

// The totals form (TOTALS, a shard of a sequence-sharded tensor): m1 and m2
// are the caller's (2, B, G) totals, added over the shards, over count
// values a group; step 1 reads them instead of summing the pieces.
template <typename Pre, typename Out, int CB, bool FILM, bool MASKED, bool TOTALS>
__device__ __forceinline__ void gn_bwd_body(const GnBwdArgs& p) {
  constexpr bool MIX = MASKED;  // a thread's channels may straddle groups
  constexpr int CPT = GB_CPT;
  constexpr int TPR = CB / CPT;         // threads a frame
  constexpr int RP = GB_THREADS / TPR;  // frames at a time
  constexpr int ITERS = TT / RP;        // this thread's frames of the bucket
  extern __shared__ __align__(16) float sm[];
  const int tile = blockIdx.x, c0 = blockIdx.y * CB, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int T = p.T, C = p.C, cg = C / p.G, nT = p.nT;
  const int t0 = tile * TT, nrows = min(TT, T - t0), ncols = MASKED ? min(CB, C - c0) : CB;
  const bool has_extra = p.extra != nullptr;

  // dynamic shared memory (gn_bwd_smem): the staged tiles (then the FiLM
  // sums' rows), the channels' bucket sums, the groups' means
  float* s_dy = sm;                                                   // [TT][CB]
  Pre* s_x = reinterpret_cast<Pre*>(s_dy + TT * CB);                  // [TT][CB]
  float* acc = reinterpret_cast<float*>(s_x + TT * CB);
  const int g_lo = c0 / cg, W = gn_bwd_window(c0, ncols, cg), ngr = W / cg, w0 = g_lo * cg;
  float* mm = acc + 2 * (W > GB_THREADS ? W : GB_THREADS);            // [2][ngr]
  float* red = sm;                                       // [3][RP][CB], after the pass

  const size_t row0 = ((size_t)b * T + t0) * C + c0;
  gn_bwd_stage<CB, MASKED>(s_dy, p.dy + row0, nrows, ncols, C);
  gn_bwd_stage<CB, MASKED>(s_x, static_cast<const Pre*>(p.pre) + row0, nrows, ncols, C);
  sm90::cp_async_commit();
  // the third input, z1 (FiLM) or extra, straight into registers: this
  // thread's frames r0 + i RP and channels, so a block's shared memory
  // leaves room for three or four blocks an SM
  const int r0 = tid / TPR, j0 = (tid % TPR) * CPT, cb = c0 + j0;
  const bool cok = !MASKED || j0 < ncols;  // this thread's channels lie inside C
  const float* third = FILM ? p.z1 : p.extra;
  float z[ITERS][CPT];
#pragma unroll
  for (int i = 0; i < ITERS; ++i) {
    const int r = r0 + i * RP;
    if (MASKED && third != nullptr && r < nrows && cok) {  // the channels inside C
#pragma unroll
      for (int e = 0; e < CPT; ++e)
        z[i][e] = j0 + e < ncols ? third[row0 + (size_t)r * C + j0 + e] : 0.f;
    } else if (third != nullptr && r < nrows && cok) {
      load4(third + row0 + (size_t)r * C + j0, z[i]);
    } else {
#pragma unroll
      for (int e = 0; e < CPT; ++e) z[i][e] = 0.f;
    }
  }

  // 1. m1, m2 of the groups [g_lo, g_lo + ngr), channels [w0, w0 + W)
  if constexpr (TOTALS) {
    const float inv_n = 1.f / (float)p.count;
    for (int j = tid; j < ngr; j += GB_THREADS) {
      mm[j] = p.totals[(size_t)b * p.G + g_lo + j] * inv_n;
      mm[ngr + j] = p.totals[((size_t)p.B + b) * p.G + g_lo + j] * inv_n;
    }
  } else {
    const int NS = W >= GB_THREADS ? 1 : GB_THREADS / W;  // slices of the buckets a channel
    {
      const size_t plane = (size_t)p.B * nT * C;
      const float* q = p.pieces + (size_t)b * nT * C + w0;
      for (int u = tid; u < NS * W; u += GB_THREADS) {
        const int sl = u / W, c = u - sl * W;
        const int k1 = nT * (sl + 1) / NS;
        float a1 = 0.f, a2 = 0.f;
#pragma unroll 4
        for (int k = nT * sl / NS; k < k1; ++k) {
          const float* e = q + (size_t)k * C + c;
          a1 += e[0] + e[plane];              // d_y: head + tail
          a2 += e[2 * plane] + e[3 * plane];  // d_y * xhat
        }
        acc[u] = a1;
        acc[NS * W + u] = a2;
      }
    }
    __syncthreads();
    const float inv_n = 1.f / ((float)T * (float)cg);
    for (int j = warp; j < ngr; j += GB_THREADS / 32) {
      float s1 = 0.f, s2 = 0.f;
      for (int c = j * cg + lane; c < (j + 1) * cg; c += 32) {
        float a1 = 0.f, a2 = 0.f;
        for (int sl = 0; sl < NS; ++sl) {
          a1 += acc[sl * W + c];
          a2 += acc[(NS + sl) * W + c];
        }
        const float ga = __ldg(p.gamma + w0 + c);
        s1 += ga * a1;
        s2 += ga * a2;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      if (lane == 0) {
        mm[j] = s1 * inv_n;
        mm[ngr + j] = s2 * inv_n;
      }
    }
  }

  // 2. this thread's CPT channels (one group's unless MIX: C/G is then not
  // a multiple of CPT, and each channel keeps its own group's constants;
  // all loaded once) and frames r0, r0 + RP, ... of the tile
  float ga[CPT], sc[CPT];
  float mu[MIX ? CPT : 1], rs[MIX ? CPT : 1];
#pragma unroll
  for (int e = 0; e < (MIX ? CPT : 1); ++e) {
    // MASKED: a channel past C (nothing stored) takes the last channel's group
    const int ge = cok ? (MASKED ? min(cb + e, c0 + ncols - 1) : cb + e) / cg : g_lo;
    mu[e] = __ldg(p.mean + b * p.G + ge);
    rs[e] = __ldg(p.rstd + b * p.G + ge);
  }
#pragma unroll
  for (int e = 0; e < CPT; ++e) {
    const bool in = cok && (!MASKED || j0 + e < ncols);
    ga[e] = in ? __ldg(p.gamma + cb + e) : 0.f;
    sc[e] = FILM && in ? 1.f + __ldg(p.film_scale + b * C + cb + e) : 1.f;
  }
  sm90::cp_async_wait<0>();
  __syncthreads();  // the group means and every thread's staged rows are in
  float m1[MIX ? CPT : 1], m2[MIX ? CPT : 1];
#pragma unroll
  for (int e = 0; e < (MIX ? CPT : 1); ++e) {
    const int ge = cok ? (MASKED ? min(cb + e, c0 + ncols - 1) : cb + e) / cg : g_lo;
    m1[e] = mm[ge - g_lo];
    m2[e] = mm[ngr + ge - g_lo];
  }
  Out* out = static_cast<Out*>(p.out) + row0 + j0;
  float q0[CPT], q1[CPT], q2[CPT];
#pragma unroll
  for (int e = 0; e < CPT; ++e) q0[e] = q1[e] = q2[e] = 0.f;
#pragma unroll
  for (int i = 0; i < ITERS; ++i) {
    const int r = r0 + i * RP;
    if (r >= nrows || !cok) break;
    const int o = r * CB + j0;
    float dy[CPT], x[CPT], d[CPT];
    load4(s_dy + o, dy);
    load4(s_x + o, x);
#pragma unroll
    for (int e = 0; e < CPT; ++e) {
      const int k = MIX ? e : 0;
      const float xh = (x[e] - mu[k]) * rs[k];
      d[e] = rs[k] * (dy[e] * ga[e] - m1[k] - xh * m2[k]);
    }
    if (!FILM && has_extra) {
#pragma unroll
      for (int e = 0; e < CPT; ++e) d[e] += z[i][e];
    }
    if constexpr (FILM) {
#pragma unroll
      for (int e = 0; e < CPT; ++e) {
        const float dz = d[e] * sc[e];
        q0[e] += d[e];
        q1[e] += d[e] * z[i][e];
        q2[e] += dz;
        d[e] = dz;
      }
    }
    if constexpr (MASKED) {
#pragma unroll
      for (int e = 0; e < CPT; ++e)
        if (j0 + e < ncols) out[(size_t)r * C + e] = from_f<Out>(d[e]);
    } else {
      store4(out + (size_t)r * C, d);
    }
  }
  if constexpr (FILM) {
    __syncthreads();  // every thread's reads of the staged tiles are done
#pragma unroll
    for (int e = 0; e < CPT; ++e) {
      const int o = r0 * CB + j0 + e;
      red[o] = q0[e];
      red[RP * CB + o] = q1[e];
      red[2 * RP * CB + o] = q2[e];
    }
    __syncthreads();
    const size_t plane = (size_t)p.B * nT * C;
    for (int u = tid; u < 3 * CB; u += GB_THREADS) {
      const int w = u / CB, c = u - w * CB;
      if (MASKED && c >= ncols) continue;
      float s = 0.f;
      for (int r = 0; r < RP; ++r) s += red[(w * RP + r) * CB + c];
      p.part_out[w * plane + ((size_t)b * nT + tile) * C + c0 + c] = s;
    }
  }
}

template <typename Pre, typename Out, int CB, bool FILM, bool MASKED>
__global__ void __launch_bounds__(GB_THREADS, 3) gn_bwd_kernel(const GnBwdArgs p) {
  gn_bwd_body<Pre, Out, CB, FILM, MASKED, false>(p);
}

template <typename Pre, typename Out, int CB, bool FILM, bool MASKED>
__global__ void __launch_bounds__(GB_THREADS, 3) gn_bwd_totals_kernel(const GnBwdArgs p) {
  gn_bwd_body<Pre, Out, CB, FILM, MASKED, true>(p);
}

}  // namespace

namespace {

constexpr int ERR_PLAN = -3;  // a launch plan the kernel does not take (ops/_build.py)

// the plan's grid and shared memory must be this kernel's for the shape: a
// smaller grid would leave output rows unwritten, smaller shared memory
// would overrun the ring
template <typename Pre, bool ACT, int TAPS, int MW, int BN_>
int launch_dgrad(const DgradArgs& a, bool halo, int mtiles, int ntiles, int splits, int smem,
                 cudaStream_t s) {
  using D = DgradGeo<TAPS, MW, BN_>;
  // M tiles over the flattened rows, or (the halo form where 2T < BM: a
  // tile would meet more than 3 batch rows) over each batch row apart
  const int want_m = halo && 2 * a.T < D::BM ? a.B * ((a.T + D::BM - 1) / D::BM)
                                             : (a.B * a.T + D::BM - 1) / D::BM;
  if (mtiles != want_m || ntiles != (a.cin + BN_ - 1) / BN_ ||
      smem != D::SMEM || splits < 1 || splits > 8 || splits > (a.cout + 63) / 64)
    return ERR_PLAN;
  // the masked form where an N tile or a K chunk is partial (a last chunk
  // of 32 needs none: its k16 steps stop at 32) or a width is off the
  // 8-channel unit (and so off those of BN and 32)
  const bool masked = a.cin % BN_ || a.cout % 32;
  static bool attr_set[4] = {false, false, false, false};
  const dim3 grid(mtiles, ntiles, splits);
  if constexpr (ACT && TAPS == 3) {
    if (halo && masked)
      return (int)sm90::launch_cluster(conv3_dgrad_halo_kernel<Pre, MW, BN_, true>,
                                       attr_set[3], grid, 128 * (MW + 1), smem, splits, s, a);
    if (halo)
      return (int)sm90::launch_cluster(conv3_dgrad_halo_kernel<Pre, MW, BN_, false>,
                                       attr_set[2], grid, 128 * (MW + 1), smem, splits, s, a);
  }
  if (halo) return (int)cudaErrorInvalidValue;  // the halo form takes 3 taps with the SiLU backward
  if (masked)
    return (int)sm90::launch_cluster(conv3_dgrad_kernel<Pre, ACT, TAPS, MW, BN_, true>,
                                     attr_set[1], grid, 128 * (MW + 1), smem, splits, s, a);
  return (int)sm90::launch_cluster(conv3_dgrad_kernel<Pre, ACT, TAPS, MW, BN_, false>,
                                   attr_set[0], grid, 128 * (MW + 1), smem, splits, s, a);
}

template <typename Pre, bool ACT, int TAPS>
int launch_dgrad_plan(const DgradArgs& a, bool halo, int mw, int bn, int mtiles, int ntiles,
                      int splits, int smem, cudaStream_t s) {
  if (mw == 1 && bn == 64)
    return launch_dgrad<Pre, ACT, TAPS, 1, 64>(a, halo, mtiles, ntiles, splits, smem, s);
  if (mw == 2 && bn == 64)
    return launch_dgrad<Pre, ACT, TAPS, 2, 64>(a, halo, mtiles, ntiles, splits, smem, s);
  if (mw == 1 && bn == 128)
    return launch_dgrad<Pre, ACT, TAPS, 1, 128>(a, halo, mtiles, ntiles, splits, smem, s);
  return ERR_PLAN;
}

}  // namespace

// modes: 3 taps with the SiLU backward (pre bf16 or fp32), 1 tap raw; with
// halo, the halo form (3 taps with the SiLU backward; hl, hr 0 or 1)
extern "C" int lm2a_conv3_dgrad(const void* g, const void* w, const void* pre, int pre_is_f32,
                                const float* mean, const float* rstd, const float* gamma,
                                const float* beta, float* out, float* pieces, int B, int T,
                                int cin, int cout, int taps, int groups, int nT, int mw, int bn,
                                int mtiles, int ntiles, int splits, int smem, int halo, int hl,
                                int hr, void* stream) {
  if (B < 1 || T < 1 || nT != (T + TT - 1) / TT || cin < 1 || cout < 1 || groups < 1 ||
      cin % groups || hl < 0 || hl > 1 || hr < 0 || hr > 1 || (!halo && (hl || hr)))
    return (int)cudaErrorInvalidValue;
  DgradArgs a;
  a.g = static_cast<const bf16*>(g);
  a.w = static_cast<const bf16*>(w);
  a.pre = pre;
  a.mean = mean;
  a.rstd = rstd;
  a.gamma = gamma;
  a.beta = beta;
  a.out = out;
  a.pieces = pieces;
  a.B = B;
  a.T = T;
  a.cin = cin;
  a.cout = cout;
  a.groups = groups;
  a.nT = nT;
  a.hl = hl;
  a.hr = hr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e;
  if (taps == 3 && pre != nullptr && pre_is_f32)
    e = launch_dgrad_plan<float, true, 3>(a, halo, mw, bn, mtiles, ntiles, splits, smem, s);
  else if (taps == 3 && pre != nullptr)
    e = launch_dgrad_plan<bf16, true, 3>(a, halo, mw, bn, mtiles, ntiles, splits, smem, s);
  else if (taps == 1 && pre == nullptr)
    e = launch_dgrad_plan<bf16, false, 1>(a, halo, mw, bn, mtiles, ntiles, splits, smem, s);
  else
    return (int)cudaErrorInvalidValue;
  if (e != 0) return e;
  return (int)cudaGetLastError();
}

namespace {

// the plan must be this kernel's for the shape: its grid, its shared memory
// (less would overrun the rings), a split and parts that leave every rank
// chunks to sum, and no more parts than the wrapper's partials hold
template <typename Src, bool ACT, int TAPS, int MW>
int launch_wgrad(const WgradArgs& a, int ntiles, int ctiles, int parts, int smem,
                 cudaStream_t s) {
  const int nch = (a.B * a.T + 63) / 64;
  if (ntiles != (a.cout + 64 * MW - 1) / (64 * MW) || ctiles != (a.cin + 63) / 64 ||
      a.splits < 1 || a.splits > 8 || parts < 1 || parts > WGRAD_PARTS ||
      a.splits * parts > nch || smem != WgradGeo<Src, TAPS, MW>::SMEM)
    return ERR_PLAN;
  // the masked form where a channel tile is partial, a unit of 8 channels
  // straddles groups or a width is off the 8-channel unit (and so off the
  // 64-channel one)
  const bool masked = a.cin % 64 || a.cout % (64 * MW) || (ACT && (a.cin / a.groups) % 8);
  static bool attr_set[2] = {false, false};
  const dim3 grid(ntiles, ctiles, a.splits * parts);
  if (masked)
    return (int)sm90::launch_cluster(conv3_wgrad_kernel<Src, ACT, TAPS, MW, true>, attr_set[1],
                                     grid, 128 * (MW + 1), smem, a.splits, s, a);
  return (int)sm90::launch_cluster(conv3_wgrad_kernel<Src, ACT, TAPS, MW, false>, attr_set[0],
                                   grid, 128 * (MW + 1), smem, a.splits, s, a);
}

template <typename Src, bool ACT, int TAPS>
int launch_wgrad_mw(const WgradArgs& a, int mw, int ntiles, int ctiles, int parts, int smem,
                    cudaStream_t s) {
  if (mw == 1) return launch_wgrad<Src, ACT, TAPS, 1>(a, ntiles, ctiles, parts, smem, s);
  if (mw == 2) return launch_wgrad<Src, ACT, TAPS, 2>(a, ntiles, ctiles, parts, smem, s);
  return ERR_PLAN;
}

template <typename Src, bool ACT>
int launch_wgrad_taps(const WgradArgs& a, int taps, int mw, int ntiles, int ctiles, int parts,
                      int smem, cudaStream_t s) {
  if (taps == 3) return launch_wgrad_mw<Src, ACT, 3>(a, mw, ntiles, ctiles, parts, smem, s);
  if (taps == 1) return launch_wgrad_mw<Src, ACT, 1>(a, mw, ntiles, ctiles, parts, smem, s);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared bytes of gn_bwd_kernel: the staged tiles and the largest
// block's bucket sums and group means (the FiLM sums' rows reuse the d_y tile)
int gn_bwd_smem(int C, int cg, int cb, int pre_bytes) {
  int w = 0;
  for (int c0 = 0; c0 < C; c0 += cb) {
    const int wi = gn_bwd_window(c0, C - c0 < cb ? C - c0 : cb, cg);
    w = wi > w ? wi : w;
  }
  return TT * cb * (4 + pre_bytes) +
         4 * (2 * (w > GB_THREADS ? w : GB_THREADS) + 2 * (w / cg));
}
static_assert(3 * GB_THREADS * GB_CPT <= TT * 64, "the FiLM sums' rows fit the d_y tile");

template <typename Pre, typename Out, int CB, bool FILM, bool MASKED>
int launch_gn_bwd(const GnBwdArgs& a, cudaStream_t s) {
  const int smem = gn_bwd_smem(a.C, a.C / a.G, CB, (int)sizeof(Pre));
  static bool attr_set[2] = {false, false};
  const dim3 grid(a.nT, (a.C + CB - 1) / CB, a.B);
  if (a.totals != nullptr)
    return (int)sm90::launch_cluster(gn_bwd_totals_kernel<Pre, Out, CB, FILM, MASKED>,
                                     attr_set[1], grid, GB_THREADS, smem, 1, s, a);
  return (int)sm90::launch_cluster(gn_bwd_kernel<Pre, Out, CB, FILM, MASKED>, attr_set[0], grid,
                                   GB_THREADS, smem, 1, s, a);
}

template <typename Pre, typename Out, int CB, bool MASKED>
int launch_gn_bwd_film(const GnBwdArgs& a, cudaStream_t s) {
  return a.film_scale != nullptr ? launch_gn_bwd<Pre, Out, CB, true, MASKED>(a, s)
                                 : launch_gn_bwd<Pre, Out, CB, false, MASKED>(a, s);
}

// a C that blocks of cb channels do not divide (C off the 8-channel unit
// among them), or C/G not a multiple of GB_CPT (the narrow models' C/G 1, 2,
// 6, ...), takes the MASKED form, in blocks of 64 channels only
template <typename Pre, typename Out>
int launch_gn_bwd_plan(const GnBwdArgs& a, int cb, cudaStream_t s) {
  const bool masked = (a.C / a.G) % GB_CPT != 0 || a.C % cb != 0;
  if (cb == 64) return masked ? launch_gn_bwd_film<Pre, Out, 64, true>(a, s)
                              : launch_gn_bwd_film<Pre, Out, 64, false>(a, s);
  if (cb == 128 && !masked) return launch_gn_bwd_film<Pre, Out, 128, false>(a, s);
  return ERR_PLAN;
}

}  // namespace

extern "C" int lm2a_conv3_wgrad(const void* src, int src_is_f32, const float* mean,
                                const float* rstd, const float* gamma, const float* beta,
                                const void* g, float* out, float* bias_out, int B, int T,
                                int cin, int cout, int taps, int groups, int mw, int ntiles,
                                int ctiles, int splits, int parts, int smem, void* stream) {
  if (B < 1 || T < 1 || cin < 1 || cout < 1 || groups < 1 || cin % groups)
    return (int)cudaErrorInvalidValue;
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
  int e;
  if (mean == nullptr) {
    if (src_is_f32) return (int)cudaErrorInvalidValue;  // raw mode reads bf16 x
    e = launch_wgrad_taps<bf16, false>(a, taps, mw, ntiles, ctiles, parts, smem, s);
  } else if (src_is_f32) {
    e = launch_wgrad_taps<float, true>(a, taps, mw, ntiles, ctiles, parts, smem, s);
  } else {
    e = launch_wgrad_taps<bf16, true>(a, taps, mw, ntiles, ctiles, parts, smem, s);
  }
  if (e != 0) return e;
  return (int)cudaGetLastError();
}

// pieces: conv3_dgrad's (2, 2, B, nT, C) head and tail pieces, read as they
// are (head + tail per bucket), or (the totals form) null with totals the
// (2, B, G) group totals over count values a group; every pointer 16-byte
// aligned; any C; extra (GN1) or FiLM (GN2), not both; cb: the plan's
// channels a block (64, or 128 where it divides C and C/G is a multiple of 4)
extern "C" int lm2a_gn_bwd(const float* dy, const void* pre, int pre_is_f32, const float* mean,
                           const float* rstd, const float* gamma, const float* pieces,
                           const float* extra, const float* film_scale, const float* z1,
                           void* out, int out_is_f32, float* part_out, int B, int T, int C,
                           int G, int nT, int cb, const float* totals, int count,
                           void* stream) {
  if (B < 1 || T < 1 || G < 1 || C % G || nT != (T + TT - 1) / TT ||
      (film_scale != nullptr) != (z1 != nullptr) || (film_scale != nullptr) != (part_out != nullptr) ||
      (film_scale != nullptr && extra != nullptr) || (pieces == nullptr) == (totals == nullptr) ||
      (totals != nullptr && count < T * (C / G)))
    return (int)cudaErrorInvalidValue;
  if (cb != 64 && cb != 128) return ERR_PLAN;
  GnBwdArgs a;
  a.dy = dy;
  a.pre = pre;
  a.mean = mean;
  a.rstd = rstd;
  a.gamma = gamma;
  a.pieces = pieces;
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
  a.totals = totals;
  a.count = count;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e;
  if (pre_is_f32 && out_is_f32)
    e = launch_gn_bwd_plan<float, float>(a, cb, s);
  else if (pre_is_f32)
    e = launch_gn_bwd_plan<float, bf16>(a, cb, s);
  else if (out_is_f32)
    e = launch_gn_bwd_plan<bf16, float>(a, cb, s);
  else
    e = launch_gn_bwd_plan<bf16, bf16>(a, cb, s);
  if (e != 0) return e;
  return (int)cudaGetLastError();
}
