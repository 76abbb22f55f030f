// Fused attention core softmax(q k^T / sqrt(hd)) v for Hopper (sm_90a).
//
// Replaces both Pallas TPU kernels of lm2a_tpu/ops/pallas_attention.py:
// _attention_kernel (all of S in one VMEM block, S <= 1024) and _flash_kernel
// (online softmax over S tiles, S > 1024). They compute one function; only
// the TPU's VMEM budget split them. Here one flash-style forward covers both.
//
// Arithmetic, as the JAX serving route (bf16 operands): scores accumulate in
// fp32 (bf16 tensor cores); p = 2^(s * log2(e) / sqrt(hd) - m) in fp32 with m
// the running row max, rounded to bf16 for the P.V product; l sums the
// unrounded p; the output is O / l, one division at the end, rounded to bf16.
//
// Layout: q is read as (B, H, T, hd) through element strides, k and v as
// (B, H, S, hd), hd contiguous; the port passes views of its channels-last
// projections, so no transposes precede or follow the kernel. The output is
// written through strides (the wrapper allocates it (B, T, H, hd)).
//
// Bound on the H100: 4*T*S*hd tensor operations per (batch, head) against
// 2*(2T + 2S)*hd bytes, so long form (S = T = 12920) is bound by operations;
// besides, every score takes one exp2 on the MUFU (16 a clock per SM), which
// at hd = 32 takes longer than the score's 128 tensor operations. The 6 s
// geometries are small grids bound by latency. The design:
//  - a block holds 128 query rows of one (batch, head): three warpgroups, a
//    producer and two consumers of 64 rows each (setmaxnreg 40 / 232);
//  - the producer's one thread streams K and V tiles of BN keys by TMA
//    (cp.async.bulk.tensor over the strided 4-D view, 32-, 64- or 128-byte
//    swizzle by hd) into a ring of `stages` stages, each K and each V tile
//    completing on its own mbarrier; the consumers free a stage through a
//    third mbarrier;
//  - both products are wgmma.mma_async: S = Q K^T with Q the register A
//    operand (ldmatrix once per block) and the K tile K-major behind a
//    descriptor; O += P V with P the bf16 repack of the S accumulators (the
//    m64nN accumulator layout is the k16 A fragment) and the V tile
//    MN-major (tnspB = 1);
//  - the consumers take turns at the tensor cores (named barriers, FA3's
//    ping-pong): one issues S(j) and P.V(j-1) and hands over the turn, then
//    runs the softmax of tile j while the other's products run;
//  - only the last key tile, where S is ragged, is masked, on a path of its
//    own;
//  - head dims from 1 to 256: Q and K are read into tiles of HDQ
//    channels, hd rounded up to 16, 32, 64, or a multiple of 64 above 64
//    (the wgmma k16 step and the swizzle's 32-, 64- or 128-byte rows); the
//    tensor map zero-fills the columns past the head (per-head maps, hd a
//    multiple of 8) or the kernel zeroes Q's columns outside the head in
//    registers (window maps), so the scores see the head's hd values alone.
//    The softmax scale is 1/sqrt of the true hd;
//  - a head whose row offset h*hd*2 bytes is off the 16-byte unit (hd not a
//    multiple of 8: 2, 4, 6, 12 at the narrow bases) cannot have a tensor map
//    of its own: the maps then see each row's H*hd channels as one window,
//    and a block loads HDQ channels from the 8-channel unit that holds its
//    head's first channel, the head at offset (h*hd) % 8 in the tile;
//  - head dims above 128 (v1's 192 at C = 1536): the output accumulator of
//    64 rows by HDQ would overrun the consumers' registers, so V and O are
//    split into parts of 128 columns, one block each (grid y = H * parts),
//    each recomputing the same scores; only the head's columns are stored;
//  - a head whose tile passes 256 channels (hd above 256) takes the chunked
//    form below: the scores accumulate over chunks of 128 channels;
//  - where the grid is small (the 6 s geometries), the key tiles are split
//    over the `split` blocks of a thread-block cluster; each keeps (m, l, O)
//    of its keys, pushes each row's through distributed shared memory to
//    the rank that owns the row, and the owner combines them in rank order
//    (the same bits on every run, no atomics). The launch plan
//    (ops/attention.py attention_plan) picks BN, stages and split.
//
// The folded cross-attention core (lm2a_fold_core, counted as `fold_core`)
// runs the same bodies over both branches of a folded CrossAttentionFusion
// in one launch: 2H heads, where heads [0, H) read the motion branch's K and
// V and heads [H, 2H) the text branch's, each branch's projections read in
// place through a pair of maps of its own; Q is the merged projection's
// (B, T, 2H*hd) rows and O is written into such rows. It replaces no Pallas
// kernel: the JAX package leaves the folded core to XLA's fusion of einsum,
// softmax and einsum. Its own kernels (fold_core_kernel,
// fold_core_chunked_kernel) keep the fused route's SASS and kernel names as
// they were.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and the driver's enums; the entry point comes at run time

#include "common.cuh"
#include "sm90_gemm.cuh"

namespace {

constexpr int BM = 128;        // query rows per block
constexpr int NTHREADS = 384;  // the producer warpgroup and two consumers
constexpr int MAX_STAGES = 8;
constexpr int MAX_SPLIT = 8;  // a portable cluster
constexpr int CMAX_ROWS = BM + MAX_SPLIT;  // split * ceil(BM / split) rows at most
constexpr int BAR_TURN = 1;       // named barriers 1 and 2: the consumers' turns
constexpr int BAR_CONSUMERS = 3;  // both consumers, before the split's combine
constexpr int REGS_PRODUCER = 40, REGS_CONSUMER = 232;  // 40 + 2 * 232 = 3 * 168

struct AttnArgs {
  bf16* o;
  int T, S;
  int hd;                      // the true head dim (the tiles hold HDQ channels)
  int window;                  // 1: window maps over each row's H*hd channels
  long long o_sb, o_sh, o_st;  // element strides; hd stride is 1
  int tiles;                   // key tiles of BN keys
  int split;                   // cluster blocks along x that split the key tiles
  int stages;                  // ring depth
  int qperm[3], kperm[3], vperm[3];  // the tensor maps' order of (t, h, b)
};

// The folded form's heads: 2H in the grid, `heads` (H) a branch; a window
// map's Q channels of branch 1 start `q_branch` channels into the row (a
// multiple of 8), its output `o_branch` elements after branch 0's
struct FoldArgs {
  int heads;
  int q_branch;
  long long o_branch;
};

// Where a block's head lies: the maps it reads, its index in the Q map and
// in the K/V maps (0 for a window map), the first channel of its tiles in
// each, its offset into its tiles (a window's, else 0), its batch and its
// output at row 0
struct HeadAt {
  const CUtensorMap *q, *k, *v;
  int qh, kh, qc, kc, hoff, b;
  bf16* o;
};

// HDQ: the channels of a Q and a K tile row (16, 32, 64, 128, 192 or 256);
// HDV: those of a V tile row and of the O accumulator, VPARTS blocks a head
template <int HDQ_, int BN>
struct Geo {
  static constexpr int HDQ = HDQ_;
  static constexpr int HDV = HDQ > 128 ? 128 : HDQ;
  static constexpr int VPARTS = (HDQ + HDV - 1) / HDV;
  static constexpr int ROWB = HDQ * 2 > 128 ? 128 : HDQ * 2;  // bytes a swizzled row
  static constexpr int QBOXES = HDQ * 2 / ROWB;  // boxes of 64 channels along a Q or K row
  static constexpr int VBOXES = HDV * 2 / ROWB;
  static constexpr int BOX = ROWB / 2;  // channels a box row
  static constexpr int Q_BYTES = BM * HDQ * 2;
  static constexpr int K_BYTES = BN * HDQ * 2;
  static constexpr int V_BYTES = BN * HDV * 2;
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
  static constexpr int CO_LD = HDV + 4;  // fp32 row stride of the combine buffer
  // the split's combine, reusing the ring: O, m and l of CMAX_ROWS rows,
  // then each owned row's weights over the ranks and their sum
  static constexpr int COMBINE_BYTES =
      (CMAX_ROWS * CO_LD + 2 * CMAX_ROWS + (BM / 2) * (MAX_SPLIT + 1)) * 4;
  // dynamic shared bytes: alignment slack, the Q tile, the ring or the combine
  static constexpr int smem(int stages) {
    return 1024 + Q_BYTES +
           (stages * STAGE_BYTES > COMBINE_BYTES ? stages * STAGE_BYTES : COMBINE_BYTES);
  }
};

// a Q register (two bf16 of columns c and c + 1 of the tile) with the
// columns outside [lo, hi) zeroed
__device__ __forceinline__ uint32_t keep_cols(uint32_t v, int c, int lo, int hi) {
  const uint32_t m0 = (c >= lo && c < hi) ? 0x0000ffffu : 0u;
  const uint32_t m1 = (c + 1 >= lo && c + 1 < hi) ? 0xffff0000u : 0u;
  return v & (m0 | m1);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// one box of a 4-D map; c = (hd, row, h, b), placed in the map's order
__device__ __forceinline__ int pick(int which, int row, int h, int b) {
  return which == 0 ? row : which == 1 ? h : b;
}
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                        const int (&perm)[3], int hdc, int row, int h, int b) {
  sm90::tma_load_4d(dst, map, bar, hdc, pick(perm[0], row, h, b), pick(perm[1], row, h, b),
                    pick(perm[2], row, h, b));
}

// -inf where key >= S: a select, not a branch (the scores are wgmma
// accumulators, which a divergent write would make ptxas serialize)
__device__ __forceinline__ float mask_key(float s, int key, int S) {
  float r;
  asm("{\n.reg .pred p;\nsetp.ge.s32 p, %1, %2;\nselp.f32 %0, 0fFF800000, %3, p;\n}\n"
      : "=f"(r)
      : "r"(key), "r"(S), "f"(s));
  return r;
}

// EXACT: a per-head map and hd == HDQ (the flagship's 32, 64 and 128, and
// 16): hd, the scale and the stores are compile-time and Q needs no mask,
// the code of the kernel before it took other head dims. The body of
// attention_kernel and fold_core_kernel, which differ in where a head lies.
template <int HDQ, int BN, bool EXACT>
__device__ __forceinline__ void attention_body(const HeadAt& at, const AttnArgs& p) {
  using G = Geo<HDQ, BN>;
  constexpr int HDV = G::HDV, ROWB = G::ROWB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;
  uint8_t* ring = smem + G::Q_BYTES;  // stage s: K tile, then V tile
  __shared__ uint64_t bars[1 + 3 * MAX_STAGES];
  uint64_t* qbar = bars;
  uint64_t* kfull = bars + 1;
  uint64_t* vfull = kfull + MAX_STAGES;
  uint64_t* empty = vfull + MAX_STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the warpgroup, warp-uniform as ptxas can see (else it serializes wgmma)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int split = p.split, stages = p.stages, hd = EXACT ? HDQ : p.hd;
  const int rank = (int)(blockIdx.x % split), mtile = (int)(blockIdx.x / split);
  const int vpart = (int)blockIdx.y % G::VPARTS, b = at.b, hoff = at.hoff;
  const int t0 = mtile * BM;
  const int j_beg = p.tiles * rank / split, n = p.tiles * (rank + 1) / split - j_beg;

  if (tid == 0) {
    sm90::mbar_init(qbar, 1);
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(kfull + s, 1);
      sm90::mbar_init(vfull + s, 1);
      sm90::mbar_init(empty + s, 8);  // lane 0 of each consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    sm90::regs_dec<REGS_PRODUCER>();
    if (tid == 0) {
      sm90::mbar_expect_tx(qbar, G::Q_BYTES);
#pragma unroll
      for (int hh = 0; hh < G::QBOXES; ++hh)
        tma_box(sm90::smem_u32(qs) + hh * BM * 128, at.q, qbar, p.qperm, at.qc + hh * G::BOX, t0,
                at.qh, b);
      const int vc = at.kc + vpart * HDV;  // this block's part of V's columns
      for (int i = 0; i < n; ++i) {
        const int s = i % stages;
        if (i >= stages) sm90::mbar_wait(empty + s, ((i / stages) & 1) ^ 1);
        const int key0 = (j_beg + i) * BN;
        const uint32_t kt = sm90::smem_u32(ring + s * G::STAGE_BYTES);
        sm90::mbar_expect_tx(kfull + s, G::K_BYTES);
#pragma unroll
        for (int hh = 0; hh < G::QBOXES; ++hh)
          tma_box(kt + hh * BN * 128, at.k, kfull + s, p.kperm, at.kc + hh * G::BOX, key0, at.kh,
                  b);
        sm90::mbar_expect_tx(vfull + s, G::V_BYTES);
#pragma unroll
        for (int hh = 0; hh < G::VBOXES; ++hh)
          tma_box(kt + G::K_BYTES + hh * BN * 128, at.v, vfull + s, p.vperm, vc + hh * G::BOX,
                  key0, at.kh, b);
      }
    }
    if (split > 1) {  // the consumers' two cluster barriers of the combine
      cluster_arrive();
      cluster_wait();
      cluster_arrive();
      cluster_wait();
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  sm90::regs_inc<REGS_CONSUMER>();
  const int cw = wg - 1;         // rows 64 * cw .. 64 * cw + 63 of the block
  const int wrow = (warp & 3) * 16 + (lane >> 2);  // this thread's rows wrow, wrow + 8
  const float scale = 1.4426950408889634f / sqrtf((float)hd);

  // Q as the register A operand of every S product: ldmatrix from the
  // swizzled tile, row lane & 15 of the warp's 16, k 0-7 or 8-15 by lane >> 4
  uint32_t qa[HDQ / 16][4];
  sm90::mbar_wait(qbar, 0);
  {
    const int row = cw * 64 + (warp & 3) * 16 + (lane & 15);
#pragma unroll
    for (int kk = 0; kk < HDQ / 16; ++kk) {
      const int hh = kk / (ROWB / 32), chunk = (kk % (ROWB / 32)) * 2 + (lane >> 4);
      sm90::ldmatrix_x4(qa[kk], sm90::smem_u32(qs) + hh * BM * 128 +
                                    sm90::sw_offset<ROWB>(row, chunk));
    }
    // Q's columns outside the head are 0 (a window's neighbouring heads; past
    // hd a per-head map reads zeros already). Registers 0, 1 hold columns
    // 16 kk + 2 (lane & 3) and + 1, registers 2, 3 the same + 8.
    if (!EXACT) {
#pragma unroll
      for (int kk = 0; kk < HDQ / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          qa[kk][r] =
              keep_cols(qa[kk][r], 16 * kk + 8 * (r >> 1) + 2 * (lane & 3), hoff, hoff + hd);
    }
  }

  float o[HDV / 2];
#pragma unroll
  for (int e = 0; e < HDV / 2; ++e) o[e] = 0.f;
  float sc[BN / 2];
  uint32_t pa[BN / 16][4];  // P of the previous tile, the A fragments of P.V
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  // S = Q K^T of the K tile in stage s: k16 steps along the channels
  auto s_gemm = [&](int s) {
    const uint32_t kt = sm90::smem_u32(ring + s * G::STAGE_BYTES);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDQ / 16; ++kk) {
      const int hh = kk / (ROWB / 32), koff = (kk % (ROWB / 32)) * 32;
      sm90::wgmma_rs<BN, 0>(sc, qa[kk], sm90::desc_kmajor<ROWB>(kt + hh * BN * 128 + koff),
                            kk > 0);
    }
    sm90::wgmma_commit();
  };
  // O += P V of the V tile in stage s: k16 steps along its keys, V MN-major
  auto pv = [&](int s) {
    const uint32_t vt = sm90::smem_u32(ring + s * G::STAGE_BYTES + G::K_BYTES);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      sm90::wgmma_rs<HDV, 1>(o, pa[kk], sm90::desc_mn<ROWB>(vt + kk * 16 * ROWB, BN * 128));
    sm90::wgmma_commit();
  };
  // the online softmax of tile i, in place in sc (p, fp32); the rescale of
  // l and O comes after the previous tile's P.V has finished
  float corr[2];
  auto softmax = [&](int i) {
    const int key0 = (j_beg + i) * BN;
    if (key0 + BN > p.S) {  // only the last tile can hold keys at or beyond S
#pragma unroll
      for (int e = 0; e < BN / 2; ++e)
        sc[e] = mask_key(sc[e], key0 + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1), p.S);
    }
    float mx[2] = {m_run[0], m_run[1]}, base[2];
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // a row's columns lie in the lanes of one quad
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = sm90::ex2((m_run[r] - mx[r]) * scale);  // 0 while m_run is -inf
      base[r] = mx[r] * scale;
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) sc[e] = sm90::ex2(fmaf(sc[e], scale, -base[(e >> 1) & 1]));
  };
  auto rescale_pack = [&]() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float rs = 0.f;
#pragma unroll
      for (int e = 0; e < BN / 2; ++e)
        if (((e >> 1) & 1) == r) rs += sc[e];
      l_run[r] = l_run[r] * corr[r] + rs;
    }
#pragma unroll
    for (int e = 0; e < HDV / 2; ++e) o[e] *= corr[(e >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      pa[kk][0] = sm90::pack_bf16x2(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = sm90::pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = sm90::pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = sm90::pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };
  auto release = [&](int s) {  // this warp is done with stage s
    if (lane == 0) sm90::mbar_arrive(empty + s);
  };

  // tile 0: its S alone
  if (cw == 1) sm90::bar_arrive(BAR_TURN + 0, 256);  // consumer 0 goes first
  sm90::mbar_wait(kfull, 0);
  sm90::bar_sync(BAR_TURN + cw, 256);  // this consumer's turn at the tensor cores
  s_gemm(0);
  if (cw == 0 || n > 1) sm90::bar_arrive(BAR_TURN + 1 - cw, 256);  // the other's turn
  sm90::wgmma_wait<0>();
  sm90::fence_regs(sc);
  softmax(0);
  rescale_pack();
  // tile i: S(i) and P.V(i - 1) go to the tensor cores together; the
  // softmax of tile i runs while P.V(i - 1) (and the other consumer's
  // products) run
  for (int i = 1; i < n; ++i) {
    const int s = i % stages, sp = (i - 1) % stages;
    sm90::mbar_wait(kfull + s, (i / stages) & 1);
    sm90::bar_sync(BAR_TURN + cw, 256);
    s_gemm(s);
    sm90::mbar_wait(vfull + sp, ((i - 1) / stages) & 1);
    pv(sp);
    if (cw == 0 || i + 1 < n) sm90::bar_arrive(BAR_TURN + 1 - cw, 256);
    sm90::wgmma_wait<1>();  // S(i) done; P.V(i - 1) may still run
    sm90::fence_regs(sc);
    softmax(i);
    sm90::wgmma_wait<0>();  // P.V(i - 1) done: O, P and stage i - 1 are free
    sm90::fence_regs(o);
    release(sp);
    rescale_pack();
  }
  {  // the last tile's P.V
    const int sp = (n - 1) % stages;
    sm90::mbar_wait(vfull + sp, ((n - 1) / stages) & 1);
    pv(sp);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }

  // column c of this block's O is column c + jc of the head; where the head
  // starts on the tile and hd is a multiple of 8, whole pairs (quads in the
  // combine) of columns lie inside it and go out 4 (8) bytes at a time, else
  // one bf16 at a time
  const int jc = vpart * HDV - hoff;
  const bool whole = EXACT || (hoff == 0 && hd % 8 == 0);
  bf16* ob = at.o;
  if (split == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = t0 + cw * 64 + wrow + 8 * r;
      if (row >= p.T) continue;
      bf16* orow = ob + (long long)row * p.o_st;
#pragma unroll
      for (int nt = 0; nt < HDV / 8; ++nt) {
        const int j = jc + 8 * nt + 2 * (lane & 3);
        const float v0 = o[4 * nt + 2 * r] / l_run[r], v1 = o[4 * nt + 2 * r + 1] / l_run[r];
        if (whole) {
          if (j < hd) *reinterpret_cast<uint32_t*>(orow + j) = sm90::pack_bf16x2(v0, v1);
        } else {
          if (j >= 0 && j < hd) orow[j] = from_f<bf16>(v0);
          if (j + 1 >= 0 && j + 1 < hd) orow[j + 1] = from_f<bf16>(v1);
        }
      }
    }
  } else {
    // split over the cluster: rank r combines rows [r * rows_per, ...); each
    // rank stores (m * scale, l, O) of every row into the buffer of the row's
    // owner, in its own slot (remote stores only: nothing waits on a peer's
    // shared memory), and each owner combines its rows over the slots in rank
    // order from its own shared memory. The buffer is the ring, free once every
    // rank's products are done.
    const int rows_per = (BM + split - 1) / split;
    float* co = reinterpret_cast<float*>(ring);  // [split * rows_per][CO_LD]
    float* cm = co + CMAX_ROWS * G::CO_LD;       // [split * rows_per]
    float* cl = cm + CMAX_ROWS;
    float* wts = cl + CMAX_ROWS;                 // [rows_per][MAX_SPLIT]
    float* lsum = wts + (BM / 2) * MAX_SPLIT;    // [rows_per]
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    cluster_arrive();
    cluster_wait();  // every rank's ring is free
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = cw * 64 + wrow + 8 * r, owner = row / rows_per;
      const int slot = rank * rows_per + row - owner * rows_per;
      float* dst = cluster.map_shared_rank(co, owner) + slot * G::CO_LD + 2 * (lane & 3);
#pragma unroll
      for (int nt = 0; nt < HDV / 8; ++nt)
        *reinterpret_cast<float2*>(dst + 8 * nt) =
            make_float2(o[4 * nt + 2 * r], o[4 * nt + 2 * r + 1]);
      if ((lane & 3) == 0) {
        cluster.map_shared_rank(cm, owner)[slot] = m_run[r] * scale;
        cluster.map_shared_rank(cl, owner)[slot] = l_run[r];
      }
    }
    cluster_arrive();
    cluster_wait();  // every part of this rank's rows has arrived
    const int r_beg = rank * rows_per, nr = min(rows_per, BM - r_beg);
    const int tc = tid - 128;  // 0 .. 255
    for (int li = tc; li < nr; li += 256) {  // each row: the ranks' weights 2^(m_q - max)
      float mmax = -INFINITY;
      for (int q = 0; q < split; ++q) mmax = fmaxf(mmax, cm[q * rows_per + li]);
      float l = 0.f;
      for (int q = 0; q < split; ++q) {
        const float w = sm90::ex2(cm[q * rows_per + li] - mmax);
        wts[li * MAX_SPLIT + q] = w;
        l += w * cl[q * rows_per + li];
      }
      lsum[li] = l;
    }
    sm90::bar_sync(BAR_CONSUMERS, 256);
    for (int e = tc; e < nr * (HDV / 4); e += 256) {  // quads of columns
      const int li = e / (HDV / 4), c = 4 * (e % (HDV / 4)), j = jc + c;
      if (t0 + r_beg + li >= p.T || j >= hd || j + 4 <= 0) continue;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q = 0; q < split; ++q) {  // rank order
        const float w = wts[li * MAX_SPLIT + q];
        const float4 v = *reinterpret_cast<const float4*>(co + (q * rows_per + li) * G::CO_LD + c);
        acc.x += w * v.x;
        acc.y += w * v.y;
        acc.z += w * v.z;
        acc.w += w * v.w;
      }
      const float l = lsum[li];
      bf16* orow = ob + (long long)(t0 + r_beg + li) * p.o_st;
      if (whole) {
        *reinterpret_cast<uint2*>(orow + j) = make_uint2(
            sm90::pack_bf16x2(acc.x / l, acc.y / l), sm90::pack_bf16x2(acc.z / l, acc.w / l));
      } else {
        const float vals[4] = {acc.x / l, acc.y / l, acc.z / l, acc.w / l};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (j + u >= 0 && j + u < hd) orow[j + u] = from_f<bf16>(vals[u]);
      }
    }
  }
}

// The maps' head and first channel of a head's tiles: per-head maps start
// at the head; a window starts at the 8-channel unit that holds the head's
// first channel, the head hoff channels into the tile
template <int HDQ, int BN, bool EXACT>
__global__ void __launch_bounds__(NTHREADS, 1)
    attention_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, const AttnArgs p) {
  const int h = (int)blockIdx.y / Geo<HDQ, BN>::VPARTS, b = blockIdx.z;
  const int hd = EXACT ? HDQ : p.hd;
  const bool window = !EXACT && p.window;
  const int hm = window ? 0 : h, c = window ? (h * hd) & ~7 : 0;
  attention_body<HDQ, BN, EXACT>(HeadAt{&qmap, &kmap, &vmap, hm, hm, c, c,
                                        window ? (h * hd) & 7 : 0, b,
                                        p.o + b * p.o_sb + h * p.o_sh},
                                 p);
}

// The folded core: head h of the grid's 2H is head hb of branch br, its K
// and V in that branch's maps; in a window its Q channels lie q_branch
// channels further along the row for branch 1, where the head's offset
// into its tiles is the same as in the branch's K and V (q_branch a
// multiple of 8)
template <int HDQ, int BN, bool EXACT>
__global__ void __launch_bounds__(NTHREADS, 1)
    fold_core_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap0,
                     const __grid_constant__ CUtensorMap vmap0,
                     const __grid_constant__ CUtensorMap kmap1,
                     const __grid_constant__ CUtensorMap vmap1, const AttnArgs p,
                     const FoldArgs f) {
  const int h = (int)blockIdx.y / Geo<HDQ, BN>::VPARTS, b = blockIdx.z;
  const int br = h >= f.heads ? 1 : 0, hb = h - br * f.heads;
  const int hd = EXACT ? HDQ : p.hd;
  const bool window = !EXACT && p.window;
  const int c = window ? (hb * hd) & ~7 : 0;
  attention_body<HDQ, BN, EXACT>(
      HeadAt{&qmap, br ? &kmap1 : &kmap0, br ? &vmap1 : &vmap0, window ? 0 : h,
             window ? 0 : hb, window ? br * f.q_branch + c : 0, c, window ? (hb * hd) & 7 : 0, b,
             p.o + b * p.o_sb + br * f.o_branch + hb * p.o_sh},
      p);
}

// CHUNKED: a head whose tile passes 256 channels (hd above 256, or hd
// 249-255 at a window offset). Q and K of 64 or more rows by such a head fit
// neither the consumers' registers nor a ring of useful depth, so the scores
// of a key tile accumulate over chunks of CHUNK channels: the ring's items
// are a (Q chunk, K chunk) pair for each chunk, then the tile's part of V (a
// K chunk's bytes), one stage each. Q comes again with every key tile (L2
// holds it). The same arithmetic as attention_kernel, without its ping-pong
// and split: no shipped config reaches these head dims.
constexpr int CHUNK = 128;

template <int BN>
struct ChunkGeo {
  static constexpr int ROWB = 128, BOX = 64;  // two 64-channel boxes a chunk
  static constexpr int Q_BYTES = BM * CHUNK * 2;
  static constexpr int K_BYTES = BN * CHUNK * 2;  // a V part takes as much
  static constexpr int STAGE_BYTES = Q_BYTES + K_BYTES;
  static constexpr int smem(int stages) { return 1024 + stages * STAGE_BYTES; }
};

template <int BN>
__device__ __forceinline__ void chunked_body(const HeadAt& at, const AttnArgs& p, const int nc) {
  using G = ChunkGeo<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  __shared__ uint64_t bars[2 * MAX_STAGES];
  uint64_t* full = bars;
  uint64_t* empty = bars + MAX_STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int stages = p.stages, hd = p.hd;
  const bool window = p.window;
  const int vpart = (int)blockIdx.y % nc, b = at.b, hoff = at.hoff;
  const int t0 = blockIdx.x * BM;
  const int n = p.tiles, items = n * (nc + 1);  // per key tile: nc chunks, then V

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, 8);  // lane 0 of each consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    sm90::regs_dec<REGS_PRODUCER>();
    if (tid == 0) {
      for (int it = 0; it < items; ++it) {
        const int s = it % stages, c = it % (nc + 1), key0 = (it / (nc + 1)) * BN;
        if (it >= stages) sm90::mbar_wait(empty + s, ((it / stages) & 1) ^ 1);
        const uint32_t st = sm90::smem_u32(ring + s * G::STAGE_BYTES);
        if (c < nc) {
          sm90::mbar_expect_tx(full + s, G::Q_BYTES + G::K_BYTES);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int ch = c * CHUNK + hh * G::BOX;
            tma_box(st + hh * BM * 128, at.q, full + s, p.qperm, at.qc + ch, t0, at.qh, b);
            tma_box(st + G::Q_BYTES + hh * BN * 128, at.k, full + s, p.kperm, at.kc + ch, key0,
                    at.kh, b);
          }
        } else {
          sm90::mbar_expect_tx(full + s, G::K_BYTES);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            tma_box(st + G::Q_BYTES + hh * BN * 128, at.v, full + s, p.vperm,
                    at.kc + vpart * CHUNK + hh * G::BOX, key0, at.kh, b);
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  sm90::regs_inc<REGS_CONSUMER>();
  const int cw = wg - 1;
  const int wrow = (warp & 3) * 16 + (lane >> 2);
  const int qrow = cw * 64 + (warp & 3) * 16 + (lane & 15);  // ldmatrix's row
  const float scale = 1.4426950408889634f / sqrtf((float)hd);

  float o[CHUNK / 2];
#pragma unroll
  for (int e = 0; e < CHUNK / 2; ++e) o[e] = 0.f;
  float sc[BN / 2];
  uint32_t qa[CHUNK / 16][4];
  uint32_t pa[BN / 16][4];
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int i = 0; i < n; ++i) {
    // S = sum over the chunks of Q_c K_c^T
    for (int c = 0; c < nc; ++c) {
      const int it = i * (nc + 1) + c, s = it % stages;
      sm90::mbar_wait(full + s, (it / stages) & 1);
      const uint32_t st = sm90::smem_u32(ring + s * G::STAGE_BYTES);
#pragma unroll
      for (int kk = 0; kk < CHUNK / 16; ++kk)
        sm90::ldmatrix_x4(qa[kk], st + (kk / 4) * BM * 128 +
                                      sm90::sw_offset<128>(qrow, (kk % 4) * 2 + (lane >> 4)));
      if (window) {  // a window's neighbouring heads: Q's columns outside the head are 0
#pragma unroll
        for (int kk = 0; kk < CHUNK / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            qa[kk][r] = keep_cols(qa[kk][r], c * CHUNK + 16 * kk + 8 * (r >> 1) + 2 * (lane & 3),
                                  hoff, hoff + hd);
      }
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CHUNK / 16; ++kk)
        sm90::wgmma_rs<BN, 0>(
            sc, qa[kk],
            sm90::desc_kmajor<128>(st + G::Q_BYTES + (kk / 4) * BN * 128 + (kk % 4) * 32),
            c > 0 || kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      if (lane == 0) sm90::mbar_arrive(empty + s);
    }
    // the online softmax of the tile, as attention_kernel's
    const int key0 = i * BN;
    if (key0 + BN > p.S) {
#pragma unroll
      for (int e = 0; e < BN / 2; ++e)
        sc[e] = mask_key(sc[e], key0 + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1), p.S);
    }
    float mx[2] = {m_run[0], m_run[1]}, base[2], corr[2];
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = sm90::ex2((m_run[r] - mx[r]) * scale);
      base[r] = mx[r] * scale;
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) sc[e] = sm90::ex2(fmaf(sc[e], scale, -base[(e >> 1) & 1]));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float rs = 0.f;
#pragma unroll
      for (int e = 0; e < BN / 2; ++e)
        if (((e >> 1) & 1) == r) rs += sc[e];
      l_run[r] = l_run[r] * corr[r] + rs;
    }
#pragma unroll
    for (int e = 0; e < CHUNK / 2; ++e) o[e] *= corr[(e >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      pa[kk][0] = sm90::pack_bf16x2(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = sm90::pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = sm90::pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = sm90::pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    // O += P V of this block's part of V
    {
      const int it = i * (nc + 1) + nc, s = it % stages;
      sm90::mbar_wait(full + s, (it / stages) & 1);
      const uint32_t vt = sm90::smem_u32(ring + s * G::STAGE_BYTES + G::Q_BYTES);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        sm90::wgmma_rs<CHUNK, 1>(o, pa[kk], sm90::desc_mn<128>(vt + kk * 16 * 128, BN * 128));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      if (lane == 0) sm90::mbar_arrive(empty + s);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  // column c of this block's O is column c + jc of the head
  const int jc = vpart * CHUNK - hoff;
  const bool whole = hoff == 0 && hd % 8 == 0;
  bf16* ob = at.o;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = t0 + cw * 64 + wrow + 8 * r;
    if (row >= p.T) continue;
    bf16* orow = ob + (long long)row * p.o_st;
#pragma unroll
    for (int nt = 0; nt < CHUNK / 8; ++nt) {
      const int j = jc + 8 * nt + 2 * (lane & 3);
      const float v0 = o[4 * nt + 2 * r] / l_run[r], v1 = o[4 * nt + 2 * r + 1] / l_run[r];
      if (whole) {
        if (j < hd) *reinterpret_cast<uint32_t*>(orow + j) = sm90::pack_bf16x2(v0, v1);
      } else {
        if (j >= 0 && j < hd) orow[j] = from_f<bf16>(v0);
        if (j + 1 >= 0 && j + 1 < hd) orow[j + 1] = from_f<bf16>(v1);
      }
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(NTHREADS, 1)
    attention_chunked_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap, const AttnArgs p,
                             const int nc) {
  const int h = (int)blockIdx.y / nc, b = blockIdx.z;
  const int hm = p.window ? 0 : h, c = p.window ? (h * p.hd) & ~7 : 0;
  chunked_body<BN>(HeadAt{&qmap, &kmap, &vmap, hm, hm, c, c, p.window ? (h * p.hd) & 7 : 0, b,
                          p.o + b * p.o_sb + h * p.o_sh},
                   p, nc);
}

// the folded core's chunked form, its heads as fold_core_kernel's
template <int BN>
__global__ void __launch_bounds__(NTHREADS, 1)
    fold_core_chunked_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap0,
                             const __grid_constant__ CUtensorMap vmap0,
                             const __grid_constant__ CUtensorMap kmap1,
                             const __grid_constant__ CUtensorMap vmap1, const AttnArgs p,
                             const FoldArgs f, const int nc) {
  const int h = (int)blockIdx.y / nc, b = blockIdx.z;
  const int br = h >= f.heads ? 1 : 0, hb = h - br * f.heads;
  const int c = p.window ? (hb * p.hd) & ~7 : 0;
  chunked_body<BN>(HeadAt{&qmap, br ? &kmap1 : &kmap0, br ? &vmap1 : &vmap0, p.window ? 0 : h,
                          p.window ? 0 : hb, p.window ? br * f.q_branch + c : 0, c,
                          p.window ? (hb * p.hd) & 7 : 0, b,
                          p.o + b * p.o_sb + br * f.o_branch + hb * p.o_sh},
                   p, nc);
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {  // the driver's cuTensorMapEncodeTiled, without linking -lcuda
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The strided (B, H, rows, hd) view as a 4-D map: hd innermost, then (rows,
// h, b) by increasing stride (a dimension of extent 1 last), so every view
// the wrapper admits (16-byte aligned rows) is described; perm gives the
// map's order of (rows, h, b). Boxes of (box_hd, box_rows, 1, 1); hd beyond
// the tensor (hd = 8 under a 16-wide box) and rows beyond `rows` read zeros.
bool encode(CUtensorMap* map, int (&perm)[3], const void* base, int hd, int rows, int H, int B,
            long long s_row, long long s_h, long long s_b, int box_hd, int box_rows, int rowb) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const long long ext[3] = {rows, H, B};
  long long st[3] = {s_row * 2, s_h * 2, s_b * 2};  // bytes
  long long far = 16;
  for (int d = 0; d < 3; ++d)
    if (ext[d] > 1 && st[d] * ext[d] > far) far = st[d] * ext[d];
  for (int d = 0; d < 3; ++d) {
    perm[d] = d;
    if (ext[d] == 1) st[d] = (far + 15) / 16 * 16;  // unused stride: past the rest
  }
  for (int i = 0; i < 3; ++i)  // by increasing stride (insertion sort)
    for (int j = i; j > 0 && st[perm[j]] < st[perm[j - 1]]; --j) {
      const int t = perm[j];
      perm[j] = perm[j - 1];
      perm[j - 1] = t;
    }
  cuuint64_t dims[4] = {(cuuint64_t)hd, 0, 0, 0};
  cuuint64_t strides[3];
  for (int d = 0; d < 3; ++d) {
    dims[d + 1] = (cuuint64_t)ext[perm[d]];
    strides[d] = (cuuint64_t)st[perm[d]];
  }
  cuuint32_t box[4] = {(cuuint32_t)box_hd, 1, 1, 1};
  for (int d = 0; d < 3; ++d)
    if (perm[d] == 0) box[d + 1] = (cuuint32_t)box_rows;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = rowb == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : rowb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                             : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// host-side refusals, returned as negative codes (the wrapper names them)
constexpr int ERR_TENSOR_MAP = -1;  // cuTensorMapEncodeTiled refused a view
constexpr int ERR_REGISTERS = -2;   // the kernel's register budget cannot fund setmaxnreg
constexpr int ERR_PLAN = -3;        // a launch plan the kernel does not take

// What a launch reads: q as (B, H * branches, T, hd), each branch's k and v
// as (B, H, S, hd), through element strides (b, h, row) of q, k and v (the
// branches share k's and v's); the folded form has two branches
struct Views {
  const void* q;
  const void* k[2];
  const void* v[2];
  long long st[9];
  int B, H, branches;
};

// 1 once the kernel's attributes are set, else the refusal or cudaError_t;
// `ready` is the kernel's own (0: not yet)
template <typename Kern>
int set_up(Kern kern, int& ready) {
  if (ready == 0) {
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, kern);
    if (e != cudaSuccess) return (int)e;
    // setmaxnreg moves registers between the warpgroups of the block's
    // allocation: 128 * (40 + 2 * 232) needs 168 a thread at launch
    if (fa.numRegs * NTHREADS < 128 * (REGS_PRODUCER + 2 * REGS_CONSUMER)) {
      ready = ERR_REGISTERS;
    } else {
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               232448 - (int)fa.sharedSizeBytes);
      if (e != cudaSuccess) return (int)e;
      ready = 1;
    }
  }
  return ready;
}

// the maps of a launch with boxes of `box` channels by BM query rows or bn
// keys; a window: each row's channels as one head (the heads lie side by
// side, checked by the entry), Q's row `qwin` channels wide
bool encode_views(const Views& w, AttnArgs& p, int qwin, int box, int bn, int rowb,
                  CUtensorMap& qm, CUtensorMap (&km)[2], CUtensorMap (&vm)[2]) {
  const long long* st = w.st;
  const int qhd = p.window ? qwin : p.hd, qh = p.window ? 1 : w.H * w.branches;
  const int khd = p.window ? w.H * p.hd : p.hd, kh = p.window ? 1 : w.H;
  if (!encode(&qm, p.qperm, w.q, qhd, p.T, qh, w.B, st[2], st[1], st[0], box, BM, rowb))
    return false;
  for (int i = 0; i < w.branches; ++i)
    if (!encode(&km[i], p.kperm, w.k[i], khd, p.S, kh, w.B, st[5], st[4], st[3], box, bn, rowb) ||
        !encode(&vm[i], p.vperm, w.v[i], khd, p.S, kh, w.B, st[8], st[7], st[6], box, bn, rowb))
      return false;
  return true;
}

// one launch over a cluster of `split` blocks along x
template <typename... Params, typename... Args>
int launch_cluster(void (*kern)(Params...), dim3 grid, int split, int smem, cudaStream_t s,
                   Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int HDQ, int BN, bool EXACT>
int launch(const Views& w, AttnArgs& p, const FoldArgs& f, int smem, cudaStream_t s) {
  using G = Geo<HDQ, BN>;
  // less shared memory than the ring (or the combine) takes would overrun it
  if (smem != G::smem(p.stages)) return ERR_PLAN;
  static int ready = 0, ready_fold = 0;
  auto kern = attention_kernel<HDQ, BN, EXACT>;
  auto fold = fold_core_kernel<HDQ, BN, EXACT>;
  const int r = w.branches == 1 ? set_up(kern, ready) : set_up(fold, ready_fold);
  if (r != 1) return r;
  CUtensorMap qm, km[2], vm[2];
  if (!encode_views(w, p, (w.branches - 1) * f.q_branch + w.H * p.hd, G::BOX, BN, G::ROWB, qm,
                    km, vm))
    return ERR_TENSOR_MAP;
  const dim3 grid(p.split * ((p.T + BM - 1) / BM), w.H * w.branches * G::VPARTS, w.B);
  if (w.branches == 1) return launch_cluster(kern, grid, p.split, smem, s, qm, km[0], vm[0], p);
  return launch_cluster(fold, grid, p.split, smem, s, qm, km[0], vm[0], km[1], vm[1], p, f);
}

// the chunked form: BN = 64, no split, grid (mtiles, H * branches * nc, B)
int launch_chunked(const Views& w, AttnArgs& p, const FoldArgs& f, int nc, int bn, int smem,
                   cudaStream_t s) {
  using G = ChunkGeo<64>;
  if (bn != 64 || p.split != 1 || smem != G::smem(p.stages)) return ERR_PLAN;
  static int ready = 0, ready_fold = 0;
  auto kern = attention_chunked_kernel<64>;
  auto fold = fold_core_chunked_kernel<64>;
  const int r = w.branches == 1 ? set_up(kern, ready) : set_up(fold, ready_fold);
  if (r != 1) return r;
  CUtensorMap qm, km[2], vm[2];
  if (!encode_views(w, p, (w.branches - 1) * f.q_branch + w.H * p.hd, G::BOX, 64, G::ROWB, qm,
                    km, vm))
    return ERR_TENSOR_MAP;
  const dim3 grid((p.T + BM - 1) / BM, w.H * w.branches * nc, w.B);
  if (w.branches == 1) {
    kern<<<grid, NTHREADS, smem, s>>>(qm, km[0], vm[0], p, nc);
  } else {
    fold<<<grid, NTHREADS, smem, s>>>(qm, km[0], vm[0], km[1], vm[1], p, f, nc);
  }
  return (int)cudaGetLastError();
}

template <int HDQ, bool EXACT>
int launch_exact(const Views& w, AttnArgs& p, const FoldArgs& f, int bn, int smem,
                 cudaStream_t s) {
  if (bn == 64) return launch<HDQ, 64, EXACT>(w, p, f, smem, s);
  // above 128 channels only 64-key tiles: S, P, Q and O together fit the
  // consumers' registers there
  if constexpr (HDQ <= 128) {
    if (bn == 128) return launch<HDQ, 128, EXACT>(w, p, f, smem, s);
  }
  return ERR_PLAN;
}

template <int HDQ>
int launch_bn(const Views& w, AttnArgs& p, const FoldArgs& f, int bn, int smem, cudaStream_t s) {
  if constexpr (HDQ <= 128) {
    if (!p.window && p.hd == HDQ) return launch_exact<HDQ, true>(w, p, f, bn, smem, s);
  }
  return launch_exact<HDQ, false>(w, p, f, bn, smem, s);
}

// the channels of a Q or K tile row for head dim hd whose heads start
// `hoff_max` channels at most into their tile: 16, 32, 64, then multiples of
// 64 to 256, above that multiples of CHUNK (the chunked form)
int tile_channels(int hd, int hoff_max) {
  const int need = hd + hoff_max;
  if (need <= 16) return 16;
  if (need <= 32) return 32;
  if (need <= 256) return (need + 63) / 64 * 64;
  return (need + CHUNK - 1) / CHUNK * CHUNK;
}

// both entries: the arguments every launch checks, then the form by hdq.
// The head stride of q, k, v is hd wherever a window reads them (heads side
// by side), and `heads` (H a branch) sets the window's offsets.
int run(const Views& w, AttnArgs& p, const FoldArgs& f, int hdq, int bn, int stages, int split,
        int smem, cudaStream_t s) {
  if (p.T < 1 || p.S < 1 || p.hd < 1) return (int)cudaErrorInvalidValue;
  if (stages < 3 || stages > MAX_STAGES || split < 1 || split > MAX_SPLIT) return ERR_PLAN;
  // hd off the 8-channel unit: a head's offset h*hd*2 bytes is off the tensor
  // map's 16-byte unit, so the maps read windows of each row's channels
  p.window = p.hd % 8 != 0;
  p.tiles = (p.S + bn - 1) / bn;
  p.split = split;
  p.stages = stages;
  if (split > p.tiles) return ERR_PLAN;
  int hoff_max = 0;
  if (p.window) {  // the heads side by side (head stride hd)
    if (w.st[1] != p.hd || w.st[4] != p.hd || w.st[7] != p.hd) return (int)cudaErrorInvalidValue;
    for (int hh = 0; hh < w.H && hoff_max < 7; ++hh) hoff_max = max(hoff_max, (hh * p.hd) & 7);
  }
  if (hdq != tile_channels(p.hd, hoff_max)) return ERR_PLAN;
  switch (hdq) {
    case 16: return launch_bn<16>(w, p, f, bn, smem, s);
    case 32: return launch_bn<32>(w, p, f, bn, smem, s);
    case 64: return launch_bn<64>(w, p, f, bn, smem, s);
    case 128: return launch_bn<128>(w, p, f, bn, smem, s);
    case 192: return launch_bn<192>(w, p, f, bn, smem, s);
    case 256: return launch_bn<256>(w, p, f, bn, smem, s);
    default:  // hd plus its offset in the window above 256
      return launch_chunked(w, p, f, hdq / CHUNK, bn, smem, s);
  }
}

AttnArgs args(void* o, int T, int S, int hd, long long o_sb, long long o_sh, long long o_st) {
  AttnArgs p;
  p.o = static_cast<bf16*>(o);
  p.T = T;
  p.S = S;
  p.hd = hd;
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_st = o_st;
  return p;
}

}  // namespace

extern "C" int lm2a_attention(const void* q, const void* k, const void* v, void* o, int B,
                              int H, int T, int S, int hd, long long q_sb, long long q_sh,
                              long long q_st, long long k_sb, long long k_sh, long long k_st,
                              long long v_sb, long long v_sh, long long v_st, long long o_sb,
                              long long o_sh, long long o_st, int hdq, int bn, int stages,
                              int split, int smem, void* stream) {
  const Views w = {q, {k, nullptr}, {v, nullptr},
                   {q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st}, B, H, 1};
  AttnArgs p = args(o, T, S, hd, o_sb, o_sh, o_st);
  return run(w, p, FoldArgs{H, 0, 0}, hdq, bn, stages, split, smem,
             static_cast<cudaStream_t>(stream));
}

// The folded core: q (B, T, 2C) rows, branch 1's channels q_branch into the
// row (C unless the wrapper padded the rows); k0, v0 (motion) and k1, v1
// (text) (B, S, C) rows of H heads of hd side by side; o (B, T, 2C) rows,
// branch 1 o_branch elements into the row. Row and batch strides in
// elements; every head stride is hd.
extern "C" int lm2a_fold_core(const void* q, const void* k0, const void* v0, const void* k1,
                              const void* v1, void* o, int B, int H, int T, int S, int hd,
                              long long q_sb, long long q_st, long long k_sb, long long k_st,
                              long long v_sb, long long v_st, long long o_sb, long long o_st,
                              int q_branch, int o_branch, int hdq, int bn, int stages, int split,
                              int smem, void* stream) {
  // per-head maps read Q's 2H heads at a stride of hd, so branch 1 follows
  // branch 0; a window's branch base is on the 8-channel unit
  if (H < 1 || (hd % 8 == 0 ? q_branch != H * hd : q_branch % 8 != 0 || q_branch < H * hd))
    return (int)cudaErrorInvalidValue;
  const Views w = {q, {k0, k1}, {v0, v1},
                   {q_sb, hd, q_st, k_sb, hd, k_st, v_sb, hd, v_st}, B, H, 2};
  AttnArgs p = args(o, T, S, hd, o_sb, hd, o_st);
  return run(w, p, FoldArgs{H, q_branch, o_branch}, hdq, bn, stages, split, smem,
             static_cast<cudaStream_t>(stream));
}
