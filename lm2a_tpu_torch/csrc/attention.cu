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
//  - head dims 2 and 4 (C/8 at the narrow base-16 and base-32 models): a
//    head's row of 4 or 8 bytes is below the tensor map's 16-byte stride
//    unit, so the maps see each row's H*hd channels as H*hd/8 virtual heads
//    of 8 (hd 8's maps exactly), and a block loads the virtual head that
//    holds its head, at offset (h*hd) % 8. Q's other columns are zeroed in
//    registers after the ldmatrix, so the scores see the head's hd values
//    alone; only the head's hd output columns are stored;
//  - where the grid is small (the 6 s geometries), the key tiles are split
//    over the `split` blocks of a thread-block cluster; each keeps (m, l, O)
//    of its keys, pushes each row's through distributed shared memory to
//    the rank that owns the row, and the owner combines them in rank order
//    (the same bits on every run, no atomics). The launch plan
//    (ops/attention.py attention_plan) picks BN, stages and split.

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
  long long o_sb, o_sh, o_st;  // element strides; hd stride is 1
  int tiles;                   // key tiles of BN keys
  int split;                   // cluster blocks along x that split the key tiles
  int stages;                  // ring depth
  int qperm[3], kperm[3], vperm[3];  // the tensor maps' order of (t, h, b)
};

template <int HD, int BN>
struct Geo {
  static constexpr int HDP = HD < 16 ? 16 : HD;                // contraction, padded to k16
  static constexpr int ROWB = HDP * 2 > 128 ? 128 : HDP * 2;  // bytes a swizzled row
  static constexpr int HALVES = HDP * 2 / ROWB;  // hd = 128: two boxes of 64 along hd
  static constexpr int BOX = ROWB / 2;           // hd values a box row
  static constexpr int Q_BYTES = BM * HDP * 2;
  static constexpr int KV_BYTES = BN * HDP * 2;  // one K or one V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int CO_LD = HDP + 4;  // fp32 row stride of the combine buffer
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

template <int HD, int BN>
__global__ void __launch_bounds__(NTHREADS, 1)
    attention_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, const AttnArgs p) {
  using G = Geo<HD, BN>;
  constexpr int HDP = G::HDP, ROWB = G::ROWB;
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
  const int split = p.split, stages = p.stages;
  const int rank = (int)(blockIdx.x % split), mtile = (int)(blockIdx.x / split);
  const int h = blockIdx.y, b = blockIdx.z;
  // hd < 8: the virtual head of 8 channels that holds this head, and the
  // head's first column in it
  const int hmap = HD < 8 ? (h * HD) >> 3 : h, hoff = HD < 8 ? (h * HD) & 7 : 0;
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
      for (int hh = 0; hh < G::HALVES; ++hh)
        tma_box(sm90::smem_u32(qs) + hh * BM * 128, &qmap, qbar, p.qperm, hh * G::BOX, t0, hmap,
                b);
      for (int i = 0; i < n; ++i) {
        const int s = i % stages;
        if (i >= stages) sm90::mbar_wait(empty + s, ((i / stages) & 1) ^ 1);
        const int key0 = (j_beg + i) * BN;
        const uint32_t kt = sm90::smem_u32(ring + s * G::STAGE_BYTES);
        sm90::mbar_expect_tx(kfull + s, G::KV_BYTES);
#pragma unroll
        for (int hh = 0; hh < G::HALVES; ++hh)
          tma_box(kt + hh * BN * 128, &kmap, kfull + s, p.kperm, hh * G::BOX, key0, hmap, b);
        sm90::mbar_expect_tx(vfull + s, G::KV_BYTES);
#pragma unroll
        for (int hh = 0; hh < G::HALVES; ++hh)
          tma_box(kt + G::KV_BYTES + hh * BN * 128, &vmap, vfull + s, p.vperm, hh * G::BOX, key0,
                  hmap, b);
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
  const float scale = 1.4426950408889634f / sqrtf((float)HD);

  // Q as the register A operand of every S product: ldmatrix from the
  // swizzled tile, row lane & 15 of the warp's 16, k 0-7 or 8-15 by lane >> 4
  uint32_t qa[HDP / 16][4];
  sm90::mbar_wait(qbar, 0);
  {
    const int row = cw * 64 + (warp & 3) * 16 + (lane & 15);
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const int hh = kk / (ROWB / 32), chunk = (kk % (ROWB / 32)) * 2 + (lane >> 4);
      sm90::ldmatrix_x4(qa[kk], sm90::smem_u32(qs) + hh * BM * 128 +
                                    sm90::sw_offset<ROWB>(row, chunk));
    }
    if (HD < 8) {  // the virtual head's other heads: Q's columns outside the head are 0
      // (registers 2, 3 hold columns 8-15; 0, 1 columns 2 (lane & 3) and + 1)
      const int c = 2 * (lane & 3);
      qa[0][2] = qa[0][3] = 0u;
      if (c < hoff || c >= hoff + HD) qa[0][0] = qa[0][1] = 0u;
    }
  }

  float o[HDP / 2];
#pragma unroll
  for (int e = 0; e < HDP / 2; ++e) o[e] = 0.f;
  float sc[BN / 2];
  uint32_t pa[BN / 16][4];  // P of the previous tile, the A fragments of P.V
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  // S = Q K^T of the K tile in stage s: k16 steps along hd
  auto s_gemm = [&](int s) {
    const uint32_t kt = sm90::smem_u32(ring + s * G::STAGE_BYTES);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const int hh = kk / (ROWB / 32), koff = (kk % (ROWB / 32)) * 32;
      sm90::wgmma_rs<BN, 0>(sc, qa[kk], sm90::desc_kmajor<ROWB>(kt + hh * BN * 128 + koff),
                            kk > 0);
    }
    sm90::wgmma_commit();
  };
  // O += P V of the V tile in stage s: k16 steps along its keys, V MN-major
  auto pv = [&](int s) {
    const uint32_t vt = sm90::smem_u32(ring + s * G::STAGE_BYTES + G::KV_BYTES);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      sm90::wgmma_rs<HDP, 1>(o, pa[kk], sm90::desc_mn<ROWB>(vt + kk * 16 * ROWB, BN * 128));
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
    for (int e = 0; e < HDP / 2; ++e) o[e] *= corr[(e >> 1) & 1];
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

  if (split == 1 && HD < 8) {  // the head's columns hoff .. hoff + HD - 1 of O
    const int c = 2 * (lane & 3);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = t0 + cw * 64 + wrow + 8 * r;
      if (row < p.T && c >= hoff && c < hoff + HD)
        *reinterpret_cast<uint32_t*>(p.o + b * p.o_sb + h * p.o_sh + (long long)row * p.o_st +
                                     c - hoff) =
            sm90::pack_bf16x2(o[2 * r] / l_run[r], o[2 * r + 1] / l_run[r]);
    }
  } else if (split == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = t0 + cw * 64 + wrow + 8 * r;
      if (row >= p.T) continue;
      bf16* orow = p.o + b * p.o_sb + h * p.o_sh + (long long)row * p.o_st + 2 * (lane & 3);
#pragma unroll
      for (int nt = 0; nt < HDP / 8; ++nt)
        if (8 * nt < HD)
          *reinterpret_cast<uint32_t*>(orow + 8 * nt) =
              sm90::pack_bf16x2(o[4 * nt + 2 * r] / l_run[r], o[4 * nt + 2 * r + 1] / l_run[r]);
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
      for (int nt = 0; nt < HDP / 8; ++nt)
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
    bf16* ob = p.o + b * p.o_sb + h * p.o_sh;
    for (int e = tc; HD < 8 && e < nr * (HD / 2); e += 256) {  // the head's column pairs
      const int li = e / (HD / 2), c = 2 * (e % (HD / 2));
      if (t0 + r_beg + li >= p.T) continue;
      float2 acc = make_float2(0.f, 0.f);
      for (int q = 0; q < split; ++q) {  // rank order
        const float w = wts[li * MAX_SPLIT + q];
        const float2 v =
            *reinterpret_cast<const float2*>(co + (q * rows_per + li) * G::CO_LD + hoff + c);
        acc.x += w * v.x;
        acc.y += w * v.y;
      }
      const float l = lsum[li];
      *reinterpret_cast<uint32_t*>(ob + (long long)(t0 + r_beg + li) * p.o_st + c) =
          sm90::pack_bf16x2(acc.x / l, acc.y / l);
    }
    for (int e = tc; HD >= 8 && e < nr * (HDP / 4); e += 256) {
      const int li = e / (HDP / 4), c = 4 * (e % (HDP / 4));
      if (t0 + r_beg + li >= p.T || c >= HD) continue;
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
      *reinterpret_cast<uint2*>(ob + (long long)(t0 + r_beg + li) * p.o_st + c) = make_uint2(
          sm90::pack_bf16x2(acc.x / l, acc.y / l), sm90::pack_bf16x2(acc.z / l, acc.w / l));
    }
  }
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

template <int HD, int BN>
int launch(const void* q, const void* k, const void* v, AttnArgs& p, int B, int H,
           const long long (&st)[9], int smem, cudaStream_t s) {
  using G = Geo<HD, BN>;
  // less shared memory than the ring (or the combine) takes would overrun it
  if (smem != G::smem(p.stages)) return ERR_PLAN;
  auto kern = attention_kernel<HD, BN>;
  static int ready = 0;  // 1: attributes set; < 0: the refusal
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
  if (ready < 0) return ready;
  CUtensorMap qm, km, vm;
  const int mtiles = (p.T + BM - 1) / BM;
  // hd < 8: H*hd/8 virtual heads of 8 channels, 8 apart (each view's heads
  // lie side by side, checked by the entry)
  const int mhd = HD < 8 ? 8 : HD, mh = HD < 8 ? H * HD / 8 : H;
  const long long vs[3] = {HD < 8 ? 8 : st[1], HD < 8 ? 8 : st[4], HD < 8 ? 8 : st[7]};
  if (!encode(&qm, p.qperm, q, mhd, p.T, mh, B, st[2], vs[0], st[0], G::BOX, BM, G::ROWB) ||
      !encode(&km, p.kperm, k, mhd, p.S, mh, B, st[5], vs[1], st[3], G::BOX, BN, G::ROWB) ||
      !encode(&vm, p.vperm, v, mhd, p.S, mh, B, st[8], vs[2], st[6], G::BOX, BN, G::ROWB))
    return ERR_TENSOR_MAP;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.split * mtiles, H, B);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, qm, km, vm, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bn(const void* q, const void* k, const void* v, AttnArgs& p, int B, int H,
              const long long (&st)[9], int bn, int smem, cudaStream_t s) {
  if (bn == 64) return launch<HD, 64>(q, k, v, p, B, H, st, smem, s);
  if (bn == 128) return launch<HD, 128>(q, k, v, p, B, H, st, smem, s);
  return ERR_PLAN;
}

}  // namespace

extern "C" int lm2a_attention(const void* q, const void* k, const void* v, void* o, int B,
                              int H, int T, int S, int hd, long long q_sb, long long q_sh,
                              long long q_st, long long k_sb, long long k_sh, long long k_st,
                              long long v_sb, long long v_sh, long long v_st, long long o_sb,
                              long long o_sh, long long o_st, int bn, int stages, int split,
                              int smem, void* stream) {
  if (T < 1 || S < 1) return (int)cudaErrorInvalidValue;
  if (stages < 3 || stages > MAX_STAGES || split < 1 || split > MAX_SPLIT) return ERR_PLAN;
  AttnArgs p;
  p.o = static_cast<bf16*>(o);
  p.T = T;
  p.S = S;
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_st = o_st;
  p.tiles = (S + bn - 1) / bn;
  p.split = split;
  p.stages = stages;
  if (split > p.tiles) return ERR_PLAN;
  const long long st[9] = {q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // hd < 8: the heads side by side (head stride hd) in whole 8-channel units
  if (hd < 8 && (q_sh != hd || k_sh != hd || v_sh != hd || (H * hd) % 8))
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 2: return launch_bn<2>(q, k, v, p, B, H, st, bn, smem, s);
    case 4: return launch_bn<4>(q, k, v, p, B, H, st, bn, smem, s);
    case 8: return launch_bn<8>(q, k, v, p, B, H, st, bn, smem, s);
    case 16: return launch_bn<16>(q, k, v, p, B, H, st, bn, smem, s);
    case 32: return launch_bn<32>(q, k, v, p, B, H, st, bn, smem, s);
    case 64: return launch_bn<64>(q, k, v, p, B, H, st, bn, smem, s);
    case 128: return launch_bn<128>(q, k, v, p, B, H, st, bn, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
