// Fused attention core softmax(q k^T / sqrt(hd)) v for Hopper (sm_90a).
//
// Replaces both Pallas TPU kernels of lm2a_tpu/ops/pallas_attention.py:
// _attention_kernel (all of S in one VMEM block, S <= 1024) and _flash_kernel
// (online softmax over S tiles, S > 1024). They compute one function; only
// the TPU's VMEM budget split them. Here one flash-style forward covers both:
// a block owns 64 query rows of one (batch, head), four warps of 16 rows
// each; it streams K/V tiles of 64 keys through shared memory, keeps a
// running max m, a running sum l and an fp32 accumulator per row in
// registers, masks keys at or beyond S, and divides by l once at the end.
// Nothing is padded in device memory: rows beyond T and keys beyond S are
// loaded as zeros and masked.
//
// Arithmetic, as the JAX serving route (bf16 operands):
//   scores accumulate in fp32 (bf16 tensor-core MMA) and are scaled by
//   1/sqrt(hd) in fp32; exp(s - m_new) is fp32 and rounded to bf16 for the
//   P.V product, as _flash_kernel does; l sums the unrounded fp32 p; the
//   output is acc / l rounded to bf16. The running max starts at -inf and the
//   correction exp(m_old - m_new) is 0 while m_old is -inf, so a masked key
//   gives exp -> 0 and never NaN.
//
// Layout: q is read as (B, H, T, hd) through element strides, k and v as
// (B, H, S, hd), hd contiguous. The port passes views of its channels-last
// projections (B, T, h*hd), so no transposes precede or follow the kernel;
// the output is written through strides as well (the wrapper allocates it
// (B, T, h, hd)).
//
// Bound on the H100: 4*T*S*hd operations per (batch, head) against
// 2*(T + 2S + T)*hd bytes, so at long form (S = T = 12920) it is bound by
// tensor-core operations; at 6 s the grids are small and launch latency
// dominates. This version uses warp-level mma.sync m16n8k16 (bf16 -> fp32)
// with the P fragments reused from the score accumulators in registers, K
// and V fragments by ldmatrix (V transposed on the way), and K/V tiles
// double-buffered with cp.async so the next tile's loads overlap this
// tile's products; wgmma, TMA and a producer/consumer split are later work.

#include "common.cuh"

namespace {

constexpr int BM = 64;  // query rows per block: 16 per warp
constexpr int BN = 64;  // keys per K/V tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = 32 * NWARPS;

struct AttnArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int T, S;
  long long q_sb, q_sh, q_st;  // element strides; hd stride is 1
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st;
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two fp32 -> one register of two bf16, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 8x8 bf16 matrices from shared memory, one row address per lane (lanes
// 8m..8m+7 give the rows of matrix m); .trans transposes each on the way
__device__ __forceinline__ void ldsm_x2(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// 16 bytes global -> shared without a register round trip; zero-filled
// when !valid (the source address must still be a valid one)
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {  // all but the newest group landed
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// rows row0 .. row0+63 of a (rows, HD) strided matrix into a [64][LD] bf16
// tile; rows at or beyond n_valid (> row0) are zero. 16 bytes per thread
// and step, asynchronous: the caller commits and waits.
template <int HD, int LD>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, long long stride,
                                                int row0, int n_valid) {
  constexpr int CH = HD / 8;
  for (int i = threadIdx.x; i < 64 * CH; i += NTHREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool valid = row0 + r < n_valid;
    cp_async16(dst + r * LD + c, src + (long long)(valid ? row0 + r : row0) * stride + c,
               valid);
  }
}

template <int HD>
constexpr int smem_bytes() {
  return 4 * BN * ((HD < 16 ? 16 : HD) + 8) * (int)sizeof(bf16);
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS) attention_kernel(AttnArgs p) {
  constexpr int HDP = HD < 16 ? 16 : HD;  // contraction of q k^T, padded to the MMA's k16
  constexpr int LD = HDP + 8;             // bf16 row stride: conflict-free ldmatrix rows
  constexpr int KSTEPS = HDP / 16;
  constexpr int NT_S = BN / 8;  // score n-tiles per warp
  constexpr int NT_O = HD / 8;  // output n-tiles per warp
  // two stages of K and V tiles; the Q tile is staged in K stage 1 first
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const kbuf = reinterpret_cast<bf16*>(smem_raw);
  bf16* const vbuf = kbuf + 2 * BN * LD;

  const int h = blockIdx.y, b = blockIdx.z;
  const int t0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int T = p.T, S = p.S;
  const bf16* q = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* k = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* v = p.v + b * p.v_sb + h * p.v_sh;

  if constexpr (HDP > HD) {  // zero pad columns, never overwritten by the tile loads
    for (int i = threadIdx.x; i < 2 * BN * (HDP - HD); i += NTHREADS)
      kbuf[(i / (HDP - HD)) * LD + HD + i % (HDP - HD)] = __float2bfloat16_rn(0.f);
  }
  // K/V tile 0 into stage 0 while Q goes through stage 1 into registers
  load_tile_async<HD, LD>(kbuf, k, p.k_st, 0, S);
  load_tile_async<HD, LD>(vbuf, v, p.v_st, 0, S);
  cp_async_commit();
  load_tile_async<HD, LD>(kbuf + BN * LD, q, p.q_st, t0, T);
  cp_async_commit();
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  uint32_t qa[KSTEPS][4];
  {
    const bf16* qw = kbuf + BN * LD + (warp * 16) * LD;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int c = 16 * kk + 2 * tq;
      qa[kk][0] = ld32(qw + g * LD + c);
      qa[kk][1] = ld32(qw + (g + 8) * LD + c);
      qa[kk][2] = ld32(qw + g * LD + c + 8);
      qa[kk][3] = ld32(qw + (g + 8) * LD + c + 8);
    }
  }
  __syncthreads();

  // scores in the log2 domain: exp(s - m) == exp2(s*log2e - m*log2e)
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)HD);
  float o[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8 of the warp
  float l[2] = {0.f, 0.f};              // this thread's columns; quad-summed at the end
  // ldmatrix row addresses of this lane: matrix lane >> 3, row lane & 7
  const int lm = lane >> 3, lr = lane & 7;

  const int n_tiles = (S + BN - 1) / BN;
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {  // prefetch the next tile into the other stage
      const int nxt = (j + 1) & 1;
      load_tile_async<HD, LD>(kbuf + nxt * BN * LD, k, p.k_st, (j + 1) * BN, S);
      load_tile_async<HD, LD>(vbuf + nxt * BN * LD, v, p.v_st, (j + 1) * BN, S);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const bf16* ks = kbuf + (j & 1) * BN * LD;
    const bf16* vs = vbuf + (j & 1) * BN * LD;
    const int s0 = j * BN;

    float sc[NT_S][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      // B fragments of q k^T: keys nt*8 + row, hd columns in 8-wide matrices
      const bf16* kr = ks + (nt * 8 + lr) * LD;
      if constexpr (KSTEPS == 1) {
        uint32_t kb[2];
        ldsm_x2(kb, kr + 8 * (lm & 1));
        mma16816(sc[nt], qa[0], kb[0], kb[1]);
      } else {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; kk += 2) {
          uint32_t kb[4];
          ldsm_x4(kb, kr + 16 * kk + 8 * lm);
          mma16816(sc[nt], qa[kk], kb[0], kb[1]);
          mma16816(sc[nt], qa[kk + 1], kb[2], kb[3]);
        }
      }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = s0 + nt * 8 + 2 * tq + (e & 1);
        const float s = col < S ? sc[nt][e] * scale_log2 : -INFINITY;
        sc[nt][e] = s;
        mx[e >> 1] = fmaxf(mx[e >> 1], s);
      }
    }
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float corr = m[r] == -INFINITY ? 0.f : exp2f(m[r] - mx[r]);
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      m[r] = mx[r];
      l[r] *= corr;
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        o[n][2 * r] *= corr;
        o[n][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(sc[nt][e] - base[e >> 1]);
        sc[nt][e] = pe;
        l[e >> 1] += pe;
      }
    }

    // O += P V: the score accumulators of n-tiles 2kk, 2kk+1 are the A
    // fragment of the k16 step kk; V fragments transposed by ldmatrix
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      // matrix lm: keys 16kk + 8*(lm & 1) + row, hd columns 8*(lm >> 1) on
      const bf16* vr = vs + (16 * kk + 8 * (lm & 1) + lr) * LD + 8 * (lm >> 1);
      if constexpr (NT_O == 1) {
        uint32_t vb[2];
        ldsm_x2_trans(vb, vr);
        mma16816(o[0], pa, vb[0], vb[1]);
      } else {
#pragma unroll
        for (int n = 0; n < NT_O; n += 2) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, vr + 8 * n);
          mma16816(o[n], pa, vb[0], vb[1]);
          mma16816(o[n + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // this stage is refilled by the prefetch two tiles on
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  bf16* out = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = t0 + warp * 16 + g + 8 * r;
    if (row >= T) continue;
    bf16* orow = out + (long long)row * p.o_st + 2 * tq;
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) =
          pack_bf16(o[n][2 * r] / l[r], o[n][2 * r + 1] / l[r]);
  }
}

template <int HD>
cudaError_t launch(const AttnArgs& p, int B, int H, cudaStream_t s) {
  constexpr int bytes = smem_bytes<HD>();
  static cudaError_t attr = cudaFuncSetAttribute(
      attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  dim3 grid((p.T + BM - 1) / BM, H, B);
  attention_kernel<HD><<<grid, NTHREADS, bytes, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lm2a_attention(const void* q, const void* k, const void* v, void* o, int B,
                              int H, int T, int S, int hd, long long q_sb, long long q_sh,
                              long long q_st, long long k_sb, long long k_sh, long long k_st,
                              long long v_sb, long long v_sh, long long v_st, long long o_sb,
                              long long o_sh, long long o_st, void* stream) {
  AttnArgs p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.T = T;
  p.S = S;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.q_st = q_st;
  p.k_sb = k_sb;
  p.k_sh = k_sh;
  p.k_st = k_st;
  p.v_sb = v_sb;
  p.v_sh = v_sh;
  p.v_st = v_st;
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_st = o_st;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T < 1 || S < 1) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 8: return (int)launch<8>(p, B, H, s);
    case 16: return (int)launch<16>(p, B, H, s);
    case 32: return (int)launch<32>(p, B, H, s);
    case 64: return (int)launch<64>(p, B, H, s);
    case 128: return (int)launch<128>(p, B, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
