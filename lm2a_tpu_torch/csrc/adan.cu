// Fused clip + Adan + EMA update for Hopper (sm_90a): one multi-tensor launch.
//
// Replaces the Pallas TPU kernel _make_kernel of lm2a_tpu/ops/pallas_opt.py,
// which the JAX package calls through _bucket_call (up to 8 small leaves per
// call, each whole in VMEM) and _big_call (one row-blocked call per leaf
// above 65,536 elements). Here every leaf is one record of a device table
// (g, p, ema, m, v, n, prev_grad pointers and the element count), the
// leaves are cut into chunks of CHUNK elements, and one grid-stride launch
// walks all chunks of all leaves: a block finds its leaf by binary search
// in the table of each leaf's first chunk. The eight step scalars (warm,
// gnorm, lr, c_m, c_v, c_n, denom, ema_decay) are read from device memory,
// so the step never waits on the host. p, ema, m, v, n and prev_grad are
// updated in place; the state is fp32 or bf16 (template S), math fp32.
//
// The expressions are the JAX kernel's, operation for operation, written
// with round-to-nearest intrinsics so that nvcc contracts nothing into an
// FMA and the result is the plain PyTorch version's bit for bit:
// where(gnorm < clip, g, (g / gnorm) * clip); the moments frozen while
// warm = 0; pnew = p + ((p - raw) / denom - p); the EMA from pnew.
//
// Bound on the H100: 52 bytes per element at fp32 state (g read, p, ema, m,
// v, n, prev_grad read and written), 36 at bf16, and ~30 flops: bytes bound
// it, ~2.1 ms for the flagship's 134.4M parameters at fp32 state.

#include "common.cuh"

namespace {

constexpr int CHUNK = 4096;
constexpr int THREADS = 256;

template <typename S>
__device__ __forceinline__ float ld(const void* p, long long i) {
  return to_f(static_cast<const S*>(p)[i]);
}

template <typename S>
__device__ __forceinline__ void st(void* p, long long i, float v) {
  static_cast<S*>(p)[i] = from_f<S>(v);
}

template <typename S>
__global__ void __launch_bounds__(THREADS)
adan_ema_kernel(const long long* __restrict__ table, const long long* __restrict__ first,
                int n_leaves, long long n_chunks, const float* __restrict__ scal,
                float b1, float b2, float b3, float omb1, float omb2, float omb3, float eps,
                float clip) {
  const float warm = scal[0], gnorm = scal[1], lr = scal[2];
  const float c_m = scal[3], c_v = scal[4], c_n = scal[5];
  const float denom = scal[6], ema = scal[7];
  const float omema = __fsub_rn(1.f, ema);
  for (long long ch = blockIdx.x; ch < n_chunks; ch += gridDim.x) {
    int lo = 0, hi = n_leaves - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (first[mid] <= ch) lo = mid; else hi = mid - 1;
    }
    const long long* rec = table + 8 * (long long)lo;
    const float* g = reinterpret_cast<const float*>(rec[0]);
    float* p = reinterpret_cast<float*>(rec[1]);
    float* e = reinterpret_cast<float*>(rec[2]);
    void* m = reinterpret_cast<void*>(rec[3]);
    void* v = reinterpret_cast<void*>(rec[4]);
    void* n = reinterpret_cast<void*>(rec[5]);
    void* pg = reinterpret_cast<void*>(rec[6]);
    const long long numel = rec[7];
    const long long beg = (ch - first[lo]) * CHUNK;
    const long long end = beg + CHUNK < numel ? beg + CHUNK : numel;
    for (long long i = beg + threadIdx.x; i < end; i += THREADS) {
      float gg = g[i];
      if (clip > 0.f && !(gnorm < clip)) gg = __fmul_rn(__fdiv_rn(gg, gnorm), clip);
      const float mm = ld<S>(m, i), vv = ld<S>(v, i), nn = ld<S>(n, i), pgf = ld<S>(pg, i);
      const float m2 = __fadd_rn(mm, __fmul_rn(warm, __fsub_rn(
          __fadd_rn(__fmul_rn(omb1, mm), __fmul_rn(b1, gg)), mm)));
      const float diff = __fsub_rn(gg, pgf);
      const float v2 = __fadd_rn(vv, __fmul_rn(warm, __fsub_rn(
          __fadd_rn(__fmul_rn(omb2, vv), __fmul_rn(b2, diff)), vv)));
      const float u = __fadd_rn(gg, __fmul_rn(omb2, diff));
      const float tgt = __fadd_rn(__fmul_rn(omb3, nn), __fmul_rn(b3, __fmul_rn(u, u)));
      const float n2 = __fadd_rn(nn, __fmul_rn(warm, __fsub_rn(tgt, nn)));
      const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(n2, c_n)), eps);
      const float num = __fadd_rn(__fmul_rn(m2, c_m), __fmul_rn(__fmul_rn(omb2, v2), c_v));
      const float raw = __fmul_rn(__fdiv_rn(lr, den), num);
      const float pf = p[i];
      const float pnew = __fadd_rn(pf, __fsub_rn(__fdiv_rn(__fsub_rn(pf, raw), denom), pf));
      p[i] = pnew;
      e[i] = __fadd_rn(__fmul_rn(e[i], ema), __fmul_rn(pnew, omema));
      st<S>(m, i, m2);
      st<S>(v, i, v2);
      st<S>(n, i, n2);
      st<S>(pg, i, gg);
    }
  }
}

}  // namespace

extern "C" int lm2a_adan_ema(const long long* table, const long long* first, int n_leaves,
                             long long n_chunks, const float* scal, float b1, float b2,
                             float b3, float omb1, float omb2, float omb3, float eps,
                             float clip, int state_is_bf16, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (state_is_bf16)
    adan_ema_kernel<bf16><<<grid, THREADS, 0, s>>>(table, first, n_leaves, n_chunks, scal, b1,
                                                   b2, b3, omb1, omb2, omb3, eps, clip);
  else
    adan_ema_kernel<float><<<grid, THREADS, 0, s>>>(table, first, n_leaves, n_chunks, scal, b1,
                                                    b2, b3, omb1, omb2, omb3, eps, clip);
  return (int)cudaGetLastError();
}
