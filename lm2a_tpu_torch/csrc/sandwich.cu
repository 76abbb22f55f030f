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
// Bound on the H100. Each output moves 4 bytes in bf16 (one input read, one
// output written): ~3.8 us at 3.35 TB/s for the 3.2M outputs of a late
// vocoder stage. The arithmetic is at least 44 fp32 instructions an output
// (24 filter FMAs, two snakes of 9 with their MUFU sines), so the kernel is
// bound by instruction issue first: the first design issued 110-150 an
// output from shared memory; this one keeps a run's inputs, phases and
// halos in registers, and measured on the H100 its arithmetic alone, with
// no load or store, takes nearly as long as the whole kernel
// (scripts/torch_sandwich_ablation.py, PERF.md):
//
// - Register-blocked polyphase. A tensor is a set of rows (b, c) of T
//   samples; each row is cut into runs of RUN = 8 consecutive outputs, and
//   the runs of all rows are numbered one after the other. A lane owns one
//   run: one 16-byte load in bf16 (two in fp32) when the row is contiguous
//   and aligned (scalar loads otherwise: a ragged last run, a misaligned
//   view, channels-last strides), its 16 phases computed once each, both
//   filters as FMAs on registers. The +-3 input halo and the +-3 phase halo
//   come from the neighbouring lanes by __shfl_up/down_sync.
// - Overlapping warp tiles instead of halo loads. A warp tile is 32
//   consecutive runs of which lanes 1..30 store; lanes 0 and 31 compute
//   their runs to feed lanes 1 and 30 their halos (lane 0's last three
//   phases, lane 31's first three, need only its own inputs and its
//   neighbour's). Tiles step by 30 runs, so 2 of 32 lanes are extra work
//   and no lane loads or computes anything else.
// - Edge clamps only where a run touches the end of its row: a lane whose
//   run starts a row takes snake(y_even[0]) for the phases before it and
//   x[0] for the inputs; the lane whose run ends its row takes
//   snake(y_odd[T-1]) and x[T-1]. A neighbour lane in another row is then
//   never read, so runs of several rows share a warp.
// - No division per output: alpha and beta are loaded once per run (raw
//   log-scale values exponentiated here when the flag says so), and
//   1 / (beta + 1e-9) is taken once; s = y + sn * sn * inv_b.
// - A reduced-range hardware sine: u = alpha y is reduced to
//   r = u - k 2pi in [-pi, pi] with k = rint(u / 2pi) and two FMAs on a
//   hi/lo split of 2pi, then __sinf(r) (MUFU.SIN, absolute error ~2^-21.4 on
//   [-pi, pi]), in bf16 and fp32 alike. Two MUFU ops an output at 16 a
//   clock per SM are a floor of ~0.2 us at a late stage.
// - Loads under the arithmetic: one wave of resident blocks whose warps
//   stride over the tiles, each warp issuing its next tile's load before it
//   computes the current one.
// - The row and column of a run by multiply-shift division (the host's
//   magic numbers), not integer division.
// The launch plan (warps per block, tiles per warp, blocks) comes from
// vocoder/sandwich.py:sandwich_plan; the entry refuses any other (ERR_PLAN).

#include "common.cuh"

namespace {

constexpr int RUN = 8;            // outputs a lane owns
constexpr int STORED = 30;        // lanes of a warp tile that store outputs
constexpr int MAX_WARPS = 16;     // warps per block
constexpr int ERR_PLAN = -3;      // a launch plan the kernel does not take (ops/_build.py)
constexpr unsigned FULL = 0xffffffffu;
constexpr float INV_2PI = 0.15915493667125702f;
constexpr float TWO_PI_HI = 6.2831854820251465f;       // fp32 nearest 2 pi
constexpr float TWO_PI_LO = -1.7484555314695172e-07f;  // 2 pi - TWO_PI_HI
constexpr float ROUND_MAGIC = 12582912.f;              // 1.5 * 2^23

// n / d for 0 <= n < 2^31 by a multiply and a shift (magic numbers from the
// host: s = ceil(log2 d), m = 2^32 (2^s - d) / d + 1)
struct FastDiv {
  unsigned m, s;
  __device__ __forceinline__ int div(int n) const {
    return static_cast<int>((__umulhi(static_cast<unsigned>(n), m) + static_cast<unsigned>(n)) >> s);
  }
};

struct Args {
  const void* x;
  void* z;
  const float* alpha;
  const float* beta;
  long long sxb, sxt, sxc, szb, szt, szc;
  int T, C, runs_per_row, runs, tiles, logscale;
  FastDiv by_runs, by_c;
  float up[12];    // 2 f: the upsampler's taps
  float down[12];  // f
};

__device__ __forceinline__ float snake(float y, float al, float inv_b) {
  const float u = al * y;
  // k = rint(u / 2pi), round to nearest even by the 1.5 * 2^23 trick: two
  // FMA-pipe instructions where FRND is a conversion (16 a clock per SM)
  const float k = fmaf(u, INV_2PI, ROUND_MAGIC) - ROUND_MAGIC;
  float r = fmaf(-k, TWO_PI_HI, u);
  r = fmaf(-k, TWO_PI_LO, r);
  const float s = __sinf(r);
  return fmaf(s * s, inv_b, y);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// one run's place: its row's pointers, first output, channel and flags
template <typename T>
struct Run {
  const T* xp;
  T* zp;
  int t0, c;
  bool owner, full, first, last, vec;
};

template <typename T>
__device__ __forceinline__ Run<T> locate(const Args& a, int tile, int lane) {
  Run<T> r;
  // lane 0 and lane 31 take the runs on either side of the 30 stored ones
  const int g = tile * STORED - 1 + lane;
  r.owner = lane >= 1 && lane <= STORED && g < a.runs;
  const int gc = min(max(g, 0), a.runs - 1);
  const int row = a.by_runs.div(gc);
  r.t0 = (gc - row * a.runs_per_row) * RUN;
  const int b = a.by_c.div(row);
  r.c = row - b * a.C;
  r.xp = static_cast<const T*>(a.x) + b * a.sxb + r.c * a.sxc;
  r.zp = static_cast<T*>(a.z) + b * a.szb + r.c * a.szc;
  r.full = r.t0 + RUN <= a.T;
  r.first = r.t0 == 0;
  r.last = r.t0 + RUN >= a.T;
  r.vec = a.sxt == 1 && r.full && aligned16(r.xp + r.t0);
  return r;
}

// a run's inputs as raw 16-byte vectors, so the loads stay in flight while
// the previous run computes
template <typename T>
struct Raw {
  static constexpr int N = RUN * static_cast<int>(sizeof(T)) / 16;
  uint4 v[N];
};

template <typename T>
__device__ __forceinline__ void fetch(const Run<T>& r, Raw<T>& raw) {
  if (r.vec) {
    const uint4* p = reinterpret_cast<const uint4*>(r.xp + r.t0);
#pragma unroll
    for (int i = 0; i < Raw<T>::N; ++i) raw.v[i] = p[i];
  }
}

template <typename T>
__device__ __forceinline__ void unpack(const Raw<T>& raw, float* v) {
#pragma unroll
  for (int i = 0; i < Raw<T>::N; ++i) {
    const unsigned w[4] = {raw.v[i].x, raw.v[i].y, raw.v[i].z, raw.v[i].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (sizeof(T) == 4) {
        v[4 * i + k] = __uint_as_float(w[k]);
      } else {  // two bf16, low half first: a bf16 is the top half of its fp32
        v[8 * i + 2 * k] = __uint_as_float(w[k] << 16);
        v[8 * i + 2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
      }
    }
  }
}

// one run: phases, halos by shuffles, edge clamps, the down filter, the store
template <typename T>
__device__ __forceinline__ void sandwich_run(const Args& a, const Run<T>& r, const Raw<T>& raw,
                                             float al, float be) {
  // xv[i] = x[t0 - 3 + i], i in [0, RUN + 6)
  float xv[RUN + 6];
  if (r.vec) {
    unpack(raw, xv + 3);
  } else {
#pragma unroll
    for (int j = 0; j < RUN; ++j) xv[3 + j] = to_f(r.xp[min(r.t0 + j, a.T - 1) * a.sxt]);
  }
  if (a.logscale) {
    al = expf(al);
    be = expf(be);
  }
  const float inv_b = 1.f / (be + 1e-9f);

#pragma unroll
  for (int k = 0; k < 3; ++k) {
    xv[k] = __shfl_up_sync(FULL, xv[RUN + k], 1);
    xv[RUN + 3 + k] = __shfl_down_sync(FULL, xv[3 + k], 1);
  }
  if (r.first) xv[0] = xv[1] = xv[2] = xv[3];
  if (r.last) xv[RUN + 3] = xv[RUN + 4] = xv[RUN + 5] = xv[RUN + 2];  // x[T-1]: loads clamp

  float se[RUN], so[RUN];
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    float ye = a.up[0] * xv[j], yo = a.up[1] * xv[j + 1];
#pragma unroll
    for (int q = 1; q < 6; ++q) {
      ye = fmaf(a.up[2 * q], xv[j + q], ye);
      yo = fmaf(a.up[2 * q + 1], xv[j + q + 1], yo);
    }
    se[j] = snake(ye, al, inv_b);
    so[j] = snake(yo, al, inv_b);
  }
  // positions at or past T read snake(y_odd[T-1]), which this run holds
  float cv = so[RUN - 1];
  if (r.last) {
#pragma unroll
    for (int j = 0; j < RUN; ++j)
      if (r.t0 + j == a.T - 1) cv = so[j];
#pragma unroll
    for (int j = 0; j < RUN; ++j)
      if (r.t0 + j >= a.T) se[j] = so[j] = cv;
  }

  // sox[i] = s_odd at t0 - 3 + i (i < RUN + 5), sex[i] = s_even at t0 - 2 + i
  float sox[RUN + 5], sex[RUN + 5];
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    sox[3 + j] = so[j];
    sex[2 + j] = se[j];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    sox[k] = __shfl_up_sync(FULL, so[RUN - 3 + k], 1);
    sex[RUN + 2 + k] = __shfl_down_sync(FULL, se[k], 1);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    sex[k] = __shfl_up_sync(FULL, se[RUN - 2 + k], 1);
    sox[RUN + 3 + k] = __shfl_down_sync(FULL, so[k], 1);
  }
  if (r.first) sox[0] = sox[1] = sox[2] = sex[0] = sex[1] = se[0];
  if (r.last) sox[RUN + 3] = sox[RUN + 4] = sex[RUN + 2] = sex[RUN + 3] = sex[RUN + 4] = cv;

  float out[RUN];
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    float acc = a.down[0] * sox[j];
    acc = fmaf(a.down[1], sex[j], acc);
#pragma unroll
    for (int q = 1; q < 6; ++q) {
      acc = fmaf(a.down[2 * q], sox[j + q], acc);
      acc = fmaf(a.down[2 * q + 1], sex[j + q], acc);
    }
    out[j] = acc;
  }
  if (r.owner) {
    T* zr = r.zp + r.t0 * a.szt;
    if (a.szt == 1 && r.full && aligned16(zr)) {
      store8(zr, out);
    } else {
#pragma unroll
      for (int j = 0; j < RUN; ++j)
        if (r.t0 + j < a.T) r.zp[(r.t0 + j) * a.szt] = from_f<T>(out[j]);
    }
  }
}

// The grid's warps stride over the tiles (warp w takes w, w + W, ...); each
// next tile's vector loads and parameters are issued before the current tile
// computes, so every warp keeps one tile's loads in flight.
template <typename T>
__global__ void __launch_bounds__(MAX_WARPS * 32)
snake_sandwich_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  // warp-uniform by construction, so the tile loop and its shuffles are too
  const int warp = __shfl_sync(FULL, blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5), 0);
  const int stride = gridDim.x * (blockDim.x >> 5);
  int tile = warp;
  if (tile >= a.tiles) return;
  Run<T> cur = locate<T>(a, tile, lane);
  Raw<T> raw;
  fetch(cur, raw);
  float al = a.alpha[cur.c], be = a.beta[cur.c];
  for (; tile < a.tiles; tile += stride) {
    Run<T> nxt = cur;
    Raw<T> nraw = raw;
    float nal = al, nbe = be;
    if (tile + stride < a.tiles) {
      nxt = locate<T>(a, tile + stride, lane);
      fetch(nxt, nraw);
      nal = a.alpha[nxt.c];
      nbe = a.beta[nxt.c];
    }
    sandwich_run<T>(a, cur, raw, al, be);
    cur = nxt;
    raw = nraw;
    al = nal;
    be = nbe;
  }
}

FastDiv fast_div(unsigned d) {
  unsigned s = 0;
  while ((1ull << s) < d) ++s;
  const unsigned long long m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return FastDiv{static_cast<unsigned>(m), s};
}

}  // namespace

// The plan (run, warps, tiles_per_warp, blocks) must be the kernel's for the
// shape: runs of 8, 1..16 warps of a block, no block without a tile
// (blocks <= ceil(tiles / warps)), and tiles_per_warp the most tiles a warp
// takes, ceil(tiles / (blocks * warps)), for ceil(runs / 30) tiles. Anything
// else returns ERR_PLAN and launches nothing.
extern "C" int lm2a_snake_sandwich(const void* x, void* z, int is_f32,
                                   const float* alpha, const float* beta, int logscale,
                                   const float* taps, int B, int T, int C,
                                   long long sxb, long long sxt, long long sxc,
                                   long long szb, long long szt, long long szc,
                                   int run, int warps, int tiles_per_warp, int blocks,
                                   void* stream) {
  if (run != RUN || warps < 1 || warps > MAX_WARPS || blocks < 1 || B < 1 || T < 1 || C < 1)
    return ERR_PLAN;
  const long long runs_per_row = (T + RUN - 1) / RUN;
  const long long runs = runs_per_row * B * C;
  if (runs + 2 * STORED >= (1ll << 31)) return ERR_PLAN;
  const long long tiles = (runs + STORED - 1) / STORED;
  const long long grid_warps = static_cast<long long>(blocks) * warps;
  if (blocks > (tiles + warps - 1) / warps ||
      tiles_per_warp != (tiles + grid_warps - 1) / grid_warps)
    return ERR_PLAN;
  Args a;
  a.x = x;
  a.z = z;
  a.alpha = alpha;
  a.beta = beta;
  a.sxb = sxb; a.sxt = sxt; a.sxc = sxc;
  a.szb = szb; a.szt = szt; a.szc = szc;
  a.T = T;
  a.C = C;
  a.runs_per_row = static_cast<int>(runs_per_row);
  a.runs = static_cast<int>(runs);
  a.tiles = static_cast<int>(tiles);
  a.logscale = logscale;
  a.by_runs = fast_div(static_cast<unsigned>(runs_per_row));
  a.by_c = fast_div(static_cast<unsigned>(C));
  for (int i = 0; i < 12; ++i) {
    a.up[i] = 2.f * taps[i];
    a.down[i] = taps[i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f32)
    snake_sandwich_kernel<float><<<blocks, warps * 32, 0, s>>>(a);
  else
    snake_sandwich_kernel<bf16><<<blocks, warps * 32, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of `warps` warps of the kernel that one SM holds at once (the CUDA
// occupancy calculator), or a negative cudaError_t. The launch plan's table
// of resident warps is held against this on the card.
extern "C" int lm2a_sandwich_blocks_per_sm(int is_f32, int warps) {
  int n = 0;
  const cudaError_t e = is_f32
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, snake_sandwich_kernel<float>, warps * 32, 0)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, snake_sandwich_kernel<bf16>, warps * 32, 0);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}
