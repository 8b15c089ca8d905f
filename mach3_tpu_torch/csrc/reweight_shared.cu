// Fused spline-reweight + Σw/Σw² histogram over static (shared) bins, for
// Hopper.
//
// Replaces the TPU kernel K2, mach3_tpu/splines/pallas_reweight.py
// _kernel_shared_blocked_sorted (reached through
// fused_reweight_histogram_shared with tile_starts / block_plan). It computes
// what K2 computes; it is not carried over block by block. Per (chain c,
// event e) of an event tile:
//
//   w   = base[c,e] · Π_{p active in the tile} resp_p(seg[c,p], t[c,p], coeffs[p,:,e])
//         · exp(Σ_k log|ext[c,k]|·S[k,e]) · (−1)^(Σ_k neg[c,k]·S[k,e])
//   mc[c, bin[e]] += w,   w2[c, bin[e]] += w²        (bin[e] ∉ [0, n_bins) dropped)
//
// Responses: resp_p = y + t(b + t(c + t·d)) from the 4 coefficient rows
// seg*4 + (0..3) of coeffs[p, :, e], in f32, as the shifted kernel does (no
// selector dot, no bf16 deviation rounding); bf16 tables are upcast on load.
// Parameters missing from a tile's list are the identity on every event of
// the tile (splines/plan.py), and skipping them is exact: y = 1, b = c = d = 0
// gives resp == 1.0 in f32.
//
// Norm: log|ext| floored at 1e-30 as in the TPU kernels, so a zero norm
// gives a ~1e-30 weight.
//
// Layout (splines/plan.py): the events come in tiles of kEventTile = 256,
// one per thread. Per tile the plan gives a window (start, width) and a CSR
// list of active parameters; within a tile the events are sorted by bin. A
// block is one tile x kChainTile = 16 chains; blockIdx.x runs over the chain
// tiles so that the blocks that read one tile's coefficients run side by
// side and share them in L2.
//
// Histogram: a [kChainTile][2][nbl] shared-memory histogram (nbl the widest
// window of the sample), of which a tile zeroes and flushes its own width.
// Sorted events put long runs of equal bins into one warp, and shared atomics
// on one address serialise, so each warp first sums w and w² over its runs of
// equal bin (a segmented scan with shuffles) and only the last lane of a run
// adds to shared memory. A bin outside the window goes straight to the global
// histogram, so the result does not depend on the plan's window. After the
// tile, one global atomicAdd per non-empty (chain, bin) of the window.
//
// What bounds it on this card, and what the design does about each:
//  * the coefficient reads. The bf16 tables of the reference-scale fixture
//    (244 MB numu_beam, 344 MB atmo) do not fit the 50 MB L2. A thread reads
//    4 rows of each active parameter per chain; rows of the 16 chains of a
//    block that share a segment hit L1, and the 8 chain tiles of 128 chains
//    read each tile's rows while they sit in L2, so device memory sees each
//    active row about once a call. Inactive (parameter, tile) pairs are never
//    read.
//  * the [C, E] base_w read (~C·E·4 bytes a call), coalesced along E;
//  * the norm match counts S [NA1, E], re-read per chain from L1/L2.
//  * arithmetic: ~10 instructions per active (chain, event, parameter) plus
//    2 per (chain, event, norm slot). At 128 chains this is the largest term.
//
// Sums are taken in an order that changes from run to run (atomics), so
// results agree with the plain version to f32 summation-order tolerance.
//
// Launch: grid (ceil(C / kChainTile), n_tiles), kThreads threads, on the
// caller's stream. It allocates nothing; mc and w2 must be zeroed [C, n_bins]
// f32 arrays. The entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kChainTile = 16;
constexpr int kThreads = 256;
constexpr int kEventTile = kThreads;  // one event per thread
constexpr int kMaxBins = 4096;
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on Hopper
constexpr int kMaxParams = 256;
constexpr int kMaxNorm = 256;
constexpr int kMaxTiles = 65535;  // gridDim.y
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float load_coef(const float* p) { return *p; }
__device__ __forceinline__ float load_coef(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename CoefT, bool kHasNorm>
__global__ void __launch_bounds__(kThreads) reweight_shared_kernel(
    const int* __restrict__ seg, const float* __restrict__ tval,
    const CoefT* __restrict__ coeffs, const float* __restrict__ base_w,
    const int* __restrict__ bins, const int* __restrict__ tile_start,
    const int* __restrict__ tile_width, const int* __restrict__ plan_ptr,
    const int* __restrict__ plan_idx, int nbl, const float* __restrict__ norm_ext,
    const float* __restrict__ norm_s, int na1, float* __restrict__ mc,
    float* __restrict__ w2, int C, int P, int K4, int E, int n_bins) {
  extern __shared__ float smem[];
  float* hist = smem;                                    // [CT][2][nbl]
  float* sh_t = hist + kChainTile * 2 * nbl;             // [CT][nact]
  int* sh_seg = reinterpret_cast<int*>(sh_t + kChainTile * P);  // [CT][nact]
  int* sh_p = sh_seg + kChainTile * P;                   // [nact]
  float* sh_logext = reinterpret_cast<float*>(sh_p + P);  // [CT][na1]
  float* sh_neg = sh_logext + kChainTile * na1;          // [CT][na1]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tile = blockIdx.y;
  const int c0 = blockIdx.x * kChainTile;
  const int nct = min(kChainTile, C - c0);
  const int start = tile_start[tile];
  const int width = min(tile_width[tile], nbl);
  const int p_begin = plan_ptr[tile];
  const int nact = plan_ptr[tile + 1] - p_begin;

  for (int i = tid; i < nct * width; i += kThreads) {
    const int c = i / width;
    float* hc = hist + c * 2 * nbl + (i - c * width);
    hc[0] = 0.f;
    hc[nbl] = 0.f;
  }
  for (int i = tid; i < nact; i += kThreads) sh_p[i] = plan_idx[p_begin + i];
  for (int i = tid; i < nct * nact; i += kThreads) {
    const int c = i / nact;
    const size_t g = static_cast<size_t>(c0 + c) * P + plan_idx[p_begin + i - c * nact];
    sh_seg[i] = seg[g];
    sh_t[i] = tval[g];
  }
  if (kHasNorm) {
    for (int i = tid; i < nct * na1; i += kThreads) {
      const float v = norm_ext[static_cast<size_t>(c0) * na1 + i];
      sh_logext[i] = logf(fmaxf(fabsf(v), 1e-30f));
      sh_neg[i] = v < 0.f ? 1.f : 0.f;
    }
  }
  __syncthreads();

  const size_t es = static_cast<size_t>(E);
  const int e = tile * kEventTile + tid;
  const int b = e < E ? bins[e] : -1;
  const int key = (b >= 0 && b < n_bins) ? b : -1;  // -1: dropped
  const int local = key - start;
  const bool in_window = key >= 0 && local >= 0 && local < width;

  // Runs of equal key in this warp (the same for every chain): the first
  // lane of each run and whether this lane ends one.
  const int prev = __shfl_up_sync(kFullMask, key, 1);
  const int next = __shfl_down_sync(kFullMask, key, 1);
  const unsigned heads = __ballot_sync(kFullMask, lane == 0 || prev != key);
  const int run_start = 31 - __clz(heads & (kFullMask >> (31 - lane)));
  const bool run_end = lane == 31 || next != key;

  for (int c = 0; c < nct; ++c) {
    float w = 0.f;
    if (key >= 0) {
      w = base_w[static_cast<size_t>(c0 + c) * es + e];
      const int* cs = sh_seg + c * nact;
      const float* ct = sh_t + c * nact;
      for (int j = 0; j < nact; ++j) {
        const float t = ct[j];
        const CoefT* co = coeffs +
            (static_cast<size_t>(sh_p[j]) * K4 + static_cast<size_t>(cs[j]) * 4) * es + e;
        const float y = load_coef(co);
        const float bb = load_coef(co + es);
        const float cc = load_coef(co + 2 * es);
        const float d = load_coef(co + 3 * es);
        w *= y + t * (bb + t * (cc + t * d));
      }
      if (kHasNorm) {
        float lw = 0.f;
        float pw = 0.f;
        for (int k = 0; k < na1; ++k) {
          const float s = norm_s[static_cast<size_t>(k) * es + e];
          lw = fmaf(sh_logext[c * na1 + k], s, lw);
          pw = fmaf(sh_neg[c * na1 + k], s, pw);
        }
        const float sign = 1.f - 2.f * (pw - 2.f * floorf(pw * 0.5f));
        w *= expf(lw) * sign;
      }
    }
    // Segmented inclusive scan of (w, w²) over the runs: the run's last
    // lane ends up with the run's sums.
    float sw = w;
    float sq = w * w;
    for (int off = 1; off < 32; off <<= 1) {
      const float uw = __shfl_up_sync(kFullMask, sw, off);
      const float uq = __shfl_up_sync(kFullMask, sq, off);
      if (lane - off >= run_start) {
        sw += uw;
        sq += uq;
      }
    }
    if (run_end && key >= 0) {
      if (in_window) {
        float* hc = hist + c * 2 * nbl;
        atomicAdd(hc + local, sw);
        atomicAdd(hc + nbl + local, sq);
      } else {
        const size_t o = static_cast<size_t>(c0 + c) * n_bins + key;
        atomicAdd(mc + o, sw);
        atomicAdd(w2 + o, sq);
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < nct * width; i += kThreads) {
    const int c = i / width;
    const int l = i - c * width;
    const int bin = start + l;
    if (bin >= n_bins) continue;
    const float m = hist[c * 2 * nbl + l];
    const float q = hist[c * 2 * nbl + nbl + l];
    const size_t o = static_cast<size_t>(c0 + c) * n_bins + bin;
    if (m != 0.f) atomicAdd(mc + o, m);
    if (q != 0.f) atomicAdd(w2 + o, q);
  }
}

template <typename CoefT, bool kHasNorm>
cudaError_t launch(size_t smem, dim3 grid, cudaStream_t stream, const int* seg,
                   const float* t, const void* coeffs, const float* base_w,
                   const int* bins, const int* tile_start, const int* tile_width,
                   const int* plan_ptr, const int* plan_idx, int nbl,
                   const float* norm_ext,
                   const float* norm_s, int na1, float* mc, float* w2, int C,
                   int P, int K4, int E, int n_bins) {
  auto kernel = reweight_shared_kernel<CoefT, kHasNorm>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      seg, t, static_cast<const CoefT*>(coeffs), base_w, bins, tile_start,
      tile_width, plan_ptr, plan_idx, nbl, norm_ext, norm_s, na1, mc, w2, C, P,
      K4, E, n_bins);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. coeffs is f32 (coef_bf16 == 0) or bf16; norm_ext
// and norm_s may be null (na1 is then ignored). event_tile must equal the
// kernel's tile (the plan was built for it). Returns a cudaError_t code:
// cudaErrorInvalidValue for sizes the kernel does not take, otherwise
// cudaGetLastError() right after the launch.
extern "C" int m3_reweight_shared(
    const void* seg, const void* t, const void* coeffs, int coef_bf16,
    const void* base_w, const void* bins, const void* tile_start,
    const void* tile_width, const void* plan_ptr, const void* plan_idx, int nbl,
    const void* norm_ext,
    const void* norm_s, int na1, void* mc, void* w2, int C, int P, int K4,
    int E, int n_bins, int event_tile, void* stream) {
  const bool has_norm = norm_ext != nullptr && norm_s != nullptr;
  if (!has_norm) na1 = 0;
  const int n_tiles = E > 0 ? (E + kEventTile - 1) / kEventTile : 0;
  if (C <= 0 || E <= 0 || P <= 0 || P > kMaxParams || K4 <= 0 || K4 % 4 != 0 ||
      n_bins <= 0 || n_bins > kMaxBins || nbl <= 0 || nbl > n_bins ||
      na1 < 0 || na1 > kMaxNorm || event_tile != kEventTile ||
      n_tiles > kMaxTiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t words = static_cast<size_t>(kChainTile) * 2 * nbl +
                       2 * static_cast<size_t>(kChainTile) * P + P +
                       2 * static_cast<size_t>(kChainTile) * na1;
  const size_t smem = words * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((C + kChainTile - 1) / kChainTile, n_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define M3_ARGS                                                               \
  smem, grid, s, static_cast<const int*>(seg), static_cast<const float*>(t),  \
      coeffs, static_cast<const float*>(base_w), static_cast<const int*>(bins), \
      static_cast<const int*>(tile_start),                                    \
      static_cast<const int*>(tile_width), static_cast<const int*>(plan_ptr), \
      static_cast<const int*>(plan_idx), nbl,                                 \
      static_cast<const float*>(norm_ext), static_cast<const float*>(norm_s), \
      na1, static_cast<float*>(mc), static_cast<float*>(w2), C, P, K4, E,     \
      n_bins
  cudaError_t err;
  if (coef_bf16) {
    err = has_norm ? launch<__nv_bfloat16, true>(M3_ARGS)
                   : launch<__nv_bfloat16, false>(M3_ARGS);
  } else {
    err = has_norm ? launch<float, true>(M3_ARGS)
                   : launch<float, false>(M3_ARGS);
  }
#undef M3_ARGS
  return static_cast<int>(err);
}

extern "C" const char* m3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
