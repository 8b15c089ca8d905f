// Fused spline-reweight + Σw/Σw² histogram over static (shared) bins, for
// Hopper.
//
// Replaces the TPU kernel K2, mach3_tpu/splines/pallas_reweight.py
// _kernel_shared_blocked_sorted (reached through
// fused_reweight_histogram_shared with tile_starts / block_plan); under a
// trivial plan (every parameter, the whole bin axis) it computes K4a
// _kernel_shared and K4b _kernel_shared_blocked. It computes what they
// compute; it is not carried over block by block. Per (chain c, event e) of
// an event tile:
//
//   w   = base[c,e] · exp(Σ_k log|ext[c,k]|·S[k,e]) · (−1)^(Σ_k neg[c,k]·S[k,e])
//         · Π_{p active in the tile} resp_p(seg[c,p], t[c,p], coeffs[p,:,e])
//   mc[c, bin[e]] += w,   w2[c, bin[e]] += w²        (bin[e] ∉ [0, n_bins) dropped)
//
// Responses: resp_p = y + t(b + t(c + t·d)) from the 4 coefficient rows
// seg*4 + (0..3) of coeffs[p, :, e], in f32 (no selector dot, no bf16
// deviation rounding); bf16 tables are upcast on load. Parameters missing
// from a tile's list are the identity on every event of the tile
// (splines/plan.py), and skipping them is exact: y = 1, b = c = d = 0 gives
// resp == 1.0 in f32.
//
// Norm: log|ext| floored at 1e-30 as in the TPU kernels, so a zero norm
// gives a ~1e-30 weight; a NaN norm gives NaN weights to the events that
// match it.
//
// Layout (splines/plan.py): the events come in tiles of kEventTile = 256,
// one per thread. Per tile the plan gives a window (start, width) and a CSR
// list of active parameters; within a tile the events are sorted by bin. A
// block is one tile x kChainTile = 16 chains; blockIdx.x runs over the chain
// tiles so that the blocks that read one tile's coefficients run side by
// side and share them in L2.
//
// Response product: m3::TileCore (spline_response.cuh). A thread keeps the
// 16 chains' weights of its event in registers (starting from base · norm);
// the tile's work is a list of (parameter, segment, chain mask) items whose
// coefficient rows are staged through a 3-stage shared-memory ring by 16-byte
// cp.async, four items to a stage.
//
// Histogram: a [kChainTile][2·nbl + 1] shared-memory histogram (nbl the
// widest window of the sample), of which a tile zeroes and flushes its own
// width. After the product the weights are parked in shared memory as
// [event][chain] and the threads regroup: thread (chain, event group) walks 16
// consecutive events of one chain, sums each run of equal bins (the events
// are sorted by bin) in registers and adds a run once. Lanes of a warp then
// add into 16 different chains' histograms, whose odd pitch puts them on 16
// different banks, so the float atomicAdd (a compare-and-swap loop in shared
// memory) meets at most one other lane. A bin outside the window goes
// straight to the global histogram, so the result does not depend on the
// plan's window. After the tile, one global atomicAdd per non-empty
// (chain, bin) of the window.
//
// What bounds it on this card, and what the design does about each:
//  * instruction slots of the response loop (spline_response.cuh): ~5 instructions
//    per (item, chain) and thread. At the reference-scale fixture (~21.6 items
//    a tile: ~10.8 active parameters, chains on both sides of the knot at
//    the nominal value) the loop takes about a third of the kernel's time and
//    runs near the card's instruction rate.
//  * what a block does once, whatever its items: the dependent global reads
//    of its plan, (seg, t) and norm values, three barriers to list the items,
//    the window's zeroing and flush. A block lives for one tile of 256
//    events, so this weighs about as much as the loop.
//  * the coefficient reads. The bf16 tables of the reference-scale fixture
//    (244 MB numu_beam, 344 MB atmo) do not fit the 50 MB L2. A block copies
//    each row it needs once (the distinct segments of its 16 chains), 16
//    bytes a thread, ahead of their use; the 8 chain tiles of 128 chains read
//    a tile's rows while they sit in L2, so device memory sees each active
//    row about once a call. Inactive (parameter, tile) pairs are never read.
//  * the [C, E] base_w read (~C·E·4 bytes a call), coalesced along E, 16
//    independent loads a thread;
//  * the norm match counts S [NA1, E], read once per event (not per chain),
//    eight slots at a time; an unmatched slot costs a load and a compare.
//
// Limits: n_bins ≤ 4096, P ≤ 256, NA+1 ≤ 256, K4 / 4 ≤ 64 knots, E·sizeof(coef)
// and the table's base pointer multiples of 16 bytes, and the block's shared
// memory (the ring: 24 KB for bf16, 48 KB for f32; the window histogram; 136
// bytes per parameter, 8 per possible item, 128 per norm slot) ≤ 227 KB.
//
// Sums are taken in an order that changes from run to run (atomics), so
// results agree with the plain version to f32 summation-order tolerance.
//
// Occupancy: registers are capped at 80 a thread, three blocks of 256
// threads to an SM, which is also what the reference-scale fixture's shared
// memory (~67 KB a block with a 256-bin window) allows; a cap of 64 registers
// spills.
//
// Launch: grid (ceil(C / kChainTile), n_tiles), kThreads threads, on the
// caller's stream. It allocates nothing; mc and w2 must be zeroed [C, n_bins]
// f32 arrays. The entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "spline_response.cuh"

namespace {

constexpr int kChainTile = m3::kTileChains;
constexpr int kThreads = m3::kTileEvents;
constexpr int kEventTile = kThreads;  // one event per thread
constexpr int kMaxBins = 4096;
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on Hopper
constexpr int kMaxParams = m3::kMaxTileParams;
constexpr int kMaxNorm = 256;
constexpr int kMaxTiles = 65535;  // gridDim.y

template <typename CoefT, bool kHasNorm>
__global__ void __launch_bounds__(kThreads, 3) reweight_shared_kernel(
    const int* __restrict__ seg, const float* __restrict__ tval,
    const CoefT* __restrict__ coeffs, const float* __restrict__ base_w,
    const int* __restrict__ bins, const int* __restrict__ tile_start,
    const int* __restrict__ tile_width, const int* __restrict__ plan_ptr,
    const int* __restrict__ plan_idx, int nbl, const float* __restrict__ norm_ext,
    const float* __restrict__ norm_s, int na1, float* __restrict__ mc,
    float* __restrict__ w2, int C, int P, int K4, int E, int n_bins) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  m3::TileCore<CoefT> core;
  float* sh_logext = reinterpret_cast<float*>(core.carve(smem_raw, P, K4));  // [na1][CT]
  float* sh_neg = sh_logext + kChainTile * na1;                              // [na1][CT]
  float* hist = sh_neg + kChainTile * na1;                                   // [CT][hp]
  const int hp = 2 * nbl + 1;  // odd: lanes over chains hit 16 different banks
  int* sh_key = reinterpret_cast<int*>(hist + kChainTile * hp);              // [kThreads]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tile = blockIdx.y;
  const int c0 = blockIdx.x * kChainTile;
  const int nct = min(kChainTile, C - c0);
  const int start = tile_start[tile];
  const int width = min(tile_width[tile], nbl);
  const int p_begin = plan_ptr[tile];
  const int nact = plan_ptr[tile + 1] - p_begin;
  const int e0 = tile * kEventTile;

  for (int i = tid; i < nct * width; i += kThreads) {
    const int c = i / width;
    float* hc = hist + c * hp + (i - c * width);
    hc[0] = 0.f;
    hc[nbl] = 0.f;
  }
  if (kHasNorm) m3::norm_prepare(sh_logext, sh_neg, norm_ext, c0, nct, na1);
  const int n_items = core.prepare(seg, tval, plan_idx + p_begin, nact, c0, nct, P, K4);

  const size_t es = static_cast<size_t>(E);
  const int e = e0 + tid;
  const int b = e < E ? bins[e] : -1;
  const int key = (b >= 0 && b < n_bins) ? b : -1;  // -1: dropped

  core.start(coeffs, es, E, e0, n_items);
  float w[kChainTile];
  if (kHasNorm && key >= 0) {
    m3::norm_factor(sh_logext, sh_neg, norm_s, es, e, na1, w);
  } else {
#pragma unroll
    for (int c = 0; c < kChainTile; ++c) w[c] = 1.f;
  }
#pragma unroll
  for (int c = 0; c < kChainTile; ++c) {
    w[c] *= (key >= 0 && c < nct) ? base_w[static_cast<size_t>(c0 + c) * es + e] : 0.f;
  }
  core.multiply(coeffs, es, E, e0, n_items, w);

  // The tail (spline_response.cuh): this thread's chain and 16 consecutive
  // events, whose runs of equal bin (the events are sorted by bin) are summed
  // in registers. A run's sums go to the window histogram, or, for a bin
  // outside the window, straight to the global one.
  sh_key[tid] = key;
  const float* sh_w = core.park(w);
  const int c = tid % kChainTile;
  if (c < nct) {
    float* hc = hist + c * hp;
    const size_t row = static_cast<size_t>(c0 + c) * n_bins;
    const int ev0 = (tid / kChainTile) * m3::kTailEvents;
    int cur = -1;
    float sw = 0.f;
    float sq = 0.f;
    for (int k = 0; k <= m3::kTailEvents; ++k) {
      const int kk = k < m3::kTailEvents ? sh_key[ev0 + k] : -2;  // -2 ends the last run
      if (kk == -1) continue;
      if (kk != cur) {
        if (cur >= 0) {
          const int local = cur - start;
          if (local >= 0 && local < width) {
            atomicAdd(hc + local, sw);
            atomicAdd(hc + nbl + local, sq);
          } else {
            atomicAdd(mc + row + cur, sw);
            atomicAdd(w2 + row + cur, sq);
          }
        }
        cur = kk;
        sw = 0.f;
        sq = 0.f;
      }
      if (kk >= 0) {
        const float wv = sh_w[(ev0 + k) * m3::kWeightPitch + c];
        sw += wv;
        sq += wv * wv;
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < nct * width; i += kThreads) {
    const int c = i / width;
    const int l = i - c * width;
    const int bin = start + l;
    if (bin >= n_bins) continue;
    const float m = hist[c * hp + l];
    const float q = hist[c * hp + nbl + l];
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
// and norm_s may be null (na1 is then ignored). event_tile and chain_tile
// must equal the kernel's (the plan was built for the first, the caller sized
// the shared memory with the second). Returns a cudaError_t code:
// cudaErrorInvalidValue for sizes the kernel does not take (the header's
// limits), otherwise cudaGetLastError() right after the launch.
extern "C" int m3_reweight_shared(
    const void* seg, const void* t, const void* coeffs, int coef_bf16,
    const void* base_w, const void* bins, const void* tile_start,
    const void* tile_width, const void* plan_ptr, const void* plan_idx, int nbl,
    const void* norm_ext,
    const void* norm_s, int na1, void* mc, void* w2, int C, int P, int K4,
    int E, int n_bins, int event_tile, int chain_tile, void* stream) {
  const bool has_norm = norm_ext != nullptr && norm_s != nullptr;
  if (!has_norm) na1 = 0;
  const int n_tiles = E > 0 ? (E + kEventTile - 1) / kEventTile : 0;
  if (C <= 0 || E <= 0 || P <= 0 || P > kMaxParams || K4 <= 0 || K4 % 4 != 0 ||
      n_bins <= 0 || n_bins > kMaxBins || nbl <= 0 || nbl > n_bins ||
      na1 < 0 || na1 > kMaxNorm || event_tile != kEventTile ||
      chain_tile != kChainTile || n_tiles > kMaxTiles || K4 / 4 > m3::kMaxKnots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t coef_size = coef_bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  if ((static_cast<size_t>(E) * coef_size) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(coeffs) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = m3::core_bytes(coef_size, P, K4) +
                      sizeof(float) * (kChainTile * (2 * static_cast<size_t>(nbl) + 1 + 2 * na1) +
                                       kThreads);
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
