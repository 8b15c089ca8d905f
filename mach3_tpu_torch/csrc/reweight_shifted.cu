// Fused spline-reweight + shifted-axis binning + Σw/Σw² histogram for Hopper.
//
// Replaces the TPU kernels K1, mach3_tpu/splines/pallas_reweight.py
// _kernel_maskreduce_shifted (with _resp_dot, _norm_weight and
// _shifted_bin_histogram), reached through fused_reweight_histogram_shifted,
// and K3, _kernel_shifted_blocked (the same function with P streamed through
// VMEM in blocks of 8; here the list of a tile's items takes the place of the
// blocks). It computes, per (chain c, event e):
//
//   w   = base[c,e] · exp(Σ_k log|ext[c,k]|·S[k,e]) · (−1)^(Σ_k neg[c,k]·S[k,e])
//         · Π_{p active in e's tile} resp_p
//   x   = x_nom[e] · (1 + v[c])                      (shift kind "scale")
//         x_nom[e] + v[c]                            ("offset")
//         1 + (x_nom[e] − 1) · (1 + v[c])            ("scale_about_one")
//   idx = #(edges ≤ x) − 1
//   bin = static[e] + stride·idx, or dropped when idx ∉ [0, n_axis) or
//         static[e] < 0
//   mc[c,bin] += w,  w2[c,bin] += w²
//
// Responses: resp_p = y + t(b + t(c + t·d)) from the 4 coefficient rows
// seg*4 + (0..3) of coeffs[p, :, e], in f32 (spline_response.cuh; the JAX
// production route rounds the deviation resp − 1 to bf16; this port does
// not).
//
// Activity plan: the events come in tiles of kEventTile = 256 (one per
// thread) and a CSR list (plan_ptr, plan_idx) names the parameters that are
// not the identity on some event of each tile (splines/plan.shifted_layout
// sorts the events by activity pattern so that the lists are short: ~11 of 43
// on the reference-scale nue_beam). A parameter missing from a tile's list
// must be the identity on every event of the tile; skipping it is exact
// (y = 1, b = c = d = 0 gives resp == 1.0 in f32). Without a plan (null
// pointers) every parameter is read on every tile.
//
// Norm: log|ext| is floored at 1e-30 as in the TPU kernel, so a zero norm
// gives a ~1e-30 weight, not an exact 0 (the JAX XLA route gives 0); a NaN
// norm gives NaN weights to the events that match it.
//
// Binning (m3::shifted_bin, spline_response.cuh, which the backward kernel
// shares): x is formed with __fadd_rn/__fsub_rn/__fmul_rn, one rounding per
// operation in the plain version's order, so it cannot be contracted into an
// FMA and lands in the same bin as the f32 reference. The edge count
// is a binary search over the edges staged in shared memory; a NaN x compares
// false everywhere, gives idx = −1 and so is dropped. An event of weight 0 (a
// pad of the layout) adds nothing and skips the search.
//
// A block is one tile x kChainTile = 16 chains; blockIdx.x runs over the
// chain tiles so that the blocks that read one tile's coefficients run side
// by side and share them in L2. Response product: m3::TileCore
// (spline_response.cuh): the 16 chains' weights of a thread's event in
// registers (starting from base · norm), the tile's (parameter, segment,
// chain mask) items staged through a 3-stage shared-memory ring by 16-byte
// cp.async. After the product the weights are parked in shared memory as
// [event][chain] and the threads regroup: thread (chain, event group) walks 16
// consecutive events of one chain: shift, edge search, and the sums of
// consecutive events of one bin added once to a [kChainTile][2·B + 1]
// shared-memory histogram. Lanes of a warp then add into 16 different chains'
// histograms (the odd pitch puts them on 16 different banks), so the float
// atomicAdd (a compare-and-swap loop in shared memory) meets at most one other
// lane, where lanes over events of one chain met up to 31. After the tile, one
// global atomicAdd per non-empty (chain, bin).
//
// What bounds it on this card, and what the design does about each:
//  * what a block does once, whatever its items: the dependent global reads
//    of its plan, (seg, t), norm values and edges, three barriers to list the
//    items, the histogram's zeroing and its flush (up to 2·B global atomics a
//    chain). A block lives for one tile of 256 events; with few parameters
//    (the toy's P = 4, ~1.3 of them active on a tile) this and the tail are
//    nearly all of the time;
//  * instruction slots: the response loop (~5 instructions per (item, chain) and
//    thread) and the tail (a binary search of log2(edges) dependent
//    shared-memory reads per (chain, event));
//  * the coefficient reads: each block copies each row it needs once (the
//    distinct segments of its 16 chains), ahead of use; the chain tiles of a
//    tile run side by side, so device memory sees each active row about once
//    a call (the reference-scale nue_beam table, 103 MB in bf16, does not fit
//    the 50 MB L2);
//  * the [C, E] base_w read from device memory (~C·E·4 bytes a call):
//    coalesced along E, 16 independent loads a thread.
//
// Limits: n_bins ≤ 512, edges ≤ 1025, P ≤ 256, NA+1 ≤ 256, K4 / 4 ≤ 64 knots,
// E·sizeof(coef) and the table's base pointer multiples of 16 bytes, and the
// block's shared memory (the ring: 24 KB for bf16, 48 KB for f32; the
// histogram; 136 bytes per parameter, 8 per possible item, 128 per norm slot;
// the edges) ≤ 227 KB.
//
// Sums are taken in an order that changes from run to run (atomics), so
// results agree with the plain version to f32 summation-order tolerance, not
// bit for bit.
//
// Occupancy: registers are capped at 64 a thread (four blocks of 256 threads
// to an SM; a few spilled words) because a block waits more than it
// computes: on an H100 (700 W) four resident blocks beat three by 5% on the
// reference-scale nue_beam (P = 43) and by 12-13% on the toy (P = 4).
//
// Launch: grid (ceil(C / kChainTile), ceil(E / kEventTile)), kThreads
// threads, on the caller's stream. It allocates nothing; mc and w2 must be
// zeroed [C, n_bins] f32 arrays. The entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "spline_response.cuh"

namespace {

constexpr int kChainTile = m3::kTileChains;
constexpr int kThreads = m3::kTileEvents;
constexpr int kEventTile = kThreads;  // one event per thread
constexpr int kMaxBins = 512;
constexpr int kMaxEdges = 1025;
constexpr int kMaxParams = m3::kMaxTileParams;
constexpr int kMaxNorm = 256;
constexpr int kMaxTiles = 65535;  // gridDim.y
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on Hopper

template <typename CoefT, bool kHasNorm>
__global__ void __launch_bounds__(kThreads, 4) reweight_shifted_kernel(
    const int* __restrict__ seg, const float* __restrict__ tval,
    const CoefT* __restrict__ coeffs, const float* __restrict__ base_w,
    const float* __restrict__ shift_vals, const float* __restrict__ x_nom,
    const int* __restrict__ static_base, const float* __restrict__ edges,
    int n_edges, const int* __restrict__ plan_ptr, const int* __restrict__ plan_idx,
    const float* __restrict__ norm_ext, const float* __restrict__ norm_s, int na1,
    float* __restrict__ mc, float* __restrict__ w2, int C, int P, int K4, int E,
    int n_bins, int stride_j, int n_axis_j, int shift_kind) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  m3::TileCore<CoefT> core;
  float* sh_logext = reinterpret_cast<float*>(core.carve(smem_raw, P, K4));  // [na1][CT]
  float* sh_neg = sh_logext + kChainTile * na1;                              // [na1][CT]
  float* hist = sh_neg + kChainTile * na1;                                   // [CT][hp]
  const int hp = 2 * n_bins + 1;  // odd: lanes over chains hit 16 different banks
  float* sh_edges = hist + kChainTile * hp;                                  // [n_edges]
  float* sh_shift = sh_edges + n_edges;                                      // [CT] a of shift_x
  float* sh_x = sh_shift + kChainTile;                                       // [kThreads] x_nom
  int* sh_sb = reinterpret_cast<int*>(sh_x + kThreads);                      // [kThreads] static bin

  const int tid = threadIdx.x;
  const int tile = blockIdx.y;
  const int c0 = blockIdx.x * kChainTile;
  const int nct = min(kChainTile, C - c0);
  const int e0 = tile * kEventTile;
  const int p_begin = plan_ptr ? plan_ptr[tile] : 0;
  const int nact = plan_ptr ? plan_ptr[tile + 1] - p_begin : P;

  for (int i = tid; i < kChainTile * hp; i += kThreads) hist[i] = 0.f;
  for (int i = tid; i < n_edges; i += kThreads) sh_edges[i] = edges[i];
  if (kHasNorm) m3::norm_prepare(sh_logext, sh_neg, norm_ext, c0, nct, na1);
  for (int i = tid; i < nct; i += kThreads) {
    sh_shift[i] = m3::shift_factor(shift_kind, shift_vals[c0 + i]);
  }
  const int n_items = core.prepare(seg, tval, plan_ptr ? plan_idx + p_begin : nullptr, nact,
                                   c0, nct, P, K4);

  const size_t es = static_cast<size_t>(E);
  const int e = e0 + tid;
  const bool live = e < E;
  const float xn = live ? x_nom[e] : 0.f;
  const int sb = live ? static_base[e] : -1;
  core.start(coeffs, es, E, e0, n_items);
  float w[kChainTile];
  if (kHasNorm && live) {
    m3::norm_factor(sh_logext, sh_neg, norm_s, es, e, na1, w);
  } else {
#pragma unroll
    for (int c = 0; c < kChainTile; ++c) w[c] = 1.f;
  }
#pragma unroll
  for (int c = 0; c < kChainTile; ++c) {
    w[c] *= (live && sb >= 0 && c < nct) ? base_w[static_cast<size_t>(c0 + c) * es + e] : 0.f;
  }
  core.multiply(coeffs, es, E, e0, n_items, w);

  // The tail (spline_response.cuh): this thread's chain and 16 consecutive
  // events; consecutive events of one bin are summed in registers.
  sh_x[tid] = xn;
  sh_sb[tid] = sb;
  const float* sh_w = core.park(w);
  const int c = tid % kChainTile;
  if (c < nct) {
    const float a = sh_shift[c];
    float* hc = hist + c * hp;
    const int ev0 = (tid / kChainTile) * m3::kTailEvents;
    int cur = -1;
    float sw = 0.f;
    float sq = 0.f;
    for (int k = 0; k < m3::kTailEvents; ++k) {
      const float wv = sh_w[(ev0 + k) * m3::kWeightPitch + c];
      if (wv == 0.f) continue;
      const int bin = m3::shifted_bin(shift_kind, sh_x[ev0 + k], a, sh_sb[ev0 + k], sh_edges,
                                      n_edges, stride_j, n_axis_j);
      if (bin < 0) continue;
      if (bin != cur) {
        if (cur >= 0) {
          atomicAdd(hc + cur, sw);
          atomicAdd(hc + n_bins + cur, sq);
        }
        cur = bin;
        sw = 0.f;
        sq = 0.f;
      }
      sw += wv;
      sq += wv * wv;
    }
    if (cur >= 0) {
      atomicAdd(hc + cur, sw);
      atomicAdd(hc + n_bins + cur, sq);
    }
  }
  __syncthreads();

  for (int i = tid; i < nct * n_bins; i += kThreads) {
    const int c = i / n_bins;
    const int b = i - c * n_bins;
    const float m = hist[c * hp + b];
    const float q = hist[c * hp + n_bins + b];
    const size_t o = static_cast<size_t>(c0 + c) * n_bins + b;
    if (m != 0.f) atomicAdd(mc + o, m);
    if (q != 0.f) atomicAdd(w2 + o, q);
  }
}

template <typename CoefT, bool kHasNorm>
cudaError_t launch(size_t smem, dim3 grid, cudaStream_t stream, const int* seg,
                   const float* t, const void* coeffs, const float* base_w,
                   const float* shift_vals, const float* x_nom,
                   const int* static_base, const float* edges, int n_edges,
                   const int* plan_ptr, const int* plan_idx,
                   const float* norm_ext, const float* norm_s, int na1,
                   float* mc, float* w2, int C, int P, int K4, int E,
                   int n_bins, int stride_j, int n_axis_j, int shift_kind) {
  auto kernel = reweight_shifted_kernel<CoefT, kHasNorm>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      seg, t, static_cast<const CoefT*>(coeffs), base_w, shift_vals, x_nom,
      static_base, edges, n_edges, plan_ptr, plan_idx, norm_ext, norm_s, na1, mc,
      w2, C, P, K4, E, n_bins, stride_j, n_axis_j, shift_kind);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. coeffs is f32 (coef_bf16 == 0) or bf16; norm_ext
// and norm_s may be null (na1 is then ignored); plan_ptr and plan_idx may be
// null (every parameter on every tile). event_tile and chain_tile must equal
// the kernel's (the plan was built for the first, the caller sized the shared
// memory with the second). Returns a cudaError_t code: cudaErrorInvalidValue
// for sizes the kernel does not take (the header's limits), otherwise
// cudaGetLastError() right after the launch.
extern "C" int m3_reweight_shifted(
    const void* seg, const void* t, const void* coeffs, int coef_bf16,
    const void* base_w, const void* shift_vals, const void* x_nom,
    const void* static_base, const void* edges, int n_edges,
    const void* plan_ptr, const void* plan_idx,
    const void* norm_ext, const void* norm_s, int na1, void* mc, void* w2,
    int C, int P, int K4, int E, int n_bins, int stride_j, int n_axis_j,
    int shift_kind, int event_tile, int chain_tile, void* stream) {
  const bool has_norm = norm_ext != nullptr && norm_s != nullptr;
  if (!has_norm) na1 = 0;
  if (plan_ptr == nullptr || plan_idx == nullptr) plan_ptr = plan_idx = nullptr;
  const int n_tiles = E > 0 ? (E + kEventTile - 1) / kEventTile : 0;
  if (C <= 0 || E <= 0 || P <= 0 || P > kMaxParams || K4 <= 0 || K4 % 4 != 0 ||
      n_bins <= 0 || n_bins > kMaxBins || n_edges < 2 || n_edges > kMaxEdges ||
      n_axis_j != n_edges - 1 || na1 < 0 || na1 > kMaxNorm ||
      shift_kind < m3::kShiftScale || shift_kind > m3::kShiftAboutOne ||
      event_tile != kEventTile || chain_tile != kChainTile || n_tiles > kMaxTiles ||
      K4 / 4 > m3::kMaxKnots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t coef_size = coef_bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  if ((static_cast<size_t>(E) * coef_size) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(coeffs) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = m3::core_bytes(coef_size, P, K4) +
                      sizeof(float) * (kChainTile * (2 * static_cast<size_t>(n_bins) + 2 * na1 + 2) +
                                       n_edges + 2 * kThreads);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((C + kChainTile - 1) / kChainTile, n_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define M3_ARGS                                                              \
  smem, grid, s, static_cast<const int*>(seg), static_cast<const float*>(t), \
      coeffs, static_cast<const float*>(base_w),                             \
      static_cast<const float*>(shift_vals), static_cast<const float*>(x_nom), \
      static_cast<const int*>(static_base), static_cast<const float*>(edges), \
      n_edges, static_cast<const int*>(plan_ptr),                            \
      static_cast<const int*>(plan_idx), static_cast<const float*>(norm_ext), \
      static_cast<const float*>(norm_s), na1, static_cast<float*>(mc),       \
      static_cast<float*>(w2), C, P, K4, E, n_bins, stride_j, n_axis_j, shift_kind
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
