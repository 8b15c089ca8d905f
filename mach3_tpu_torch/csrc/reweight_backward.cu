// Analytic backward of the fused spline-reweight + Σw/Σw² histogram, for
// Hopper: one kernel, entry m3_reweight_backward.
//
// Replaces the TPU kernels K6a and K6b, mach3_tpu/splines/pallas_grad.py
// _kernel_grad_a and _kernel_grad_b (both reached through _grad_backward
// from fused_reweight_diff and fused_reweight_diff_shifted). It computes
// their function, contracted with the port's parameterisation of the
// responses, in one launch; it is not carried over block by block.
//
// Forward (without the norm product, which rides base_w): w[c,e] =
// base[c,e] · Π_p resp_p, resp_p = y + t(b + t(c + t·d)) from the 4
// coefficient rows seg[c,p]*4 + (0..3) of coeffs[p, :, e], t = value −
// knot[seg] (so ∂t/∂θ = 1); then mc[c, bin] += w, w2[c, bin] += w². Given
// the output cotangents ḡ_mc, ḡ_w2 [C, B], per (chain c, event e):
//
//   pnz = Π_{p: resp_p ≠ 0} resp_p,  nz = #{p: resp_p == 0}
//   r   = pnz if nz == 0 else 0,     G = ḡ_mc[c, bin] + 2·base·r·ḡ_w2[c, bin]
//   ḡ_base[c, e] = G·r                    (G = 0 for a bin outside [0, n_bins))
//   ḡ_t[c, p]    = Σ_e G·base·excl_p·(b + t(2c + 3t·d)),
//   excl_p = pnz / resp_p if nz == 0;  pnz if nz == 1 and resp_p == 0;  else 0
//
// which is K6a's ḡ_base and K6b's ḡ_selector[c, p, :] contracted with
// ∂selector/∂t = [0, 1, 2t, 3t²] at the segment. The bin is bins[e] (the
// shared route's static bins), bins[c, e] (per-chain bins given: a sample
// whose shifts are torch code) or, on the shifted route and the generic
// route's named shifts, formed here from the forward's bin map by
// m3::perchain_bin (spline_response.cuh), the forward kernel's own binning,
// in f32.
//
// Why one kernel: the TPU's two passes handed three [C, E] fields (G·base,
// pnz, nz) from pass A to pass B through device memory, 24 bytes per (chain,
// event) written and read back: 294 MB for numu_beam at 64 chains, more than
// either pass's own bound. Here a block computes both phases of its tile, so
// those values stay in registers, and the only [C, E] output is ḡ_base.
//
// A block is one tile of kEventTile = 256 events (one per thread) x
// kChainTile = 16 chains, the forward kernels' tile, on m3::TileCore: the
// tile's (parameter, segment, chain mask) items, listed under the tile's
// activity plan (every parameter without one), stream through a 3-stage
// shared-memory ring; a parameter missing from the plan is the identity on
// every event of the tile (response 1.0, slope 0), so skipping it is exact.
//
//  * Phase 1 (K6a's function): the ring walk keeps per chain pnz[c] in a
//    register and, per chain, two bits in one register: "at least one zero
//    response" (bit c) and "at least two" (bit 16 + c), a saturating count
//    of 0, 1 or ≥ 2, all that excl_p needs. Then each thread gathers G for
//    its event and its 16 chains and writes ḡ_base, and keeps u[c] = G·base·
//    pnz (0 for two zeros or more) in registers.
//  * Phase 2 (K6b's function, kNeedT): the same items again, re-streamed
//    from L2 (the 16-chain blocks of one event tile run side by side, and the
//    tile's rows were just read). Keeping a tile's rows in a larger ring
//    instead (32 items, 64 KB in bf16) was faster at two blocks an SM and
//    slower than streaming at three, which it does not leave room for
//    (kernel_probe.py on an H100; PERF.md §6). Per item and
//    chain of its mask: r and its slope s = b + t(2c + 3t·d), and acc[c] +=
//    s·u/r, one MUFU reciprocal (__fdividef) instead of an IEEE division. A
//    warp in which some chain of some event has a zero response (rare: a
//    response clipped at 0), or one outside [2^-126, 2^126] where the
//    reciprocal is not within 2 ulp (phase 1 flags it), takes the exact rule
//    above instead: s·u where r == 0 and that was the one zero, else 0, and
//    an IEEE division u / r. A parameter's items have disjoint masks and share
//    one acc[16]; after its last item the warp reduces acc[16] by
//    reduce-scatter, 8 + 4 + 2 + 1 + 1 = 16 shuffles leaving chain lane / 2
//    on lanes (lane, lane ^ 1) (a shuffle tree per chain takes 80), and the
//    even lanes store it in shared memory. After the walk the block sums its
//    8 warps in a fixed order into partial[tile, c, p], exactly 0 for a
//    parameter the tile does not list; the wrapper sums over tiles. No float
//    atomics: ḡ_t is bit-identical from run to run.
//
// What bounds it on this card (numu_beam of the reference-scale fixture, 64
// chains, bf16 table, ~21.6 items a tile: ~10.8 listed parameters with the
// chains on both sides of a knot):
//  * the function's bound is bytes: base_w in and ḡ_base out (2 x 49 MB),
//    the listed rows once (~33 MB), the per-tile partials (6 MB): ~0.04 ms
//    at 3.35 TB/s. Its f32 operations, each response once (14 per evaluated
//    (chain, event, parameter)), take less at the card's FP32 peak;
//  * this design's limit is instruction slots: per item, thread and chain of
//    the tile ~9 in phase 1 (Horner, the range compare, the product or the
//    zero bits, the mask predicate) and ~9 in phase 2 (Horner again, slope,
//    reciprocal, two products), issued whether the chain sits in the item's
//    segment or not; ~300 per (item, thread) with the shared-memory reads,
//    ~5e9 for the call: ~0.17 ms at the card's issue rate.
// What the design does about them: the coefficient rows reach a thread from
// shared memory, never from global memory inside the loop; the plan lists
// only the parameters a tile needs; the three [C, E] fields of the TPU's two
// passes are gone; the reduction is 16 shuffles per parameter and warp.
//
// Occupancy: registers are capped at 80 a thread (three blocks of 256
// threads an SM; a few spilled words) because a block waits more than it
// computes: uncapped it takes 116 and two blocks, 14-25% slower on every
// sample of the gradient path (kernel_probe.py on an H100). Branching per
// chain on the item's mask beats computing all 16 chains and selecting.
//
// Everything is f32, from f32 operands (bf16 tables are upcast on load). The
// TPU kernel rounds both operands of its pass-B dot to bf16; this one does
// not, as the forward kernels do not copy the forward's rounding.
//
// Tables: any row pitch; rows that start on 16-byte boundaries are copied by
// 16-byte cp.async, others one element a thread (a sample that is not laid
// out). Limits: P ≤ 256, K4 / 4 ≤ 64 knots, the bin map's (4 shifted axes, 8
// shifts, edges ≤ 1025 an axis), and the block's shared memory (the tile
// core; with kNeedT 8 x 16 floats per parameter for the warps' sums and an
// int per parameter; the map's edges, shift factors, event rows and cells)
// ≤ 227 KB.
//
// Launch: grid (ceil(C / kChainTile), ceil(E / kEventTile)), kThreads
// threads, on the caller's stream. It allocates nothing. The entry returns
// cudaErrorInvalidValue for sizes it does not take, else cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "spline_response.cuh"

namespace {

constexpr int kChainTile = m3::kTileChains;
constexpr int kThreads = m3::kTileEvents;
constexpr int kEventTile = kThreads;  // one event per thread
constexpr int kWarps = kThreads / 32;
constexpr int kMaxParams = m3::kMaxTileParams;
constexpr int kMaxTiles = 65535;     // gridDim.y
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on Hopper
constexpr unsigned kFullMask = 0xffffffffu;
// __fdividef(u, r) is within 2 ulp of u / r for kFastMin ≤ |r| ≤ kFastMax
// (2^-126, the least normal float, and 2^126); outside it returns 0 or
// flushes r.
constexpr float kFastMin = 1.17549435e-38f;
constexpr float kFastMax = 8.50705917e37f;
// Where an event's bin comes from (splines/grad.py BINS_*).
constexpr int kBinsShared = 0;    // bins[e]
constexpr int kBinsPerChain = 1;  // bins[c, e]
constexpr int kBinsMap = 2;       // m3::perchain_bin of the forward's bin map
// A kernel's bin source (its kBins) is one of those or, for a map of one
// axis with one shift (the shifted route's), m3::axis_bin with the map's
// fields read from the arguments and the event's value in a register.
constexpr int kBinsAxis = 3;

struct Args {
  const int* seg;
  const float* t;
  const void* coeffs;
  const float* base_w;
  const int* bins;
  const float* kin;         // [V, E] the map's rows
  const float* shift_vals;  // [C, map.n_shifts]
  const int* statics;       // [E]
  const float* edges;       // [map.n_axes][map.edge_pitch]
  const int* cells;         // [map.n_cells]
  m3::BinMap map;
  const float* gmc;
  const float* gw2;
  const int* plan_ptr;
  const int* plan_idx;
  float* gbase;
  float* partial;
  int C, P, K4, E, n_bins;
  bool aligned;
};

// The warp's sum of acc[16] over its 32 lanes, by reduce-scatter: after the
// exchanges over lane bits 4, 3, 2 and 1 a lane holds the partial sum of
// chain lane >> 1 over half the warp, and the last exchange adds the other
// half. Lanes lane and lane ^ 1 return the same value.
__device__ __forceinline__ float reduce_scatter(const float (&acc)[kChainTile], int lane) {
  float a8[8], a4[4], a2[2];
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4, h2 = lane & 2;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float send = h16 ? acc[k] : acc[k + 8];
    a8[k] = (h16 ? acc[k + 8] : acc[k]) + __shfl_xor_sync(kFullMask, send, 16);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float send = h8 ? a8[k] : a8[k + 4];
    a4[k] = (h8 ? a8[k + 4] : a8[k]) + __shfl_xor_sync(kFullMask, send, 8);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float send = h4 ? a4[k] : a4[k + 2];
    a2[k] = (h4 ? a4[k + 2] : a4[k]) + __shfl_xor_sync(kFullMask, send, 4);
  }
  const float a1 = (h2 ? a2[1] : a2[0]) + __shfl_xor_sync(kFullMask, h2 ? a2[0] : a2[1], 2);
  return a1 + __shfl_xor_sync(kFullMask, a1, 1);
}

template <typename CoefT, bool kNeedT, int kBins>
__global__ void __launch_bounds__(kThreads, 3) reweight_backward_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ m3::BinMap map;
  m3::TileCore<CoefT> core;
  // [W][P][CT] the warps' sums
  float* red = reinterpret_cast<float*>(core.carve(smem_raw, a.P, a.K4));
  int* slot = reinterpret_cast<int*>(red + (kNeedT ? kWarps * a.P * kChainTile : 0));  // [P]
  constexpr bool by_map = kBins >= kBinsMap;
  const m3::BinMap& am = a.map;
  float* sh_edges = reinterpret_cast<float*>(slot + (kNeedT ? a.P : 0));  // [n_axes][pitch]
  float* sh_fac = sh_edges + (by_map ? am.n_axes * am.edge_pitch : 0);    // [n_shifts][CT]
  float* sh_x = sh_fac + (by_map ? am.n_shifts * kChainTile : 0);         // [n_axes][kThreads]
  int* sh_cell = reinterpret_cast<int*>(sh_x + (by_map ? am.n_axes * kThreads : 0));

  const int tid = threadIdx.x;
  const int tile = blockIdx.y;
  const int c0 = blockIdx.x * kChainTile;
  const int nct = min(kChainTile, a.C - c0);
  const int e0 = tile * kEventTile;
  const int p_begin = a.plan_ptr ? a.plan_ptr[tile] : 0;
  const int nact = a.plan_ptr ? a.plan_ptr[tile + 1] - p_begin : a.P;
  const CoefT* coeffs = static_cast<const CoefT*>(a.coeffs);

  if (by_map) {
    m3::stage_bin_map(map, a.map, a.edges, a.cells, a.shift_vals, c0, nct, sh_edges, sh_cell,
                      sh_fac);
  }
  if (kNeedT) {
    for (int i = tid; i < a.P; i += kThreads) slot[i] = -1;
  }
  const int n_items = core.prepare(a.seg, a.t, a.plan_ptr ? a.plan_idx + p_begin : nullptr,
                                   nact, c0, nct, a.P, a.K4);

  const size_t es = static_cast<size_t>(a.E);
  const int e = e0 + tid;
  const bool live = e < a.E;

  // Phase 1: the product of the nonzero responses and the zero bits.
  core.start(coeffs, es, a.E, e0, n_items, a.aligned);
  float pnz[kChainTile];
#pragma unroll
  for (int c = 0; c < kChainTile; ++c) pnz[c] = 1.f;
  unsigned zeros = 0;  // bit c: a zero response on chain c; bit 16 + c: two
  bool wide = false;   // a nonzero response outside [kFastMin, kFastMax] (or NaN)
  core.for_each_item(coeffs, es, a.E, e0, n_items, a.aligned,
                     [&](int, int jm, float y, float b, float c, float d) {
    const unsigned mask = static_cast<unsigned>(jm) & 0xffffu;
    const float4* tp = core.item_t(jm);
    const float4 ta = tp[0], tb = tp[1], tc = tp[2], td = tp[3];
#define M3_STEP(C, T)                                                  \
  if (mask & (1u << (C))) {                                            \
    const float r = fmaf(T, fmaf(T, fmaf(T, d, c), b), y);             \
    if (!(fabsf(r) >= kFastMin && fabsf(r) <= kFastMax)) {             \
      if (r == 0.f) {                                                  \
        zeros |= ((zeros & (1u << (C))) << 16) | (1u << (C));          \
      } else {                                                         \
        wide = true;                                                   \
        pnz[C] *= r;                                                   \
      }                                                                \
    } else {                                                           \
      pnz[C] *= r;                                                     \
    }                                                                  \
  }
    M3_STEP(0, ta.x) M3_STEP(1, ta.y) M3_STEP(2, ta.z) M3_STEP(3, ta.w)
    M3_STEP(4, tb.x) M3_STEP(5, tb.y) M3_STEP(6, tb.z) M3_STEP(7, tb.w)
    M3_STEP(8, tc.x) M3_STEP(9, tc.y) M3_STEP(10, tc.z) M3_STEP(11, tc.w)
    M3_STEP(12, td.x) M3_STEP(13, td.y) M3_STEP(14, td.z) M3_STEP(15, td.w)
#undef M3_STEP
  });

  // The cotangent gather: ḡ_base out, u = G·base·pnz kept for phase 2.
  if (!live) zeros = 0;
  int bin_e = -1;
  float x0 = 0.f;
  if (live) {
    if (kBins == kBinsShared) bin_e = a.bins[e];
    if (by_map) {
      bin_e = a.statics[e];
      if (kBins == kBinsAxis) {
        x0 = a.kin[static_cast<size_t>(am.row[0]) * es + e];
      } else {
        for (int ax = 0; ax < map.n_axes; ++ax) {  // this thread's own row of sh_x
          sh_x[ax * kThreads + tid] = a.kin[static_cast<size_t>(map.row[ax]) * es + e];
        }
      }
    }
  }
  float u[kChainTile];
#pragma unroll
  for (int c = 0; c < kChainTile; ++c) {
    u[c] = 0.f;
    if (live && c < nct) {
      const size_t o = static_cast<size_t>(c0 + c) * es + e;
      const float base = a.base_w[o];
      int bin = bin_e;
      if (kBins == kBinsPerChain) {
        bin = a.bins[o];
      } else if (kBins == kBinsAxis) {
        bin = m3::axis_bin(am.kind[0], x0, sh_fac[c], bin_e, sh_edges, am.n_edges[0],
                           am.stride[0]);
        if (am.n_cells > 0 && bin >= 0) bin = bin < am.n_cells ? sh_cell[bin] : -1;
      } else if (kBins == kBinsMap) {
        bin = m3::perchain_bin(map, sh_x + tid, kThreads, sh_fac + c, kChainTile, bin_e,
                               sh_edges, sh_cell);
      }
      const float r = (zeros & (1u << c)) ? 0.f : pnz[c];
      float g = 0.f;
      if (bin >= 0 && bin < a.n_bins) {
        const size_t gb = static_cast<size_t>(c0 + c) * a.n_bins + bin;
        g = fmaf(2.f * (base * r), a.gw2[gb], a.gmc[gb]);
      }
      a.gbase[o] = g * r;
      u[c] = (zeros & (1u << (16 + c))) ? 0.f : g * base * pnz[c];
    }
  }
  if (!kNeedT) return;

  // Phase 2: the parameters' sums over the tile's events.
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool exact = __any_sync(kFullMask, zeros != 0 || wide);  // the warp's rule
  float acc[kChainTile];
#pragma unroll
  for (int c = 0; c < kChainTile; ++c) acc[c] = 0.f;
  __syncthreads();  // every thread has left the ring
  if (tid < nact) slot[core.par[tid]] = tid;
  core.start(coeffs, es, a.E, e0, n_items, a.aligned);
  core.for_each_item(coeffs, es, a.E, e0, n_items, a.aligned,
                     [&](int i, int jm, float y, float b, float c, float d) {
    if (live) {
      const unsigned mask = static_cast<unsigned>(jm) & 0xffffu;
      const float c2 = c + c;
      const float d3 = 3.f * d;
      const float4* tp = core.item_t(jm);
      const float4 ta = tp[0], tb = tp[1], tc = tp[2], td = tp[3];
#define M3_STEP(C, T, F)                                         \
  if (mask & (1u << (C))) {                                      \
    const float r = fmaf(T, fmaf(T, fmaf(T, d, c), b), y);       \
    acc[C] = fmaf(F, fmaf(T, fmaf(T, d3, c2), b), acc[C]);       \
  }
#define M3_ALL(F)                                                                      \
  M3_STEP(0, ta.x, F(0)) M3_STEP(1, ta.y, F(1)) M3_STEP(2, ta.z, F(2))                 \
  M3_STEP(3, ta.w, F(3)) M3_STEP(4, tb.x, F(4)) M3_STEP(5, tb.y, F(5))                 \
  M3_STEP(6, tb.z, F(6)) M3_STEP(7, tb.w, F(7)) M3_STEP(8, tc.x, F(8))                 \
  M3_STEP(9, tc.y, F(9)) M3_STEP(10, tc.z, F(10)) M3_STEP(11, tc.w, F(11))             \
  M3_STEP(12, td.x, F(12)) M3_STEP(13, td.y, F(13)) M3_STEP(14, td.z, F(14))           \
  M3_STEP(15, td.w, F(15))
#define M3_FAST(C) __fdividef(u[C], r)
#define M3_EXACT(C) ((zeros & (1u << (C))) ? (r == 0.f ? u[C] : 0.f) : u[C] / r)
      if (exact) {
        M3_ALL(M3_EXACT)
      } else {
        M3_ALL(M3_FAST)
      }
#undef M3_EXACT
#undef M3_FAST
#undef M3_ALL
#undef M3_STEP
    }
    const int j = jm >> 16;
    if (i + 1 == n_items || (core.item_jm[i + 1] >> 16) != j) {  // the parameter's last item
      const float total = reduce_scatter(acc, lane);
      if (!(lane & 1)) red[(warp * a.P + j) * kChainTile + (lane >> 1)] = total;
#pragma unroll
      for (int k = 0; k < kChainTile; ++k) acc[k] = 0.f;
    }
  });
  __syncthreads();

  float* out = a.partial + (static_cast<size_t>(tile) * a.C + c0) * a.P;
  for (int i = tid; i < nct * a.P; i += kThreads) {
    const int c = i / a.P;
    const int j = slot[i - c * a.P];
    float sum = 0.f;
    if (j >= 0) {
      for (int w = 0; w < kWarps; ++w) sum += red[(w * a.P + j) * kChainTile + c];
    }
    out[i] = sum;
  }
}

template <typename CoefT, bool kNeedT, int kBins>
cudaError_t launch(size_t smem, dim3 grid, cudaStream_t stream, const Args& a) {
  auto kernel = reweight_backward_kernel<CoefT, kNeedT, kBins>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int kBins>
cudaError_t dispatch(bool bf16, bool need_t, size_t smem, dim3 grid, cudaStream_t s,
                     const Args& a) {
  if (bf16) {
    return need_t ? launch<__nv_bfloat16, true, kBins>(smem, grid, s, a)
                  : launch<__nv_bfloat16, false, kBins>(smem, grid, s, a);
  }
  return need_t ? launch<float, true, kBins>(smem, grid, s, a)
                : launch<float, false, kBins>(smem, grid, s, a);
}

}  // namespace

// Plain C entry for ctypes. coeffs is f32 (coef_bf16 == 0) or bf16, of any
// row pitch. bins_kind 0: bins [E] int32; 1: bins [C, E] int32; 2: bins
// null and the forward's bin map (the host descriptor desc, as the forward
// entries of reweight_shifted.cu take it: m3::parse_bin_map; kin [V, E],
// shift_vals [C, n_shifts], static_base [E], edges [n_axes, edge_pitch],
// cells [n_cells] or null), which is ignored otherwise. plan_ptr / plan_idx
// (CSR over tiles of event_tile events) may both be null: every parameter on
// every tile. Writes gbase [C, E] f32 and, unless partial is null (no ḡ_t
// wanted), partial [ceil(E / event_tile), C, P] f32: every entry, 0 for a
// parameter a tile's plan does not list; ḡ_t is its sum over the first
// axis. event_tile and chain_tile must equal the kernel's. Returns a
// cudaError_t code: cudaErrorInvalidValue for sizes the kernel does not
// take, otherwise cudaGetLastError() right after the launch.
extern "C" int m3_reweight_backward(
    const void* seg, const void* t, const void* coeffs, int coef_bf16, const void* base_w,
    int bins_kind, const void* bins, const void* kin, const void* shift_vals,
    const void* static_base, const void* edges, const void* cells, const int* desc,
    const void* gmc, const void* gw2, const void* plan_ptr, const void* plan_idx, void* gbase,
    void* partial, int C, int P, int K4, int E, int n_bins, int event_tile, int chain_tile,
    void* stream) {
  if (plan_ptr == nullptr || plan_idx == nullptr) plan_ptr = plan_idx = nullptr;
  const bool by_map = bins_kind == kBinsMap;
  m3::BinMap map{};
  const int n_tiles = E > 0 ? (E + kEventTile - 1) / kEventTile : 0;
  if (C <= 0 || E <= 0 || P <= 0 || P > kMaxParams || K4 <= 0 || K4 % 4 != 0 ||
      K4 / 4 > m3::kMaxKnots || n_bins <= 0 || bins_kind < kBinsShared ||
      bins_kind > kBinsMap || (!by_map && bins == nullptr) ||
      (by_map && (!m3::parse_bin_map(desc, &map) || kin == nullptr || static_base == nullptr ||
                  edges == nullptr || (map.n_shifts > 0 && shift_vals == nullptr) ||
                  (map.n_cells > 0 && cells == nullptr))) ||
      event_tile != kEventTile || chain_tile != kChainTile || n_tiles > kMaxTiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t coef_size = coef_bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  const bool need_t = partial != nullptr;
  const size_t smem =
      m3::core_bytes(coef_size, P, K4) +
      (need_t ? (static_cast<size_t>(kWarps) * kChainTile + 1) * P * 4 : 0) +
      (by_map ? 4 * (static_cast<size_t>(map.n_axes) * map.edge_pitch +
                     static_cast<size_t>(map.n_shifts) * kChainTile +
                     static_cast<size_t>(map.n_axes) * kThreads + map.n_cells)
              : 0);
  if (smem + sizeof(m3::BinMap) > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int*>(seg), static_cast<const float*>(t), coeffs,
               static_cast<const float*>(base_w), static_cast<const int*>(bins),
               static_cast<const float*>(kin), static_cast<const float*>(shift_vals),
               static_cast<const int*>(static_base), static_cast<const float*>(edges),
               static_cast<const int*>(cells), map, static_cast<const float*>(gmc),
               static_cast<const float*>(gw2), static_cast<const int*>(plan_ptr),
               static_cast<const int*>(plan_idx), static_cast<float*>(gbase),
               static_cast<float*>(partial), C, P, K4, E, n_bins,
               (static_cast<size_t>(E) * coef_size) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(coeffs) % 16 == 0};
  const dim3 grid((C + kChainTile - 1) / kChainTile, n_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kind = by_map && map.n_axes == 1 && map.n_shifts == 1 ? kBinsAxis : bins_kind;
  switch (kind) {
    case kBinsShared:
      return static_cast<int>(dispatch<kBinsShared>(coef_bf16, need_t, smem, grid, s, a));
    case kBinsPerChain:
      return static_cast<int>(dispatch<kBinsPerChain>(coef_bf16, need_t, smem, grid, s, a));
    case kBinsAxis:
      return static_cast<int>(dispatch<kBinsAxis>(coef_bf16, need_t, smem, grid, s, a));
    default:
      return static_cast<int>(dispatch<kBinsMap>(coef_bf16, need_t, smem, grid, s, a));
  }
}

extern "C" const char* m3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
