// Fused spline-reweight + per-chain binning + Σw/Σw² histogram for Hopper:
// the forward kernel of every route whose bins move with θ.
//
// Replaces four TPU kernels of mach3_tpu/splines/pallas_reweight.py:
//  * K1, _kernel_maskreduce_shifted (with _resp_dot, _norm_weight and
//    _shifted_bin_histogram), reached through
//    fused_reweight_histogram_shifted, and K3, _kernel_shifted_blocked (the
//    same function with P streamed through VMEM in blocks of 8; here the
//    list of a tile's items takes the place of the blocks): entry
//    m3_reweight_shifted, one shifted axis binned in-kernel;
//  * K5, _kernel_maskreduce (fused_reweight_histogram, hist="maskreduce"):
//    entry m3_reweight_perchain, the generic route's bins formed in-kernel
//    from a bin map or given as input [C, E];
//  * K5b, _kernel (hist="blockdiag", a radix block-diagonal MXU histogram
//    with the same output): entry m3_reweight_perchain_det, the same
//    function through a histogram summed in a fixed order.
// They are one kernel with two bin sources and two histogram tails. It
// computes, per (chain c, event e):
//
//   w   = base[c,e] · exp(Σ_k log|ext[c,k]|·S[k,e]) · (−1)^(Σ_k neg[c,k]·S[k,e])
//         · Π_{p active in e's tile} resp_p
//   bin = m3::perchain_bin (spline_response.cuh): each binned axis that
//         named shifts move, x = kin[row, e] moved by them in order
//           x · (1 + v[c])                 (shift kind "scale")
//           x + v[c]                       ("offset")
//           1 + (x − 1) · (1 + v[c])       ("scale_about_one"),
//         idx = #(edges ≤ x) − 1; bin = static[e] + Σ stride·idx, through
//         the cell map of a hyper-rectangle binning; dropped when some idx
//         ∉ [0, n_axis), static[e] < 0 or the cell is a gap. The shifted
//         route is the map of one axis and one shift. Or bin = bins[c, e]
//         (a sample whose shifts are torch code), dropped outside
//         [0, n_bins).
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
// Binning: each shifted value is formed with __fadd_rn/__fsub_rn/__fmul_rn,
// one rounding per operation in the plain version's order, so it cannot be
// contracted into an FMA and lands in the same bin as the f32 reference
// (splines/reweight.py perchain_bins_ref, and SampleModel._perchain_bins).
// The edge counts are binary searches over the edges staged in shared
// memory; a NaN x compares false everywhere, gives idx = −1 and so is
// dropped. An event of weight 0 (a pad of the layout, an event whose bin is
// dropped) adds nothing and skips the search.
//
// A block is kChainTile = 16 chains by `tiles` consecutive event tiles
// (1 on the shifted route; the per-chain entries take 8, 2048 events, so
// that a block flushes its histogram once for 8 tiles: the generic route's
// samples have hundreds of bins and an event or two per (chain, bin) in one
// tile). blockIdx.x runs over the chain tiles so that the blocks that read
// one tile's coefficients run side by side and share them in L2. Per tile,
// the response product is m3::TileCore (spline_response.cuh): the 16
// chains' weights of a thread's event in registers (starting from base ·
// norm), the tile's (parameter, segment, chain mask) items staged through a
// 3-stage shared-memory ring by 16-byte cp.async (plain loads for a table
// whose rows are not 16-byte aligned). Then the weights are parked in
// shared memory as [event][chain] and the threads regroup as (chain, 16
// consecutive events):
//  * atomics tail (K1, K3, K5): each thread bins its events and adds runs of
//    equal bins, summed in registers, to a [kChainTile][2·B + 1]
//    shared-memory histogram by float atomicAdd; lanes of a warp add into 16
//    different chains' histograms (the odd pitch puts them on 16 banks), so
//    an atomic (a compare-and-swap loop in shared memory) meets at most one
//    other lane. After the block's tiles, one global atomicAdd per non-empty
//    (chain, bin). The order of the sums changes from run to run;
//  * deterministic tail (K5b): the threads bin their events into shared
//    memory; then warp w adds chains w and w + 8, 32 events a step in event
//    order: the lanes of one bin are grouped (__match_any_sync), the group's
//    lowest lane sums their weights in lane order and adds the sums to the
//    same histogram with plain adds (a step's groups have distinct bins: one
//    writer per entry, no atomics). After the block's tiles it writes its
//    histogram as a partial [blockIdx.y, 2, C, B]; the wrapper sums the
//    partials over blocks with torch.sum. The result is the same bit for bit
//    on every run, as the TPU's sequential grid was.
//
// What bounds it on this card, and what the design does about each:
//  * the function's bound is bytes: base_w (C·E·4), the bin source (a few
//    [E] rows of the map, or the [C, E] bins), the norm match counts and the
//    table's active rows, once. The generic route's [C, E] bins and norm
//    gather, formed by plain torch ops before this kernel, are gone from the
//    path with the map;
//  * what a block does once per tile, whatever its items: the dependent
//    global reads of its plan, (seg, t), norm values and event rows, three
//    barriers to list the items; per block: the histogram's zeroing and its
//    flush (up to 2·B global atomics a chain), which the generic route's
//    blocks share over 2 (atomics) or 8 (deterministic) tiles. A tile's work
//    is mostly waiting, so resident blocks are the lever: with a histogram
//    of hundreds of bins (numu_2d: 31 KB) an f32 table takes the small ring
//    (16 KB) so that four blocks fit;
//  * instruction slots: the response loop (~5 instructions per (item, chain)
//    and thread) and the tail (per (chain, event) and shifted axis a binary
//    search of log2(edges) shared-memory reads, interleaved over kBatch
//    events; the deterministic tail's grouping of 32 events a warp step);
//  * the coefficient reads: each block copies each row it needs once (the
//    distinct segments of its 16 chains), ahead of use; the chain tiles of a
//    tile run side by side, so device memory sees each active row about once
//    a call.
//
// Limits: n_bins ≤ 512, edges ≤ 1025 an axis, 4 shifted axes and 8 shifts a
// map, P ≤ 256, NA+1 ≤ 256, K4 / 4 ≤ 64 knots, and the block's shared
// memory (the ring: 24 KB for bf16, 32 or 16 KB for f32; the histogram; 136
// bytes per parameter, 8 per possible item, 128 per norm slot; the map's
// edges, event rows and cells; the parked bins of the bins input and of the
// deterministic tail, 17 KB) ≤ 227 KB. The shifted entry takes tables whose
// rows start on 16-byte boundaries only (a laid-out sample's).
//
// Occupancy: registers are capped at 64 a thread (four blocks of 256
// threads to an SM where shared memory allows; a few spilled words) because
// a block waits more than it computes: on an H100 (700 W) four resident
// blocks beat three by 5% on the reference-scale nue_beam (P = 43) and by
// 12-13% on the toy (P = 4).
//
// Launch: grid (ceil(C / kChainTile), ceil(T / tiles)) for T event tiles,
// kThreads threads, on the caller's stream. It allocates nothing; mc and w2
// must be zeroed [C, n_bins] f32 arrays. The entries return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "spline_response.cuh"

namespace {

constexpr int kChainTile = m3::kTileChains;
constexpr int kThreads = m3::kTileEvents;
constexpr int kEventTile = kThreads;  // one event per thread
constexpr int kPitch = m3::kWeightPitch;
constexpr int kMaxBins = 512;
constexpr int kMaxParams = m3::kMaxTileParams;
constexpr int kMaxNorm = 256;
constexpr int kMaxGrid = 65535;  // gridDim.y
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on Hopper
constexpr unsigned kFullMask = 0xffffffffu;
// The tile core's ring (kSmall: the small f32 ring). bf16 rows: three
// stages of four items (24 KB). f32 rows: two stages of four (32 KB) or,
// where the rest of a block's shared memory (a histogram of hundreds of
// bins) would leave room for fewer than four resident blocks with those, two
// of two (16 KB: just the parked weights, parked swizzled; see parked()).
// The small ring gives numu_2d of the experiment a fourth block and costs
// the index arithmetic of the swizzle elsewhere (PERF.md §6).
template <typename CoefT, bool kSmall>
constexpr int kRingOf = sizeof(CoefT) == 4 ? 2 : m3::kStages;
template <typename CoefT, bool kSmall>
constexpr int kItemsOf = sizeof(CoefT) == 4 && kSmall ? 2 : m3::kItemsPerStage;

// Where the weight of (event ev, chain c) is parked in the ring: [event][17]
// floats (m3::TileCore::park) or, in the small ring, [event][16] with the
// chains swizzled by the event, so that a warp writing one chain of 32
// consecutive events, and two half-warps reading 16 chains of one event each
// (events of opposite parity, see the tail), touch 32 different banks.
template <bool kSmall>
__device__ __forceinline__ int parked(int ev, int c) {
  if constexpr (kSmall) {
    return ev * kChainTile + (c ^ ((ev ^ (ev >> 4)) & (kChainTile - 1)));
  } else {
    return ev * kPitch + c;
  }
}

struct Args {
  const int* seg;
  const float* t;
  const void* coeffs;
  const float* base_w;
  const int* bins;           // [C, E] (bins input)
  const float* kin;          // [V, E] (bin map): the rows map.row
  const float* shift_vals;   // [C, map.n_shifts]
  const int* statics;        // [E]
  const float* edges;        // [map.n_axes][map.edge_pitch]
  const int* cells;          // [map.n_cells]
  m3::BinMap map;
  const int* plan_ptr;
  const int* plan_idx;
  const float* norm_ext;
  const float* norm_s;
  int na1;
  float* mc;       // atomics tail: [C, n_bins]
  float* w2;
  float* partial;  // deterministic tail: [gridDim.y, 2, C, n_bins]
  int C, P, K4, E, n_bins;
  int tiles;       // event tiles of a block
  bool aligned;    // the table's rows start on 16-byte boundaries
};

// Floats of shared memory past the tile core: norm arrays, histogram, the
// parked bins (bins input or deterministic tail), the map's edges, shift
// factors, event rows, static parts and cells.
size_t extra_floats(const Args& a, bool map, bool det) {
  size_t n = static_cast<size_t>(kChainTile) * (2 * a.na1 + 2 * a.n_bins + 1);
  if (det || !map) n += static_cast<size_t>(kThreads) * kPitch;
  if (map) {
    const m3::BinMap& m = a.map;
    n += static_cast<size_t>(m.n_axes) * m.edge_pitch + static_cast<size_t>(m.n_shifts) * kChainTile +
         static_cast<size_t>(m.n_axes + 1) * kThreads + m.n_cells;
  }
  return n;
}

// Where a thread's bins come from (the kernel's kSource): the bins given
// [C, E]; a bin map read per event (m3::perchain_bin: several shifts on an
// axis, or more than two axes); or a map of 1 or 2 axes with one shift
// each, its fields held in registers and the events' searches interleaved.
constexpr int kGiven = -1;
constexpr int kAnyMap = 0;
constexpr int kBatch = 4;  // events of a thread binned together in the tail

// The fields of a map of kAxes axes with one shift each that a thread's
// chain needs, in registers.
template <int kAxes>
struct ChainMap {
  const float* edges[kAxes];
  int n_edges[kAxes];
  int top[kAxes];  // the largest power of two ≤ n_edges
  int stride[kAxes];
  int kind[kAxes];
  float fac[kAxes];

  ChainMap() = default;
  __device__ __forceinline__ ChainMap(const m3::BinMap& m, const float* sh_edges,
                                      const float* sh_fac, int c) {
#pragma unroll
    for (int a = 0; a < kAxes; ++a) {
      edges[a] = sh_edges + a * m.edge_pitch;
      n_edges[a] = m.n_edges[a];
      top[a] = 1 << (31 - __clz(m.n_edges[a]));
      stride[a] = m.stride[a];
      kind[a] = m.kind[a];
      fac[a] = sh_fac[a * kChainTile + c];
    }
  }

  // The bins of kBatch consecutive events from ev (−1: dropped): the
  // searches of the batch interleaved, each a fixed number of halvings
  // (#(edges ≤ x): a NaN x counts 0, as in m3::edges_le).
  __device__ __forceinline__ void bins(const float* sh_x, const int* sh_sb, int ev,
                                       const int* cells, int n_cells,
                                       int (&bin)[kBatch]) const {
    int flat[kBatch];
    bool ok[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      flat[j] = sh_sb[ev + j];
      ok[j] = flat[j] >= 0;
    }
#pragma unroll
    for (int a = 0; a < kAxes; ++a) {
      float x[kBatch];
      int lo[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        x[j] = m3::shift_x(kind[a], sh_x[a * kThreads + ev + j], fac[a]);
        lo[j] = 0;
      }
      for (int step = top[a]; step > 0; step >>= 1) {
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int m = lo[j] + step;
          if (m <= n_edges[a] && edges[a][m - 1] <= x[j]) lo[j] = m;
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        ok[j] = ok[j] && lo[j] >= 1 && lo[j] < n_edges[a];
        flat[j] += stride[a] * (lo[j] - 1);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      bin[j] = !ok[j] ? -1 : n_cells == 0 ? flat[j] : flat[j] < n_cells ? cells[flat[j]] : -1;
    }
  }
};

template <typename CoefT, bool kHasNorm, int kSource, bool kDet, bool kSmall>
__global__ void __launch_bounds__(kThreads, 4) reweight_perchain_kernel(const Args a) {
  constexpr bool kMap = kSource != kGiven;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ m3::BinMap map;
  m3::TileCore<CoefT, kRingOf<CoefT, kSmall>, kItemsOf<CoefT, kSmall>> core;
  static_assert(!kSmall || sizeof(CoefT) * kRingOf<CoefT, kSmall> * kItemsOf<CoefT, kSmall> * 4 ==
                               sizeof(float) * kChainTile,
                "the small ring holds the swizzled parked weights");
  float* sh_logext = reinterpret_cast<float*>(core.carve(smem_raw, a.P, a.K4));  // [na1][CT]
  float* sh_neg = sh_logext + kChainTile * a.na1;                                // [na1][CT]
  float* hist = sh_neg + kChainTile * a.na1;                                     // [CT][hp]
  const int hp = 2 * a.n_bins + 1;  // odd: lanes over chains hit 16 different banks
  int* sh_bin = reinterpret_cast<int*>(hist + kChainTile * hp);  // [kThreads][kPitch]
  float* sh_edges =
      reinterpret_cast<float*>(sh_bin + (kDet || !kMap ? kThreads * kPitch : 0));
  float* sh_fac = sh_edges + (kMap ? a.map.n_axes * a.map.edge_pitch : 0);  // [n_shifts][CT]
  float* sh_x = sh_fac + (kMap ? a.map.n_shifts * kChainTile : 0);          // [n_axes][kThreads]
  int* sh_sb = reinterpret_cast<int*>(sh_x + (kMap ? a.map.n_axes * kThreads : 0));  // [kThreads]
  int* sh_cell = sh_sb + (kMap ? kThreads : 0);                                     // [n_cells]

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kChainTile;
  const int nct = min(kChainTile, a.C - c0);
  const int tile0 = blockIdx.y * a.tiles;
  const int tile1 = min((a.E + kEventTile - 1) / kEventTile, tile0 + a.tiles);
  const CoefT* coeffs = static_cast<const CoefT*>(a.coeffs);
  const size_t es = static_cast<size_t>(a.E);

  for (int i = tid; i < kChainTile * hp; i += kThreads) hist[i] = 0.f;
  if (kHasNorm) m3::norm_prepare(sh_logext, sh_neg, a.norm_ext, c0, nct, a.na1);
  if (kMap) {
    m3::stage_bin_map(map, a.map, a.edges, a.cells, a.shift_vals, c0, nct, sh_edges, sh_cell,
                      sh_fac);
  }

  for (int tile = tile0; tile < tile1; ++tile) {
    const int e0 = tile * kEventTile;
    const int p_begin = a.plan_ptr ? a.plan_ptr[tile] : 0;
    const int nact = a.plan_ptr ? a.plan_ptr[tile + 1] - p_begin : a.P;
    // Its barriers also order this tile's writes after the last tile's tail.
    const int n_items = core.prepare(a.seg, a.t, a.plan_ptr ? a.plan_idx + p_begin : nullptr,
                                     nact, c0, nct, a.P, a.K4);

    const int e = e0 + tid;
    const bool live = e < a.E;
    const int sb = live ? (kMap ? a.statics[e] : 0) : -1;
    // The event's values on the map's axes, loaded while the product runs.
    constexpr int kRows = kSource > 0 ? kSource : (kMap ? m3::kMaxMapAxes : 0);
    float xr[kRows > 0 ? kRows : 1];
#pragma unroll
    for (int ax = 0; ax < kRows; ++ax) {
      xr[ax] = live && ax < map.n_axes ? a.kin[static_cast<size_t>(map.row[ax]) * es + e] : 0.f;
    }
    core.start(coeffs, es, a.E, e0, n_items, a.aligned);
    float w[kChainTile];
    if (kHasNorm && live) {
      m3::norm_factor(sh_logext, sh_neg, a.norm_s, es, e, a.na1, w);
    } else {
#pragma unroll
      for (int c = 0; c < kChainTile; ++c) w[c] = 1.f;
    }
#pragma unroll
    for (int c = 0; c < kChainTile; ++c) {
      bool keep = sb >= 0 && c < nct;
      int b = -1;
      if (keep) {
        const size_t o = static_cast<size_t>(c0 + c) * es + e;
        if (!kMap) {
          b = a.bins[o];
          keep = b >= 0 && b < a.n_bins;
        }
        if (keep) w[c] *= a.base_w[o];
      }
      // A dropped event weighs 0 here, but the responses of an event past E
      // are the ring's stale contents and may make it NaN: its bin is −1.
      if (!kMap) sh_bin[tid * kPitch + c] = keep ? b : -1;
      if (!keep) w[c] = 0.f;
    }
    core.multiply(coeffs, es, a.E, e0, n_items, w, a.aligned);

    // The tail (spline_response.cuh): this thread's chain and 16 consecutive
    // events, kBatch at a time; the map's event rows staged for it.
    if (kMap) {
#pragma unroll
      for (int ax = 0; ax < kRows; ++ax) {
        if (ax < map.n_axes) sh_x[ax * kThreads + tid] = xr[ax];
      }
      sh_sb[tid] = sb;
    }
    float* sh_w;
    if constexpr (kSmall) {
      __syncthreads();  // every thread has left the ring
      sh_w = reinterpret_cast<float*>(core.ring);
#pragma unroll
      for (int c = 0; c < kChainTile; ++c) sh_w[parked<true>(tid, c)] = w[c];
      __syncthreads();
    } else {
      sh_w = core.park(w);
    }
    const int c = tid % kChainTile;
    const int ev0 = (tid / kChainTile) * m3::kTailEvents;
    // In the small ring the second half-warp takes each pair of its events
    // in the other order, so that the two halves read events of opposite
    // parity together.
    const int h = kSmall ? (tid / kChainTile) & 1 : 0;
    ChainMap<(kSource > 0 ? kSource : 1)> regs;
    if constexpr (kSource > 0) regs = decltype(regs)(map, sh_edges, sh_fac, c);
    // The bins of events ev .. ev + kBatch − 1 of this thread's chain.
    auto batch_bins = [&](int ev, int (&bin)[kBatch]) {
      if constexpr (kSource == kGiven) {
#pragma unroll
        for (int j = 0; j < kBatch; ++j) bin[j] = sh_bin[(ev + j) * kPitch + c];
      } else if constexpr (kSource == kAnyMap) {
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          bin[j] = m3::perchain_bin(map, sh_x + ev + j, kThreads, sh_fac + c, kChainTile,
                                    sh_sb[ev + j], sh_edges, sh_cell);
        }
      } else {
        regs.bins(sh_x, sh_sb, ev, sh_cell, map.n_cells, bin);
      }
    };
    if (!kDet) {
      if (c < nct) {
        float* hc = hist + c * hp;
        int cur = -1;
        float sw = 0.f;
        float sq = 0.f;
        for (int k = 0; k < m3::kTailEvents; k += kBatch) {
          float wv[kBatch];
          int bin[kBatch];
#pragma unroll
          for (int j = 0; j < kBatch; ++j) wv[j] = sh_w[parked<kSmall>(ev0 + k + (j ^ h), c)];
          batch_bins(ev0 + k, bin);
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            const int b = h ? bin[j ^ 1] : bin[j];
            if (wv[j] == 0.f || b < 0 || b >= a.n_bins) continue;
            if (b != cur) {
              if (cur >= 0) {
                atomicAdd(hc + cur, sw);
                atomicAdd(hc + a.n_bins + cur, sq);
              }
              cur = b;
              sw = 0.f;
              sq = 0.f;
            }
            sw += wv[j];
            sq += wv[j] * wv[j];
          }
        }
        if (cur >= 0) {
          atomicAdd(hc + cur, sw);
          atomicAdd(hc + a.n_bins + cur, sq);
        }
      }
    } else {
      if (kMap && c < nct) {
        for (int k = 0; k < m3::kTailEvents; k += kBatch) {
          int bin[kBatch];
          batch_bins(ev0 + k, bin);
#pragma unroll
          for (int j = 0; j < kBatch; ++j) sh_bin[(ev0 + k + j) * kPitch + c] = bin[j];
        }
      }
      __syncthreads();
      // Warp w adds chains w and w + 8, 32 events a step in event order: the
      // lanes of one bin are grouped (__match_any_sync) and the group's
      // lowest lane adds their weights in lane order, then to the histogram;
      // a step's groups have distinct bins, so no two lanes write one entry.
      const int lane = tid & 31;
      for (int cc = tid >> 5; cc < nct; cc += kThreads / 32) {
        float* hc = hist + cc * hp;
        for (int ev = lane; ev < kEventTile; ev += 32) {
          const float wv = sh_w[parked<kSmall>(ev, cc)];
          int key = sh_bin[ev * kPitch + cc];
          if (wv == 0.f || key < 0 || key >= a.n_bins) key = -1;
          const unsigned peers = __match_any_sync(kFullMask, key);
          if (key >= 0 && lane == __ffs(static_cast<int>(peers)) - 1) {
            float sw = 0.f;
            float sq = 0.f;
            for (unsigned m = peers; m != 0; m &= m - 1) {
              const float v =
                  sh_w[parked<kSmall>(ev - lane + __ffs(static_cast<int>(m)) - 1, cc)];
              sw += v;
              sq += v * v;
            }
            hc[key] += sw;
            hc[a.n_bins + key] += sq;
          }
        }
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < nct * a.n_bins; i += kThreads) {
    const int c = i / a.n_bins;
    const int b = i - c * a.n_bins;
    const float m = hist[c * hp + b];
    const float q = hist[c * hp + a.n_bins + b];
    if (kDet) {
      const size_t o = (static_cast<size_t>(blockIdx.y) * 2 * a.C + c0 + c) * a.n_bins + b;
      a.partial[o] = m;
      a.partial[o + static_cast<size_t>(a.C) * a.n_bins] = q;
    } else {
      const size_t o = static_cast<size_t>(c0 + c) * a.n_bins + b;
      if (m != 0.f) atomicAdd(a.mc + o, m);
      if (q != 0.f) atomicAdd(a.w2 + o, q);
    }
  }
}

template <typename CoefT, bool kHasNorm, int kSource, bool kDet, bool kSmall = false>
cudaError_t launch(size_t smem, dim3 grid, cudaStream_t stream, const Args& a) {
  auto kernel = reweight_perchain_kernel<CoefT, kHasNorm, kSource, kDet, kSmall>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int kSource, bool kDet>
cudaError_t dispatch(bool bf16, bool small, size_t smem, dim3 grid, cudaStream_t s,
                     const Args& a) {
  const bool norm = a.norm_ext != nullptr;
  if (bf16) {
    return norm ? launch<__nv_bfloat16, true, kSource, kDet>(smem, grid, s, a)
                : launch<__nv_bfloat16, false, kSource, kDet>(smem, grid, s, a);
  }
  if (small) {
    return norm ? launch<float, true, kSource, kDet, true>(smem, grid, s, a)
                : launch<float, false, kSource, kDet, true>(smem, grid, s, a);
  }
  return norm ? launch<float, true, kSource, kDet>(smem, grid, s, a)
              : launch<float, false, kSource, kDet>(smem, grid, s, a);
}

// The kernel's kSource for a bin map: its axes held in registers when there
// are at most two with one shift each.
int map_source(const m3::BinMap& m) {
  for (int ax = 0; ax < m.n_axes; ++ax) {
    if (m.first[ax + 1] - m.first[ax] != 1) return kAnyMap;
  }
  return m.n_axes <= 2 ? m.n_axes : kAnyMap;
}

// Checks the sizes every form shares and launches; cudaErrorInvalidValue
// for what the kernel does not take.
cudaError_t run(Args a, bool bf16, bool map, bool det, int event_tile, int chain_tile,
                void* stream) {
  if (a.norm_ext == nullptr || a.norm_s == nullptr) {
    a.norm_ext = a.norm_s = nullptr;
    a.na1 = 0;
  }
  if (a.plan_ptr == nullptr || a.plan_idx == nullptr) a.plan_ptr = a.plan_idx = nullptr;
  const int n_tiles = a.E > 0 ? (a.E + kEventTile - 1) / kEventTile : 0;
  if (a.C <= 0 || a.E <= 0 || a.P <= 0 || a.P > kMaxParams || a.K4 <= 0 || a.K4 % 4 != 0 ||
      a.K4 / 4 > m3::kMaxKnots || a.n_bins <= 0 || a.n_bins > kMaxBins || a.na1 < 0 ||
      a.na1 > kMaxNorm || a.tiles < 1 || event_tile != kEventTile || chain_tile != kChainTile ||
      (n_tiles + a.tiles - 1) / a.tiles > kMaxGrid || (!map && a.bins == nullptr) ||
      (det && a.partial == nullptr) || (!det && (a.mc == nullptr || a.w2 == nullptr))) {
    return cudaErrorInvalidValue;
  }
  const size_t coef_size = bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  a.aligned = (static_cast<size_t>(a.E) * coef_size) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(a.coeffs) % 16 == 0;
  const size_t rest = 4 * extra_floats(a, map, det);
  const size_t with_big = bf16 ? m3::core_bytes(coef_size, a.P, a.K4) + rest
                               : m3::core_bytes(coef_size, a.P, a.K4, kRingOf<float, false>,
                                                kItemsOf<float, false>) + rest;
  const bool small = !bf16 && 4 * (with_big + sizeof(m3::BinMap)) > kMaxSmem;
  const size_t smem = small ? m3::core_bytes(coef_size, a.P, a.K4, kRingOf<float, true>,
                                             kItemsOf<float, true>) + rest
                            : with_big;
  if (smem + sizeof(m3::BinMap) > kMaxSmem) return cudaErrorInvalidValue;
  const dim3 grid((a.C + kChainTile - 1) / kChainTile, (n_tiles + a.tiles - 1) / a.tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (map ? map_source(a.map) : kGiven) {
    case kGiven:
      return det ? dispatch<kGiven, true>(bf16, small, smem, grid, s, a)
                 : dispatch<kGiven, false>(bf16, small, smem, grid, s, a);
    case 1:
      return det ? dispatch<1, true>(bf16, small, smem, grid, s, a)
                 : dispatch<1, false>(bf16, small, smem, grid, s, a);
    case 2:
      return det ? dispatch<2, true>(bf16, small, smem, grid, s, a)
                 : dispatch<2, false>(bf16, small, smem, grid, s, a);
    default:
      return det ? dispatch<kAnyMap, true>(bf16, small, smem, grid, s, a)
                 : dispatch<kAnyMap, false>(bf16, small, smem, grid, s, a);
  }
}

}  // namespace

// Plain C entries for ctypes. coeffs is f32 (coef_bf16 == 0) or bf16;
// norm_ext and norm_s may be null (na1 is then ignored); plan_ptr and
// plan_idx may be null (every parameter on every tile). event_tile and
// chain_tile must equal the kernel's (the plan was built for the first, the
// caller sized the shared memory with the second). Each returns a
// cudaError_t code: cudaErrorInvalidValue for sizes the kernel does not take
// (the header's limits), otherwise cudaGetLastError() right after the launch.

// The shifted route: the bin map of one axis, x_nom [E], with one shift of
// kind shift_kind valued shift_vals [C]; tables with 16-byte aligned rows.
extern "C" int m3_reweight_shifted(
    const void* seg, const void* t, const void* coeffs, int coef_bf16,
    const void* base_w, const void* shift_vals, const void* x_nom,
    const void* static_base, const void* edges, int n_edges,
    const void* plan_ptr, const void* plan_idx,
    const void* norm_ext, const void* norm_s, int na1, void* mc, void* w2,
    int C, int P, int K4, int E, int n_bins, int stride_j, int n_axis_j,
    int shift_kind, int event_tile, int chain_tile, void* stream) {
  const int desc[] = {1, 1, n_edges, 0, 0, n_edges, stride_j, 0, shift_kind};
  Args a{};
  if (n_axis_j != n_edges - 1 || !m3::parse_bin_map(desc, &a.map)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t coef_size = coef_bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  if ((static_cast<size_t>(E) * coef_size) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(coeffs) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.seg = static_cast<const int*>(seg);
  a.t = static_cast<const float*>(t);
  a.coeffs = coeffs;
  a.base_w = static_cast<const float*>(base_w);
  a.kin = static_cast<const float*>(x_nom);
  a.shift_vals = static_cast<const float*>(shift_vals);
  a.statics = static_cast<const int*>(static_base);
  a.edges = static_cast<const float*>(edges);
  a.plan_ptr = static_cast<const int*>(plan_ptr);
  a.plan_idx = static_cast<const int*>(plan_idx);
  a.norm_ext = static_cast<const float*>(norm_ext);
  a.norm_s = static_cast<const float*>(norm_s);
  a.na1 = na1;
  a.mc = static_cast<float*>(mc);
  a.w2 = static_cast<float*>(w2);
  a.C = C;
  a.P = P;
  a.K4 = K4;
  a.E = E;
  a.n_bins = n_bins;
  a.tiles = 1;
  return static_cast<int>(run(a, coef_bf16 != 0, true, false, event_tile, chain_tile, stream));
}

// The generic route: bins [C, E] int32 given (desc null; kin, shift_vals,
// static_base, edges and cells ignored), or formed from the bin map that
// the host descriptor desc describes (bins null; kin [V, E], shift_vals [C,
// n_shifts], static_base [E], edges [n_axes, edge_pitch], cells [n_cells]
// or null). Any row pitch of the table. A block walks `tiles` event tiles.
// Without partial (null) the atomics tail adds into the zeroed mc and w2
// [C, n_bins]; with it the deterministic tail writes every entry of partial
// [ceil(ceil(E / event_tile) / tiles), 2, C, n_bins].
#define M3_PERCHAIN_PARAMS                                                                   \
  const void *seg, const void *t, const void *coeffs, int coef_bf16, const void *base_w,     \
      const void *bins, const void *kin, const void *shift_vals, const void *static_base,    \
      const void *edges, const void *cells, const int *desc, const void *plan_ptr,           \
      const void *plan_idx, const void *norm_ext, const void *norm_s, int na1, int C, int P, \
      int K4, int E, int n_bins, int event_tile, int chain_tile, int tiles, void *stream

namespace {

int perchain(M3_PERCHAIN_PARAMS, float* mc, float* w2, float* partial) {
  Args a{};
  const bool map = bins == nullptr;
  if (map && !m3::parse_bin_map(desc, &a.map)) return static_cast<int>(cudaErrorInvalidValue);
  a.seg = static_cast<const int*>(seg);
  a.t = static_cast<const float*>(t);
  a.coeffs = coeffs;
  a.base_w = static_cast<const float*>(base_w);
  a.bins = static_cast<const int*>(bins);
  a.kin = static_cast<const float*>(kin);
  a.shift_vals = static_cast<const float*>(shift_vals);
  a.statics = static_cast<const int*>(static_base);
  a.edges = static_cast<const float*>(edges);
  a.cells = static_cast<const int*>(cells);
  if (map && (a.kin == nullptr || a.statics == nullptr || a.edges == nullptr ||
              (a.map.n_shifts > 0 && a.shift_vals == nullptr) ||
              (a.map.n_cells > 0 && a.cells == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.plan_ptr = static_cast<const int*>(plan_ptr);
  a.plan_idx = static_cast<const int*>(plan_idx);
  a.norm_ext = static_cast<const float*>(norm_ext);
  a.norm_s = static_cast<const float*>(norm_s);
  a.na1 = na1;
  a.mc = mc;
  a.w2 = w2;
  a.partial = partial;
  a.C = C;
  a.P = P;
  a.K4 = K4;
  a.E = E;
  a.n_bins = n_bins;
  a.tiles = tiles;
  return static_cast<int>(
      run(a, coef_bf16 != 0, map, partial != nullptr, event_tile, chain_tile, stream));
}

}  // namespace

extern "C" int m3_reweight_perchain(M3_PERCHAIN_PARAMS, void* mc, void* w2) {
  return perchain(seg, t, coeffs, coef_bf16, base_w, bins, kin, shift_vals, static_base, edges,
                  cells, desc, plan_ptr, plan_idx, norm_ext, norm_s, na1, C, P, K4, E, n_bins,
                  event_tile, chain_tile, tiles, stream, static_cast<float*>(mc),
                  static_cast<float*>(w2), nullptr);
}

extern "C" int m3_reweight_perchain_det(M3_PERCHAIN_PARAMS, void* partial) {
  if (partial == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return perchain(seg, t, coeffs, coef_bf16, base_w, bins, kin, shift_vals, static_base, edges,
                  cells, desc, plan_ptr, plan_idx, norm_ext, norm_s, na1, C, P, K4, E, n_bins,
                  event_tile, chain_tile, tiles, stream, nullptr, nullptr,
                  static_cast<float*>(partial));
}

#undef M3_PERCHAIN_PARAMS

extern "C" const char* m3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
