// Device helpers shared by the reweight kernels of this directory, forward
// and backward.
//
// A spline response is evaluated from its segment's 4 coefficient rows
// seg*4 + (0..3) of coeffs[p, :, e] — (y, b, c, d) — and one f32 Horner
// step, resp = y + t(b + t(c + t·d)); bf16 tables are upcast on load. seg is
// trusted to lie in [0, n_knots − 2], as find_segments clamps it (the tile
// core below clamps it into the table besides).
//
//  * TileCore: the response product of one tile of kTileEvents events (one
//    per thread) by kTileChains chains, parameter-outer, with the chains'
//    running products in registers (reweight_shared.cu, reweight_shifted.cu,
//    reweight_backward.cu).
//    The work of a tile is a list of items (active parameter, segment, the
//    16-bit mask of the tile's chains that sit in that segment): only
//    segments some chain is in are listed, ascending, so a parameter whose
//    chains straddle a knot gives two items. An item's 4 coefficient rows for
//    the tile's events (2 KB in bf16, 4 KB in f32) are copied into shared
//    memory with 16-byte cp.async, kItems items to a stage (kItemsPerStage
//    = 4 by default), in a ring of kRing stages (kStages = 3 by default): the
//    rows of the next
//    kRing − 1 stages are in flight while this one's are used, the addresses
//    depend on no chain, and each row leaves L2 once per block instead of
//    once per chain. A thread then reads
//    its event's 4 coefficients from shared memory (consecutive lanes,
//    consecutive events: no bank conflict), the item's 16 t values as four
//    broadcast float4 reads, and multiplies the response into w[c] for each
//    chain of the mask (a warp-uniform predicate). Nothing in the loop
//    depends on a load from global memory.
//
//    What bounds the loop: instruction slots. Per item and thread 4 + 4 + 1
//    shared-memory reads, 4 conversions and, per chain, one predicate and
//    four FMA-pipe instructions, whether the chain is in the item's segment
//    or not; so chains split over two segments cost twice the FMA slots of
//    chains in one.
//
//    Tables whose row starts are 16-byte aligned (the table's base pointer
//    and its row pitch E·sizeof(CoefT) multiples of 16: any laid-out table)
//    are copied by cp.async. The per-chain forward form and the backward
//    kernel also take any other table (a sample that is not laid out): with
//    `aligned` false a stage is copied one element a thread at a time with
//    plain loads and shared-memory stores, which the stage's barrier orders
//    like the asynchronous copies.
//
//  * The per-chain binning (BinMap, perchain_bin): named shifts applied to
//    the binned axes they move, an edge search per such axis, a static part
//    for the axes no shift moves and an optional cell -> bin map. One code
//    for the forward and the backward kernel, so both put an event in the
//    same bin; a single shifted axis (the shifted route) is its simplest
//    case.

#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>

#include <cstddef>
#include <cstdint>

namespace m3 {

__device__ __forceinline__ float load_coef(const float* p) { return *p; }
__device__ __forceinline__ float load_coef(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

constexpr int kTileEvents = 256;   // events of a tile = threads of a block
constexpr int kTileChains = 16;    // chains of a block, products in registers
constexpr int kItemsPerStage = 4;  // items copied and used between two barriers
constexpr int kStages = 3;         // ring depth (a TileCore's default)
constexpr int kMaxKnots = 64;      // K4 / 4: segments fit one 64-bit mask
constexpr int kMaxTileParams = kTileEvents;  // one thread lists one parameter
constexpr int kWeightPitch = kTileChains + 1;  // floats per event of the parked weights

// Most items a tile can have: a parameter's 16 chains sit in at most 16
// segments, and in at most K4 / 4.
__host__ __device__ inline size_t core_item_cap(int P, int K4) {
  const int k = K4 / 4;
  return static_cast<size_t>(P) * (k < kTileChains ? k : kTileChains);
}

// Shared memory of a TileCore of `stages` ring stages of `items` items (a
// multiple of 16 bytes).
__host__ __device__ inline size_t core_bytes(size_t coef_size, int P, int K4,
                                             int stages = kStages, int items = kItemsPerStage) {
  const size_t ring = static_cast<size_t>(stages) * items * 4 * kTileEvents * coef_size;
  const size_t b = ring + static_cast<size_t>(P) * kTileChains * 8 +
                   (2 * static_cast<size_t>(P) + 1) * 4 + core_item_cap(P, K4) * 8;
  return (b + 15) & ~static_cast<size_t>(15);
}

template <typename CoefT, int kRing = kStages, int kItems = kItemsPerStage>
struct TileCore {
  static_assert(kRing >= 2, "a stage is copied while the one before it is used");
  CoefT* ring;    // [kRing][kItems][4][kTileEvents]
  float* t;       // [nact][kTileChains]
  int* seg;       // [nact][kTileChains], -1 for a chain past the batch
  int* par;       // [nact] the tile's active parameters
  int* cnt;       // [P + 1] items per parameter; cnt[P] = items of the tile
  int* item_row;  // [items] first coefficient row p·K4 + 4·segment
  int* item_jm;   // [items] slot of the parameter in t << 16 | chain mask

  // Takes core_bytes() of the 16-byte aligned `base`; returns what follows.
  __device__ unsigned char* carve(unsigned char* base, int P, int K4) {
    ring = reinterpret_cast<CoefT*>(base);
    base += static_cast<size_t>(kRing) * kItems * 4 * kTileEvents * sizeof(CoefT);
    t = reinterpret_cast<float*>(base);
    base += static_cast<size_t>(P) * kTileChains * 4;
    seg = reinterpret_cast<int*>(base);
    base += static_cast<size_t>(P) * kTileChains * 4;
    par = reinterpret_cast<int*>(base);
    base += static_cast<size_t>(P) * 4;
    cnt = reinterpret_cast<int*>(base);
    base += (static_cast<size_t>(P) + 1) * 4;
    const size_t cap = core_item_cap(P, K4);
    item_row = reinterpret_cast<int*>(base);
    base += cap * 4;
    item_jm = reinterpret_cast<int*>(base);
    base += cap * 4;
    return reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(base) + 15) & ~static_cast<uintptr_t>(15));
  }

  // Loads the tile's nact active parameters (`active`, or 0..nact-1 when it
  // is null) and the (seg, t) of chains [c0, c0 + nct) and lists the items.
  // Every thread of the block calls it; it contains barriers, and whatever
  // the caller wrote to shared memory before is visible after. Returns the
  // number of items.
  __device__ int prepare(const int* __restrict__ seg_g, const float* __restrict__ t_g,
                         const int* __restrict__ active, int nact, int c0, int nct,
                         int P, int K4) {
    const int tid = threadIdx.x;
    const int kseg = K4 / 4;
    for (int i = tid; i < nact; i += kTileEvents) par[i] = active ? active[i] : i;
    for (int i = tid; i < nact * kTileChains; i += kTileEvents) {
      const int c = i / nact;
      const int j = i - c * nact;
      const int o = j * kTileChains + c;
      if (c < nct) {
        const size_t g = static_cast<size_t>(c0 + c) * P + (active ? active[j] : j);
        seg[o] = min(max(seg_g[g], 0), kseg - 1);
        t[o] = t_g[g];
      } else {
        seg[o] = -1;
        t[o] = 0.f;
      }
    }
    __syncthreads();
    unsigned long long present = 0;
    if (tid < nact) {
      for (int c = 0; c < kTileChains; ++c) {
        const int s = seg[tid * kTileChains + c];
        if (s >= 0) present |= 1ull << s;
      }
      cnt[tid] = __popcll(present);
    }
    if (tid == 0 && nact == 0) cnt[P] = 0;
    __syncthreads();
    if (tid < nact) {
      int off = 0;
      for (int i = 0; i < tid; ++i) off += cnt[i];
      const int row0 = par[tid] * K4;
      while (present) {
        const int s = __ffsll(static_cast<long long>(present)) - 1;
        present &= present - 1;
        unsigned mask = 0;
        for (int c = 0; c < kTileChains; ++c) {
          if (seg[tid * kTileChains + c] == s) mask |= 1u << c;
        }
        item_row[off] = row0 + 4 * s;
        item_jm[off] = (tid << 16) | static_cast<int>(mask);
        ++off;
      }
      if (tid == nact - 1) cnt[P] = off;
    }
    __syncthreads();
    return cnt[P];
  }

  // Starts the copies of stage `stage`'s items: rows item_row + (0..3) of the
  // events [e0, e0 + kTileEvents) that exist, 16 bytes a copy, or (aligned
  // false) one element a thread at a time.
  __device__ __forceinline__ void copy_stage(const CoefT* __restrict__ coeffs, size_t es, int E,
                                             int e0, int stage, int n_items, bool aligned) {
    CoefT* slot = ring + static_cast<size_t>(stage % kRing) * kItems * 4 * kTileEvents;
    const int first = stage * kItems;
    if (!aligned) {
#pragma unroll 4
      for (int q = threadIdx.x; q < kItems * 4 * kTileEvents; q += kTileEvents) {
        const int i = q / (4 * kTileEvents);
        const int col = q % kTileEvents;
        if (first + i < n_items && e0 + col < E) {
          const int r = (q / kTileEvents) % 4;
          slot[q] = coeffs[static_cast<size_t>(item_row[first + i] + r) * es + e0 + col];
        }
      }
      return;
    }
    constexpr int kElems = 16 / sizeof(CoefT);
    constexpr int kPerRow = kTileEvents / kElems;
    constexpr int kPerItem = 4 * kPerRow;
    constexpr int kChunks = kItems * kPerItem;
#pragma unroll
    for (int q = threadIdx.x; q < kChunks; q += kTileEvents) {
      const int i = q / kPerItem;
      const int r = (q % kPerItem) / kPerRow;
      const int col = (q % kPerRow) * kElems;
      if (first + i < n_items && e0 + col < E) {
        __pipeline_memcpy_async(
            slot + (i * 4 + r) * kTileEvents + col,
            coeffs + static_cast<size_t>(item_row[first + i] + r) * es + e0 + col, 16);
      }
    }
  }

  // Starts the copies of the first kRing − 1 stages, so that they are in
  // flight while the caller forms its starting weights; for_each_item() or
  // multiply() follows. A second walk over the same items needs a barrier
  // between the first walk's end and this call.
  __device__ __forceinline__ void start(const CoefT* __restrict__ coeffs, size_t es, int E,
                                        int e0, int n_items, bool aligned = true) {
    const int n_stages = (n_items + kItems - 1) / kItems;
    for (int g = 0; g < kRing - 1; ++g) {
      if (g < n_stages) copy_stage(coeffs, es, E, e0, g, n_items, aligned);
      __pipeline_commit();
    }
  }

  // After start(): calls body(i, jm, y, b, c, d) for each item i of the tile
  // in order, with jm = item_jm[i] and the item's 4 coefficients at this
  // thread's event (e0 + threadIdx.x; garbage past E). Every thread of the
  // block calls it (it contains barriers), whether its event exists or not;
  // the body may use warp collectives when the whole warp calls it alike.
  template <typename Body>
  __device__ __forceinline__ void for_each_item(const CoefT* __restrict__ coeffs, size_t es,
                                                int E, int e0, int n_items, bool aligned,
                                                Body&& body) {
    const int n_stages = (n_items + kItems - 1) / kItems;
    for (int g = 0; g < n_stages; ++g) {
      __pipeline_wait_prior(kRing - 2);
      __syncthreads();  // stage g has landed; stage g − 1's slot is free
      if (g + kRing - 1 < n_stages) {
        copy_stage(coeffs, es, E, e0, g + kRing - 1, n_items, aligned);
      }
      __pipeline_commit();
      const CoefT* slot = ring +
          static_cast<size_t>(g % kRing) * kItems * 4 * kTileEvents + threadIdx.x;
      const int first = g * kItems;
      const int n = min(kItems, n_items - first);
      for (int i = 0; i < n; ++i) {
        const CoefT* co = slot + i * 4 * kTileEvents;
        body(first + i, item_jm[first + i], load_coef(co), load_coef(co + kTileEvents),
             load_coef(co + 2 * kTileEvents), load_coef(co + 3 * kTileEvents));
      }
    }
    __pipeline_wait_prior(0);
  }

  // The item's 16 t values, as four float4 (broadcast reads).
  __device__ __forceinline__ const float4* item_t(int jm) const {
    return reinterpret_cast<const float4*>(t + (jm >> 16) * kTileChains);
  }

  // After start(): w[c] *= Π over the tile's items of the response of this
  // thread's event (e0 + threadIdx.x) for chain c. Every thread of the block
  // calls both (multiply contains barriers), whether its event exists or not.
  __device__ __forceinline__ void multiply(const CoefT* __restrict__ coeffs, size_t es, int E,
                                           int e0, int n_items, float (&w)[kTileChains],
                                           bool aligned = true) {
    for_each_item(coeffs, es, E, e0, n_items, aligned,
                  [&](int, int jm, float y, float b, float c, float d) {
      const unsigned mask = static_cast<unsigned>(jm) & 0xffffu;
      const float4* tp = item_t(jm);
      const float4 ta = tp[0], tb = tp[1], tc = tp[2], td = tp[3];
#define M3_STEP(C, T) \
  if (mask & (1u << (C))) w[C] *= fmaf(T, fmaf(T, fmaf(T, d, c), b), y);
      M3_STEP(0, ta.x) M3_STEP(1, ta.y) M3_STEP(2, ta.z) M3_STEP(3, ta.w)
      M3_STEP(4, tb.x) M3_STEP(5, tb.y) M3_STEP(6, tb.z) M3_STEP(7, tb.w)
      M3_STEP(8, tc.x) M3_STEP(9, tc.y) M3_STEP(10, tc.z) M3_STEP(11, tc.w)
      M3_STEP(12, td.x) M3_STEP(13, td.y) M3_STEP(14, td.z) M3_STEP(15, td.w)
#undef M3_STEP
    });
  }

  // After multiply(): writes the block's weights into the ring's memory as
  // [event][kWeightPitch] floats (the odd pitch keeps both this write, lanes
  // over events, and the tail's reads, lanes over chains, off each other's
  // banks) and returns them. Every thread of the block calls it; what the
  // caller wrote to shared memory before is visible after.
  __device__ __forceinline__ float* park(const float (&w)[kTileChains]) {
    static_assert(sizeof(CoefT) * kRing * kItems * 4 >= sizeof(float) * kWeightPitch,
                  "the ring holds the parked weights");
    __syncthreads();  // every thread has left the ring
    float* sh_w = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int c = 0; c < kTileChains; ++c) sh_w[threadIdx.x * kWeightPitch + c] = w[c];
    __syncthreads();
    return sh_w;
  }
};

// Shift kinds (splines/reweight.py SHIFT_KINDS). shift_factor is the
// per-chain constant a of shift_x: 1 + v, or v for "offset".
constexpr int kShiftScale = 0;     // x * (1 + v)
constexpr int kShiftOffset = 1;    // x + v
constexpr int kShiftAboutOne = 2;  // 1 + (x - 1) * (1 + v)

__device__ __forceinline__ float shift_factor(int kind, float v) {
  return kind == kShiftOffset ? v : __fadd_rn(1.0f, v);
}

// The shifted value, one rounding per operation in the plain version's
// order (no FMA contraction), so it lands in the same bin as the f32
// reference.
__device__ __forceinline__ float shift_x(int kind, float x, float a) {
  switch (kind) {
    case kShiftOffset:
      return __fadd_rn(x, a);
    case kShiftAboutOne:
      return __fadd_rn(1.0f, __fmul_rn(__fsub_rn(x, 1.0f), a));
    default:
      return __fmul_rn(x, a);
  }
}

constexpr int kMaxMapAxes = 4;    // shifted binned axes of a bin map
constexpr int kMaxMapShifts = 8;  // shifts of a bin map
constexpr int kMaxMapEdges = 1025;  // edges of one axis

// A sample's per-chain binning (splines/reweight.py PerchainBins): the
// binned axes that named shifts move, each with its kinematic row, edges
// and stride in the flat index, and the shifts grouped by axis (an axis's
// shifts in the order they apply; shifts of different axes commute).
// `statics` (per event) holds the part of the flat index that the axes no
// shift moves give, −1 where one of them is out of range; `cells` maps a
// flat cell index to its bin (a hyper-rectangle binning; a cell in a gap
// maps to n_bins or past it, dropped), or is absent (n_cells = 0).
struct BinMap {
  int n_axes;
  int n_shifts;
  int edge_pitch;              // floats per axis row of the edges
  int n_cells;
  int row[kMaxMapAxes];        // kinematic row of each axis
  int n_edges[kMaxMapAxes];    // its strictly increasing edges (n_edges − 1 cells)
  int stride[kMaxMapAxes];     // its stride in the flat index
  int first[kMaxMapAxes + 1];  // the shifts of axis a: [first[a], first[a + 1])
  int kind[kMaxMapShifts];     // each shift's kind
};

// On the host: the map of the descriptor the Python wrappers pass (n_axes,
// n_shifts, edge_pitch, n_cells, then (kinematic row, n_edges, stride) per
// axis and (axis, kind) per shift, the shifts grouped by axis in ascending
// order); false for one the kernels do not take.
inline bool parse_bin_map(const int* desc, BinMap* m) {
  if (desc == nullptr) return false;
  *m = BinMap{};
  m->n_axes = desc[0];
  m->n_shifts = desc[1];
  m->edge_pitch = desc[2];
  m->n_cells = desc[3];
  if (m->n_axes < 1 || m->n_axes > kMaxMapAxes || m->n_shifts < 0 ||
      m->n_shifts > kMaxMapShifts || m->edge_pitch < 2 || m->n_cells < 0) {
    return false;
  }
  const int* ax = desc + 4;
  for (int a = 0; a < m->n_axes; ++a) {
    m->row[a] = ax[3 * a];
    m->n_edges[a] = ax[3 * a + 1];
    m->stride[a] = ax[3 * a + 2];
    if (m->row[a] < 0 || m->n_edges[a] < 2 || m->n_edges[a] > m->edge_pitch ||
        m->n_edges[a] > kMaxMapEdges || m->stride[a] < 0) {
      return false;
    }
  }
  const int* sh = ax + 3 * m->n_axes;
  int axis = 0;
  m->first[0] = 0;
  for (int s = 0; s < m->n_shifts; ++s) {
    const int a = sh[2 * s];
    if (a < axis || a >= m->n_axes || sh[2 * s + 1] < kShiftScale ||
        sh[2 * s + 1] > kShiftAboutOne) {
      return false;
    }
    while (axis < a) m->first[++axis] = s;
    m->kind[s] = sh[2 * s + 1];
  }
  while (axis < m->n_axes) m->first[++axis] = m->n_shifts;
  return true;
}


// #(edges ≤ x) by binary search over n strictly increasing edges; a NaN x
// compares false everywhere and counts 0, +inf counts every finite edge.
__device__ __forceinline__ int edges_le(const float* edges, int n, float x) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (edges[mid] <= x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The bin of a map of one axis with one shift (the shifted route's): static
// + stride·idx with idx = edges_le(x shifted) − 1, or −1 when static < 0 or
// idx ∉ [0, n_edges − 1).
__device__ __forceinline__ int axis_bin(int kind, float x_nom, float a, int static_bin,
                                        const float* edges, int n_edges, int stride) {
  if (static_bin < 0) return -1;
  const int idx = edges_le(edges, n_edges, shift_x(kind, x_nom, a)) - 1;
  return (idx < 0 || idx >= n_edges - 1) ? -1 : static_bin + stride * idx;
}

// Stages a block's bin map in shared memory: the description (sh_map), the
// edges and cells, and the shift factors of chains [c0, c0 + nct) as
// [n_shifts][kTileChains] (1 for a chain past the batch). Every thread of the
// block calls it; it contains a barrier.
__device__ __forceinline__ void stage_bin_map(BinMap& sh_map, const BinMap& m,
                                              const float* __restrict__ edges,
                                              const int* __restrict__ cells,
                                              const float* __restrict__ shift_vals, int c0,
                                              int nct, float* sh_edges, int* sh_cell,
                                              float* sh_fac) {
  const int tid = threadIdx.x;
  if (tid == 0) sh_map = m;
  for (int i = tid; i < m.n_axes * m.edge_pitch; i += kTileEvents) sh_edges[i] = edges[i];
  for (int i = tid; i < m.n_cells; i += kTileEvents) sh_cell[i] = cells[i];
  __syncthreads();
  for (int i = tid; i < sh_map.n_shifts * kTileChains; i += kTileEvents) {
    const int s = i / kTileChains;
    const int c = i - s * kTileChains;
    sh_fac[i] = c < nct ? shift_factor(sh_map.kind[s],
                                       shift_vals[static_cast<size_t>(c0 + c) * sh_map.n_shifts + s])
                        : 1.f;
  }
}

// The flat bin of one (chain, event), or −1 (dropped) when static_bin < 0 or
// an axis index idx = edges_le − 1 ∉ [0, n_edges − 1); the caller drops a
// result ≥ n_bins too (a gap cell), and a flat index past the cell map. x[a·x_pitch]: the event's nominal value
// on axis a; fac[s·fac_pitch]: the chain's shift_factor of shift s; edges:
// axis a's at a·edge_pitch; cells: the cell map (unread when n_cells = 0).
// The axes are in shared memory; each shift rounds as the plain route does.
__device__ __forceinline__ int perchain_bin(const BinMap& m, const float* x, int x_pitch,
                                            const float* fac, int fac_pitch, int static_bin,
                                            const float* edges, const int* cells) {
  if (static_bin < 0) return -1;
  int flat = static_bin;
  for (int a = 0; a < m.n_axes; ++a) {
    float v = x[a * x_pitch];
    for (int s = m.first[a]; s < m.first[a + 1]; ++s) v = shift_x(m.kind[s], v, fac[s * fac_pitch]);
    const int idx = edges_le(edges + a * m.edge_pitch, m.n_edges[a], v) - 1;
    if (idx < 0 || idx >= m.n_edges[a] - 1) return -1;
    flat += m.stride[a] * idx;
  }
  if (m.n_cells == 0) return flat;
  return flat < m.n_cells ? cells[flat] : -1;
}

// The tail of a tile: thread (chain = tid % 16, event group = tid / 16) walks
// 16 consecutive events of one chain. Lanes of a warp then add into 16
// different chains' histograms, so a shared-memory float atomicAdd (a
// compare-and-swap loop on this card) meets at most one other lane on its
// address, where lanes over events met up to 31; and a run of equal bins
// (sorted events) is summed in registers and added once.
constexpr int kTailEvents = kTileEvents / kTileChains;

// The in-kernel norm product of a chain tile: log|ext| (floored at 1e-30; a
// NaN stays NaN, as in the plain version and the TPU kernel, so that it
// spoils the chain's NLL) and the sign flags of chains [c0, c0 + nct), as
// [na1][kTileChains] arrays in shared memory. A barrier must follow before
// norm_factor reads them.
__device__ __forceinline__ void norm_prepare(float* sh_logext, float* sh_neg,
                                             const float* __restrict__ norm_ext, int c0,
                                             int nct, int na1) {
  for (int i = threadIdx.x; i < na1 * kTileChains; i += kTileEvents) {
    const int c = i / na1;
    const int k = i - c * na1;
    const float v = c < nct ? norm_ext[static_cast<size_t>(c0 + c) * na1 + k] : 1.f;
    const float a = fabsf(v);
    sh_logext[k * kTileChains + c] = logf(a < 1e-30f ? 1e-30f : a);  // fmaxf drops a NaN
    sh_neg[k * kTileChains + c] = v < 0.f ? 1.f : 0.f;
  }
}

// w[c] = exp(Σ_k log|ext[c,k]|·S[k,e]) · (−1)^(Σ_k neg[c,k]·S[k,e]) for
// event e. A slot the event does not match (S = 0) adds exactly 0 to both
// sums and is skipped; the S reads go eight at a time. sh_logext and sh_neg
// are 16-byte aligned.
__device__ __forceinline__ void norm_factor(const float* sh_logext, const float* sh_neg,
                                            const float* __restrict__ norm_s, size_t es,
                                            int e, int na1, float (&w)[kTileChains]) {
  float lw[kTileChains];
  float pw[kTileChains];
#pragma unroll
  for (int c = 0; c < kTileChains; ++c) {
    lw[c] = 0.f;
    pw[c] = 0.f;
  }
  constexpr int kBatch = 8;
  for (int k0 = 0; k0 < na1; k0 += kBatch) {
    float s[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      s[u] = k0 + u < na1 ? norm_s[static_cast<size_t>(k0 + u) * es + e] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (s[u] != 0.f) {
        const float4* le = reinterpret_cast<const float4*>(sh_logext + (k0 + u) * kTileChains);
        const float4* ng = reinterpret_cast<const float4*>(sh_neg + (k0 + u) * kTileChains);
#pragma unroll
        for (int q = 0; q < kTileChains / 4; ++q) {
          const float4 l4 = le[q];
          const float4 n4 = ng[q];
          lw[4 * q] = fmaf(l4.x, s[u], lw[4 * q]);
          lw[4 * q + 1] = fmaf(l4.y, s[u], lw[4 * q + 1]);
          lw[4 * q + 2] = fmaf(l4.z, s[u], lw[4 * q + 2]);
          lw[4 * q + 3] = fmaf(l4.w, s[u], lw[4 * q + 3]);
          pw[4 * q] = fmaf(n4.x, s[u], pw[4 * q]);
          pw[4 * q + 1] = fmaf(n4.y, s[u], pw[4 * q + 1]);
          pw[4 * q + 2] = fmaf(n4.z, s[u], pw[4 * q + 2]);
          pw[4 * q + 3] = fmaf(n4.w, s[u], pw[4 * q + 3]);
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kTileChains; ++c) {
    const float sign = 1.f - 2.f * (pw[c] - 2.f * floorf(pw[c] * 0.5f));
    w[c] = expf(lw[c]) * sign;
  }
}

}  // namespace m3
