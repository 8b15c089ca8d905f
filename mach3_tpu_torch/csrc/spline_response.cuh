// Device helpers shared by the forward reweight kernels of this directory.
//
// A spline response is evaluated from its segment's 4 coefficient rows
// seg*4 + (0..3) of coeffs[p, :, e] — (y, b, c, d) — and one f32 Horner
// step, resp = y + t(b + t(c + t·d)); bf16 tables are upcast on load. seg is
// trusted to lie in [0, n_knots − 2], as find_segments clamps it (the tile
// core below clamps it into the table besides).
//
// Two forms:
//
//  * spline_weight: one (chain, event) at a time, straight from global
//    memory (reweight_perchain.cu).
//
//  * TileCore: the response product of one tile of kTileEvents events (one
//    per thread) by kTileChains chains, parameter-outer, with the chains'
//    running products in registers (reweight_shared.cu, reweight_shifted.cu).
//    The work of a tile is a list of items (active parameter, segment, the
//    16-bit mask of the tile's chains that sit in that segment): only
//    segments some chain is in are listed, ascending, so a parameter whose
//    chains straddle a knot gives two items. An item's 4 coefficient rows for
//    the tile's events (2 KB in bf16, 4 KB in f32) are copied into shared
//    memory with 16-byte cp.async, kItemsPerStage items to a stage, in a ring
//    of kStages stages: the rows of the next two stages are in flight while
//    this one's are used, the addresses depend on no chain, and each row
//    leaves L2 once per block instead of once per chain. A thread then reads
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
//    Row starts must be 16-byte aligned: the table's base pointer and its
//    row pitch E·sizeof(CoefT) are multiples of 16 (the entries check it).

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

// w · Π_p resp_p for event e of one chain; seg/t are that chain's [P] rows.
template <typename CoefT>
__device__ __forceinline__ float spline_weight(
    const CoefT* __restrict__ coeffs, const int* seg, const float* t, int P,
    int K4, size_t es, int e, float w) {
  for (int p = 0; p < P; ++p) {
    const float tp = t[p];
    const CoefT* co = coeffs +
        (static_cast<size_t>(p) * K4 + static_cast<size_t>(seg[p]) * 4) * es + e;
    const float y = load_coef(co);
    const float b = load_coef(co + es);
    const float c = load_coef(co + 2 * es);
    const float d = load_coef(co + 3 * es);
    w *= y + tp * (b + tp * (c + tp * d));
  }
  return w;
}

constexpr int kTileEvents = 256;   // events of a tile = threads of a block
constexpr int kTileChains = 16;    // chains of a block, products in registers
constexpr int kItemsPerStage = 4;  // items copied and used between two barriers
constexpr int kStages = 3;         // ring depth
constexpr int kMaxKnots = 64;      // K4 / 4: segments fit one 64-bit mask
constexpr int kMaxTileParams = kTileEvents;  // one thread lists one parameter
constexpr int kWeightPitch = kTileChains + 1;  // floats per event of the parked weights

// Most items a tile can have: a parameter's 16 chains sit in at most 16
// segments, and in at most K4 / 4.
__host__ __device__ inline size_t core_item_cap(int P, int K4) {
  const int k = K4 / 4;
  return static_cast<size_t>(P) * (k < kTileChains ? k : kTileChains);
}

// Shared memory of a TileCore (a multiple of 16 bytes).
__host__ __device__ inline size_t core_bytes(size_t coef_size, int P, int K4) {
  const size_t ring = static_cast<size_t>(kStages) * kItemsPerStage * 4 * kTileEvents * coef_size;
  const size_t b = ring + static_cast<size_t>(P) * kTileChains * 8 +
                   (2 * static_cast<size_t>(P) + 1) * 4 + core_item_cap(P, K4) * 8;
  return (b + 15) & ~static_cast<size_t>(15);
}

template <typename CoefT>
struct TileCore {
  CoefT* ring;    // [kStages][kItemsPerStage][4][kTileEvents]
  float* t;       // [nact][kTileChains]
  int* seg;       // [nact][kTileChains], -1 for a chain past the batch
  int* par;       // [nact] the tile's active parameters
  int* cnt;       // [P + 1] items per parameter; cnt[P] = items of the tile
  int* item_row;  // [items] first coefficient row p·K4 + 4·segment
  int* item_jm;   // [items] slot of the parameter in t << 16 | chain mask

  // Takes core_bytes() of the 16-byte aligned `base`; returns what follows.
  __device__ unsigned char* carve(unsigned char* base, int P, int K4) {
    ring = reinterpret_cast<CoefT*>(base);
    base += static_cast<size_t>(kStages) * kItemsPerStage * 4 * kTileEvents * sizeof(CoefT);
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
  // events [e0, e0 + kTileEvents) that exist, 16 bytes a copy.
  __device__ __forceinline__ void copy_stage(const CoefT* __restrict__ coeffs, size_t es, int E,
                                        int e0, int stage, int n_items) {
    constexpr int kElems = 16 / sizeof(CoefT);
    constexpr int kPerRow = kTileEvents / kElems;
    constexpr int kPerItem = 4 * kPerRow;
    constexpr int kChunks = kItemsPerStage * kPerItem;
    CoefT* slot = ring + static_cast<size_t>(stage % kStages) * kItemsPerStage * 4 * kTileEvents;
    const int first = stage * kItemsPerStage;
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

  // Starts the copies of the first kStages − 1 stages, so that they are in
  // flight while the caller forms its starting weights; multiply() follows.
  __device__ __forceinline__ void start(const CoefT* __restrict__ coeffs, size_t es, int E,
                                        int e0, int n_items) {
    const int n_stages = (n_items + kItemsPerStage - 1) / kItemsPerStage;
    for (int g = 0; g < kStages - 1; ++g) {
      if (g < n_stages) copy_stage(coeffs, es, E, e0, g, n_items);
      __pipeline_commit();
    }
  }

  // After start(): w[c] *= Π over the tile's items of the response of this
  // thread's event (e0 + threadIdx.x) for chain c. Every thread of the block
  // calls both (multiply contains barriers), whether its event exists or not.
  __device__ __forceinline__ void multiply(const CoefT* __restrict__ coeffs, size_t es, int E,
                                           int e0, int n_items, float (&w)[kTileChains]) {
    const int n_stages = (n_items + kItemsPerStage - 1) / kItemsPerStage;
    for (int g = 0; g < n_stages; ++g) {
      __pipeline_wait_prior(kStages - 2);
      __syncthreads();  // stage g has landed; stage g − 1's slot is free
      if (g + kStages - 1 < n_stages) copy_stage(coeffs, es, E, e0, g + kStages - 1, n_items);
      __pipeline_commit();
      const CoefT* slot = ring +
          static_cast<size_t>(g % kStages) * kItemsPerStage * 4 * kTileEvents + threadIdx.x;
      const int first = g * kItemsPerStage;
      const int n = min(kItemsPerStage, n_items - first);
      for (int i = 0; i < n; ++i) {
        const int jm = item_jm[first + i];
        const unsigned mask = static_cast<unsigned>(jm) & 0xffffu;
        const float4* tp = reinterpret_cast<const float4*>(t + (jm >> 16) * kTileChains);
        const CoefT* co = slot + i * 4 * kTileEvents;
        const float y = load_coef(co);
        const float b = load_coef(co + kTileEvents);
        const float c = load_coef(co + 2 * kTileEvents);
        const float d = load_coef(co + 3 * kTileEvents);
        const float4 ta = tp[0], tb = tp[1], tc = tp[2], td = tp[3];
#define M3_STEP(C, T) \
  if (mask & (1u << (C))) w[C] *= fmaf(T, fmaf(T, fmaf(T, d, c), b), y);
        M3_STEP(0, ta.x) M3_STEP(1, ta.y) M3_STEP(2, ta.z) M3_STEP(3, ta.w)
        M3_STEP(4, tb.x) M3_STEP(5, tb.y) M3_STEP(6, tb.z) M3_STEP(7, tb.w)
        M3_STEP(8, tc.x) M3_STEP(9, tc.y) M3_STEP(10, tc.z) M3_STEP(11, tc.w)
        M3_STEP(12, td.x) M3_STEP(13, td.y) M3_STEP(14, td.z) M3_STEP(15, td.w)
#undef M3_STEP
      }
    }
    __pipeline_wait_prior(0);
  }

  // After multiply(): writes the block's weights into the ring's memory as
  // [event][kWeightPitch] floats (the odd pitch keeps both this write, lanes
  // over events, and the tail's reads, lanes over chains, off each other's
  // banks) and returns them. Every thread of the block calls it; what the
  // caller wrote to shared memory before is visible after.
  __device__ __forceinline__ float* park(const float (&w)[kTileChains]) {
    static_assert(sizeof(CoefT) * kStages * kItemsPerStage * 4 >= sizeof(float) * kWeightPitch,
                  "the ring holds the parked weights");
    __syncthreads();  // every thread has left the ring
    float* sh_w = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int c = 0; c < kTileChains; ++c) sh_w[threadIdx.x * kWeightPitch + c] = w[c];
    __syncthreads();
    return sh_w;
  }
};

// The tail of a tile: thread (chain = tid % 16, event group = tid / 16) walks
// 16 consecutive events of one chain. Lanes of a warp then add into 16
// different chains' histograms, so a shared-memory float atomicAdd (a
// compare-and-swap loop on this card) meets at most one other lane on its
// address, where lanes over events met up to 31; and a run of equal bins
// (sorted events) is summed in registers and added once.
constexpr int kTailEvents = kTileEvents / kTileChains;

// The in-kernel norm product of a chain tile: log|ext| (floored at 1e-30)
// and the sign flags of chains [c0, c0 + nct), as [na1][kTileChains] arrays
// in shared memory. A barrier must follow before norm_factor reads them.
__device__ __forceinline__ void norm_prepare(float* sh_logext, float* sh_neg,
                                             const float* __restrict__ norm_ext, int c0,
                                             int nct, int na1) {
  for (int i = threadIdx.x; i < na1 * kTileChains; i += kTileEvents) {
    const int c = i / na1;
    const int k = i - c * na1;
    const float v = c < nct ? norm_ext[static_cast<size_t>(c0 + c) * na1 + k] : 1.f;
    sh_logext[k * kTileChains + c] = logf(fmaxf(fabsf(v), 1e-30f));
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
