// Backward of the likelihood's event-sized gathers, for Hopper: one kernel,
// entry m3_gather_backward.
//
// It replaces no TPU kernel. The JAX package leaves these gathers
// (mach3_tpu/samples/sample.py: the norm product over norm_idx and the
// oscillation weights' flat gather) and their transposes to XLA. On the card
// the backward of index_select is an atomic index_add, and for these gathers
// almost every add lands on a few hot addresses: a norm table has 16-23
// slots a chain and an oscillation table 320-800, while every chain has
// 60,000-190,000 events. Same-address float atomics serialise in L2; at
// 128 chains on the beam1det fit they took ~9.9 ms a batched evaluation.
//
// Two functions (samples/gather.py), both reductions of an event-sized
// cotangent g [C, E] into a chain's S slots:
//
//   gather (kProduct false, W = 1): out[c, s] = Σ_{e: idx[e] = s} g[c, e]
//   norm product (kProduct, W ≤ 8):
//     out[c, s] = Σ_e Σ_{w: idx[e, w] = s} g[c, e] · Π_{w' ≠ w} tab[c, idx[e, w']]
//
// the second being the backward of Π_w tab[c, idx[e, w]]. The product of the
// other factors is formed in registers from running products from both ends,
// with no division, so it is exact for a zero factor and a NaN stays in its
// own chain.
//
// What bounds it: bytes. Each cotangent is read once (4 B a chain and event),
// the index once per chain tile, the partials written and read once: at 128
// chains on beam1det ~260 MB for the four gathers, ~0.08 ms at 3.35 TB/s.
//
// What the design does about the contention:
//  * A block is a tile of kChainTile = 8 chains by a range of events (16
//    chains a block ran as fast or slower); each of its two warps owns
//    kChainsPerWarp = 4 of the tile's chains over the whole range and keeps
//    their sums, [chain][S] f32, in shared memory. No two warps write one
//    address, so no atomics are needed, in shared memory or in device
//    memory.
//  * Lanes run along events, so a warp's read of g[c, e..e+31] is one
//    coalesced 128-byte row segment. Each thread has its 4 chains x 4 event
//    steps of loads in flight before it adds (2 steps for a norm product of
//    more than 2 columns).
//  * Lanes whose events read the same slot are combined inside the warp
//    before anything touches shared memory: __match_any_sync gives each
//    lane its group, and a suffix sum over the group's lanes in lane order
//    (Hillis-Steele: at step k a lane adds the value of the lane 2^k ranks
//    above it, found by pointer jumping, one integer shuffle a step) leaves
//    the group's sum on its first lane, the leader, which adds it to its
//    chain's slot; the leaders of one instruction write distinct slots. The
//    grouping is done once for the warp's 4 chains. The steps run only as
//    long as some lane of the warp has a partner left, and the shuffles of
//    all a warp's loaded values (event steps x columns x chains) go step by
//    step together, so that they issue back to back: done one value at a
//    time, behind a branch each, they cost numu_beam's gather 0.46 ms
//    instead of 0.05.
//  * The index is the sample's own int64 buffer ([E] or [E, W]), read once
//    per tile of chains (the tiles of one event range share it in L2).
//  * Each block writes its tile's sums to partial[event block, c, s]; the
//    wrapper sums them over event blocks in a fixed order (torch's sum over
//    the first axis, as reweight_backward's partials). Every addition here
//    has a fixed order: the result is bit-identical from run to run, which
//    index_add's is not.
//  * Events a block: 2,048 for the gather, 1,024 for the norm product (the
//    fastest of 256-4,096 at beam1det's shapes); the partials stay a fifth
//    of the cotangent's bytes or less.
//
// Measured (H100 80GB HBM3, 700 W, 128 chains, the benchmark's beam1det
// model, device time of graph replays): numu_beam's norm product 0.127 ms
// and gather 0.056 ms, nue_beam's 0.069 and 0.044, all four 0.297, against
// a bytes bound of ~0.08 ms for the four; index_add took 0.39-0.49 and
// 0.15-0.16 ms for the two gathers, and the norm products' former backward
// ~9-11 and ~4.7 ms. A plan of the groups precomputed from the static index
// in place of __match_any_sync took 0.288 ms for the four, and the
// benchmark's ChEES rate did not tell the two apart. The norm product is
// bound by its shuffles: its columns have 1-2 slots a warp, so five scan
// steps a value.
//
// The wrapper decides, from the shapes before any launch, which gathers come
// here: a table whose 8 chains do not fit kSmemBudget (an atmospheric table,
// thousands of slots a chain, where atomics find little contention) takes
// index_add instead.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpSize = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kChainsPerWarp = 4;
constexpr int kChainTile = 8;
// Aligned 32-event steps a warp loads together (the kernel's kEventSteps):
// 4 (16 loads of g in flight a thread) for the gather, 2 for a norm product
// of up to 4 columns, 1 for a wider one, whose slots, groups and values
// take the registers. A block's events are a multiple of the most.
constexpr int kBlockEventMultiple = 4 * 32;
constexpr int kMaxW = 8;
constexpr int kSmemBudget = 64 * 1024;
constexpr int kScanSteps = 5;  // log2 of the warp size

struct Args {
  const float* g;        // [C, E]
  const float* table;    // [C, S] (product only)
  const int64_t* idx;    // [E, W] slots
  float* partial;        // [n_event_blocks, C, S]
  int C, E, S, events;
};

template <int kW, bool kProduct>
__global__ void __launch_bounds__(kChainTile / kChainsPerWarp * kWarpSize)
    gather_backward_kernel(const Args a) {
  constexpr int kEventSteps = kW == 1 ? 4 : (kW <= 4 ? 2 : 1);
  extern __shared__ float smem[];
  const int S = a.S;
  float* acc = smem;                   // [kChainTile][S]
  float* tab = smem + kChainTile * S;  // [kChainTile][S], the product's factors
  const int c0 = blockIdx.x * kChainTile;
  const int e0 = blockIdx.y * a.events;
  const int e1 = min(e0 + a.events, a.E);
  for (int cl = 0; cl < kChainTile; ++cl) {
    const bool live_row = c0 + cl < a.C;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      acc[cl * S + s] = 0.0f;
      if (kProduct) {
        tab[cl * S + s] = live_row ? a.table[static_cast<size_t>(c0 + cl) * S + s] : 1.0f;
      }
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / kWarpSize;
  const int lane = threadIdx.x % kWarpSize;
  const int cl0 = warp * kChainsPerWarp;  // the warp's first chain in the tile
  const unsigned below = (1u << lane) - 1u;
  const unsigned above = ~((2u << lane) - 1u);  // 0 for lane 31
  bool live[kChainsPerWarp];
#pragma unroll
  for (int j = 0; j < kChainsPerWarp; ++j) live[j] = c0 + cl0 + j < a.C;

  for (int eb = e0; eb < e1; eb += kEventSteps * kWarpSize) {
    bool in[kEventSteps];
    int key[kEventSteps][kW];
    float gv[kEventSteps][kChainsPerWarp];
#pragma unroll
    for (int s = 0; s < kEventSteps; ++s) {
      const int e = eb + s * kWarpSize + lane;
      in[s] = e < e1;
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        key[s][w] = in[s] ? static_cast<int>(__ldg(a.idx + static_cast<size_t>(e) * kW + w)) : 0;
      }
#pragma unroll
      for (int j = 0; j < kChainsPerWarp; ++j) {
        gv[s][j] = in[s] && live[j]
                       ? __ldg(a.g + static_cast<size_t>(c0 + cl0 + j) * a.E + e)
                       : 0.0f;
      }
    }
    // Each (step, column, chain)'s contribution (0 past the events' end).
    float v[kEventSteps][kW][kChainsPerWarp];
#pragma unroll
    for (int s = 0; s < kEventSteps; ++s) {
#pragma unroll
      for (int j = 0; j < kChainsPerWarp; ++j) {
        if (kProduct) {
          const float* trow = tab + (cl0 + j) * S;
          float f[kW];
#pragma unroll
          for (int w = 0; w < kW; ++w) f[w] = trow[key[s][w]];
          // Π of the other factors: the product of those before w times the
          // product of those after it.
          float before = 1.0f;
#pragma unroll
          for (int w = 0; w < kW; ++w) {
            v[s][w][j] = before;
            before *= f[w];
          }
          float after = 1.0f;
#pragma unroll
          for (int w = kW - 1; w >= 0; --w) {
            v[s][w][j] = in[s] ? gv[s][j] * (v[s][w][j] * after) : 0.0f;
            after *= f[w];
          }
        } else {
#pragma unroll
          for (int w = 0; w < kW; ++w) v[s][w][j] = gv[s][j];
        }
      }
    }
    // Each lane's group (lanes past the end form one of their own, keyed
    // -1, and lead none), its leader, and the lane one rank above it.
    bool lead[kEventSteps][kW];
    int src[kEventSteps][kW];  // the lane 2^k ranks above, or -1
    bool pending = false;
#pragma unroll
    for (int s = 0; s < kEventSteps; ++s) {
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        const unsigned m = __match_any_sync(kFullMask, in[s] ? key[s][w] : -1);
        const unsigned up = m & above;
        lead[s][w] = in[s] && (m & below) == 0u;
        src[s][w] = up != 0u ? __ffs(up) - 1 : -1;
        pending |= src[s][w] >= 0;
      }
    }
    // The groups' suffix sums, every value's shuffle of a step together.
#pragma unroll
    for (int k = 0; k < kScanSteps; ++k) {
      if (!__any_sync(kFullMask, pending)) break;
      pending = false;
#pragma unroll
      for (int s = 0; s < kEventSteps; ++s) {
#pragma unroll
        for (int w = 0; w < kW; ++w) {
          const bool has = src[s][w] >= 0;
          const int from = has ? src[s][w] : lane;
#pragma unroll
          for (int j = 0; j < kChainsPerWarp; ++j) {
            const float t = __shfl_sync(kFullMask, v[s][w][j], from);
            if (has) v[s][w][j] += t;
          }
          const int next = __shfl_sync(kFullMask, src[s][w], from);
          src[s][w] = has ? next : -1;
          pending |= src[s][w] >= 0;
        }
      }
    }
    // Each group's leader adds its sum to its slot, the four chains' rows
    // read together and then written (distinct rows), steps and columns in
    // order (they may share a slot).
#pragma unroll
    for (int s = 0; s < kEventSteps; ++s) {
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        if (lead[s][w]) {
          float old[kChainsPerWarp];
#pragma unroll
          for (int j = 0; j < kChainsPerWarp; ++j) old[j] = acc[(cl0 + j) * S + key[s][w]];
#pragma unroll
          for (int j = 0; j < kChainsPerWarp; ++j) {
            acc[(cl0 + j) * S + key[s][w]] = old[j] + v[s][w][j];
          }
        }
      }
    }
  }
  __syncthreads();
  for (int cl = 0; cl < kChainTile && c0 + cl < a.C; ++cl) {
    float* out = a.partial + (static_cast<size_t>(blockIdx.y) * a.C + c0 + cl) * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) out[s] = acc[cl * S + s];
  }
}

template <int kW, bool kProduct>
cudaError_t launch(const Args& a, dim3 grid, size_t smem, cudaStream_t stream) {
  auto kernel = gather_backward_kernel<kW, kProduct>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kChainTile / kChainsPerWarp * kWarpSize, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int kW>
cudaError_t launch_product(const Args& a, dim3 grid, size_t smem, cudaStream_t stream) {
  return launch<kW, true>(a, grid, smem, stream);
}

}  // namespace

// Plain C entry for ctypes. g [C, E] f32; table [C, S] f32 (product != 0,
// else ignored); idx [E, W] int64, every entry in [0, S); partial
// [ceil(E / events), C, S] f32, every entry written. chains must equal the
// kernel's tile (8), events (a multiple of 128) are a block's; W is 1
// without the product and 1..8 with it. Returns a cudaError_t code:
// cudaErrorInvalidValue for sizes the kernel does not take, otherwise
// cudaGetLastError() right after the launch.
extern "C" int m3_gather_backward(const void* g, const void* table, const void* idx,
                                  void* partial, int C, int E, int S, int W, int product,
                                  int chains, int events, void* stream) {
  const size_t smem = static_cast<size_t>(chains) * S * sizeof(float) * (product ? 2 : 1);
  if (g == nullptr || idx == nullptr || partial == nullptr || (product && table == nullptr) ||
      C <= 0 || E <= 0 || S <= 0 || W < 1 || W > (product ? kMaxW : 1) ||
      chains != kChainTile || events <= 0 || events % kBlockEventMultiple != 0 ||
      smem > kSmemBudget) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(g), static_cast<const float*>(table),
               static_cast<const int64_t*>(idx), static_cast<float*>(partial), C, E, S,
               events};
  const dim3 grid((C + chains - 1) / chains, (E + events - 1) / events);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!product) return static_cast<int>(launch<1, false>(a, grid, smem, s));
  switch (W) {
    case 1: return static_cast<int>(launch_product<1>(a, grid, smem, s));
    case 2: return static_cast<int>(launch_product<2>(a, grid, smem, s));
    case 3: return static_cast<int>(launch_product<3>(a, grid, smem, s));
    case 4: return static_cast<int>(launch_product<4>(a, grid, smem, s));
    case 5: return static_cast<int>(launch_product<5>(a, grid, smem, s));
    case 6: return static_cast<int>(launch_product<6>(a, grid, smem, s));
    case 7: return static_cast<int>(launch_product<7>(a, grid, smem, s));
    default: return static_cast<int>(launch_product<8>(a, grid, smem, s));
  }
}

extern "C" const char* m3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
