// Analytic backward of the fused spline-reweight + Σw/Σw² histogram, for
// Hopper: two passes, entry points m3_reweight_grad_a and m3_reweight_grad_b.
//
// Replaces the TPU kernels K6a and K6b, mach3_tpu/splines/pallas_grad.py
// _kernel_grad_a and _kernel_grad_b (reached through _grad_backward from
// fused_reweight_diff / fused_reweight_diff_shifted). It computes their
// function, contracted with the port's parameterisation of the responses; it
// is not carried over block by block.
//
// Forward (csrc/reweight_shared.cu, csrc/reweight_shifted.cu, without the
// norm product): w[c,e] = base[c,e] · Π_p resp_p, resp_p = y + t(b + t(c +
// t·d)) from the 4 coefficient rows seg[c,p]*4 + (0..3) of coeffs[p, :, e],
// t = value − knot[seg] (so ∂t/∂θ = 1), then mc[c, bin] += w, w2[c, bin] += w².
// Given the output cotangents ḡ_mc, ḡ_w2 [C, B]:
//
// Pass A (grad_a), per (chain c, event e):
//   pnz = Π_{p: resp_p ≠ 0} resp_p,  nz = #{p: resp_p == 0}
//   r   = pnz if nz == 0 else 0,     w = base · r
//   G   = ḡ_mc[c, bin] + 2w·ḡ_w2[c, bin]   (0 for a bin outside [0, n_bins))
//   ḡ_base = G·r,  sev = G·base           -> four [C, E] fields (nz as int32)
// bin is static_bins[e] (shared route) or bins[c, e] (per-chain bins, the
// shifted route, as the plain binning puts the event).
//
// Pass B (grad_b), per (c, p), the exclusion product without a division by 0:
//   excl_p = pnz / resp_p if nz == 0;  pnz if nz == 1 and resp_p == 0;  else 0
//   ḡ_t[c, p] = Σ_e sev · excl_p · (b + t(2c + 3t·d))[p, seg, e]
// which is the TPU kernel's ḡ_selector[c, p, :] = Σ_e sev·excl_p·(coeffs −
// I)[p, :, e] contracted with ∂selector/∂t = [0, 1, 2t, 3t²] at the segment.
// Each block (one event tile x one chain tile) writes its partial sums to
// partial[tile, c, p] (exactly 0 for a parameter it does not list); the
// wrapper sums over tiles. No float atomics: the result does not depend on
// the order in which blocks run, and the block's own reduction (a shuffle
// tree per warp, then the 8 warps in order) is fixed too.
//
// Everything is f32, from f32 operands (bf16 tables are upcast on load). The
// TPU kernel rounds both operands of its pass-B dot to bf16; this one does
// not, as the forward kernels do not copy the forward's rounding.
//
// Tiles and the plan: a block is kEventTile = 256 events (one per thread) x
// kChainTile = 16 chains, the shared kernel's tile. With a plan (the shared
// route's splines/plan.py, CSR lists of each tile's active parameters) a
// block evaluates only its tile's listed parameters. Skipping the others is
// exact: an unlisted parameter is the identity on every event of the tile
// (y = 1, b = c = d = 0), so its response is 1.0 (no change to pnz or nz) and
// its slope is 0 (no contribution to ḡ_t). Without a plan every parameter is
// evaluated.
//
// What bounds it on this card, and what the design does about each:
//  * the coefficient reads, 4 rows per (chain, listed parameter, event), as
//    in the forward kernels: coalesced along E, rows of the 16 chains of a
//    block that share a segment hit L1, and blockIdx.x runs over the chain
//    tiles so the blocks that read one event tile's rows run side by side
//    and share them in L2;
//  * pass A's [C, E] traffic: base and (per-chain) bins in, four fields out
//    (~24 bytes per (chain, event));
//  * pass B's reduction: 5 shuffles per (chain, listed parameter) per warp
//    beside the ~12 instructions of the response and its slope per (chain,
//    event, parameter).
//
// Launch: grid (ceil(C / kChainTile), ceil(E / kEventTile)), kThreads
// threads, on the caller's stream. It allocates nothing. Each entry returns
// cudaErrorInvalidValue for sizes it does not take, else cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kChainTile = 16;
constexpr int kThreads = 256;
constexpr int kEventTile = kThreads;  // one event per thread
constexpr int kWarps = kThreads / 32;
constexpr int kMaxParams = 256;
constexpr int kMaxTiles = 65535;  // gridDim.y
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on Hopper
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float load_coef(const float* p) { return *p; }
__device__ __forceinline__ float load_coef(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// The response y + t(b + t(c + t·d)) at one event; co points at row
// seg*4 of parameter p, column e; rows are es apart.
template <typename CoefT>
__device__ __forceinline__ float response(const CoefT* co, size_t es, float t) {
  const float y = load_coef(co);
  const float b = load_coef(co + es);
  const float c = load_coef(co + 2 * es);
  const float d = load_coef(co + 3 * es);
  return y + t * (b + t * (c + t * d));
}

template <typename CoefT>
__device__ __forceinline__ void response_and_slope(const CoefT* co, size_t es, float t,
                                                   float& r, float& dr) {
  const float y = load_coef(co);
  const float b = load_coef(co + es);
  const float c = load_coef(co + 2 * es);
  const float d = load_coef(co + 3 * es);
  r = y + t * (b + t * (c + t * d));
  dr = b + t * (2.f * c + 3.f * t * d);
}

// Stages the chain tile's (seg, t) of the tile's parameters, and the
// parameter list, in shared memory. nact parameters: the plan's list for
// this tile, or all P.
template <bool kHasPlan>
__device__ __forceinline__ int stage_params(const int* __restrict__ seg,
                                            const float* __restrict__ tval,
                                            const int* __restrict__ plan_ptr,
                                            const int* __restrict__ plan_idx, int tile,
                                            int c0, int nct, int P, int* sh_p,
                                            int* sh_seg, float* sh_t) {
  const int p_begin = kHasPlan ? plan_ptr[tile] : 0;
  const int nact = kHasPlan ? plan_ptr[tile + 1] - p_begin : P;
  for (int i = threadIdx.x; i < nact; i += kThreads) {
    sh_p[i] = kHasPlan ? plan_idx[p_begin + i] : i;
  }
  for (int i = threadIdx.x; i < nct * nact; i += kThreads) {
    const int c = i / nact;
    const int j = i - c * nact;
    const int p = kHasPlan ? plan_idx[p_begin + j] : j;
    const size_t g = static_cast<size_t>(c0 + c) * P + p;
    sh_seg[i] = seg[g];
    sh_t[i] = tval[g];
  }
  return nact;
}

template <typename CoefT, bool kPerChainBins, bool kHasPlan>
__global__ void __launch_bounds__(kThreads) grad_a_kernel(
    const int* __restrict__ seg, const float* __restrict__ tval,
    const CoefT* __restrict__ coeffs, const float* __restrict__ base_w,
    const int* __restrict__ bins, const float* __restrict__ gmc,
    const float* __restrict__ gw2, const int* __restrict__ plan_ptr,
    const int* __restrict__ plan_idx, float* __restrict__ gbase,
    float* __restrict__ sev, float* __restrict__ pnz_out, int* __restrict__ nz_out,
    int C, int P, int K4, int E, int n_bins) {
  extern __shared__ float smem[];
  float* sh_t = smem;                                           // [CT][nact]
  int* sh_seg = reinterpret_cast<int*>(sh_t + kChainTile * P);  // [CT][nact]
  int* sh_p = sh_seg + kChainTile * P;                          // [nact]

  const int tile = blockIdx.y;
  const int c0 = blockIdx.x * kChainTile;
  const int nct = min(kChainTile, C - c0);
  const int nact = stage_params<kHasPlan>(seg, tval, plan_ptr, plan_idx, tile, c0, nct,
                                          P, sh_p, sh_seg, sh_t);
  __syncthreads();

  const int e = tile * kEventTile + threadIdx.x;
  if (e >= E) return;
  const size_t es = static_cast<size_t>(E);
  const int shared_bin = kPerChainBins ? 0 : bins[e];
  for (int c = 0; c < nct; ++c) {
    const int* cs = sh_seg + c * nact;
    const float* ct = sh_t + c * nact;
    float pnz = 1.f;
    int nz = 0;
    for (int j = 0; j < nact; ++j) {
      const CoefT* co = coeffs +
          (static_cast<size_t>(sh_p[j]) * K4 + static_cast<size_t>(cs[j]) * 4) * es + e;
      const float r = response(co, es, ct[j]);
      if (r == 0.f) {
        ++nz;
      } else {
        pnz *= r;
      }
    }
    const size_t o = static_cast<size_t>(c0 + c) * es + e;
    const float base = base_w[o];
    const float r_total = nz == 0 ? pnz : 0.f;
    const int b = kPerChainBins ? bins[o] : shared_bin;
    float g = 0.f;
    if (b >= 0 && b < n_bins) {
      const size_t gb = static_cast<size_t>(c0 + c) * n_bins + b;
      const float w = base * r_total;
      g = gmc[gb] + 2.f * w * gw2[gb];
    }
    gbase[o] = g * r_total;
    sev[o] = g * base;
    pnz_out[o] = pnz;
    nz_out[o] = nz;
  }
}

template <typename CoefT, bool kHasPlan>
__global__ void __launch_bounds__(kThreads) grad_b_kernel(
    const int* __restrict__ seg, const float* __restrict__ tval,
    const CoefT* __restrict__ coeffs, const float* __restrict__ sev,
    const float* __restrict__ pnz, const int* __restrict__ nz,
    const int* __restrict__ plan_ptr, const int* __restrict__ plan_idx,
    float* __restrict__ partial, int C, int P, int K4, int E) {
  extern __shared__ float smem[];
  float* red = smem;                                            // [W][CT][P]
  float* sh_t = red + kWarps * kChainTile * P;                  // [CT][nact]
  int* sh_seg = reinterpret_cast<int*>(sh_t + kChainTile * P);  // [CT][nact]
  int* sh_p = sh_seg + kChainTile * P;                          // [nact]
  int* slot = sh_p + P;                                         // [P]: j or -1

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.y;
  const int c0 = blockIdx.x * kChainTile;
  const int nct = min(kChainTile, C - c0);
  for (int i = tid; i < P; i += kThreads) slot[i] = -1;
  const int nact = stage_params<kHasPlan>(seg, tval, plan_ptr, plan_idx, tile, c0, nct,
                                          P, sh_p, sh_seg, sh_t);
  __syncthreads();
  for (int j = tid; j < nact; j += kThreads) slot[sh_p[j]] = j;

  const int e = tile * kEventTile + tid;
  const bool valid = e < E;
  const size_t es = static_cast<size_t>(E);
  for (int c = 0; c < nct; ++c) {
    float s = 0.f;
    float q = 0.f;
    int n = 2;  // an event past E contributes 0
    if (valid) {
      const size_t o = static_cast<size_t>(c0 + c) * es + e;
      s = sev[o];
      q = pnz[o];
      n = nz[o];
    }
    const int* cs = sh_seg + c * nact;
    const float* ct = sh_t + c * nact;
    for (int j = 0; j < nact; ++j) {
      float v = 0.f;
      if (valid) {
        const CoefT* co = coeffs +
            (static_cast<size_t>(sh_p[j]) * K4 + static_cast<size_t>(cs[j]) * 4) * es + e;
        float r, dr;
        response_and_slope(co, es, ct[j], r, dr);
        const bool is_zero = r == 0.f;
        const float excl =
            n == 0 ? q / (is_zero ? 1.f : r) : ((n == 1 && is_zero) ? q : 0.f);
        v = s * excl * dr;
      }
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFullMask, v, off);
      if (lane == 0) red[(warp * kChainTile + c) * P + j] = v;
    }
  }
  __syncthreads();

  float* out = partial + (static_cast<size_t>(tile) * C + c0) * P;
  for (int i = tid; i < nct * P; i += kThreads) {
    const int c = i / P;
    const int j = slot[i - c * P];
    float acc = 0.f;
    if (j >= 0) {
      for (int w = 0; w < kWarps; ++w) acc += red[(w * kChainTile + c) * P + j];
    }
    out[i] = acc;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename CoefT, bool kPerChainBins, bool kHasPlan>
cudaError_t launch_a(size_t smem, dim3 grid, cudaStream_t stream, const int* seg,
                     const float* t, const void* coeffs, const float* base_w,
                     const int* bins, const float* gmc, const float* gw2,
                     const int* plan_ptr, const int* plan_idx, float* gbase,
                     float* sev, float* pnz, int* nz, int C, int P, int K4, int E,
                     int n_bins) {
  auto kernel = grad_a_kernel<CoefT, kPerChainBins, kHasPlan>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      seg, t, static_cast<const CoefT*>(coeffs), base_w, bins, gmc, gw2, plan_ptr,
      plan_idx, gbase, sev, pnz, nz, C, P, K4, E, n_bins);
  return cudaGetLastError();
}

template <typename CoefT, bool kHasPlan>
cudaError_t launch_b(size_t smem, dim3 grid, cudaStream_t stream, const int* seg,
                     const float* t, const void* coeffs, const float* sev,
                     const float* pnz, const int* nz, const int* plan_ptr,
                     const int* plan_idx, float* partial, int C, int P, int K4, int E) {
  auto kernel = grad_b_kernel<CoefT, kHasPlan>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(seg, t, static_cast<const CoefT*>(coeffs),
                                           sev, pnz, nz, plan_ptr, plan_idx, partial,
                                           C, P, K4, E);
  return cudaGetLastError();
}

bool bad_sizes(int C, int P, int K4, int E, int event_tile) {
  const int n_tiles = E > 0 ? (E + kEventTile - 1) / kEventTile : 0;
  return C <= 0 || E <= 0 || P <= 0 || P > kMaxParams || K4 <= 0 || K4 % 4 != 0 ||
         event_tile != kEventTile || n_tiles > kMaxTiles;
}

}  // namespace

// Pass A. coeffs is f32 (coef_bf16 == 0) or bf16; bins is [E] (per_chain_bins
// == 0) or [C, E] int32; plan_ptr / plan_idx (CSR over tiles of event_tile
// events) may both be null, and then every parameter is evaluated. Outputs
// gbase, sev, pnz [C, E] f32 and nz [C, E] int32.
extern "C" int m3_reweight_grad_a(
    const void* seg, const void* t, const void* coeffs, int coef_bf16,
    const void* base_w, const void* bins, int per_chain_bins, const void* gmc,
    const void* gw2, const void* plan_ptr, const void* plan_idx, void* gbase,
    void* sev, void* pnz, void* nz, int C, int P, int K4, int E, int n_bins,
    int event_tile, void* stream) {
  const bool has_plan = plan_ptr != nullptr && plan_idx != nullptr;
  if (bad_sizes(C, P, K4, E, event_tile) || n_bins <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = (2 * static_cast<size_t>(kChainTile) * P + P) * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((C + kChainTile - 1) / kChainTile, (E + kEventTile - 1) / kEventTile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define M3_ARGS                                                                   \
  smem, grid, s, static_cast<const int*>(seg), static_cast<const float*>(t),      \
      coeffs, static_cast<const float*>(base_w), static_cast<const int*>(bins),   \
      static_cast<const float*>(gmc), static_cast<const float*>(gw2),             \
      static_cast<const int*>(plan_ptr), static_cast<const int*>(plan_idx),       \
      static_cast<float*>(gbase), static_cast<float*>(sev),                       \
      static_cast<float*>(pnz), static_cast<int*>(nz), C, P, K4, E, n_bins
#define M3_PICK(CoefT)                                                            \
  (per_chain_bins ? (has_plan ? launch_a<CoefT, true, true>(M3_ARGS)              \
                              : launch_a<CoefT, true, false>(M3_ARGS))            \
                  : (has_plan ? launch_a<CoefT, false, true>(M3_ARGS)             \
                              : launch_a<CoefT, false, false>(M3_ARGS)))
  const cudaError_t err = coef_bf16 ? M3_PICK(__nv_bfloat16) : M3_PICK(float);
#undef M3_PICK
#undef M3_ARGS
  return static_cast<int>(err);
}

// Pass B. Takes pass A's sev, pnz (f32) and nz (int32) [C, E] and writes
// partial [ceil(E / event_tile), C, P] f32: every entry, 0 for a parameter
// a tile's plan does not list. ḡ_t is its sum over the first axis.
extern "C" int m3_reweight_grad_b(
    const void* seg, const void* t, const void* coeffs, int coef_bf16,
    const void* sev, const void* pnz, const void* nz, const void* plan_ptr,
    const void* plan_idx, void* partial, int C, int P, int K4, int E,
    int event_tile, void* stream) {
  const bool has_plan = plan_ptr != nullptr && plan_idx != nullptr;
  if (bad_sizes(C, P, K4, E, event_tile)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      (static_cast<size_t>(kWarps) * kChainTile * P + 2 * static_cast<size_t>(kChainTile) * P +
       2 * static_cast<size_t>(P)) * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((C + kChainTile - 1) / kChainTile, (E + kEventTile - 1) / kEventTile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define M3_ARGS                                                                   \
  smem, grid, s, static_cast<const int*>(seg), static_cast<const float*>(t),      \
      coeffs, static_cast<const float*>(sev), static_cast<const float*>(pnz),     \
      static_cast<const int*>(nz), static_cast<const int*>(plan_ptr),             \
      static_cast<const int*>(plan_idx), static_cast<float*>(partial), C, P, K4, E
  cudaError_t err;
  if (coef_bf16) {
    err = has_plan ? launch_b<__nv_bfloat16, true>(M3_ARGS)
                   : launch_b<__nv_bfloat16, false>(M3_ARGS);
  } else {
    err = has_plan ? launch_b<float, true>(M3_ARGS) : launch_b<float, false>(M3_ARGS);
  }
#undef M3_ARGS
  return static_cast<int>(err);
}

extern "C" const char* m3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
