// Fused spline-reweight + Σw/Σw² histogram over per-chain bins, for Hopper.
//
// Replaces two TPU kernels of mach3_tpu/splines/pallas_reweight.py, both
// reached through fused_reweight_histogram (the "generic" route: a sample
// whose bins move with θ in a way no in-kernel binning covers — several
// shifts, or a custom binning with a shift — so the bins [C, E] come in as
// an input):
//  * K5, _kernel_maskreduce (hist="maskreduce"): entry m3_reweight_perchain;
//  * K5b, _kernel (hist="blockdiag", a radix block-diagonal MXU histogram
//    with the same output): entry m3_reweight_perchain_det, the same
//    function through a different, deterministic histogram.
// Per (chain c, event e):
//
//   w   = base[c,e] · Π_p resp_p(seg[c,p], t[c,p], coeffs[p,:,e])
//   mc[c, bins[c,e]] += w,   w2[c, bins[c,e]] += w²   (bins ∉ [0, n_bins) dropped)
//
// Responses: f32 Horner steps from 4 coefficient rows (spline_response.cuh),
// as the other forward kernels; bf16 tables are upcast on load. The norm
// product is in base (the generic route keeps it out of the kernel, as the
// JAX package's does). An event whose bin is dropped costs no response work.
//
// The TPU kernel K5 fills its histogram with one mask and two lane
// reductions per bin, O(B) work per event; K5b with radix one-hots fed to
// the MXU. Neither carries over: here each event adds to its one bin.
//
// What bounds it on this card: the two [C, E] inputs base and bins, 8 bytes
// per (chain, event) read once and coalesced along E (~119 MB for the
// experiment's numu_2d sample at 256 chains, ~36 µs at 3.35 TB/s), then the
// coefficient rows (4 per (param, event); the experiment's f32 tables, a few
// MB, stay in L2 and are re-read by every chain tile from there), then the
// shared-memory atomics of the histogram.
//
// m3_reweight_perchain (K5): grid (ceil(E / kEventsPerBlock), ceil(C / 8)),
// a [8][2][B] shared-memory histogram per block filled with shared float
// atomics, then one global atomicAdd per non-empty (chain, bin). The order of
// the sums changes from run to run.
//
// m3_reweight_perchain_det (K5b): grid (T = ceil(E / kEventsPerBlock),
// ceil(C / 4)). Each warp owns a private [4][2][B] histogram (8 warps: 128 KB
// of shared memory at B = 512). The warp takes 32 events at a time; for each
// chain its lanes find the lanes with the same bin (__match_any_sync), every
// lane sums the w of its group in lane order through 32 shuffles, and the
// group's lowest lane adds the sums to the warp's histogram: one writer per
// address, no atomics. At the end the block adds its 8 warp histograms in
// warp order and writes the tile's partial [T, 2, C, B]; the wrapper sums
// over T with torch.sum. No float atomics anywhere, so the result is the
// same bit for bit on every run, as the TPU's sequential grid was. The
// group sums cost 32 shuffles per lane per (chain, 32 events), several
// times K5's two atomics: K5 stays the default.
//
// Neither kernel allocates; mc and w2 must be zeroed [C, n_bins] f32 arrays
// (K5), partial any [T, 2, C, n_bins] f32 array (K5b). Launches go to the
// caller's stream; the entries return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "spline_response.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEventsPerBlock = 2048;  // PERCHAIN_EVENTS_PER_BLOCK in splines/reweight.py
constexpr int kChainTile = 8;
constexpr int kDetChainTile = 4;
constexpr int kMaxBins = 512;
constexpr int kMaxParams = 256;
constexpr int kMaxChainTiles = 65535;  // gridDim.y
constexpr unsigned kFullMask = 0xffffffffu;

// Stage the chain tile's [nct][P] segments and local coordinates.
__device__ __forceinline__ void stage_params(const int* seg, const float* tval, int* sh_seg,
                                             float* sh_t, int c0, int nct, int P) {
  for (int i = threadIdx.x; i < nct * P; i += kThreads) {
    sh_seg[i] = seg[static_cast<size_t>(c0) * P + i];
    sh_t[i] = tval[static_cast<size_t>(c0) * P + i];
  }
}

template <typename CoefT>
__global__ void __launch_bounds__(kThreads) reweight_perchain_kernel(
    const int* __restrict__ seg, const float* __restrict__ tval,
    const CoefT* __restrict__ coeffs, const float* __restrict__ base_w,
    const int* __restrict__ bins, float* __restrict__ mc, float* __restrict__ w2,
    int C, int P, int K4, int E, int n_bins) {
  extern __shared__ float smem[];
  float* hist = smem;                                            // [CT][2][B]
  float* sh_t = hist + kChainTile * 2 * n_bins;                  // [CT][P]
  int* sh_seg = reinterpret_cast<int*>(sh_t + kChainTile * P);   // [CT][P]

  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * kChainTile;
  const int nct = min(kChainTile, C - c0);
  const int e_begin = blockIdx.x * kEventsPerBlock;
  const int e_end = min(E, e_begin + kEventsPerBlock);

  for (int i = tid; i < kChainTile * 2 * n_bins; i += kThreads) hist[i] = 0.f;
  stage_params(seg, tval, sh_seg, sh_t, c0, nct, P);
  __syncthreads();

  const size_t es = static_cast<size_t>(E);
  for (int e = e_begin + tid; e < e_end; e += kThreads) {
    for (int c = 0; c < nct; ++c) {
      const size_t ce = static_cast<size_t>(c0 + c) * es + e;
      const int b = bins[ce];
      if (b < 0 || b >= n_bins) continue;
      const float w = m3::spline_weight(coeffs, sh_seg + c * P, sh_t + c * P, P, K4, es, e,
                                        base_w[ce]);
      float* hc = hist + c * 2 * n_bins;
      atomicAdd(hc + b, w);
      atomicAdd(hc + n_bins + b, w * w);
    }
  }
  __syncthreads();

  for (int i = tid; i < nct * n_bins; i += kThreads) {
    const int c = i / n_bins;
    const int b = i - c * n_bins;
    const float m = hist[c * 2 * n_bins + b];
    const float q = hist[c * 2 * n_bins + n_bins + b];
    const size_t o = static_cast<size_t>(c0 + c) * n_bins + b;
    if (m != 0.f) atomicAdd(mc + o, m);
    if (q != 0.f) atomicAdd(w2 + o, q);
  }
}

template <typename CoefT>
__global__ void __launch_bounds__(kThreads) reweight_perchain_det_kernel(
    const int* __restrict__ seg, const float* __restrict__ tval,
    const CoefT* __restrict__ coeffs, const float* __restrict__ base_w,
    const int* __restrict__ bins, float* __restrict__ partial, int C, int P,
    int K4, int E, int n_bins) {
  extern __shared__ float smem[];
  const int per_warp = kDetChainTile * 2 * n_bins;
  float* hist = smem;                                            // [W][CT][2][B]
  float* sh_t = hist + kWarps * per_warp;                        // [CT][P]
  int* sh_seg = reinterpret_cast<int*>(sh_t + kDetChainTile * P);  // [CT][P]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c0 = blockIdx.y * kDetChainTile;
  const int nct = min(kDetChainTile, C - c0);
  const int e_begin = blockIdx.x * kEventsPerBlock;
  const int e_end = min(E, e_begin + kEventsPerBlock);

  for (int i = tid; i < kWarps * per_warp; i += kThreads) hist[i] = 0.f;
  stage_params(seg, tval, sh_seg, sh_t, c0, nct, P);
  __syncthreads();

  const size_t es = static_cast<size_t>(E);
  float* own = hist + warp * per_warp;
  // e0 depends on the warp only, so the warp stays whole in the loop.
  for (int e0 = e_begin + warp * 32; e0 < e_end; e0 += kThreads) {
    const int e = e0 + lane;
    for (int c = 0; c < nct; ++c) {
      int key = -1;  // -1: no event, or its bin is dropped
      float w = 0.f;
      if (e < e_end) {
        const size_t ce = static_cast<size_t>(c0 + c) * es + e;
        const int b = bins[ce];
        if (b >= 0 && b < n_bins) {
          key = b;
          w = m3::spline_weight(coeffs, sh_seg + c * P, sh_t + c * P, P, K4, es, e, base_w[ce]);
        }
      }
      const unsigned peers = __match_any_sync(kFullMask, key);
      float sw = 0.f;
      float sq = 0.f;
#pragma unroll
      for (int src = 0; src < 32; ++src) {
        const float v = __shfl_sync(kFullMask, w, src);
        if ((peers >> src) & 1u) {
          sw += v;
          sq += v * v;
        }
      }
      if (key >= 0 && lane == __ffs(peers) - 1) {
        float* hc = own + c * 2 * n_bins;
        hc[key] += sw;
        hc[n_bins + key] += sq;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // The tile's partial: the warps' histograms added in warp order.
  for (int i = tid; i < nct * 2 * n_bins; i += kThreads) {
    const int c = i / (2 * n_bins);
    const int r = i - c * 2 * n_bins;  // k * n_bins + b, k = 0 (Σw) or 1 (Σw²)
    const int k = r / n_bins;
    const int b = r - k * n_bins;
    float s = 0.f;
    for (int wp = 0; wp < kWarps; ++wp) s += hist[wp * per_warp + i];
    partial[((static_cast<size_t>(blockIdx.x) * 2 + k) * C + c0 + c) * n_bins + b] = s;
  }
}

// Dynamic shared memory above 48 KB must be asked for per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  }
  return cudaSuccess;
}

bool bad_sizes(int C, int P, int K4, int E, int n_bins, int chain_tile) {
  return C <= 0 || E <= 0 || P <= 0 || P > kMaxParams || K4 <= 0 || K4 % 4 != 0 ||
         n_bins <= 0 || n_bins > kMaxBins ||
         (C + chain_tile - 1) / chain_tile > kMaxChainTiles;
}

}  // namespace

// Plain C entries for ctypes. coeffs is f32 (coef_bf16 == 0) or bf16.
// Return a cudaError_t code: cudaErrorInvalidValue for sizes the kernels do
// not take, otherwise cudaGetLastError() right after the launch.
extern "C" int m3_reweight_perchain(const void* seg, const void* t, const void* coeffs,
                                    int coef_bf16, const void* base_w, const void* bins,
                                    void* mc, void* w2, int C, int P, int K4, int E,
                                    int n_bins, void* stream) {
  if (bad_sizes(C, P, K4, E, n_bins, kChainTile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = (static_cast<size_t>(kChainTile) * 2 * n_bins +
                       2 * static_cast<size_t>(kChainTile) * P) * sizeof(float);
  const dim3 grid((E + kEventsPerBlock - 1) / kEventsPerBlock,
                  (C + kChainTile - 1) / kChainTile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define M3_ARGS                                                                  \
  static_cast<const int*>(seg), static_cast<const float*>(t), coeffs_t,          \
      static_cast<const float*>(base_w), static_cast<const int*>(bins),          \
      static_cast<float*>(mc), static_cast<float*>(w2), C, P, K4, E, n_bins
  if (coef_bf16) {
    auto kernel = reweight_perchain_kernel<__nv_bfloat16>;
    const auto* coeffs_t = static_cast<const __nv_bfloat16*>(coeffs);
    err = allow_smem(kernel, smem);
    if (err == cudaSuccess) kernel<<<grid, kThreads, smem, s>>>(M3_ARGS);
  } else {
    auto kernel = reweight_perchain_kernel<float>;
    const auto* coeffs_t = static_cast<const float*>(coeffs);
    err = allow_smem(kernel, smem);
    if (err == cudaSuccess) kernel<<<grid, kThreads, smem, s>>>(M3_ARGS);
  }
#undef M3_ARGS
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int m3_reweight_perchain_det(const void* seg, const void* t, const void* coeffs,
                                        int coef_bf16, const void* base_w, const void* bins,
                                        void* partial, int n_tiles, int C, int P, int K4,
                                        int E, int n_bins, void* stream) {
  if (bad_sizes(C, P, K4, E, n_bins, kDetChainTile) ||
      n_tiles != (E + kEventsPerBlock - 1) / kEventsPerBlock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = (static_cast<size_t>(kWarps) * kDetChainTile * 2 * n_bins +
                       2 * static_cast<size_t>(kDetChainTile) * P) * sizeof(float);
  const dim3 grid(n_tiles, (C + kDetChainTile - 1) / kDetChainTile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define M3_ARGS                                                                  \
  static_cast<const int*>(seg), static_cast<const float*>(t), coeffs_t,          \
      static_cast<const float*>(base_w), static_cast<const int*>(bins),          \
      static_cast<float*>(partial), C, P, K4, E, n_bins
  if (coef_bf16) {
    auto kernel = reweight_perchain_det_kernel<__nv_bfloat16>;
    const auto* coeffs_t = static_cast<const __nv_bfloat16*>(coeffs);
    err = allow_smem(kernel, smem);
    if (err == cudaSuccess) kernel<<<grid, kThreads, smem, s>>>(M3_ARGS);
  } else {
    auto kernel = reweight_perchain_det_kernel<float>;
    const auto* coeffs_t = static_cast<const float*>(coeffs);
    err = allow_smem(kernel, smem);
    if (err == cudaSuccess) kernel<<<grid, kThreads, smem, s>>>(M3_ARGS);
  }
#undef M3_ARGS
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* m3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
