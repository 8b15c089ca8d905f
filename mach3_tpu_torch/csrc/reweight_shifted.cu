// Fused spline-reweight + shifted-axis binning + Σw/Σw² histogram for Hopper.
//
// Replaces the TPU kernels K1, mach3_tpu/splines/pallas_reweight.py
// _kernel_maskreduce_shifted (with _resp_dot, _norm_weight and
// _shifted_bin_histogram), reached through fused_reweight_histogram_shifted,
// and K3, _kernel_shifted_blocked (the same function with P streamed through
// VMEM in blocks of 8; here the run-time loop over P, up to kMaxParams, takes
// the place of the blocks). It computes, per (chain c, event e):
//
//   w   = base[c,e] · Π_p resp_p · exp(Σ_k log|ext[c,k]|·S[k,e]) · (−1)^(Σ_k neg[c,k]·S[k,e])
//   x   = x_nom[e] · (1 + v[c])                      (shift kind "scale")
//         x_nom[e] + v[c]                            ("offset")
//         1 + (x_nom[e] − 1) · (1 + v[c])            ("scale_about_one")
//   idx = #(edges ≤ x) − 1
//   bin = static[e] + stride·idx, or the garbage bin n_bins when idx ∉ [0, n_axis)
//         or static[e] < 0
//   mc[c,bin] += w,  w2[c,bin] += w²                 (garbage bin dropped)
//
// Responses: resp_p = y + t(b + t(c + t·d)) from the 4 coefficient rows
// seg*4 + (0..3) of coeffs[p, :, e], in f32 (spline_response.cuh; the JAX
// production route rounds the deviation resp − 1 to bf16; this port does
// not).
//
// Norm: log|ext| is floored at 1e-30 as in the TPU kernel, so a zero norm
// gives a ~1e-30 weight, not an exact 0 (the JAX XLA route gives 0).
//
// Binning: x is formed with __fadd_rn/__fsub_rn/__fmul_rn, one rounding per
// operation in the plain version's order, so it cannot be contracted into an
// FMA and lands in the same bin as the f32 reference. The edge count
// is a binary search over the edges staged in shared memory; a NaN x compares
// false everywhere, gives idx = −1 and so goes to the garbage bin.
//
// What bounds it on this card, and what the design does about each:
//  * the [C, E] base_w read from device memory (~C·E·4 bytes a call): threads
//    run over events, so every read is coalesced and read once;
//  * the coefficient reads, 4 rows per (chain, param, event), coalesced along
//    E; chains of a tile that share a segment hit L1. The toy's dense tables
//    (~10-20 MB a sample) stay resident in the 50 MB L2, but the
//    reference-scale nue_beam table (43 params, 60k events, 103 MB in bf16)
//    does not: each of the C / kChainTile chain tiles reads the rows of its
//    event block again, and only blocks of one event block that run at the
//    same time share them in L2. At 128 chains x 60k events the grid is 30 x
//    16 blocks, few enough to be resident together, so device memory sees
//    each row about once a call; at many more events or chains the re-reads
//    reach device memory. All P params are read for every event (the shifted
//    route has no per-tile activity plan);
//  * the shared-memory atomics of the histogram: one [CT][2][B+1] histogram
//    per block, one shared atomicAdd per (chain, event) for each of Σw and
//    Σw², then one global atomicAdd per non-empty (chain, bin) per block.
//
// Sums are taken in an order that changes from run to run (atomics), so
// results agree with the plain version to f32 summation-order tolerance, not
// bit for bit.
//
// Launch: grid (ceil(E / kEventsPerBlock), ceil(C / kChainTile)), kThreads
// threads, on the caller's stream. It allocates nothing; mc and w2 must be
// zeroed [C, n_bins] f32 arrays. The entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "spline_response.cuh"

namespace {

constexpr int kChainTile = 8;
constexpr int kThreads = 256;
constexpr int kEventsPerBlock = 2048;
constexpr int kMaxBins = 512;
constexpr int kMaxEdges = 1025;
constexpr int kMaxParams = 256;
constexpr int kMaxNorm = 256;
// Shift kinds (splines/reweight.py SHIFT_KINDS); a is the per-chain
// constant: 1 + v, or v for "offset".
constexpr int kShiftScale = 0;        // x * (1 + v)
constexpr int kShiftOffset = 1;       // x + v
constexpr int kShiftAboutOne = 2;     // 1 + (x - 1) * (1 + v)

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

template <typename CoefT, bool kHasNorm>
__global__ void __launch_bounds__(kThreads) reweight_shifted_kernel(
    const int* __restrict__ seg, const float* __restrict__ tval,
    const CoefT* __restrict__ coeffs, const float* __restrict__ base_w,
    const float* __restrict__ shift_vals, const float* __restrict__ x_nom,
    const int* __restrict__ static_base, const float* __restrict__ edges,
    int n_edges, const float* __restrict__ norm_ext,
    const float* __restrict__ norm_s, int na1, float* __restrict__ mc,
    float* __restrict__ w2, int C, int P, int K4, int E, int n_bins,
    int stride_j, int n_axis_j, int shift_kind) {
  extern __shared__ float smem[];
  const int hb = n_bins + 1;                            // + garbage bin
  float* hist = smem;                                   // [CT][2][hb]
  float* sh_edges = hist + kChainTile * 2 * hb;         // [n_edges]
  float* sh_t = sh_edges + n_edges;                     // [CT][P]
  int* sh_seg = reinterpret_cast<int*>(sh_t + kChainTile * P);  // [CT][P]
  float* sh_logext = reinterpret_cast<float*>(sh_seg + kChainTile * P);
  float* sh_neg = sh_logext + kChainTile * na1;         // [CT][na1]
  float* sh_shift = sh_neg + kChainTile * na1;          // [CT] a of shift_x

  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * kChainTile;
  const int nct = min(kChainTile, C - c0);
  const int e_begin = blockIdx.x * kEventsPerBlock;
  const int e_end = min(E, e_begin + kEventsPerBlock);

  for (int i = tid; i < kChainTile * 2 * hb; i += kThreads) hist[i] = 0.f;
  for (int i = tid; i < n_edges; i += kThreads) sh_edges[i] = edges[i];
  for (int i = tid; i < nct * P; i += kThreads) {
    sh_seg[i] = seg[static_cast<size_t>(c0) * P + i];
    sh_t[i] = tval[static_cast<size_t>(c0) * P + i];
  }
  if (kHasNorm) {
    for (int i = tid; i < nct * na1; i += kThreads) {
      const float v = norm_ext[static_cast<size_t>(c0) * na1 + i];
      sh_logext[i] = logf(fmaxf(fabsf(v), 1e-30f));
      sh_neg[i] = v < 0.f ? 1.f : 0.f;
    }
  }
  for (int i = tid; i < nct; i += kThreads) {
    const float v = shift_vals[c0 + i];
    sh_shift[i] = shift_kind == kShiftOffset ? v : __fadd_rn(1.0f, v);
  }
  __syncthreads();

  const size_t es = static_cast<size_t>(E);
  for (int e = e_begin + tid; e < e_end; e += kThreads) {
    const float xn = x_nom[e];
    const int sb = static_base[e];
    for (int c = 0; c < nct; ++c) {
      float w = m3::spline_weight(coeffs, sh_seg + c * P, sh_t + c * P, P, K4, es, e,
                                  base_w[static_cast<size_t>(c0 + c) * es + e]);
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
      const float x = shift_x(shift_kind, xn, sh_shift[c]);
      int lo = 0;
      int hi = n_edges;
      while (lo < hi) {  // count of edges <= x (edges strictly increasing)
        const int mid = (lo + hi) >> 1;
        if (sh_edges[mid] <= x) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      const int idx = lo - 1;
      const bool valid = idx >= 0 && idx < n_axis_j && sb >= 0;
      const int bin = valid ? sb + stride_j * idx : n_bins;
      float* hc = hist + c * 2 * hb;
      atomicAdd(hc + bin, w);
      atomicAdd(hc + hb + bin, w * w);
    }
  }
  __syncthreads();

  for (int i = tid; i < nct * n_bins; i += kThreads) {
    const int c = i / n_bins;
    const int b = i - c * n_bins;
    const float m = hist[c * 2 * hb + b];
    const float q = hist[c * 2 * hb + hb + b];
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
      static_base, edges, n_edges, norm_ext, norm_s, na1, mc, w2, C, P, K4, E,
      n_bins, stride_j, n_axis_j, shift_kind);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. coeffs is f32 (coef_bf16 == 0) or bf16; norm_ext
// and norm_s may be null (na1 is then ignored). Returns a cudaError_t code:
// cudaErrorInvalidValue for sizes the kernel does not take, otherwise
// cudaGetLastError() right after the launch.
extern "C" int m3_reweight_shifted(
    const void* seg, const void* t, const void* coeffs, int coef_bf16,
    const void* base_w, const void* shift_vals, const void* x_nom,
    const void* static_base, const void* edges, int n_edges,
    const void* norm_ext, const void* norm_s, int na1, void* mc, void* w2,
    int C, int P, int K4, int E, int n_bins, int stride_j, int n_axis_j,
    int shift_kind, void* stream) {
  const bool has_norm = norm_ext != nullptr && norm_s != nullptr;
  if (!has_norm) na1 = 0;
  if (C <= 0 || E <= 0 || P <= 0 || P > kMaxParams || K4 <= 0 || K4 % 4 != 0 ||
      n_bins <= 0 || n_bins > kMaxBins || n_edges < 2 || n_edges > kMaxEdges ||
      n_axis_j != n_edges - 1 || na1 < 0 || na1 > kMaxNorm ||
      shift_kind < kShiftScale || shift_kind > kShiftAboutOne) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t floats = static_cast<size_t>(kChainTile) * 2 * (n_bins + 1) +
                        n_edges + 2 * static_cast<size_t>(kChainTile) * P +
                        2 * static_cast<size_t>(kChainTile) * na1 + kChainTile;
  const size_t smem = floats * sizeof(float);
  const dim3 grid((E + kEventsPerBlock - 1) / kEventsPerBlock,
                  (C + kChainTile - 1) / kChainTile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define M3_ARGS                                                              \
  smem, grid, s, static_cast<const int*>(seg), static_cast<const float*>(t), \
      coeffs, static_cast<const float*>(base_w),                             \
      static_cast<const float*>(shift_vals), static_cast<const float*>(x_nom), \
      static_cast<const int*>(static_base), static_cast<const float*>(edges), \
      n_edges, static_cast<const float*>(norm_ext),                          \
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
