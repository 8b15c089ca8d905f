// Layered-matter (PREM) oscillation grids for Hopper: one kernel, entry
// m3_osc_layered.
//
// It replaces no TPU kernel: the JAX package wrote the layered oscillation
// (mach3_tpu/osc/prob.py probabilities_layered) as plain jnp. The port's
// plain version (osc/prob.py probabilities_layered / _evolve_layers) runs it
// as torch ops: the eigensystems of each unique density as a chain of
// elementwise kernels, every layer's operator gathered and formed in device
// memory, the chain of 3x3 complex products as batched cuBLAS matmuls (32x32
// tiles for 3x3 matrices), the zenith groups cut and reassembled. At
// large700's shapes (512 chains, 20 zeniths x 50 energies, neutrinos and
// antineutrinos) that took 18.1 ms of device time a step on an H100.
//
// What it computes, for one atmospheric grid: for each chain c, neutrino or
// antineutrino, path (production height l, zenith z) and energy e,
//   P[side, c, l, z, e, a, b] = |A[b, a]|²,  A = Π_k exp(-i H(rho_k, E_e) L_k)
// over the path's layers in order (the first on the right), H the per-km
// Hamiltonian of the chain's parameters at the layer's effective density
// (Ye folded in, Ye = 0.5), U -> U* and A -> -A for antineutrinos.
//
// What bounds it: bytes. The grids are written once, 2 x C x L x NZ x NE x 9
// f32: 36.9 MB at large700's shapes, 11.0 us at 3.35 TB/s. The inputs are a
// few kB. Its arithmetic (~0.4 GFLOP of products at the benchmark's count,
// about as much again to form each layer's operator, a few hundred MFLOP of
// f64 phases) is tens of us at the card's f32 and f64 rates.
//
// What the design does about it:
//  * Nothing between the parameters and P touches device memory. A block owns
//    one (chain, neutrino or antineutrino) pair and a slice of energies. It
//    forms the PMNS matrix and the vacuum mass matrix in f64 in registers,
//    then the eigensystem of each (unique density, energy) of its slice into
//    shared memory, as osc/kernels.py herm_eigensystem gives it: the sorted
//    eigenvalues in f64 (an f64 trigonometric Cardano in place of the plain
//    version's f32 seeds and f64 Newton polish; both are exact to f64
//    rounding) and the Newton factors (H - l1) and (H - l1)(H - l2) in f32.
//    Structure of arrays, so that a warp's lanes (consecutive energies) read
//    consecutive words.
//  * Each thread then walks whole paths, one (height, zenith, energy) point
//    at a time, energies fastest, so that the lanes of a warp mostly share
//    a path and its layers. For each layer it forms exp(-i H L) in registers
//    from the shared eigensystem by Newton divided differences, as
//    evolution_from_eigensystem does (phases in f64, reduced mod 2 pi before
//    f32 trig), multiplies it into the running 3x3 complex amplitude and, at
//    the path's end, writes |A|² once: 9 f32 a point, the lanes' rows next
//    to each other.
//  * Zero-length layers (padding) are the identity and are skipped. Every
//    addition has a fixed order: the result is bit-identical from run to run.
//
// Its time beside the bound and the plain version's, at large700's grid on
// an H100, is in PERF.md's kernel table (chip_smoke.py's
// [osc-layered:kernel-time] line measures it).
#include <cuda_runtime.h>

namespace {

constexpr double kOscPhase = 1.266932679419849;     // osc/pmns.py OSC_PHASE
constexpr double kMatterA = 1.5264932435736812e-4;  // osc/pmns.py MATTER_A
constexpr double kHalfYe = 0.5;                     // Ye folded into the density
constexpr double kTwoPi = 6.283185307179586476925286766559;
constexpr double kPi = 3.14159265358979323846264338327950;
// A block: the energies of a (chain, neutrino or antineutrino) pair whose
// eigensystems it holds in shared memory, fewer where the unique densities'
// eigensystems would not fit, and its threads. The fastest at large700's
// grid of 5-50 energies by 64-256 threads.
constexpr int kBlockEnergies = 50;
constexpr int kThreads = 128;
// A block's shared memory at most (the H100's 227 KB).
constexpr int kSmemMax = 227 * 1024;
// One eigensystem: 3 f64 eigenvalues, then 4 x 9 f32: (H - l1) real part,
// H's imaginary part, (H - l1)(H - l2) real and imaginary parts.
constexpr int kLams = 3;
constexpr int kMats = 36;
constexpr int kEigBytes = kLams * 8 + kMats * 4;

struct Args {
  const double* params;   // [C, 6]: theta12, theta13, theta23, deltaCP, dm21², dm31²
  const double* energy;   // [NE] GeV
  const double* rho;      // [NR] effective densities, g/cm³
  const double* lengths;  // [L * NZ, NL] km
  const long long* idx;   // [L * NZ, NL] into rho
  float* out;             // [2, C, L * NZ, NE, 3, 3]
  int C, NE, NR, paths, NL, block_energies;
};

__device__ __forceinline__ double round_to_2pi(double x) {
  return x - kTwoPi * rint(x * (1.0 / kTwoPi));
}

// (sin x, cos x): the reduction mod 2 pi in f64, the trig in f32
// (osc/kernels.py _reduced_sincos).
__device__ __forceinline__ void reduced_sincos(double x, float* s, float* c) {
  sincosf(static_cast<float>(round_to_2pi(x)), s, c);
}

// First divided difference of f(l) = exp(-i l L):
// -i L e^{-i (a + b) L / 2} sinc((a - b) L / 2) (osc/kernels.py _phase_dd).
__device__ __forceinline__ void phase_dd(double a, double b, double len, float* re,
                                         float* im) {
  const double m = 0.5 * (a + b) * len;
  const double d = 0.5 * (a - b) * len;
  float sin_m, cos_m;
  reduced_sincos(m, &sin_m, &cos_m);
  const float sin_d = sinf(static_cast<float>(round_to_2pi(d)));
  const float x = static_cast<float>(d);
  const float sinc = fabsf(x) < 1e-4f ? 1.0f - x * x / 6.0f : sin_d / x;
  const float s = static_cast<float>(len) * sinc;
  *re = -s * sin_m;
  *im = -s * cos_m;
}

// One term of a Hermitian 3x3's real determinant: h[0, j] times the minor
// of the entries p and q.
__device__ __forceinline__ double det_term(const double* hr, const double* hi, int j, int p,
                                           int q) {
  const double m_re = hr[p] * hr[q] - hi[p] * hi[q];
  const double m_im = hr[p] * hi[q] + hi[p] * hr[q];
  return hr[j] * m_re - hi[j] * m_im;
}

// Real determinant of a Hermitian 3x3 (first-row expansion, osc/kernels.py
// herm_det's order).
__device__ __forceinline__ double herm_det(const double* hr, const double* hi) {
  double det = 0.0;
  det += det_term(hr, hi, 0, 4, 8);
  det -= det_term(hr, hi, 0, 5, 7);
  det -= det_term(hr, hi, 1, 3, 8);
  det += det_term(hr, hi, 1, 5, 6);
  det += det_term(hr, hi, 2, 3, 7);
  det -= det_term(hr, hi, 2, 4, 6);
  return det;
}

// a @ b for real 3x3, unrolled (osc/kernels.py _mm3's order).
__device__ __forceinline__ float mm3(const float* a, const float* b, int i, int k) {
  return a[3 * i] * b[k] + a[3 * i + 1] * b[3 + k] + a[3 * i + 2] * b[6 + k];
}

__global__ void osc_layered_kernel(const Args a) {
  extern __shared__ double smem[];
  const int c = blockIdx.x;
  const int side = blockIdx.y;  // 0 neutrinos, 1 antineutrinos
  const int e0 = blockIdx.z * a.block_energies;
  const int neb = min(a.block_energies, a.NE - e0);
  const int n_eig = a.NR * neb;
  double* lam = smem;                                     // [3][n_eig]
  float* mat = reinterpret_cast<float*>(lam + kLams * n_eig);  // [36][n_eig]

  // The chain's vacuum mass matrix U diag(0, dm21², dm31²) U† in f64
  // (osc/pmns.py pmns_matrix_real, hamiltonian_real).
  const double* par = a.params + static_cast<size_t>(c) * 6;
  double s12, c12, s13, c13, s23, c23, sd, cd;
  sincos(par[0], &s12, &c12);
  sincos(par[1], &s13, &c13);
  sincos(par[2], &s23, &c23);
  sincos(par[3], &sd, &cd);
  const double ur[9] = {c12 * c13, s12 * c13, s13 * cd,
                        -s12 * c23 - c12 * s23 * s13 * cd, c12 * c23 - s12 * s23 * s13 * cd,
                        s23 * c13,
                        s12 * s23 - c12 * c23 * s13 * cd, -c12 * s23 - s12 * c23 * s13 * cd,
                        c23 * c13};
  const double conj = side ? -1.0 : 1.0;  // U -> U* for antineutrinos
  const double ui[9] = {0.0, 0.0, conj * (-s13 * sd),
                        conj * (-c12 * s23 * s13 * sd), conj * (-s12 * s23 * s13 * sd), 0.0,
                        conj * (-c12 * c23 * s13 * sd), conj * (-s12 * c23 * s13 * sd), 0.0};
  const double m2[3] = {0.0, par[4], par[5]};
  double vac_r[9], vac_i[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      double rr = 0.0, ii = 0.0, ir = 0.0, ri = 0.0;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        rr += ur[3 * i + k] * m2[k] * ur[3 * j + k];
        ii += ui[3 * i + k] * m2[k] * ui[3 * j + k];
        ir += ui[3 * i + k] * m2[k] * ur[3 * j + k];
        ri += ur[3 * i + k] * m2[k] * ui[3 * j + k];
      }
      vac_r[3 * i + j] = rr + ii;
      vac_i[3 * i + j] = ir - ri;
    }
  }

  // The eigensystems of the slice, one (density, energy) a thread.
  const double potential = conj * kMatterA * kHalfYe;
  for (int j = threadIdx.x; j < n_eig; j += blockDim.x) {
    const int r = j / neb;
    const double e = a.energy[e0 + j % neb];
    const double pot = potential * a.rho[r] * e;
    const double scale = (2.0 * kOscPhase) / e;
    double hr[9], hi[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      hr[i] = (vac_r[i] + (i == 0 ? pot : 0.0)) * scale;
      hi[i] = vac_i[i] * scale;
    }
    // Trigonometric Cardano in f64 (osc/kernels.py herm_eigvals), sorted.
    const double q = (hr[0] + hr[4] + hr[8]) / 3.0;
    double dr[9];
    double p2 = 0.0;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      dr[i] = hr[i] - (i % 4 == 0 ? q : 0.0);
      p2 += dr[i] * dr[i] + hi[i] * hi[i];
    }
    const double p = sqrt(fmax(p2 / 6.0, 1e-30));
    const double rc = fmin(fmax(herm_det(dr, hi) / (2.0 * p * p * p), -1.0), 1.0);
    const double phi = fabs(rc) < 1.0 - 1e-13 ? acos(rc) : (rc > 0.0 ? 0.0 : kPi);
    double l1 = q + 2.0 * p * cos((phi + kTwoPi) / 3.0);
    double l2 = q + 2.0 * p * cos((phi + 2.0 * kTwoPi) / 3.0);
    double l3 = q + 2.0 * p * cos(phi / 3.0);
    double t;
    if (l1 > l2) { t = l1; l1 = l2; l2 = t; }
    if (l2 > l3) { t = l2; l2 = l3; l3 = t; }
    if (l1 > l2) { t = l1; l1 = l2; l2 = t; }
    lam[j] = l1;
    lam[n_eig + j] = l2;
    lam[2 * n_eig + j] = l3;
    // The Newton factors in f32.
    const float f1 = static_cast<float>(l1), f2 = static_cast<float>(l2);
    float m1r[9], m2r[9], h32[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const float h = static_cast<float>(hr[i]);
      m1r[i] = i % 4 == 0 ? h - f1 : h;
      m2r[i] = i % 4 == 0 ? h - f2 : h;
      h32[i] = static_cast<float>(hi[i]);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int ik = 3 * i + k;
        mat[ik * n_eig + j] = m1r[ik];
        mat[(9 + ik) * n_eig + j] = h32[ik];
        mat[(18 + ik) * n_eig + j] = mm3(m1r, m2r, i, k) - mm3(h32, h32, i, k);
        mat[(27 + ik) * n_eig + j] = mm3(m1r, h32, i, k) + mm3(h32, m2r, i, k);
      }
    }
  }
  __syncthreads();

  // The paths, one (height and zenith, energy) point a thread at a time.
  const int n_points = a.paths * neb;
  for (int pt = threadIdx.x; pt < n_points; pt += blockDim.x) {
    const int el = pt % neb;
    const int path = pt / neb;
    const double* len_row = a.lengths + static_cast<size_t>(path) * a.NL;
    const long long* idx_row = a.idx + static_cast<size_t>(path) * a.NL;
    float ar[9], ai[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      ar[i] = i % 4 == 0 ? 1.0f : 0.0f;
      ai[i] = 0.0f;
    }
    bool first = true;
    for (int k = 0; k < a.NL; ++k) {
      const double len = __ldg(len_row + k);
      if (len == 0.0) continue;
      const int j = static_cast<int>(__ldg(idx_row + k)) * neb + el;
      const double l1 = lam[j], l2 = lam[n_eig + j], l3 = lam[2 * n_eig + j];
      float s1, c1, f12r, f12i, f23r, f23i;
      reduced_sincos(l1 * len, &s1, &c1);
      phase_dd(l1, l2, len, &f12r, &f12i);
      phase_dd(l2, l3, len, &f23r, &f23i);
      const float d13 = static_cast<float>(l1 - l3);
      const float inv13 = fabsf(d13) < 1e-30f ? 0.0f : 1.0f / d13;
      const float f123r = (f12r - f23r) * inv13;
      const float f123i = (f12i - f23i) * inv13;
      // exp(-i H L) = f(l1) I + f[l1,l2] (H - l1) + f[l1,l2,l3] (H - l1)(H - l2)
      float opr[9], opi[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        const float m1 = mat[i * n_eig + j], h = mat[(9 + i) * n_eig + j];
        const float qr = mat[(18 + i) * n_eig + j], qi = mat[(27 + i) * n_eig + j];
        const float d = i % 4 == 0 ? 1.0f : 0.0f;
        opr[i] = c1 * d + f12r * m1 - f12i * h + f123r * qr - f123i * qi;
        opi[i] = -s1 * d + f12r * h + f12i * m1 + f123r * qi + f123i * qr;
      }
      if (first) {
#pragma unroll
        for (int i = 0; i < 9; ++i) {
          ar[i] = opr[i];
          ai[i] = opi[i];
        }
        first = false;
        continue;
      }
      float nr[9], ni[9];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          float sr = 0.0f, si = 0.0f;
#pragma unroll
          for (int n = 0; n < 3; ++n) {
            const float xr = opr[3 * i + n], xi = opi[3 * i + n];
            const float yr = ar[3 * n + m], yi = ai[3 * n + m];
            sr += xr * yr - xi * yi;
            si += xr * yi + xi * yr;
          }
          nr[3 * i + m] = sr;
          ni[3 * i + m] = si;
        }
      }
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        ar[i] = nr[i];
        ai[i] = ni[i];
      }
    }
    // A[b, a] = <b| U |a>  ->  P[a, b]
    float* o = a.out + ((static_cast<size_t>(side) * a.C + c) * a.paths + path) *
                           static_cast<size_t>(a.NE) * 9 +
               static_cast<size_t>(e0 + el) * 9;
#pragma unroll
    for (int al = 0; al < 3; ++al) {
#pragma unroll
      for (int be = 0; be < 3; ++be) {
        const int ba = 3 * be + al;
        o[3 * al + be] = ar[ba] * ar[ba] + ai[ba] * ai[ba];
      }
    }
  }
}

}  // namespace

// Plain C entry for ctypes. params [C, 6] f64 (angles in radians, dm² in
// eV²); energy [NE] f64; rho [NR] f64; lengths [paths, NL] f64 (paths = the
// production heights x zeniths); idx [paths, NL] int64, each in [0, NR);
// out [2, C, paths, NE, 3, 3] f32, every entry written. Returns a
// cudaError_t code: cudaErrorInvalidValue for sizes the kernel does not take
// (NR eigensystems of one energy that overflow a block's shared memory),
// otherwise cudaGetLastError() right after the launch.
extern "C" int m3_osc_layered(const void* params, const void* energy, const void* rho,
                              const void* lengths, const void* idx, void* out, int C, int NE,
                              int NR, int paths, int NL, void* stream) {
  if (params == nullptr || energy == nullptr || rho == nullptr || lengths == nullptr ||
      idx == nullptr || out == nullptr || C <= 0 || NE <= 0 || NR <= 0 || paths <= 0 ||
      NL <= 0 || NR > kSmemMax / kEigBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int block_energies = min(min(kBlockEnergies, NE), kSmemMax / (kEigBytes * NR));
  const size_t smem = static_cast<size_t>(NR) * block_energies * kEigBytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        osc_layered_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Args a{static_cast<const double*>(params), static_cast<const double*>(energy),
               static_cast<const double*>(rho), static_cast<const double*>(lengths),
               static_cast<const long long*>(idx), static_cast<float*>(out), C, NE, NR, paths,
               NL, block_energies};
  const dim3 grid(C, 2, (NE + block_energies - 1) / block_energies);
  osc_layered_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* m3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
