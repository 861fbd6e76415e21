// Hand-written Hopper (sm_90a) kernel for the closed-form inverse Cholesky
// factor of the Matérn-1/2 B0 cell Gram on a uniform mesh
// (vggp_tpu_torch/ops/kms.py: _tridiag_coefficients, m12_cell_factors,
// m12_geometric_ratio).
//
//   m12_finv   replaces no TPU kernel: the JAX package builds the same
//              closed form from jnp operations, which XLA fuses into a few
//              programs. Op by op in PyTorch it was about 740 launches an
//              axis, each a few scalars or one (m, m) pass, so the fit step
//              spent half its device time on launch latency.
//
// One launch writes the raw closed-form F⁻¹ = G⁻¹L⁻¹, the analytic factor
// F = L·G (both (m, m), lower-triangular, the zeros above the diagonal
// included) and the band ratio q = |b|/λ₁ of the variance-1 coefficients,
// the number ops/kms.m12_geometric_ratio returns.
//
// Bound on the H100: the two (m, m) stores, 2·m² values, 2 MB at m = 512 in
// float32 (0.63 µs at 3.35 TB/s); below m ≈ 1000 the scalar prologue's
// dependent chain (three Horner series, a few exp, sqrt and divisions,
// about a microsecond) is longer than that. Design: a 2-D grid of 32 × 32
// tiles. Every block recomputes the scalar coefficients in registers
// (nothing is shared between blocks, and one redundant chain costs no more
// time than one broadcast); then it builds in shared memory the slices of
// the length-m vectors its tile reads (q^k and ρ^k for the tile's 64
// diagonals, D̂, the G diagonal and subdiagonal for its 33 columns, 1/den and
// the first column's magnitude for its 32 rows), and writes the tile with
// one coalesced 128-byte store per warp and row. Tiles wholly above the
// diagonal write zeros and compute nothing.
//
// Order of operations. The scalars follow ops/kms._tridiag_coefficients and
// ops/stablemath operation by operation: the same Horner series and float32
// term cut-offs (10 terms of Σx^k/k!, 5 of the odd series), the same
// association, Python's delta/ℓ as reciprocal(ℓ)·delta (what
// Tensor.__rtruediv__ computes), 1 + rel_jitter in double as Python forms it.
// This source is built with -fmad=false so that no product and sum are
// contracted into one rounding, as no PyTorch operator chain contracts
// them: q is then the plain version's number bit for bit on the card. Powers
// of q and r are taken by squaring (the plain version's cumprod rounds once
// a factor; these at most twice a bit of k), ρ^k as exp(−k·u), as the plain
// version does.
//
// Templated on float and double. σ² and ℓ arrive as a 2-element device array
// (no host read of a trained parameter); δ and rel_jitter are host numbers.
// Plain C interface (loaded with ctypes): launches on the given stream and
// returns cudaGetLastError() as an int.

#include <cuda_runtime.h>

#include "cell_tile.cuh"

namespace {

using namespace vggp_tile;

constexpr int TILE = 32;
constexpr int THREADS = 256;
constexpr int ROWS_PER_PASS = THREADS / TILE;

// Σ_{k≥2} x^k/k! (ops/stablemath._series_expm1mx), |x| < 1.
template <typename T>
__device__ __forceinline__ T series_expm1mx(T x) {
  T acc = T(inv_fact(Terms<T>::n - 1));
#pragma unroll
  for (int k = Terms<T>::n - 2; k >= 0; --k) acc = acc * x + T(inv_fact(k));
  return acc * x * x;
}

template <typename T>
__device__ __forceinline__ T expm1mx(T x) {
  return fabs(x) < T(1) ? series_expm1mx(x) : exp_(x) - T(1) - x;
}

// Odd-series terms of sinh x − x: 1/3!, 1/5!, … (5 in float, 9 in double,
// ops/stablemath._INV_ODD_FACT and _N_ODD_TERMS_F32).
template <typename T> struct OddTerms;
template <> struct OddTerms<float> { static constexpr int n = 5; };
template <> struct OddTerms<double> { static constexpr int n = 9; };

template <typename T>
__device__ __forceinline__ T sinhmx(T x) {
  if (fabs(x) < T(1)) {
    const T x2 = x * x;
    T acc = T(inv_fact(2 * OddTerms<T>::n - 1));   // 1/(2k+3)! is inv_fact(2k + 1)
#pragma unroll
    for (int k = OddTerms<T>::n - 2; k >= 0; --k) acc = acc * x2 + T(inv_fact(2 * k + 1));
    return acc * x2 * x;
  }
  return T(0.5) * (expm1mx(x) - expm1mx(-x));
}

// C = γI + η_eff·W's scalars (ops/kms._tridiag_coefficients).
template <typename T>
struct Coef {
  T u, rho, s, a, b, b0, a0, sq, lam1;
};

template <typename T>
__device__ Coef<T> tridiag_coefficients(T delta, T variance, T ell, T rel, T rel1) {
  const T u = (T(1) / ell) * delta;
  const bool small = u < T(1);
  const T rho = small ? expm1s(-u) + T(1) : exp_(-fmax(u, T(1)));
  const T omr = -expm1s(-u);
  const T s2 = -expm1s(T(-2) * u);
  const T s = sqrt(s2);
  const T c = variance * ell * ell;

  const T diag0 = T(2) * c * expm1mx(-u);
  const T us = fmin(u, T(1));
  const T es = expm1s(us);
  const T eta_s = T(-2) * c * sinhmx(us) + rel * diag0;
  const T ul = fmax(u, T(1));
  const T smrho_l = T(-0.5) * expm1s(T(-2) * ul) - ul * exp_(-ul);
  const T eta_rho = small ? eta_s * rho : T(-2) * c * smrho_l + rel * diag0 * rho;

  const T gamma_s = c * es * es * exp_(-us);
  const T a_minus_2b = small ? gamma_s + eta_s * (T(1) + rho) / omr
                             : diag0 * rel1 * (T(1) + rho) / omr - T(2) * c * omr;
  const T a_plus_2b = (diag0 * rel1 * omr + T(2) * c * omr * omr) / (T(1) + rho);
  const T a = T(0.5) * (a_minus_2b + a_plus_2b);
  const T sq = sqrt(a_minus_2b * a_plus_2b);
  return {u, rho, s, a, -eta_rho / s2, -eta_rho / s, diag0 * rel1, sq, T(0.5) * (a + sq)};
}

// x^k, k ≥ 0, by squaring.
template <typename T>
__device__ __forceinline__ T ipow(T x, int k) {
  T r = T(1);
  while (k > 0) {
    if (k & 1) r = r * x;
    x = x * x;
    k >>= 1;
  }
  return r;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
m12_finv_kernel(const T* __restrict__ scal, double delta_d, double rel_d, T* __restrict__ finv,
                T* __restrict__ fmat, T* __restrict__ q_out, int m) {
  const int j0 = blockIdx.x * TILE, i0 = blockIdx.y * TILE;
  const int lane = threadIdx.x % TILE, rg = threadIdx.x / TILE;
  const T delta = T(delta_d), rel = T(rel_d), rel1 = T(1.0 + rel_d);
  const T variance = scal[0], ell = scal[1];

  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
    const Coef<T> c1 = tridiag_coefficients(delta, T(1), ell, rel, rel1);
    *q_out = fabs(c1.b) / c1.lam1;
  }
  const int j = j0 + lane;
  if (j0 > i0 + TILE - 1) {   // wholly above the diagonal
    for (int i = i0 + rg; i < min(i0 + TILE, m); i += ROWS_PER_PASS) {
      if (j < m) {
        const long long o = static_cast<long long>(i) * m + j;
        finv[o] = T(0);
        fmat[o] = T(0);
      }
    }
    return;
  }

  const Coef<T> co = tridiag_coefficients(delta, variance, ell, rel, rel1);
  const T lam2 = (co.b * co.b) / co.lam1;
  const T d1 = co.a0;
  const T d2 = co.a * d1 - co.b0 * co.b0;
  const T coef_a = (d2 - lam2 * d1) / co.sq;
  const T coef_b = (co.lam1 * d1 - d2) / co.sq;
  const T r = lam2 / co.lam1;
  const T q = fabs(co.b) / co.lam1;
  const T qb0 = fabs(co.b0) / co.lam1;
  // D̂_k = D_k/λ₁ᵏ, the leading principal minors normalised: D̂_0 = 1,
  // D̂_{k+1} = (coefA + coefB·r^k)/λ₁.
  auto dhat = [&](int k) { return k == 0 ? T(1) : (coef_a + coef_b * ipow(r, k - 1)) / co.lam1; };

  // the tile's diagonals k = i − j ∈ [kb, kb + 64), its columns j0..j0+32, its rows
  __shared__ T s_qk[2 * TILE], s_rhok[2 * TILE];
  __shared__ T s_dhat[TILE + 1], s_dvec[TILE], s_esub[TILE];
  __shared__ T s_inv_den[TILE], s_col0[TILE];
  const int kb = i0 - j0 - TILE;
  const int t = threadIdx.x;
  if (t < 2 * TILE) {
    const int k = kb + t;
    s_qk[t] = k >= 0 ? ipow(q, k) : T(0);
    s_rhok[t] = k >= 0 ? exp_(T(-k) * co.u) : T(0);
  } else if (t < 3 * TILE + 1) {
    const int c = t - 2 * TILE, jc = j0 + c;
    if (jc <= m) s_dhat[c] = dhat(jc);
    if (c < TILE && jc < m) {
      const T dv = sqrt((co.lam1 * dhat(jc + 1)) / dhat(jc));
      s_dvec[c] = dv;
      s_esub[c] = (jc == 0 ? co.b0 : co.b) / dv;
    }
  } else if (t >= 4 * TILE && t < 5 * TILE) {
    const int rr = t - 4 * TILE, ir = i0 + rr;
    if (ir < m) {
      s_inv_den[rr] = T(1) / sqrt((co.lam1 * dhat(ir)) * dhat(ir + 1));
      s_col0[rr] = qb0 * (ir == 0 ? T(1) : ipow(q, ir - 1));
    }
  }
  __syncthreads();
  if (j >= m) return;

  const T neg_sign_b = co.b >= T(0) ? T(-1) : T(1);
  const T ld = j == 0 ? T(1) : T(1) / co.s;       // L⁻¹ diagonal
  const T nrs = -co.rho / co.s;                    // L⁻¹ subdiagonal
  const T col_s0 = j == 0 ? T(1) : co.s;           // L's column scale
  const T col_s1 = co.s;
  const bool has_next = j + 1 < m;
  // (G⁻¹)_ij for i ≥ j, the row's 1/den already read
  auto ginv = [&](int i, int jj, int cj, T inv_den, T col0) {
    const int k = i - jj;
    const T mag = jj == 0 ? (i > 0 ? col0 : T(1)) : s_qk[k - kb];
    const T sgn = (k & 1) ? neg_sign_b : T(1);
    return sgn * mag * s_dhat[cj] * inv_den;
  };
  for (int rr = rg; rr < TILE; rr += ROWS_PER_PASS) {
    const int i = i0 + rr;
    if (i >= m) break;
    const long long o = static_cast<long long>(i) * m + j;
    if (i < j) {
      finv[o] = T(0);
      fmat[o] = T(0);
      continue;
    }
    const T inv_den = s_inv_den[rr], col0 = s_col0[rr];
    const int k = i - j;
    T fi = ginv(i, j, lane, inv_den, col0) * ld;
    T fm = s_rhok[k - kb] * col_s0 * s_dvec[lane];
    if (has_next && k >= 1) {   // the (i, j + 1) terms; zero above the diagonal
      fi = fi + ginv(i, j + 1, lane + 1, inv_den, col0) * nrs;
      fm = fm + s_rhok[k - 1 - kb] * col_s1 * s_esub[lane];
    }
    finv[o] = fi;
    fmat[o] = fm;
  }
}

template <typename T>
int launch_m12_finv(const T* scal, double delta, double rel, T* finv, T* fmat, T* q,
                    int m, cudaStream_t stream) {
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (m + TILE - 1) / TILE;
  m12_finv_kernel<T><<<dim3(tiles, tiles), THREADS, 0, stream>>>(scal, delta, rel, finv,
                                                                  fmat, q, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int m12_finv_f32(const float* scal, double delta, double rel_jitter, float* finv, float* fmat,
                 float* q, int m, void* stream) {
  return launch_m12_finv<float>(scal, delta, rel_jitter, finv, fmat, q, m,
                                static_cast<cudaStream_t>(stream));
}

int m12_finv_f64(const double* scal, double delta, double rel_jitter, double* finv,
                 double* fmat, double* q, int m, void* stream) {
  return launch_m12_finv<double>(scal, delta, rel_jitter, finv, fmat, q, m,
                                 static_cast<cudaStream_t>(stream));
}

}  // extern "C"
