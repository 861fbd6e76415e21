// The Matérn-1/2 B0 cell-integral tile math shared by the hand-written
// kernels (csrc/cell_kuf.cu, csrc/fused_whiten_tc.cu), as the JAX package
// shares _tile_kuf_F / _tile_kuf_dkuf between its Pallas kernels
// (vggp_tpu/ops/pallas_kernels.py).
#pragma once

#include <cuda_runtime.h>

namespace vggp_tile {

constexpr int BB = 128;  // band block of the structured F⁻¹ (ops/kms.BAND_BLOCK)

// e^x − 1 − x for |x| < 1: Horner series over 1/k!, k = 2.. (10 terms in
// float, all 17 in double) — the coefficients of ops/stablemath._INV_FACT;
// one_minus_1pd_emd's series takes one term more (1/19! below).
// A constexpr function, so that in the unrolled loop every coefficient is a
// compile-time immediate of the working type (no constant-memory loads and
// no double-to-float conversions per element).
__host__ __device__ constexpr double inv_fact(int k) {  // 1/(k + 2)!
  return k == 0 ? 0.5 : k == 1 ? 1.6666666666666666e-01
       : k == 2 ? 4.1666666666666664e-02 : k == 3 ? 8.3333333333333332e-03
       : k == 4 ? 1.3888888888888889e-03 : k == 5 ? 1.9841269841269841e-04
       : k == 6 ? 2.4801587301587302e-05 : k == 7 ? 2.7557319223985893e-06
       : k == 8 ? 2.7557319223985888e-07 : k == 9 ? 2.5052108385441720e-08
       : k == 10 ? 2.0876756987868100e-09 : k == 11 ? 1.6059043836821613e-10
       : k == 12 ? 1.1470745597729725e-11 : k == 13 ? 7.6471637318198164e-13
       : k == 14 ? 4.7794773323873853e-14 : k == 15 ? 2.8114572543455206e-15
       : k == 16 ? 1.5619206968586226e-16 : 8.2206352466243297e-18;
}

template <typename T> struct Terms;
template <> struct Terms<float> { static constexpr int n = 10; };
template <> struct Terms<double> { static constexpr int n = 17; };

__device__ __forceinline__ float exp_(float v) { return expf(v); }
__device__ __forceinline__ double exp_(double v) { return exp(v); }

template <typename T>
__device__ __forceinline__ T expm1s(T x) {
  const bool small = fabs(x) < T(1);
  const T xs = small ? x : T(0);
  T acc = T(inv_fact(Terms<T>::n - 1));
#pragma unroll
  for (int k = Terms<T>::n - 2; k >= 0; --k) acc = acc * xs + T(inv_fact(k));
  return small ? acc * xs * xs + xs : exp_(x) - T(1);
}

// What one cell row [a, b] contributes to every element of the row: its
// edges, δ/ℓ and expm1(−δ/ℓ) (the only series of the tile math).
template <typename T>
struct Row {
  T a, b, dd, em_dd;
};

template <typename T>
__device__ __forceinline__ Row<T> cell_row(T a, T b, T ell) {
  const T dd = (b - a) / ell;
  return {a, b, dd, expm1s(-dd)};
}

// 1/v for a positive normal v without the IEEE division's check for its slow
// path, a branch that holds back the loads and math after it: in float the
// approximate reciprocal and one Newton step (within an ulp of the
// quotient), in double the division.
__device__ __forceinline__ float recip_(float v) {
  const float r = __fdividef(1.0f, v);
  return fmaf(fmaf(-v, r, 1.0f), r, r);
}
__device__ __forceinline__ double recip_(double v) { return 1.0 / v; }

// cell_row with δ/ℓ a product by inv_ell = recip_(ℓ) (within an ulp of the
// quotient): no division.
template <typename T>
__device__ __forceinline__ Row<T> cell_row_inv(T a, T b, T inv_ell) {
  const T dd = (b - a) * inv_ell;
  return {a, b, dd, expm1s(-dd)};
}

// One element of (Kuf, ∂Kuf/∂ℓ) for a cell row and a point x:
//   Kuf = σ²ℓ·F,  ∂Kuf/∂ℓ = σ²(F + G)
// with F the 3-case closed form. Inside the cell the identity
// expm1(−u) + expm1(−w) = expm1(−δ/ℓ) − expm1(−u)·expm1(−w) leaves two
// plain exps per element; the series runs once per row (cell_row).
// The fused kernels' form: `inv_ell` = 1/ℓ multiplies instead of dividing by
// ℓ (within an ulp of the quotient) in the float32 one, the float64 one
// divides.
template <typename T, bool RECIP = false>
__device__ __forceinline__ void tile_kuf_dkuf(const Row<T>& r, T x, T var, T ell,
                                              T* kuf, T* dkuf, T inv_ell = T(0)) {
  const T u = RECIP ? fabs(x - r.a) * inv_ell : fabs(x - r.a) / ell;
  const T w = RECIP ? fabs(x - r.b) * inv_ell : fabs(x - r.b) / ell;
  const bool inside = (x >= r.a) && (x <= r.b);
  const T e_u = exp_(-u);
  const T e_w = exp_(-w);
  const T enear = fmax(e_u, e_w);
  const T F = inside ? -r.em_dd + (e_u - T(1)) * (e_w - T(1)) : enear * (-r.em_dd);
  *kuf = var * ell * F;
  const T near = fmin(u, w);
  const T e_dd = T(1) + r.em_dd;
  const T G = inside ? -(e_u * u + e_w * w) : enear * (near * (-r.em_dd) - e_dd * r.dd);
  *dkuf = var * (F + G);
}

// Kuf = σ²ℓ·F at K points of one cell row, for the cell_kuf kernel: the
// closed form of tile_kuf_dkuf with one exp where one suffices. Outside the
// cell (all but one cell row of a point) F = e^{−near}·(−expm1(−δ/ℓ)) with
// e^{−near} = exp(−min(u, w)), as pallas_kernels._cell_kuf_FG writes it, so
// Kuf = e^{−near}·`out_coef`, out_coef = σ²ℓ·(−expm1(−δ/ℓ)) once per row.
// Inside, the product identity needs the far exp too:
// F = −expm1(−δ/ℓ) + (e^{−near} − 1)(e^{−far} − 1), the same product as
// (e_u − 1)(e_w − 1). That part runs under one branch for the K points,
// which a warp takes only where one of its points lies in the row's cell.
// u and w multiply by inv_ell = 1/ℓ (within an ulp of the quotient): no
// division.
template <typename T, int K>
__device__ __forceinline__ void kuf_points(const Row<T>& r, const T (&x)[K], T inv_ell,
                                           T var_ell, T out_coef, T (&kuf)[K]) {
  T u[K], w[K], enear[K];
  bool in[K];
  bool any = false;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    u[k] = fabs(x[k] - r.a) * inv_ell;
    w[k] = fabs(x[k] - r.b) * inv_ell;
    enear[k] = exp_(-fmin(u[k], w[k]));
    kuf[k] = enear[k] * out_coef;
    in[k] = (x[k] >= r.a) && (x[k] <= r.b);
    any |= in[k];
  }
  if (__builtin_expect(any, 0)) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (in[k]) {
        const T efar = exp_(-fmax(u[k], w[k]));
        kuf[k] = var_ell * (-r.em_dd + (enear[k] - T(1)) * (efar - T(1)));
      }
    }
  }
}

// 1 − (1 + d)·e^{−d} = Σ_k (−1)^k (k + 1)/(k + 2)!·d^{k+2} for d = δ/ℓ ≥ 0,
// with om = −expm1(−d). Its two terms are each about d, and on the main
// path d ≈ 1.8e-3 (ℓ/δ ≈ 550), so their difference would keep only the
// rounding of the larger; below d = 1 the series (Terms<T>::n + 1 terms,
// the first left out under an ulp of the sum) gives it to an ulp or two.
// Above, the two terms no longer cancel.
template <typename T>
__device__ __forceinline__ T one_minus_1pd_emd(T d, T om) {
  if (d < T(1)) {
    constexpr int N = Terms<T>::n + 1;
    const T xs = -d;
    T acc = T(N * inv_fact(N - 1));
#pragma unroll
    for (int k = N - 2; k >= 0; --k) acc = acc * xs + T((k + 1) * inv_fact(k));
    return acc * d * d;
  }
  return om - (T(1) - om) * d;
}

// The per-row coefficients of (Kuf, ∂Kuf/∂ℓ) outside the cell, where
// F = e^{−near}·(−expm1(−δ/ℓ)) and
// G = e^{−near}·(near·(−expm1(−δ/ℓ)) − e^{−δ/ℓ}·δ/ℓ):
//   Kuf = e^{−near}·k,   ∂Kuf/∂ℓ = σ²(F + G) = e^{−near}·(c0 + c1·near),
//   k = σ²ℓ·(−expm1(−δ/ℓ)),  c1 = σ²·(−expm1(−δ/ℓ)),
//   c0 = σ²·(1 − (1 + δ/ℓ)e^{−δ/ℓ}).
template <typename T>
struct DlCoef {
  T k, c0, c1;
};

template <typename T>
__device__ __forceinline__ DlCoef<T> dl_coef(const Row<T>& r, T var, T var_ell) {
  const T om = -r.em_dd;
  return {var_ell * om, var * one_minus_1pd_emd(r.dd, om), var * om};
}

// (Kuf, ∂Kuf/∂ℓ) at K points of one cell row, for the cell_kuf_with_dl
// kernel: kuf_points with the second output. Outside the cell one exp and no
// division an element, from the row's DlCoef: near = min(|x − a|, |x − b|)/ℓ
// is one product by inv_ell (min and a positive product commute, so it is
// the same number as min(u, w)). Inside, under the branch a lane takes only
// where one of its points lies in the row's cell, the far exp, the product
// identity for F and G = −(e^{−near}·near + e^{−far}·far), as tile_kuf_dkuf,
// for all K points at once, each kept where it lies in the cell.
template <typename T, int K>
__device__ __forceinline__ void kuf_dl_points(const Row<T>& r, const T (&x)[K], T inv_ell,
                                              T var, T var_ell, const DlCoef<T>& c,
                                              T (&kuf)[K], T (&dl)[K]) {
  T near[K], enear[K];
  bool in[K];
  bool any = false;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    near[k] = fmin(fabs(x[k] - r.a), fabs(x[k] - r.b)) * inv_ell;
    enear[k] = exp_(-near[k]);
    kuf[k] = enear[k] * c.k;
    dl[k] = enear[k] * (c.c0 + c.c1 * near[k]);
    in[k] = (x[k] >= r.a) && (x[k] <= r.b);
    any |= in[k];
  }
  if (__builtin_expect(any, 0)) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T far = fmax(fabs(x[k] - r.a), fabs(x[k] - r.b)) * inv_ell;
      const T efar = exp_(-far);
      const T F = -r.em_dd + (enear[k] - T(1)) * (efar - T(1));
      kuf[k] = in[k] ? var_ell * F : kuf[k];
      dl[k] = in[k] ? var * (F - (enear[k] * near[k] + efar * far)) : dl[k];
    }
  }
}

}  // namespace vggp_tile
