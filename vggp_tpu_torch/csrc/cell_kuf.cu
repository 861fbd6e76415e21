// Hand-written Hopper (sm_90a) kernels for the Matérn-1/2 B0 cell-integral
// cross-covariance Kuf, the hot construction of the gridded SVGP step.
//
// The kernels share one __device__ copy of the tile math (cell_tile.cuh),
// as the JAX package shares _tile_kuf_F / _tile_kuf_dkuf between its Pallas
// kernels:
//
//   cell_kuf                 replaces vggp_tpu/ops/pallas_kernels.py:84
//                            (cell_kuf, pallas_call at :104)
//   cell_kuf_with_dl         replaces vggp_tpu/ops/pallas_kernels.py:134
//                            (cell_kuf_with_dl, pallas_call at :156)
//   fused_banded_whiten_kuf  replaces vggp_tpu/ops/pallas_kernels.py:231
//                            (fused_banded_whiten_kuf, pallas_call at :269);
//                            float64 only here, the float32 kernel is the
//                            tensor-core one in fused_whiten_tc.cu
//
// Kernels 1 and 2 are templated on float and double. Variance and
// lengthscale arrive as a 2-element device array (the Pallas kernels' SMEM
// `scal`), so a launch needs no host read of a trained parameter. The ragged
// edges are masked in the kernels: outputs are exactly (m, n). Built without
// --use_fast_math: expf/exp and the divisions are the precise ones, because
// the closed forms are cancellation-sensitive
// (vggp_tpu_torch/ops/stablemath.py).
//
// Plain C interface (loaded with ctypes): every entry point launches on the
// stream it is given and returns cudaGetLastError() as an int.

#include <cstdint>

#include <cuda_runtime.h>

#include "cell_tile.cuh"

namespace {

using namespace vggp_tile;

// ---------------------------------------------------------------------------
// Kernel 1: cell_kuf, Kuf alone (the serving path's kernel).
//
// Bound on the H100: the output writes, m·n values once, which the card can
// take at 3.35 TB/s only if the instructions per element stay below about 40
// (its ~33e12 lane-instructions a second over ~0.84e12 floats a second). A
// precise expf is 8 instructions in the SASS and an IEEE division about 9, so
// the element's work is kept to one exp and no division (kuf_points in
// cell_tile.cuh): 1/ℓ is one division per thread, the far exp runs only
// inside the cell, the row's δ/ℓ and series (cell_row) only when a warp
// enters a new row.
//
// Design: one wave of blocks (at most what the card holds at once, occupancy
// × SMs) over a list of m·⌈n / CHUNK⌉ chunks in row-major order; a
// chunk is CHUNK = 32·VN consecutive points of one cell row, VN = 16 bytes of
// points (4 floats, 2 doubles) per lane. Each warp walks its own contiguous
// run of chunks (the runs differ by at most one chunk), so a run crosses
// few row ends and the per-warp set-up is paid once. With VEC each lane
// loads its VN points and stores its VN values as one 16-byte access, the
// warp on 512 contiguous bytes; the wrapper's launch takes VEC when x and
// out are 16-byte aligned and n % VN = 0 (every row start aligned), and the
// scalar instance otherwise (ragged n, x a view at an offset). The stores
// are plain (not evict-first): the banded apply reads Kuf right after, and
// at the main path's (512, 4096) it stays in L2.
// ---------------------------------------------------------------------------

constexpr int KUF_THREADS = 256;
constexpr int KUF_WARPS = KUF_THREADS / 32;
constexpr int KUF_MIN_CHUNKS = 4;   // per warp, where the shape allows (plan_wave)
constexpr int DL_MIN_CHUNKS = 1;    // the same for cell_kuf_with_dl (see its launch)

template <typename T> struct Vec16;
template <> struct Vec16<float> { using V = float4; static constexpr int n = 4; };
template <> struct Vec16<double> { using V = double2; static constexpr int n = 2; };

// The VN points of a lane at column j (clamped into the row: the values of a
// lane past n are computed and not stored).
template <typename T, bool VEC>
__device__ __forceinline__ void load_points(const T* __restrict__ x, int j, int n,
                                            T (&xv)[Vec16<T>::n]) {
  using V = typename Vec16<T>::V;
  constexpr int VN = Vec16<T>::n;
  if constexpr (VEC) {
    const V v = *reinterpret_cast<const V*>(x + min(j, n - VN));
    if constexpr (VN == 4) { xv[0] = v.x; xv[1] = v.y; xv[2] = v.z; xv[3] = v.w; }
    else { xv[0] = v.x; xv[1] = v.y; }
  } else {
#pragma unroll
    for (int k = 0; k < VN; ++k) xv[k] = x[min(j + k, n - 1)];
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_points(T* __restrict__ row_out, int j, int n,
                                             const T (&f)[Vec16<T>::n]) {
  using V = typename Vec16<T>::V;
  constexpr int VN = Vec16<T>::n;
  if constexpr (VEC) {
    if (j < n) {
      if constexpr (VN == 4) *reinterpret_cast<V*>(row_out + j) = V{f[0], f[1], f[2], f[3]};
      else *reinterpret_cast<V*>(row_out + j) = V{f[0], f[1]};
    }
  } else {
#pragma unroll
    for (int k = 0; k < VN; ++k)
      if (j + k < n) row_out[j + k] = f[k];
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(KUF_THREADS)
cell_kuf_primal_kernel(const T* __restrict__ mesh, const T* __restrict__ x,
                       const T* __restrict__ scal, T* __restrict__ out, int n, int per_row,
                       int per_warp, int extra) {
  constexpr int VN = Vec16<T>::n;
  constexpr int CHUNK = 32 * VN;
  // warp w takes per_warp chunks, one more if w < extra, from
  // c = w·per_warp + min(w, extra) on
  const int warp = blockIdx.x * KUF_WARPS + threadIdx.x / 32;
  int left = per_warp + (warp < extra ? 1 : 0);
  if (left == 0) return;
  const int c = warp * per_warp + min(warp, extra);
  const int lane = threadIdx.x % 32;
  int i = c / per_row;
  int j = (c - i * per_row) * CHUNK + lane * VN;

  // the first chunk's points are loaded alongside the scalars and the row's
  // edges, and every later chunk's during the math of the one before it
  T xv[VN];
  load_points<T, VEC>(x, j, n, xv);
  const T ell = scal[1];
  const T var_ell = scal[0] * ell;
  const T inv_ell = T(1) / ell;
  Row<T> row = cell_row(mesh[i], mesh[i + 1], ell);
  T out_coef = var_ell * (-row.em_dd);
  for (;;) {
    int jn = j + CHUNK;
    const bool next_row = jn - lane * VN >= n;
    if (next_row) jn = lane * VN;
    T xn[VN], f[VN];
    load_points<T, VEC>(x, jn, n, xn);
    kuf_points(row, xv, inv_ell, var_ell, out_coef, f);
    store_points<T, VEC>(out + static_cast<size_t>(i) * n, j, n, f);
    if (--left == 0) break;
    j = jn;
#pragma unroll
    for (int k = 0; k < VN; ++k) xv[k] = xn[k];
    if (next_row) {   // the run enters the next row
      ++i;
      row = cell_row(mesh[i], mesh[i + 1], ell);
      out_coef = var_ell * (-row.em_dd);
    }
  }
}

// The wave a kernel of KUF_THREADS threads launches over `chunks` chunks:
// `grid` blocks, each warp `per_warp` chunks and the first `extra` warps one
// more. Blocks per SM: as many as fit (`per_sm_max`, the occupancy query,
// made once per device and kernel instance), but no more than leave each warp
// about `min_chunks` chunks, so that a small shape does not pay the
// per-warp set-up (1/ℓ, the row's series, the run's start) for one or two
// chunks; the same count on every SM keeps their shares even.
struct Wave {
  int grid, per_warp, extra;
};

template <typename Kernel>
cudaError_t plan_wave(Kernel kernel, long long chunks, int min_chunks, int (&sms)[64],
                      int (&per_sm_max)[64], Wave* wave) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (per_sm_max[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm_max[dev], kernel,
                                                          KUF_THREADS, 0);
    if (err != cudaSuccess) return err;
  }
  if (chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long per_sm_need =
      (chunks + static_cast<long long>(sms[dev]) * KUF_WARPS * min_chunks - 1) /
      (static_cast<long long>(sms[dev]) * KUF_WARPS * min_chunks);
  const long long per_sm = per_sm_need < per_sm_max[dev] ? per_sm_need : per_sm_max[dev];
  const long long need = (chunks + KUF_WARPS - 1) / KUF_WARPS;
  wave->grid = static_cast<int>(need < sms[dev] * per_sm ? need : sms[dev] * per_sm);
  const int warps = wave->grid * KUF_WARPS;
  wave->per_warp = static_cast<int>(chunks / warps);
  wave->extra = static_cast<int>(chunks % warps);
  return cudaSuccess;
}

template <typename T, bool VEC>
int launch_cell_kuf_primal(const T* mesh, const T* x, const T* scal, T* out, int m, int n,
                           cudaStream_t stream) {
  static int sms[64], per_sm_max[64];   // by device
  constexpr int CHUNK = 32 * Vec16<T>::n;
  const long long per_row = (n + CHUNK - 1) / CHUNK;
  Wave w;
  const cudaError_t err = plan_wave(cell_kuf_primal_kernel<T, VEC>, per_row * m,
                                    KUF_MIN_CHUNKS, sms, per_sm_max, &w);
  if (err != cudaSuccess) return static_cast<int>(err);
  cell_kuf_primal_kernel<T, VEC><<<w.grid, KUF_THREADS, 0, stream>>>(
      mesh, x, scal, out, n, static_cast<int>(per_row), w.per_warp, w.extra);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_cell_kuf(const T* mesh, const T* x, const T* scal, T* out, int m, int n,
                    cudaStream_t stream) {
  constexpr int VN = Vec16<T>::n;
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 && n % VN == 0;
  return vec ? launch_cell_kuf_primal<T, true>(mesh, x, scal, out, m, n, stream)
             : launch_cell_kuf_primal<T, false>(mesh, x, scal, out, m, n, stream);
}

// c / d for 0 ≤ c < 2^31 and d ≥ 1 as one wide product and a shift
// (Granlund and Montgomery, 1994: with l = ⌈log2 d⌉ and m = ⌈2^(32+l) / d⌉,
// c / d = ⌊c·m / 2^(32+l)⌋ for every c < 2^32; m < 2^33, so c·m < 2^64 for
// c < 2^31, which plan_wave checks): an integer division would be the
// longest dependent chain before a warp's first load.
struct Divider {
  unsigned long long m;
  int shift;
};

inline Divider make_divider(unsigned d) {
  int l = 0;
  while ((1ull << l) < d) ++l;
  return {((1ull << (32 + l)) + d - 1) / d, 32 + l};
}

__device__ __forceinline__ int divide(int c, const Divider& dv) {
  return static_cast<int>((static_cast<unsigned long long>(c) * dv.m) >> dv.shift);
}

// ---------------------------------------------------------------------------
// Kernel 2: cell_kuf_with_dl, (Kuf, ∂Kuf/∂ℓ) in one pass (training below the
// fused kernel's batch).
//
// Bound on the H100: the output writes, 2·m·n values once (8 bytes an
// element in float32) at 3.35 TB/s, about 0.42e12 elements a second. The
// function needs 22 fp32 instructions an element (chip_smoke.OPS_KUF_DL)
// against the ~80 that the card's ~33e12 lane-instructions a second leave
// at that rate, so the writes bound it: the element's work is kept near
// the 22 (no division, one exp outside the cell, the row's series once a
// row) and each lane stores 16 bytes an output.
//
// Design: kernel 1's traversal with two outputs. One wave of blocks
// (plan_wave, one chunk a warp where the card holds the blocks) over the
// m·⌈n / CHUNK⌉ chunks in row-major order, each warp on a contiguous run of
// them; 16 bytes of points a lane, loaded during the previous chunk's math,
// and each output stored 16 bytes a lane (VEC; the scalar instance for
// ragged n, an x that is a view at an offset, or an unaligned output). Per
// element outside the cell (all but one row of a point): one exp and no
// division (kuf_dl_points), from the row's DlCoef, computed when a run
// enters a row. c0 = σ²(1 − (1 + δ/ℓ)e^{−δ/ℓ}) takes a short series below
// δ/ℓ = 1 (one_minus_1pd_emd): the JAX form's two terms of size
// σ²e^{−near}·δ/ℓ, which cancel to σ²e^{−near}·(near·δ/ℓ + (δ/ℓ)²/2), are
// taken in one rounded number a row. Inside the cell, the far exp and the
// product identity, under a branch. The stores are plain (not evict-first):
// the banded apply reads both outputs right after, and at the main path's
// (512, 4096) their 16.8 MB stay in the 50 MB L2.
//
// At the small shapes (a few hundred chunks) a launch is one chunk a warp,
// so its time is the latency of a warp's chain before its first load and
// its first store. That chain has no IEEE division (1/ℓ by recip_, δ/ℓ a
// product: each division's check for its slow path is a branch that the
// loads and math after it waited behind) and no integer division (c / per_row
// by Divider). On an H100 the two took 0.00016–0.00019 and 0.00006–0.00008
// ms off a launch of about 0.0015 ms (tools/torch_cell_kuf_ab.py; PERF.md §6).
// ---------------------------------------------------------------------------

template <typename T, bool VEC>
__global__ void __launch_bounds__(KUF_THREADS)
cell_kuf_with_dl_kernel(const T* __restrict__ mesh, const T* __restrict__ x,
                        const T* __restrict__ scal, T* __restrict__ out,
                        T* __restrict__ dl, int n, int per_row, Divider by_row, int per_warp,
                        int extra) {
  constexpr int VN = Vec16<T>::n;
  constexpr int CHUNK = 32 * VN;
  const int warp = blockIdx.x * KUF_WARPS + threadIdx.x / 32;
  int left = per_warp + (warp < extra ? 1 : 0);
  if (left == 0) return;
  const int c = warp * per_warp + min(warp, extra);
  const int lane = threadIdx.x % 32;
  int i = divide(c, by_row);   // c / per_row
  int j = (c - i * per_row) * CHUNK + lane * VN;

  // the first chunk's points and row edges are loaded first, alongside the
  // scalars; 1/ℓ and δ/ℓ take no IEEE division (recip_, cell_row_inv)
  T xv[VN];
  load_points<T, VEC>(x, j, n, xv);
  const T a0 = mesh[i], b0 = mesh[i + 1];
  const T var = scal[0];
  const T ell = scal[1];
  const T var_ell = var * ell;
  const T inv_ell = recip_(ell);
  Row<T> row = cell_row_inv(a0, b0, inv_ell);
  DlCoef<T> coef = dl_coef(row, var, var_ell);
  for (;;) {
    int jn = j + CHUNK;
    const bool next_row = jn - lane * VN >= n;
    if (next_row) jn = lane * VN;
    T xn[VN], f[VN], g[VN];
    load_points<T, VEC>(x, jn, n, xn);
    kuf_dl_points(row, xv, inv_ell, var, var_ell, coef, f, g);
    const size_t base = static_cast<size_t>(i) * n;
    store_points<T, VEC>(out + base, j, n, f);
    store_points<T, VEC>(dl + base, j, n, g);
    if (--left == 0) break;
    j = jn;
#pragma unroll
    for (int k = 0; k < VN; ++k) xv[k] = xn[k];
    if (next_row) {   // the run enters the next row
      ++i;
      row = cell_row_inv(mesh[i], mesh[i + 1], inv_ell);
      coef = dl_coef(row, var, var_ell);
    }
  }
}

// One chunk a warp where the card holds the blocks (DL_MIN_CHUNKS = 1): the
// shapes that fill less than a wave at 4 chunks a warp ran faster with more
// warps on shorter runs (at (15, 20 000) 0.00246 against 0.00285 ms on an
// H100, tools/torch_cell_kuf_ab.py), and the others fill the card either way.
template <typename T, bool VEC>
int launch_cell_kuf_with_dl_wave(const T* mesh, const T* x, const T* scal, T* out, T* dl,
                                 int m, int n, cudaStream_t stream) {
  static int sms[64], per_sm_max[64];   // by device
  constexpr int CHUNK = 32 * Vec16<T>::n;
  const long long per_row = (n + CHUNK - 1) / CHUNK;
  Wave w;
  const cudaError_t err = plan_wave(cell_kuf_with_dl_kernel<T, VEC>, per_row * m,
                                    DL_MIN_CHUNKS, sms, per_sm_max, &w);
  if (err != cudaSuccess) return static_cast<int>(err);
  cell_kuf_with_dl_kernel<T, VEC><<<w.grid, KUF_THREADS, 0, stream>>>(
      mesh, x, scal, out, dl, n, static_cast<int>(per_row),
      make_divider(static_cast<unsigned>(per_row)), w.per_warp, w.extra);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_cell_kuf_with_dl(const T* mesh, const T* x, const T* scal, T* out, T* dl,
                            int m, int n, cudaStream_t stream) {
  constexpr int VN = Vec16<T>::n;
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dl) % 16 == 0 && n % VN == 0;
  return vec ? launch_cell_kuf_with_dl_wave<T, true>(mesh, x, scal, out, dl, m, n, stream)
             : launch_cell_kuf_with_dl_wave<T, false>(mesh, x, scal, out, dl, m, n, stream);
}

// ---------------------------------------------------------------------------
// Kernel 3 in float64: fused_banded_whiten_kuf.
//
// (a, t) = (F⁻¹·Kuf, F⁻¹·∂Kuf/∂ℓ) for a block-bidiagonal F⁻¹ at BB = 128:
// output band block i is D_i·K_i + S_i·K_{i−1}, with D_i = F⁻¹[i, i],
// S_i = F⁻¹[i, i−1] (zero at i = 0) and K_i the Kuf rows of band i. The Kuf
// and ∂Kuf tiles are generated on chip and never written to device memory.
//
// This body serves the float64 checks only: it ignores the precision strings
// and multiplies in f64 FMA on the CUDA cores. The float32 kernel of the main
// path is fused_whiten_tc.cu. Design: one block per (band block, TN columns);
// the 128-deep contraction walks k-chunks of KC rows. Per chunk the block
// generates the KC×TN Kuf and ∂Kuf tiles of the current and the previous
// band into shared memory, stages the matching (BB, KC) slices of D and S,
// and every thread accumulates an 8-row × 4-column register tile of a and of
// t with FMAs: 4·KC·TN + 2·BB·KC doubles, 32 KB at KC = 8.
// ---------------------------------------------------------------------------

constexpr int FW_TN = 64;       // points per block
constexpr int FW_THREADS = 256;
constexpr int FW_RT = 8;        // rows per thread   (16 row groups × 8 = 128)
constexpr int FW_CT = 4;        // columns per thread (16 col lanes × 4 = 64)
constexpr int FW_KC = 8;        // contraction rows per chunk

template <typename T>
__global__ void __launch_bounds__(FW_THREADS)
fused_whiten_kernel(const T* __restrict__ finv, const T* __restrict__ mesh,
                    const T* __restrict__ x, const T* __restrict__ scal,
                    T* __restrict__ a_out, T* __restrict__ t_out, int m, int n) {
  constexpr int KC = FW_KC;
  __shared__ T kc_s[KC][FW_TN], dkc_s[KC][FW_TN];   // current band rows
  __shared__ T kp_s[KC][FW_TN], dkp_s[KC][FW_TN];   // previous band rows
  __shared__ T d_s[BB][KC], s_s[BB][KC];            // F⁻¹ diag / sub slices

  const int band = blockIdx.y;
  const int j0 = blockIdx.x * FW_TN;
  const int tid = threadIdx.x;
  const int ty = tid / 16;   // row group
  const int tx = tid % 16;   // column lane
  const bool has_prev = band > 0;
  const T var = scal[0];
  const T ell = scal[1];
  const size_t row0 = static_cast<size_t>(band) * BB;

  T acc_a[FW_RT][FW_CT], acc_t[FW_RT][FW_CT];
#pragma unroll
  for (int r = 0; r < FW_RT; ++r)
#pragma unroll
    for (int c = 0; c < FW_CT; ++c) { acc_a[r][c] = T(0); acc_t[r][c] = T(0); }

  for (int k0 = 0; k0 < BB; k0 += KC) {
    // Kuf / ∂Kuf tiles of the KC contraction rows, current and previous band.
    for (int e = tid; e < KC * FW_TN; e += FW_THREADS) {
      const int k = e / FW_TN;
      const int c = e % FW_TN;
      const int col = j0 + c;
      const T xv = x[col < n ? col : n - 1];   // masked columns are never stored
      const int rc = static_cast<int>(row0) + k0 + k;
      tile_kuf_dkuf<T>(cell_row(mesh[rc], mesh[rc + 1], ell), xv, var, ell, &kc_s[k][c],
                       &dkc_s[k][c]);
      if (has_prev) {
        const int rp = rc - BB;
        tile_kuf_dkuf<T>(cell_row(mesh[rp], mesh[rp + 1], ell), xv, var, ell, &kp_s[k][c],
                         &dkp_s[k][c]);
      }
    }
    // (BB, KC) slices of D = F⁻¹[band, band] and S = F⁻¹[band, band − 1].
    for (int e = tid; e < BB * KC; e += FW_THREADS) {
      const int r = e / KC;
      const int k = e % KC;
      const size_t rowoff = (row0 + r) * static_cast<size_t>(m);
      d_s[r][k] = finv[rowoff + row0 + k0 + k];
      if (has_prev) s_s[r][k] = finv[rowoff + row0 - BB + k0 + k];
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < KC; ++k) {
      T kc[FW_CT], dkc[FW_CT];
#pragma unroll
      for (int c = 0; c < FW_CT; ++c) {
        kc[c] = kc_s[k][tx + 16 * c];
        dkc[c] = dkc_s[k][tx + 16 * c];
      }
#pragma unroll
      for (int r = 0; r < FW_RT; ++r) {
        const T d = d_s[ty * FW_RT + r][k];
#pragma unroll
        for (int c = 0; c < FW_CT; ++c) {
          acc_a[r][c] = fma(d, kc[c], acc_a[r][c]);
          acc_t[r][c] = fma(d, dkc[c], acc_t[r][c]);
        }
      }
      if (has_prev) {
        T kp[FW_CT], dkp[FW_CT];
#pragma unroll
        for (int c = 0; c < FW_CT; ++c) {
          kp[c] = kp_s[k][tx + 16 * c];
          dkp[c] = dkp_s[k][tx + 16 * c];
        }
#pragma unroll
        for (int r = 0; r < FW_RT; ++r) {
          const T s = s_s[ty * FW_RT + r][k];
#pragma unroll
          for (int c = 0; c < FW_CT; ++c) {
            acc_a[r][c] = fma(s, kp[c], acc_a[r][c]);
            acc_t[r][c] = fma(s, dkp[c], acc_t[r][c]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < FW_RT; ++r) {
    const size_t o = (row0 + ty * FW_RT + r) * static_cast<size_t>(n);
#pragma unroll
    for (int c = 0; c < FW_CT; ++c) {
      const int col = j0 + tx + 16 * c;
      if (col < n) {
        a_out[o + col] = acc_a[r][c];
        t_out[o + col] = acc_t[r][c];
      }
    }
  }
}

template <typename T>
int launch_fused(const T* finv, const T* mesh, const T* x, const T* scal,
                 T* a, T* t, int m, int n, cudaStream_t stream) {
  dim3 grid((n + FW_TN - 1) / FW_TN, m / BB);
  fused_whiten_kernel<T><<<grid, FW_THREADS, 0, stream>>>(finv, mesh, x, scal, a, t, m, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int cell_kuf_f32(const float* mesh, const float* x, const float* scal, float* out,
                 int m, int n, void* stream) {
  return launch_cell_kuf<float>(mesh, x, scal, out, m, n, static_cast<cudaStream_t>(stream));
}

int cell_kuf_f64(const double* mesh, const double* x, const double* scal, double* out,
                 int m, int n, void* stream) {
  return launch_cell_kuf<double>(mesh, x, scal, out, m, n, static_cast<cudaStream_t>(stream));
}

int cell_kuf_with_dl_f32(const float* mesh, const float* x, const float* scal,
                         float* out, float* dl, int m, int n, void* stream) {
  return launch_cell_kuf_with_dl<float>(mesh, x, scal, out, dl, m, n,
                                        static_cast<cudaStream_t>(stream));
}

int cell_kuf_with_dl_f64(const double* mesh, const double* x, const double* scal,
                         double* out, double* dl, int m, int n, void* stream) {
  return launch_cell_kuf_with_dl<double>(mesh, x, scal, out, dl, m, n,
                                         static_cast<cudaStream_t>(stream));
}

int fused_banded_whiten_kuf_f64(const double* finv, const double* mesh, const double* x,
                                const double* scal, double* a, double* t, int m, int n,
                                void* stream) {
  return launch_fused<double>(finv, mesh, x, scal, a, t, m, n,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
