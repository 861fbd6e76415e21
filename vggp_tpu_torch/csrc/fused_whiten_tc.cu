// fused_banded_whiten_kuf in float32 on Hopper's tensor cores (sm_90a, wgmma).
//
// Replaces vggp_tpu/ops/pallas_kernels.py:231 (fused_banded_whiten_kuf,
// pallas_call at :269). (a, t) = (F⁻¹·Kuf, F⁻¹·∂Kuf/∂ℓ) for a
// block-bidiagonal F⁻¹ at BB = 128: output band i is D_i·K_i + S_i·K_{i−1},
// with D_i = F⁻¹[i, i] (lower-triangular), S_i = F⁻¹[i, i−1] (none at i = 0)
// and K_i the Kuf (or ∂Kuf) rows of band i, generated on chip and never
// written to device memory.
//
// Precision contract (the JAX kernel's a_precision / t_precision):
//   "highest", "high"  fp32-accurate: both operands are split into three
//       bf16 pieces x = x0 + x1 + x2 and the six products x0y0 + x0y1 +
//       x1y0 + x0y2 + x2y0 + x1y1 are summed in fp32 — the reference's own
//       6-pass bf16 "highest". It costs what the 3xTF32 split (big·big +
//       big·small + small·big) would, at twice the bf16 rate, but 3xTF32
//       keeps 22 of fp32's 24 bits and under the cancellation of F⁻¹·Kuf
//       misses the plain fp32 product's error by 4–6×, where the bf16 split
//       stays within it (tests/test_torch_ops.py emulates both).
//   "default"  one TF32 product, each operand rounded to nearest.
// The wrapper maps the strings to the two template flags; any other string
// raises there.
//
// Bound on the H100 at (m, n) = (512, 16384), ("highest", "default"): the
// needed band products are nb·128·129/2 + (nb − 1)·128² = 82,176 FMAs per
// column for each of a and t, 1.346e9 in all. Six bf16 passes at 989 TFLOP/s
// and one TF32 pass at 495 TFLOP/s take 0.0218 ms; the bytes (F⁻¹'s band, x,
// the two (m, n) outputs, 67.5 MB) 0.0201 ms at 3.35 TB/s; the Kuf/∂Kuf
// generation 0.0037 ms on the CUDA cores: tensor-op bound.
//
// Design:
// - wgmma.m64nNk16 (bf16) and m64nNk8 (tf32): A = F⁻¹ rows from registers,
//   where each warp splits its own 16 rows; B = the generated Kuf/∂Kuf
//   operand in shared memory, K-major in 8 × 16-byte core matrices (no
//   swizzle: a core matrix is one 128-byte line, conflict-free).
// - One fragment load serves both precisions: the k index inside each 8-deep
//   TF32 step is permuted (slot c ↔ k = 2c, slot c + 4 ↔ k = 2c + 1), so the
//   fp32 pairs (k, k + 1) a lane loads for the bf16 registers are also its
//   TF32 registers; the TF32 B operand is written in the same permutation.
// - A bf16 piece is one cvt.rn.bf16x2 of two values, its remainder exact in
//   fp32; a TF32 operand is the fp32 word plus half a TF32 ulp, whose low 13
//   bits the tensor core does not read.
// - One block per 32-point column tile walks the nb bands in order; each
//   band's products run S_i·K_{i−1} first, then D_i·K_i. The operands of
//   two bands live in shared memory (two slots, 80 KB in all). K_{i+1} is
//   generated, each element once, into K_{i−1}'s slot between band i's D
//   slices, once both warpgroups' S products are done with it; the
//   warpgroup on rows 0–63, which has half as many D products, takes ten of
//   the sixteen row groups. The per-row division and series (cell_row) run
//   once per row and band into a table, one band ahead; the elements
//   multiply by 1/ℓ where the cell_kuf kernels divide by ℓ. Two blocks
//   share an SM.
// - Each lane loads its own F⁻¹ values of the next 16-deep slice (read-only
//   path, one slice ahead) while the current slice's products run; the A
//   registers alternate between two sets, so one slice's products are in
//   flight while the next slice is split. No staging and no block barrier
//   per slice.
// - Two warpgroups take rows 0–63 and 64–127 of the band over all 32 points;
//   the one on rows 0–63 issues no product of D at k ≥ 64, where D is zero
//   above its diagonal.
// - All products of a (and of t) accumulate in one fp32 accumulator; the S
//   products, small but for S's corner, go in before D's large ones.
// - Stores: a lane pair swaps halves of its accumulator fragments so that
//   each lane writes 4 consecutive points (16 bytes), evict-first.
//
// Measured on the H100 (PERF.md): about 0.093 ms at (512, 16384), against
// 0.353 ms for the fp32-FMA kernel it replaces. Left on the table: the band
// transitions (a drain, the stores and a barrier per band), the split's ALU
// work, and register pressure: at 128 registers a thread (two blocks per
// SM) ptxas serialises part of the wgmma pipeline (C7512/C7513 under
// -Xptxas -v).

#include <cstdint>

#include <cuda_runtime.h>

#include "cell_tile.cuh"

namespace {

using namespace vggp_tile;

constexpr int THREADS = 256;         // 2 warpgroups
constexpr int TN = 32;               // points per block
constexpr int KC = 16;               // k-slice of one product step
constexpr int NCHUNK = BB / KC;

// Shared memory of a precision pair: P = 3 the bf16 split (3 pieces, 6
// bytes an element), P = 1 one TF32 word (4 bytes).
template <int PA, int PT>
struct Cfg {
  static constexpr int K_BYTES = (PA == 3 ? 6 : 4) * TN * BB;
  static constexpr int SLOT = K_BYTES + (PT == 3 ? 6 : 4) * TN * BB;
  static constexpr int ROWP_OFF = 2 * SLOT;
  static constexpr int SMEM = ROWP_OFF + 2 * BB * 16;
};

// Byte offset of (k, point p) in a bf16 piece array: core matrices of 8
// points × 8 k (16-byte rows), K-major, k-groups innermost.
__device__ __forceinline__ int off_bf16(int k, int p) {
  return ((p >> 3) * (BB / 8) + (k >> 3)) * 128 + (p & 7) * 16 + (k & 7) * 2;
}
// Byte offset of (k, point p) in a TF32 array: core matrices of 8 points × 4
// slots, with k permuted inside each 8-deep step (slot c ↔ 2c, c + 4 ↔ 2c + 1).
__device__ __forceinline__ int off_tf32(int k, int p) {
  const int kl = k & 7;
  const int s = (k & ~7) | ((kl & 1) ? (kl >> 1) + 4 : kl >> 1);
  return ((p >> 3) * (BB / 4) + (s >> 2)) * 128 + (p & 7) * 16 + (s & 3) * 4;
}
// wgmma descriptor of a K-major operand without swizzle: leading byte offset
// (next core matrix along k) 128, stride byte offset (next 8 points) `sbo`.
__device__ __forceinline__ uint64_t desc(uint32_t saddr, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ uint32_t tf32(float x) { return __float_as_uint(x) + 0x1000u; }

// (x, y) → a packed bf16 pair, each rounded to nearest even; x in the low half.
__device__ __forceinline__ uint32_t bf16x2(float x, float y) {
  uint32_t w;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(w) : "f"(y), "f"(x));
  return w;
}

// (x, y) at consecutive k → three packed bf16 pairs: x = x0 + x1 + x2 and y
// likewise, each piece rounded to nearest and the last remainder exact.
__device__ __forceinline__ void split3(float x, float y, uint32_t (&p)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[i] = bf16x2(x, y);
    x -= __uint_as_float(p[i] << 16);
    y -= __uint_as_float(p[i] & 0xffff0000u);
  }
}

// ---- wgmma with A from registers -------------------------------------------

template <int N> struct Wg;

template <> struct Wg<32> {
  static __device__ __forceinline__ void bf16(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, 1, 1, 1, 0;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
  }
  static __device__ __forceinline__ void tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, 1, 1, 1;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
  }
};

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ---- A fragments (one 16-deep slice, one m64 tile, this warp's 16 rows) ---

// P = 3: [bf16 piece][register] of the k16 step; P = 1: [8-deep half][register].
template <int P> using AFrag = uint32_t[P == 3 ? 3 : 2][4];

// The lane's fp32 values: rows g and g + 8, (k, k + 1) pairs at k = 2c and 2c + 8.
struct AVals { float2 v[4]; };   // (g, 2c), (g + 8, 2c), (g, 2c + 8), (g + 8, 2c + 8)

template <int P>
__device__ __forceinline__ void a_frags(const AVals& x, AFrag<P>& f) {
  if constexpr (P == 3) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t p[3];
      split3(x.v[r].x, x.v[r].y, p);
      f[0][r] = p[0];
      f[1][r] = p[1];
      f[2][r] = p[2];
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      f[h][0] = tf32(x.v[2 * h].x);
      f[h][1] = tf32(x.v[2 * h + 1].x);
      f[h][2] = tf32(x.v[2 * h].y);
      f[h][3] = tf32(x.v[2 * h + 1].y);
    }
  }
}

// Piece pairs (A piece, B piece) of the bf16 split, the big pair last.
__host__ __device__ constexpr int piece_a(int q) { return q == 0 || q == 4 ? 1 : q == 2 ? 2 : 0; }
__host__ __device__ constexpr int piece_b(int q) { return q == 1 || q == 4 ? 1 : q == 3 ? 2 : 0; }

// B-operand descriptors of one 16-deep slice: P = 3 one per bf16 piece
// (`op` the piece-0 address at the slice and the warpgroup's first point,
// `piece` the byte size of a piece array), P = 1 one per 8-deep TF32 half.
template <int P> using BDesc = uint64_t[P == 3 ? 3 : 2];

template <int P>
__device__ __forceinline__ void b_descs(uint32_t op, uint32_t piece, BDesc<P>& d) {
#pragma unroll
  for (int i = 0; i < (P == 3 ? 3 : 2); ++i)
    d[i] = P == 3 ? desc(op + i * piece, (BB / 8) * 128) : desc(op + i * 256, (BB / 4) * 128);
}

// The products of one 16-deep slice into the accumulator: P = 3 the six
// bf16 products of the split, P = 1 two TF32 ones (one per 8-deep half).
template <int P, int N>
__device__ __forceinline__ void products(float (&acc)[N / 2], const AFrag<P>& a,
                                         const BDesc<P>& b) {
  if constexpr (P == 3) {
#pragma unroll
    for (int q = 0; q < 6; ++q) Wg<N>::bf16(acc, a[piece_a(q)], b[piece_b(q)]);
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) Wg<N>::tf32(acc, a[h], b[h]);
  }
}

// ---- memory ---------------------------------------------------------------

// The lane's fp32 values of one 16-deep slice of F⁻¹ at `p` (its row g, at
// column 2c): rows g and g + 8, pairs at k = 2c and 2c + 8, through the
// read-only path.
__device__ __forceinline__ AVals load_a(const float* p, int m) {
  AVals v;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    v.v[2 * h] = __ldg(reinterpret_cast<const float2*>(p + 8 * h));
    v.v[2 * h + 1] = __ldg(reinterpret_cast<const float2*>(p + 8 * static_cast<size_t>(m) + 8 * h));
  }
  return v;
}

// Write the (k, k + 1) values of point p into a B operand of P pieces.
template <int P, int TN>
__device__ __forceinline__ void put_pair(unsigned char* op, int k, int p, float v0, float v1) {
  if constexpr (P == 3) {
    uint32_t w[3];
    split3(v0, v1, w);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      *reinterpret_cast<uint32_t*>(op + i * (TN * BB * 2) + off_bf16(k, p)) = w[i];
  } else {
    *reinterpret_cast<uint32_t*>(op + off_tf32(k, p)) = tf32(v0);
    *reinterpret_cast<uint32_t*>(op + off_tf32(k + 1, p)) = tf32(v1);
  }
}

// Store one m64 × N accumulator: lanes c and c ^ 1 swap halves so that
// each lane holds 4 consecutive points of one row.
template <int N>
__device__ __forceinline__ void store_tile(float* out, const float (&acc)[N / 2], size_t row,
                                           int col0, int n, int c) {
  const bool odd = c & 1;
  const bool vec = (n & 3) == 0;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = acc[4 * j + e];
    const float r0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[2], 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, odd ? v[1] : v[3], 1);
    const float4 w = odd ? make_float4(r0, r1, v[2], v[3]) : make_float4(v[0], v[1], r0, r1);
    const int col = col0 + 8 * j + 2 * (c & ~1);
    float* dst = out + (row + (odd ? 8 : 0)) * static_cast<size_t>(n) + col;
    if (vec && col + 3 < n) {
      __stcs(reinterpret_cast<float4*>(dst), w);   // streamed: not read again here
    } else {
      const float ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < n) dst[e] = ws[e];
    }
  }
}

// ---- the kernel -------------------------------------------------------------

template <int PA, int PT>
__global__ void __launch_bounds__(THREADS, 2)
fused_whiten_tc_kernel(const float* __restrict__ finv, const float* __restrict__ mesh,
                       const float* __restrict__ x, const float* __restrict__ scal,
                       float* __restrict__ a_out, float* __restrict__ t_out, int m, int n) {
  using C = Cfg<PA, PT>;
  extern __shared__ __align__(128) unsigned char smem[];
  float4* rowp = reinterpret_cast<float4*>(smem + C::ROWP_OFF);   // [slot][BB]
  const uint32_t smem_s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int mt = warp >> 2;               // warpgroup: rows [64·mt, 64·mt + 64)
  const int wr = 64 * mt + 16 * (warp & 3) + g;   // this lane's row (and + 8)
  const int j0 = blockIdx.x * TN;
  const int nb = m / BB;
  const float var = scal[0];
  const float ell = scal[1];
  const float inv_ell = 1.0f / ell;
  // generation: lane → (point p8 of an 8-point group, k pair q of an 8-row
  // group); the warp's point group is fixed, its row groups vary
  const int gp = 8 * (warp % (TN / 8)) + (lane >> 2);
  const int gq = lane & 3;
  const float xv = x[min(j0 + gp, n - 1)];   // masked points are never stored

  auto row_params = [&](int band) {
    if (tid < BB) {
      const int r = band * BB + tid;
      const Row<float> p = cell_row(mesh[r], mesh[r + 1], ell);
      rowp[(band & 1) * BB + tid] = make_float4(p.a, p.b, p.dd, p.em_dd);
    }
  };
  // Kuf / ∂Kuf rows [8·g_begin, 8·g_end) of `band` at this warp's 8 points
  // into the band's slot. Each element is generated once: the warps of the
  // two warpgroups on one point group take complementary row groups.
  auto generate = [&](int band, int g_begin, int g_end) {
    unsigned char* op = smem + (band & 1) * C::SLOT;
    const float4* rp = rowp + (band & 1) * BB;
    for (int kg = g_begin; kg < g_end; ++kg) {
      const int k = 8 * kg + 2 * gq;
      const float4 p0 = rp[k], p1 = rp[k + 1];
      float k0v, d0v, k1v, d1v;
      tile_kuf_dkuf<float, true>(Row<float>{p0.x, p0.y, p0.z, p0.w}, xv, var, ell, &k0v, &d0v,
                                 inv_ell);
      tile_kuf_dkuf<float, true>(Row<float>{p1.x, p1.y, p1.z, p1.w}, xv, var, ell, &k1v, &d1v,
                                 inv_ell);
      put_pair<PA, TN>(op, k, gp, k0v, k1v);
      put_pair<PT, TN>(op + C::K_BYTES, k, gp, d0v, d1v);
    }
  };
  // the row groups of each warpgroup: rows 0–63's (half the D products) ten
  // of sixteen, in two runs of five; rows 64–127's six, one per D slice
  constexpr int G_SPLIT = 10;
  static_assert(NCHUNK == 8 && G_SPLIT + NCHUNK - 2 == BB / 8, "row groups of the split");

  row_params(0);
  __syncthreads();

  float acc_a[TN / 2], acc_t[TN / 2];
  AFrag<PA> fa[2];   // A registers of the products in flight: [slice parity]
  AFrag<PT> ft[2];
  AVals nxt;         // the lane's F⁻¹ values of the next slice
  // Issue the products of one 16-deep slice, with B at k0 of the operand at
  // `op`, in the A registers of parity `par` (a literal): the slice's F⁻¹
  // values are split first, then the lane's values of the slice at `next`
  // (or none) are loaded while this one multiplies.
  auto slice = [&](uint32_t op, int k0, int par, const float* next) {
    wg_wait<1>();   // the products two slices back have released these registers
    a_frags<PA>(nxt, fa[par]);
    if constexpr (PT != PA) a_frags<PT>(nxt, ft[par]);
    if (next != nullptr) nxt = load_a(next, m);
    constexpr uint32_t PIECE = TN * BB * 2;
    BDesc<PA> bk;
    BDesc<PT> bd;
    b_descs<PA>(op + (PA == 3 ? off_bf16(k0, 0) : off_tf32(k0, 0)), PIECE, bk);
    b_descs<PT>(op + C::K_BYTES + (PT == 3 ? off_bf16(k0, 0) : off_tf32(k0, 0)), PIECE, bd);
    wg_fence();
    products<PA, TN>(acc_a, fa[par], bk);
    if constexpr (PT == PA)
      products<PT, TN>(acc_t, fa[par], bd);
    else
      products<PT, TN>(acc_t, ft[par], bd);
    wg_commit();
  };

  // D rows 0–63 are zero at k ≥ 64: that warpgroup issues no product of D there
  const int d_slices = mt == 0 ? NCHUNK / 2 : NCHUNK;
  // the lane's F⁻¹ value at (row wr, column 2c) of D_0; S_i lies BB columns
  // to the left of D_i
  nxt = load_a(finv + wr * static_cast<size_t>(m) + 2 * c, m);
  generate(0, mt == 0 ? 0 : G_SPLIT, mt == 0 ? G_SPLIT : BB / 8);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // generic writes → wgmma reads
  __syncthreads();
  for (int band = 0; band < nb; ++band) {
    const int slot = band & 1;
    const bool has_next = band + 1 < nb;
    const size_t row0 = static_cast<size_t>(band) * BB;
    const float* arow = finv + (row0 + wr) * static_cast<size_t>(m) + row0 + 2 * c;
    if (has_next) row_params(band + 1);
#pragma unroll
    for (int e = 0; e < TN / 2; ++e) acc_a[e] = acc_t[e] = 0.f;

    if (band > 0) {   // S_i·K_{i−1} from the other slot
      const uint32_t op = smem_s + (slot ^ 1) * C::SLOT;
      for (int ch = 0; ch < NCHUNK; ch += 2) {
        slice(op, ch * KC, 0, arow - BB + (ch + 1) * KC);
        slice(op, (ch + 1) * KC, 1, ch + 2 < NCHUNK ? arow - BB + (ch + 2) * KC : arow);
      }
    }
    // D_i·K_i; its last slice loads the next band's first S slice. Two
    // slices in, both warpgroups' S products are done with K_{i−1}'s slot,
    // and K_{i+1} is generated there between the remaining D slices.
    const uint32_t op = smem_s + slot * C::SLOT;
    const float* last = has_next ? arow + BB * static_cast<size_t>(m) : nullptr;
    slice(op, 0, 0, arow + KC);
    slice(op, KC, 1, arow + 2 * KC);
    if (has_next) __syncthreads();
    for (int ch = 2; ch < d_slices; ch += 2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int sl = ch + h;
        slice(op, sl * KC, h, sl + 1 < d_slices ? arow + (sl + 1) * KC : last);
        if (has_next) {
          if (mt == 0)
            generate(band + 1, (sl - 2) * (G_SPLIT / 2), (sl - 1) * (G_SPLIT / 2));
          else
            generate(band + 1, G_SPLIT + sl - 2, G_SPLIT + sl - 1);
        }
      }
    }
    wg_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // generic writes → wgmma reads
    store_tile<TN>(a_out, acc_a, row0 + wr, j0, n, c);
    store_tile<TN>(t_out, acc_t, row0 + wr, j0, n, c);
    __syncthreads();   // K_{i+1} is complete
  }
}

template <int PA, int PT>
int launch(const float* finv, const float* mesh, const float* x, const float* scal, float* a,
           float* t, int m, int n, cudaStream_t stream) {
  using C = Cfg<PA, PT>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(fused_whiten_tc_kernel<PA, PT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               C::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    // two blocks per SM need the largest shared-memory carveout
    const cudaError_t f = cudaFuncSetAttribute(fused_whiten_tc_kernel<PA, PT>,
                                               cudaFuncAttributePreferredSharedMemoryCarveout,
                                               cudaSharedmemCarveoutMaxShared);
    if (f != cudaSuccess) return static_cast<int>(f);
    configured = true;
  }
  const dim3 grid((n + TN - 1) / TN);
  fused_whiten_tc_kernel<PA, PT><<<grid, THREADS, C::SMEM, stream>>>(finv, mesh, x, scal, a, t,
                                                                      m, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// split_a / split_t: 1 for the fp32-accurate six-product bf16 split
// ("highest", "high"), 0 for one TF32 product ("default").
int fused_banded_whiten_kuf_f32(const float* finv, const float* mesh, const float* x,
                                const float* scal, float* a, float* t, int m, int n,
                                int split_a, int split_t, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split_a && split_t) return launch<3, 3>(finv, mesh, x, scal, a, t, m, n, s);
  if (split_a) return launch<3, 1>(finv, mesh, x, scal, a, t, m, n, s);
  if (split_t) return launch<1, 3>(finv, mesh, x, scal, a, t, m, n, s);
  return launch<1, 1>(finv, mesh, x, scal, a, t, m, n, s);
}

}  // extern "C"
