"""Probe the port's float32 fused_banded_whiten_kuf kernel on one CUDA card.

    python3 tools/torch_fused_probe.py [--variants] [--bench]

Imports torch and the port only (no JAX). Prints:

- the kernel against its plain version and against the float64 plain
  version, for every (a_precision, t_precision) pair, at (512, 16384),
  (256, 301) and (1024, 999): max|Δ|/max of a, t and colsum(a²);
- its device time at (512, 16384), ("highest", "default");
- with ``--variants``: the device time of edited copies of
  ``vggp_tpu_torch/csrc/fused_whiten_tc.cu`` that each drop one part of the
  work (the Kuf/∂Kuf generation, the stores, the F⁻¹ loads, a's products,
  all but the products), beside the kernel, for a breakdown of its time,
  and of one that stores through the cache instead of evict-first. The
  copies that drop work compute wrong numbers by design and are only timed;
- with ``--bench``: the tensor-core rates of mma.sync (tf32 m16n8k8, bf16
  m16n8k16) and of wgmma m64n32k16 bf16 with A from registers, in streams
  of independent products.

Everything it builds goes into ``vggp_tpu_torch/_build/probe/``.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402  (timing and input helpers)

PAIRS = [("highest", "default"), ("highest", "highest"), ("default", "default"),
         ("default", "highest")]

# (name, [(text in fused_whiten_tc.cu, replacement)]) — each drops one part
_GEN = ("      tile_kuf_dkuf<float, true, true>(Row<float>{p0.x, p0.y, p0.z, p0.w}, xv, var, ell, &k0v,\n"
        "                                       &d0v, inv_ell);\n"
        "      tile_kuf_dkuf<float, true, true>(Row<float>{p1.x, p1.y, p1.z, p1.w}, xv, var, ell, &k1v,\n"
        "                                       &d1v, inv_ell);",
        "      k0v = p0.x * xv; d0v = p0.y * xv; k1v = p1.x * xv; d1v = p1.y * xv;")
_STORE = ("    store_tile<TN>(a_out, acc_a, row0 + wr, j0, n, c);\n"
          "    store_tile<TN>(t_out, acc_t, row0 + wr, j0, n, c);",
          "    if (acc_a[0] == 1234.5f) {\n"
          "    store_tile<TN>(a_out, acc_a, row0 + wr, j0, n, c);\n"
          "    store_tile<TN>(t_out, acc_t, row0 + wr, j0, n, c); }")
_LOAD = ("    if (next != nullptr) nxt = load_a(next, m);", "")
_AMMA = ("    products<PA, TN>(acc_a, fa[par], bk);", "    if (m < 0) products<PA, TN>(acc_a, fa[par], bk);")
_SPLIT = ("    a_frags<PA>(nxt, fa[par]);",
          "    for (int r = 0; r < 4; ++r)\n"
          "      fa[par][0][r] = fa[par][1][r] = fa[par][2][r] = __float_as_uint(nxt.v[r].x);")
_PLAIN_STORE = ("      __stcs(reinterpret_cast<float4*>(dst), w);   // streamed: not read again here",
                "      *reinterpret_cast<float4*>(dst) = w;")
VARIANTS = [("no_generation", [_GEN]), ("no_stores", [_STORE]), ("no_f_loads", [_LOAD]),
            ("no_a_products", [_AMMA]), ("products_only", [_GEN, _STORE, _LOAD, _SPLIT]),
            ("cached_stores", [_PLAIN_STORE])]

BENCH_CU = r"""
#include <cstdint>
#include <cuda_runtime.h>
#define R4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a, uint32_t b) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%4,%4,%4}, {%5,%5}, {%0,%1,%2,%3};\n"
               : R4(d, 0) : "r"(a), "r"(b));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a, uint32_t b) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%4,%4,%4}, {%5,%5}, {%0,%1,%2,%3};\n"
               : R4(d, 0) : "r"(a), "r"(b));
}
template <bool BF>
__global__ void mma_stream(float* out, int iters) {
  uint32_t a = 0x3f800000u ^ threadIdx.x, b = 0x3f800000u;
  float d[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) { if (BF) mma_bf16(d[j], a, b); else mma_tf32(d[j], a, b); }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void wgmma_stream(float* out, int iters, int rewrite) {
  __shared__ __align__(128) uint32_t bs[32 * 16 / 2];
  for (int i = threadIdx.x; i < 32 * 16 / 2; i += blockDim.x) bs[i] = 0x3f803f80u;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(bs));
  const uint64_t desc = static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t(128 >> 4) << 16) | (uint64_t(256 >> 4) << 32);
  uint32_t a[4] = {0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u};
  float d[16] = {};
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (rewrite) for (int r = 0; r < 4; ++r) a[r] ^= static_cast<uint32_t>(it & 1);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
                   "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, {%16,%17,%18,%19}, %20, 1, 1, 1, 0;\n"
                   : R4(d, 0), R4(d, 4), R4(d, 8), R4(d, 12)
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  float s = 0.f;
  for (int i = 0; i < 16; ++i) s += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(int kind, float* out, int blocks, int threads, int iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0) mma_stream<false><<<blocks, threads, 0, s>>>(out, iters);
  if (kind == 1) mma_stream<true><<<blocks, threads, 0, s>>>(out, iters);
  if (kind >= 2) wgmma_stream<<<blocks, threads, 0, s>>>(out, iters, kind == 3);
  return static_cast<int>(cudaGetLastError());
}
"""


def _nvcc(src: Path, out: Path, include: Path | None = None) -> subprocess.Popen:
    from vggp_tpu_torch.ops import _build

    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)]
    if include is not None:
        cmd[1:1] = ["-I", str(include)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def accuracy(device) -> None:
    import torch

    from vggp_tpu_torch.ops import cell_kuf as ck

    rel, up = cs.rel_err, (lambda t: t.double())
    colsum = lambda a: torch.sum(a.double() ** 2, dim=0)
    for shape in ((512, 16384), (256, 301), (1024, 999)):
        mesh, x, v, ell, finv = cs.kernel_inputs(*shape, torch.float32, device, seed=2)
        a64, t64 = ck.fused_banded_whiten_kuf_plain(*map(up, (finv, mesh, x, v, ell)),
                                                    "highest", "highest")
        a32, t32 = ck.fused_banded_whiten_kuf_plain(finv, mesh, x, v, ell, "highest", "highest")
        print(f"{shape} plain fp32 vs f64: a {rel(up(a32), a64):.3e}, t {rel(up(t32), t64):.3e}")
        for pair in PAIRS:
            a, t = ck.fused_banded_whiten_kuf(finv, mesh, x, v, ell, *pair)
            torch.cuda.synchronize()
            a_p, t_p = ck.fused_banded_whiten_kuf_plain(finv, mesh, x, v, ell, *pair)
            print(f"{shape} {'/'.join(pair)}: a vs plain {rel(a, a_p):.3e}, vs f64 "
                  f"{rel(up(a), a64):.3e}, colsum(a^2) vs f64 {rel(colsum(a), colsum(a64)):.3e}; "
                  f"t vs plain {rel(t, t_p):.3e}, vs f64 {rel(up(t), t64):.3e} "
                  f"(plain at these precisions {rel(up(t_p), t64):.3e})")


def variants(device, build: Path) -> None:
    import torch

    from vggp_tpu_torch.ops import _build
    from vggp_tpu_torch.ops import cell_kuf as ck

    src = (REPO / "vggp_tpu_torch" / "csrc" / "fused_whiten_tc.cu").read_text()
    procs = {}
    for name, edits in VARIANTS:
        text = src
        missing = [old for old, _ in edits if old not in text]
        if missing:
            print(f"variant {name}: skipped, the source no longer holds {missing[0][:50]!r}")
            continue
        for old, new in edits:
            text = text.replace(old, new)
        path = build / f"{name}.cu"
        path.write_text(text)
        procs[name] = _nvcc(path, build / f"{name}.so", REPO / "vggp_tpu_torch" / "csrc")
    mesh, x, v, ell, finv = cs.kernel_inputs(512, 16384, torch.float32, device, seed=4)
    scal = torch.stack([v, ell])
    a = torch.empty((512, 16384), device=device)
    t = torch.empty_like(a)
    argtypes = _build.SOURCES[_build._CSRC / "fused_whiten_tc.cu"]["fused_banded_whiten_kuf_f32"]
    runs = {"kernel": lambda: ck.fused_banded_whiten_kuf(finv, mesh, x, v, ell, "highest", "default")}
    for name, proc in procs.items():
        _, err = proc.communicate()
        cs.check(proc.returncode == 0, f"variant {name} did not build:\n{err}")
        fn = ctypes.CDLL(str(build / f"{name}.so")).fused_banded_whiten_kuf_f32
        fn.argtypes = argtypes
        ptrs = [ctypes.c_void_p(z.data_ptr()) for z in (finv, mesh, x, scal, a, t)]
        runs[name] = (lambda fn=fn, ptrs=ptrs: fn(
            *ptrs, 512, 16384, 1, 0, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)))
    for turn in range(2):
        for name, fn in runs.items():
            ms, _ = cs.time_ms(fn, kernel="fused_whiten_tc_kernel")
            print(f"variant {name} (turn {turn}): device {ms:.5f} ms")


def bench(device, build: Path) -> None:
    import torch

    src = build / "bench.cu"
    src.write_text(BENCH_CU)
    proc = _nvcc(src, build / "bench.so")
    _, err = proc.communicate()
    cs.check(proc.returncode == 0, f"bench did not build:\n{err}")
    lib = ctypes.CDLL(str(build / "bench.so"))
    lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 4 * 512, device=device)
    # (kind, label, threads, blocks per SM, flop per instruction per warp or warpgroup, per)
    cases = [(0, "mma.sync tf32 m16n8k8", 256, 4, 16 * 8 * 8 * 2, 32),
             (1, "mma.sync bf16 m16n8k16", 256, 4, 16 * 8 * 16 * 2, 32),
             (2, "wgmma m64n32k16 bf16, A in registers", 256, 2, 64 * 32 * 16 * 2, 128),
             (3, "the same, A rewritten before each group", 256, 2, 64 * 32 * 16 * 2, 128)]
    for kind, label, threads, per_sm, flop, per in cases:
        blocks, iters = sms * per_sm, 2000
        run = lambda: lib.run(kind, ctypes.c_void_p(out.data_ptr()), blocks, threads, iters,
                              ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        cs.check(run() == 0, f"{label} did not launch")
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        run()
        e1.record()
        e1.synchronize()
        total = blocks * (threads // per) * iters * 8 * flop
        print(f"bench {label}: {total / e0.elapsed_time(e1) / 1e9:.1f} TFLOP/s "
              f"({threads} threads x {per_sm} blocks per SM)")


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", action="store_true")
    parser.add_argument("--bench", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_fused_probe: no CUDA device", file=sys.stderr)
        return 2
    from vggp_tpu_torch.ops import _build

    device = torch.device("cuda")
    print(cs.card_line())
    _build.load()
    build = _build.BUILD_DIR / "probe"
    os.makedirs(build, exist_ok=True)
    accuracy(device)
    mesh, x, v, ell, finv = cs.kernel_inputs(512, 16384, torch.float32, device, seed=4)
    from vggp_tpu_torch.ops import cell_kuf as ck

    for turn in range(2):
        ms, _ = cs.time_ms(lambda: ck.fused_banded_whiten_kuf(finv, mesh, x, v, ell,
                                                              "highest", "default"),
                           kernel="fused_whiten_tc_kernel")
        print(f"time fused_banded_whiten_kuf (512, 16384) highest/default (turn {turn}): "
              f"device {ms:.5f} ms")
    if args.variants:
        variants(device, build)
    if args.bench:
        bench(device, build)
    print("PROBE OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
