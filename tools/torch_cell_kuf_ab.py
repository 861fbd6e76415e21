"""A/B of a cell kernel of the port against other builds of its source, on one CUDA card.

    python3 tools/torch_cell_kuf_ab.py [--kernel cell_kuf|cell_kuf_with_dl]
                                       [--against NAME=DIR ...] [--variants]
                                       [--turns 3] [--sass]

Each DIR holds a ``cell_kuf.cu`` and the ``cell_tile.cuh`` it includes (and,
for ``--sass``, a ``fused_whiten_tc.cu``), for example those of an earlier
commit, written out with::

    mkdir -p _smoke_tree/parent
    for f in cell_kuf.cu cell_tile.cuh fused_whiten_tc.cu; do
      git show REV:vggp_tpu_torch/csrc/$f > _smoke_tree/parent/$f; done

Imports torch and the port only (no JAX). Builds every DIR into
``vggp_tpu_torch/_build/ab/NAME/`` beside the package's own libraries and
prints:

- each build's ``KERNEL_f32`` and ``KERNEL_f64`` (``--kernel``, default
  ``cell_kuf``) against the plain version at the main path's (512, 4096),
  the serving grid's (512, 65536) and ragged shapes, and for
  ``cell_kuf_with_dl`` every shape the port launches it at (max|Δ|/max|plain|
  of each output, f64 ≤ 1e-12, f32 ≤ 2e-5);
- the float32 device time of each build's ``KERNEL_f32`` and of the
  package's, at (512, 4096) and (512, 65536) for ``cell_kuf`` and at every
  launched shape for ``cell_kuf_with_dl``, from the profiler's CUDA
  trace, in ``--turns`` interleaved turns (builds in order, then in reverse)
  beside the bound of each shape (``chip_smoke.kuf_bounds``);
- with ``--variants``, in the same turns: edited copies of the package's
  ``csrc/cell_kuf.cu`` that each drop one part of the kernel's work (the
  element math, the stores), for a breakdown of its time. They compute
  wrong numbers by design and are only timed;
- with ``--sass``: for each library, each kernel's registers per thread
  (``cuobjdump -res-usage``), its SASS instruction count and its most
  frequent opcodes (``cuobjdump -sass``; the listings, with offsets, in
  full under ``vggp_tpu_torch/_build/ab/sass/``), and whether the SASS of
  the other kernels (all but ``--kernel``'s) is the same in the package as
  in each DIR.

The card's name and power limit head the output.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402  (timing, bounds and input helpers)

# the timed shapes and the checked shapes, by kernel: cell_kuf at the main
# path's and the serving grid's; cell_kuf_with_dl at every shape the port
# launches it at (PERF.md §6: the SVGP step, the collapsed and 11a steps,
# the additive model, the zoo, phase 15's, phase 20's six, spacetime's)
SHAPES = {
    "cell_kuf": ((512, 4096), (512, 65536)),
    "cell_kuf_with_dl": ((512, 4096), (64, 65536), (512, 65536), (64, 4096), (15, 20000),
                         (64, 8192), (32, 200), (32, 1024), (20, 4400), (15, 625),
                         (20, 696), (10, 15), (10, 40), (20, 20000)),
}
CHECK_SHAPES = ((512, 4096), (512, 65536), (37, 1023), (1, 5), (200, 301))
_OUTPUTS = {"cell_kuf": 1, "cell_kuf_with_dl": 2}

# Kernel roles for the SASS comparison: (role, regex of the mangled names).
# The first source named the kernel of both cell_kuf entry points
# cell_kuf_kernel<T, WITH_DL>; then cell_kuf ran cell_kuf_primal_kernel<T, VEC>
# (VEC: 16-byte accesses) and cell_kuf_with_dl cell_kuf_with_dl_kernel<T>,
# now cell_kuf_with_dl_kernel<T, VEC>.
_ROLES = (
    ("cell_kuf f32", r"cell_kuf_kernelIfLb0E|cell_kuf_primal_kernelIfLb1E"),
    ("cell_kuf f32 scalar", r"cell_kuf_primal_kernelIfLb0E"),
    ("cell_kuf f64", r"cell_kuf_kernelIdLb0E|cell_kuf_primal_kernelIdLb1E"),
    ("cell_kuf_with_dl f32",
     r"cell_kuf_kernelIfLb1E|cell_kuf_with_dl_kernelIfE|cell_kuf_with_dl_kernelIfLb1E"),
    ("cell_kuf_with_dl f32 scalar", r"cell_kuf_with_dl_kernelIfLb0E"),
    ("cell_kuf_with_dl f64",
     r"cell_kuf_kernelIdLb1E|cell_kuf_with_dl_kernelIdE|cell_kuf_with_dl_kernelIdLb1E"),
    ("fused f64", r"fused_whiten_kernelIdE"),
    ("fused f32 (tc)", r"fused_whiten_tc_kernel"),
)

# (name, [(text in csrc/cell_kuf.cu, replacement)]) — each drops one part
_MATH = ("    kuf_points(row, xv, inv_ell, var_ell, out_coef, f);\n"
         "    store_points",
         "#pragma unroll\n"
         "    for (int k = 0; k < VN; ++k) f[k] = xv[k] * out_coef;\n"
         "    store_points")
_STORES = ("    store_points<T, VEC>(out + static_cast<size_t>(i) * n, j, n, f);",
           "    if (f[0] == T(1234.5)) store_points<T, VEC>(out + static_cast<size_t>(i) * n, j, n, f);")
_DL_MATH = ("    kuf_dl_points(row, xv, inv_ell, var, var_ell, coef, f, g);\n",
            "#pragma unroll\n"
            "    for (int k = 0; k < VN; ++k) { f[k] = xv[k] * coef.k; g[k] = xv[k] * coef.c1; }\n")
_DL_STORES = ("    store_points<T, VEC>(out + base, j, n, f);\n"
              "    store_points<T, VEC>(dl + base, j, n, g);\n",
              "    if (f[0] == T(1234.5)) {\n"
              "      store_points<T, VEC>(out + base, j, n, f);\n"
              "      store_points<T, VEC>(dl + base, j, n, g);\n"
              "    }\n")
# cell_kuf_with_dl's tuning and breakdown: four chunks a warp where the
# card holds the blocks (as cell_kuf); IEEE divisions for 1/ℓ and δ/ℓ (as
# cell_kuf); the far exp for every point, not under the cell's branch; the
# cell's branch, the c0 series each left out
_DL_CHUNKS = ("constexpr int DL_MIN_CHUNKS = 1;", "constexpr int DL_MIN_CHUNKS = 4;")
_DL_DIVIDE = [("  const T inv_ell = recip_(ell);\n  Row<T> row = cell_row_inv(a0, b0, inv_ell);",
               "  const T inv_ell = T(1) / ell;\n  Row<T> row = cell_row(a0, b0, ell);"),
              ("      row = cell_row_inv(mesh[i], mesh[i + 1], inv_ell);",
               "      row = cell_row(mesh[i], mesh[i + 1], ell);")]
_DL_ANY = ("    any |= in[k];\n  }\n  if (__builtin_expect(any, 0)) {\n#pragma unroll\n"
           "    for (int k = 0; k < K; ++k) {\n      const T far")
_DL_FREE = (_DL_ANY, _DL_ANY.replace("__builtin_expect(any, 0)", "true"))
_DL_BRANCH = (_DL_ANY, _DL_ANY.replace("__builtin_expect(any, 0)",
                                      "__builtin_expect(any && false, 0)"))
_DL_SERIES = ("  if (d < T(1)) {\n    constexpr int N", "  if (false) {\n    constexpr int N")
VARIANTS = {"cell_kuf": [("no_element_math", [_MATH]), ("no_stores", [_STORES])],
            "cell_kuf_with_dl": [("no_element_math", [_DL_MATH]), ("no_stores", [_DL_STORES]),
                                 ("min_chunks_4", [_DL_CHUNKS]), ("ieee_divisions", _DL_DIVIDE),
                                 ("branch_free", [_DL_FREE]), ("no_cell_branch", [_DL_BRANCH]),
                                 ("c0_direct", [_DL_SERIES])]}


def _compile(srcs: dict, out_dir: Path) -> dict:
    """One nvcc per source, side by side, with the package's flags."""
    from vggp_tpu_torch.ops import _build as b

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem, src in srcs.items():
        out = out_dir / f"{stem}.so"
        procs[stem] = (out, subprocess.Popen([b._nvcc(), *b.NVCC_FLAGS, "-o", str(out), str(src)],
                                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                             text=True))
    libs = {}
    for stem, (out, proc) in procs.items():
        _, err = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc failed on {srcs[stem]}:\n{err}")
        libs[stem] = out
    return libs


def _entry(lib_path: Path, name: str, outputs: int):
    fn = getattr(ctypes.CDLL(str(lib_path)), name)
    fn.argtypes = [ctypes.c_void_p] * (3 + outputs) + [ctypes.c_int, ctypes.c_int,
                                                       ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _caller(fn, mesh, x, scal, outs):
    import torch

    m, n = outs[0].shape
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (mesh, x, scal, *outs)]

    def call():
        rc = fn(*ptrs, m, n, stream())
        cs.check(rc == 0, f"launch failed: cudaError {rc}")
    return call


def _plain(kernel: str, mesh, x, v, ell) -> tuple:
    from vggp_tpu_torch.ops import cell_kuf as ck

    got = getattr(ck, f"{kernel}_plain")(mesh, x, v, ell)
    return got if isinstance(got, tuple) else (got,)


def check_builds(device, builds: dict, kernel: str) -> None:
    import torch

    from vggp_tpu_torch.ops import cell_kuf as ck

    shapes = CHECK_SHAPES + tuple(s for s in SHAPES[kernel] if s not in CHECK_SHAPES
                                  and kernel != "cell_kuf")
    for dtype, tol, sfx in ((torch.float64, cs.TOL_F64, "f64"), (torch.float32, cs.TOL_F32, "f32")):
        for shape in shapes:
            mesh, x, v, ell, _ = cs.kernel_inputs(*shape, dtype, device, seed=11)
            wants = _plain(kernel, mesh, x, v, ell)
            scal = ck._scal(v, ell, mesh)
            errs = []
            for name, lib in builds.items():
                outs = [torch.full(shape, float("nan"), dtype=dtype, device=device)
                        for _ in wants]
                _caller(_entry(lib, f"{kernel}_{sfx}", len(wants)), mesh, x, scal, outs)()
                es = [cs.rel_err(o, w) for o, w in zip(outs, wants)]
                errs.append(f"{name} " + "/".join(f"{e:.3e}" for e in es))
                cs.check(max(es) < tol, f"{name} {kernel} {sfx} {shape}: {es}")
            print(f"check {kernel} {sfx} {shape}: " + ", ".join(errs))


def time_builds(device, builds: dict, turns: int, kernel: str) -> None:
    import torch

    from vggp_tpu_torch.ops import cell_kuf as ck

    n_out = _OUTPUTS[kernel]
    for shape in SHAPES[kernel]:
        mesh, x, v, ell, _ = cs.kernel_inputs(*shape, torch.float32, device, seed=3)
        scal = ck._scal(v, ell, mesh)
        outs = [torch.empty(shape, dtype=torch.float32, device=device) for _ in range(n_out)]
        calls = {name: _caller(_entry(lib, f"{kernel}_f32", n_out), mesh, x, scal, outs)
                 for name, lib in builds.items()}
        iters = 50 if shape[0] * shape[1] <= 512 * 4096 else 20
        times = {name: [] for name in builds}
        order = list(builds)
        for _ in range(turns):
            for name in order + order[::-1]:
                times[name].append(cs.time_ms(calls[name], iters=iters, kernel=kernel)[0])
        bound = cs.kuf_bounds(*shape, kernel == "cell_kuf_with_dl")
        print(f"time {kernel} f32 {shape}, bound {bound['bound_ms']:.5f} ms ({bound['bound_by']}):")
        for name, ts in times.items():
            mean = sum(ts) / len(ts)
            print(f"  {name}: mean {mean:.5f} ms, min {min(ts):.5f}, max {max(ts):.5f} "
                  f"({len(ts)} windows), {bound['bound_ms'] / mean:.1%} of the bound; "
                  + " ".join(f"{t:.5f}" for t in ts))


def _cuobjdump(flag: str, lib: Path) -> str:
    from vggp_tpu_torch.ops import _build as b

    tool = str(Path(b._nvcc()).with_name("cuobjdump"))
    return subprocess.run([tool, flag, str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout


def _registers(lib: Path) -> dict:
    """{mangled kernel name: registers per thread} from cuobjdump -res-usage."""
    return {m.group(1): int(m.group(2)) for m in
            re.finditer(r"Function (\S+?):?\s*REG:(\d+)", _cuobjdump("-res-usage", lib))}


def _sass_functions(lib: Path) -> dict:
    """{mangled kernel name: ["/*offset*/ instruction"]} from cuobjdump -sass."""
    text = _cuobjdump("-sass", lib)
    funcs, cur = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            cur = funcs.setdefault(head.group(1), [])
            continue
        ins = re.match(r"\s*(/\*[0-9a-f]{4,}\*/)\s+(.*?)\s*;", line)
        if cur is not None and ins:
            cur.append(f"{ins.group(1)} {ins.group(2)}")
    return funcs


def _opcode(ins: str) -> str:
    """The opcode of a listing line ``/*offset*/ [@P] OPCODE operands``."""
    return re.sub(r"^/\*\w+\*/\s+(@!?U?P\w+\s+)?", "", ins).split()[0]


def sass(lib_sets: dict, out_dir: Path, kernel: str) -> None:
    """Instruction counts of every role in every build, the listings in
    ``out_dir``, and the roles of the other kernels than ``kernel``
    compared against the package's."""
    out_dir.mkdir(parents=True, exist_ok=True)
    by_build = {}
    for name, libs in lib_sets.items():
        funcs, regs = {}, {}
        for lib in libs:
            funcs.update(_sass_functions(lib))
            regs.update(_registers(lib))
        roles = {}
        for role, pat in _ROLES:
            # the instances of a role, by name without the anonymous
            # namespace's per-file tag
            hits = sorted((re.sub(r"_GLOBAL__N__\w+?_cu_\w{8}", "", f), f)
                          for f in funcs if re.search(pat, f))
            if not hits:
                continue
            roles[role] = [(short, [i for i in funcs[f] if _opcode(i) != "NOP"])
                           for short, f in hits]
            for k, (short, ins) in enumerate(roles[role]):
                ops = Counter(_opcode(i) for i in ins)
                fname = re.sub(r"\W", "_", f"{name}_{role}_{k}") + ".sass"
                (out_dir / fname).write_text("\n".join(ins) + "\n")
                print(f"sass {name} {role} [{k}]: {regs.get(hits[k][1], '?')} registers, "
                      f"{len(ins)} instructions -> {fname}; "
                      + ", ".join(f"{op} {v}" for op, v in ops.most_common(24)))
        by_build[name] = roles
    pkg = by_build["package"]
    for name, roles in by_build.items():
        if name == "package":
            continue
        for role in (r for r, _ in _ROLES if r.split()[0] != kernel):
            if role in roles and role in pkg:
                same = [ins for _, ins in roles[role]] == [ins for _, ins in pkg[role]]
                print(f"sass {role}: package vs {name}: {'identical' if same else 'DIFFERENT'} "
                      f"({len(pkg[role])} vs {len(roles[role])} instances, "
                      f"{sum(len(i) for _, i in pkg[role])} vs "
                      f"{sum(len(i) for _, i in roles[role])} instructions)")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=tuple(SHAPES), default="cell_kuf")
    ap.add_argument("--against", action="append", default=[], metavar="NAME=DIR",
                    help="a directory with another cell_kuf.cu (and its cell_tile.cuh)")
    ap.add_argument("--variants", action="store_true",
                    help="also time copies of the package's kernel that drop one part of the work")
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_cell_kuf_ab: no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {cs.card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    device = torch.device("cuda")

    from vggp_tpu_torch.ops import _build

    _build.load()
    others = dict(a.split("=", 1) for a in args.against)
    root = _build.BUILD_DIR / "ab"
    lib_sets = {"package": [_build.library_path(src) for src in _build.SOURCES]}
    for name, d in others.items():
        d = Path(d).resolve()
        srcs = {"cell_kuf": d / "cell_kuf.cu"}
        if args.sass and (d / "fused_whiten_tc.cu").exists():
            srcs["fused_whiten_tc"] = d / "fused_whiten_tc.cu"
        built = _compile(srcs, root / name)
        lib_sets[name] = list(built.values())
    builds = {name: libs[0] for name, libs in lib_sets.items()}
    builds["package"] = _build.library_path(_build._CSRC / "cell_kuf.cu")
    check_builds(device, builds, args.kernel)

    if args.variants:
        srcs = {"cell_kuf.cu": (_build._CSRC / "cell_kuf.cu").read_text(),
                "cell_tile.cuh": _build.HEADER.read_text()}
        for name, edits in VARIANTS[args.kernel]:
            texts = dict(srcs)
            for old, new in edits:   # each edit site is in one of the two files, once
                cs.check(sum(t.count(old) for t in texts.values()) == 1,
                         f"variant {name}: edit site not found once")
                texts = {f: t.replace(old, new) for f, t in texts.items()}
            d = root / name
            d.mkdir(parents=True, exist_ok=True)
            for f, t in texts.items():
                (d / f).write_text(t)
            builds[name] = _compile({"cell_kuf": d / "cell_kuf.cu"}, d)["cell_kuf"]
    time_builds(device, builds, args.turns, args.kernel)
    if args.sass:
        sass(lib_sets, root / "sass", args.kernel)
    torch.cuda.synchronize()
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
