"""A/B of the port's cell_kuf kernel against other builds of its source, on one CUDA card.

    python3 tools/torch_cell_kuf_ab.py [--against NAME=DIR ...] [--variants]
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

- each build's ``cell_kuf_f32`` and ``cell_kuf_f64`` against the plain
  version at the main path's (512, 4096), the serving grid's (512, 65536)
  and ragged shapes (max|Δ|/max|plain|, f64 ≤ 1e-12, f32 ≤ 2e-5);
- the float32 device time of each build's ``cell_kuf_f32`` and of the
  package's, at (512, 4096) and (512, 65536), from the profiler's CUDA
  trace, in ``--turns`` interleaved turns (builds in order, then in reverse)
  beside the bound of each shape (``chip_smoke.kuf_bounds``);
- with ``--variants``, in the same turns: edited copies of the package's
  ``csrc/cell_kuf.cu`` that each drop one part of the kernel's work (the
  element math, the stores), for a breakdown of its time. They compute
  wrong numbers by design and are only timed;
- with ``--sass``: for each library, each kernel's registers per thread
  (``cuobjdump -res-usage``), its SASS instruction count and its most
  frequent opcodes (``cuobjdump -sass``; the listings, with offsets, in
  full under ``vggp_tpu_torch/_build/ab/sass/``), and whether the
  ``cell_kuf_with_dl`` and fused kernels' SASS is the same in the package
  as in each DIR.

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

SHAPES = ((512, 4096), (512, 65536))
CHECK_SHAPES = ((512, 4096), (512, 65536), (37, 1023), (1, 5), (200, 301))
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

# Kernel roles for the SASS comparison: (role, regex of the mangled names).
# The earlier source named the kernel of both cell_kuf entry points
# cell_kuf_kernel<T, WITH_DL>; now cell_kuf runs cell_kuf_primal_kernel<T, VEC>
# (VEC: 16-byte accesses) and cell_kuf_with_dl runs cell_kuf_with_dl_kernel<T>.
_ROLES = (
    ("cell_kuf f32", r"cell_kuf_kernelIfLb0E|cell_kuf_primal_kernelIfLb1E"),
    ("cell_kuf f32 scalar", r"cell_kuf_primal_kernelIfLb0E"),
    ("cell_kuf f64", r"cell_kuf_kernelIdLb0E|cell_kuf_primal_kernelIdLb1E"),
    ("cell_kuf_with_dl f32", r"cell_kuf_kernelIfLb1E|cell_kuf_with_dl_kernelIfE"),
    ("cell_kuf_with_dl f64", r"cell_kuf_kernelIdLb1E|cell_kuf_with_dl_kernelIdE"),
    ("fused f64", r"fused_whiten_kernelIdE"),
    ("fused f32 (tc)", r"fused_whiten_tc_kernel"),
)
_SAME_ROLES = ("cell_kuf_with_dl f32", "cell_kuf_with_dl f64", "fused f64", "fused f32 (tc)")

# (name, [(text in csrc/cell_kuf.cu, replacement)]) — each drops one part
_MATH = ("    kuf_points(row, xv, inv_ell, var_ell, out_coef, f);\n"
         "    store_points",
         "#pragma unroll\n"
         "    for (int k = 0; k < VN; ++k) f[k] = xv[k] * out_coef;\n"
         "    store_points")
_STORES = ("    store_points<T, VEC>(out + static_cast<size_t>(i) * n, j, n, f);",
           "    if (f[0] == T(1234.5)) store_points<T, VEC>(out + static_cast<size_t>(i) * n, j, n, f);")
VARIANTS = [("no_element_math", [_MATH]), ("no_stores", [_STORES])]


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


def _entry(lib_path: Path, name: str):
    fn = getattr(ctypes.CDLL(str(lib_path)), name)
    fn.argtypes = _ARGS
    fn.restype = ctypes.c_int
    return fn


def _caller(fn, mesh, x, scal, out):
    import torch

    m, n = out.shape
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (mesh, x, scal, out)]

    def call():
        rc = fn(*ptrs, m, n, stream())
        cs.check(rc == 0, f"launch failed: cudaError {rc}")
    return call


def check_builds(device, builds: dict) -> None:
    import torch

    from vggp_tpu_torch.ops import cell_kuf as ck

    for dtype, tol, sfx in ((torch.float64, cs.TOL_F64, "f64"), (torch.float32, cs.TOL_F32, "f32")):
        for shape in CHECK_SHAPES:
            mesh, x, v, ell, _ = cs.kernel_inputs(*shape, dtype, device, seed=11)
            want = ck.cell_kuf_plain(mesh, x, v, ell)
            scal = ck._scal(v, ell, mesh)
            errs = []
            for name, lib in builds.items():
                out = torch.full(shape, float("nan"), dtype=dtype, device=device)
                _caller(_entry(lib, f"cell_kuf_{sfx}"), mesh, x, scal, out)()
                errs.append(f"{name} {cs.rel_err(out, want):.3e}")
                cs.check(cs.rel_err(out, want) < tol, f"{name} {sfx} {shape}")
            print(f"check cell_kuf {sfx} {shape}: " + ", ".join(errs))


def time_builds(device, builds: dict, turns: int) -> None:
    import torch

    from vggp_tpu_torch.ops import cell_kuf as ck

    for shape in SHAPES:
        mesh, x, v, ell, _ = cs.kernel_inputs(*shape, torch.float32, device, seed=3)
        scal = ck._scal(v, ell, mesh)
        out = torch.empty(shape, dtype=torch.float32, device=device)
        calls = {name: _caller(_entry(lib, "cell_kuf_f32"), mesh, x, scal, out)
                 for name, lib in builds.items()}
        iters = 50 if shape[1] <= 4096 else 20
        times = {name: [] for name in builds}
        order = list(builds)
        for _ in range(turns):
            for name in order + order[::-1]:
                times[name].append(cs.time_ms(calls[name], iters=iters, kernel="cell_kuf")[0])
        bound = cs.kuf_bounds(*shape, False)
        print(f"time cell_kuf f32 {shape}, bound {bound['bound_ms']:.5f} ms ({bound['bound_by']}):")
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


def sass(lib_sets: dict, out_dir: Path) -> None:
    """Instruction counts of every role in every build, the listings in
    ``out_dir``, and the with-dl and fused roles compared against the
    package's."""
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
        for role in _SAME_ROLES:
            if role in roles and role in pkg:
                same = [ins for _, ins in roles[role]] == [ins for _, ins in pkg[role]]
                print(f"sass {role}: package vs {name}: {'identical' if same else 'DIFFERENT'} "
                      f"({len(pkg[role])} vs {len(roles[role])} instances, "
                      f"{sum(len(i) for _, i in pkg[role])} vs "
                      f"{sum(len(i) for _, i in roles[role])} instructions)")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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
    check_builds(device, builds)

    if args.variants:
        src = (_build._CSRC / "cell_kuf.cu").read_text()
        for name, edits in VARIANTS:
            text = src
            for old, new in edits:
                cs.check(text.count(old) == 1, f"variant {name}: edit site not found once")
                text = text.replace(old, new)
            d = root / name
            d.mkdir(parents=True, exist_ok=True)
            (d / "cell_kuf.cu").write_text(text)
            (d / "cell_tile.cuh").write_text(_build.HEADER.read_text())
            builds[name] = _compile({"cell_kuf": d / "cell_kuf.cu"}, d)["cell_kuf"]
    time_builds(device, builds, args.turns)
    if args.sass:
        sass(lib_sets, root / "sass")
    torch.cuda.synchronize()
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
