"""Build and load the hand-written CUDA kernels.

Each source in :data:`SOURCES` is compiled with ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface and loaded with ``ctypes``;
the builds of a first use run side by side, one ``nvcc`` per source. A
library is built into ``vggp_tpu_torch/_build/``, keyed by a hash of its
source, the shared header and its flags (:data:`NVCC_FLAGS` and the
source's :data:`EXTRA_FLAGS`), so an edited source builds anew and an
unchanged one is loaded from disk. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
HEADER = _CSRC / "cell_tile.cuh"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# source → {C entry point: argument types}; every entry point returns an int
SOURCES = {
    _CSRC / "cell_kuf.cu": {
        "cell_kuf_f32": [_P] * 4 + [_I, _I, _P],
        "cell_kuf_f64": [_P] * 4 + [_I, _I, _P],
        "cell_kuf_with_dl_f32": [_P] * 5 + [_I, _I, _P],
        "cell_kuf_with_dl_f64": [_P] * 5 + [_I, _I, _P],
        "fused_banded_whiten_kuf_f64": [_P] * 6 + [_I, _I, _P],
    },
    _CSRC / "fused_whiten_tc.cu": {
        "fused_banded_whiten_kuf_f32": [_P] * 6 + [_I, _I, _I, _I, _P],
    },
    _CSRC / "m12_finv.cu": {
        "m12_finv_f32": [_P, _D, _D, _P, _P, _P, _I, _P],
        "m12_finv_f64": [_P, _D, _D, _P, _P, _P, _I, _P],
    },
}
# flags of one source on top of NVCC_FLAGS: the closed-form F⁻¹ keeps every
# product and sum rounded apart, as the PyTorch operators it replaces do
EXTRA_FLAGS = {_CSRC / "m12_finv.cu": ("-fmad=false",)}

_lib = None
_build_seconds = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _flags(source: Path) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(source, ())


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes() + HEADER.read_bytes()
                            + " ".join(_flags(source)).encode())
    return BUILD_DIR / f"{source.stem}_{digest.hexdigest()[:16]}.so"


def _compile_all(sources) -> None:
    """Run one nvcc per source, all at once; each library appears atomically."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for src in sources:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen([_nvcc(), *_flags(src), "-o", tmp, str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            jobs.append((src, tmp, proc))
        for src, tmp, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{err}")
            os.replace(tmp, library_path(src))   # a reader never sees a partial library
    finally:
        for _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)


def load():
    """The kernels' C entry points as attributes of one namespace, each
    library built first if it is not on disk."""
    global _lib, _build_seconds
    if _lib is None:
        t0 = time.perf_counter()
        missing = [src for src in SOURCES if not library_path(src).exists()]
        if missing:
            _compile_all(missing)
        _build_seconds = time.perf_counter() - t0
        fns = {}
        for src, entries in SOURCES.items():
            lib = ctypes.CDLL(str(library_path(src)))
            for name, argtypes in entries.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _I
                fns[name] = fn
        _lib = SimpleNamespace(**fns)
    return _lib


def build_seconds():
    """Seconds the first :func:`load` of this process spent building (near 0
    when the libraries were already on disk), or None before it."""
    return _build_seconds
