"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on first
use into its own shared library for ``sm_90a``, under ``_build/`` next to
this file (git-ignored).  The library name carries a hash of the source
and flags, so an edited source is rebuilt and a stale library is never
loaded.  :func:`build_all` starts one ``nvcc`` per source at once.

Nothing here runs at import: the CPU tests import every module, and this
machine may have neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("ternary_matmul", "pack", "histogram", "unpack_add",
           "popcount_dot", "sample")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures: every pointer and the stream as c_void_p
SIGNATURES = {
    "ternary_matmul": {"ternary_matmul_grouped":
                       [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _I,
                        _I, _P],
                       "ternary_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                          _I, _P]},
    "pack": {"pack_ternary_planes_segmented": [_P, _P, _P, _P, _L, _I, _P],
             "pack_ternary_planes": [_P, _P, _P, _P, _L, _L, _P]},
    "histogram": {"segment_hist_moments":
                  [_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
                  "segment_absmax": [_P, _P, _P, _P, _L, _I, _I, _P]},
    "unpack_add": {"unpack_add_many":
                   [_P, _P, _P, _P, _P, _I, _L, _L, _L, _L, _L, _I, _P]},
    "popcount_dot": {"popcount_dot": [_P, _P, _P, _P, _L, _P, _P]},
    "sample": {"sample_tokens": [_P, _I, _P, _P, _I, _L, _F, _I, _I, _P, _P,
                                 _P, _P, _P, _P]},
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}      # nvcc output (ptxas register report)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the "
                           "port's kernels are built with nvcc at first use")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def build_all(names=SOURCES) -> dict[str, ctypes.CDLL]:
    """Compile (in parallel) and load every library not yet loaded."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n in todo:
            out = _lib_path(n)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, out)
        for n, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            build_logs[n] = log
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {n}.cu:\n{log}")
            os.replace(tmp, out)
        for n in todo:
            _libs[n] = _load(n, _lib_path(n))
        return dict(_libs)


def library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    return lib if lib is not None else build_all((name,))[name]


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
