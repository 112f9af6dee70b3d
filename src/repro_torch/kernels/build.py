"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each source under `csrc/` compiles into its own shared library with a
plain C interface (pointers as `void*`, sizes as `int`, PyTorch's current
stream as `void*`), so no PyTorch header is compiled and a build takes
seconds.  Nothing is built at import time: the first CUDA call of a
kernel wrapper builds its library, and `build_all` starts every nvcc at
once (one process per source) for callers that want the build up front.

Libraries land in `_build/` beside this file, named by a digest of the
source files and the flags, so an edited source rebuilds and concurrent
builders never read a half-written file (write to a temporary name, then
`os.replace`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# -fmad=false: the planner kernels must evaluate one float expression with
# the same roundings in two kernels; no contraction into FMA anywhere
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false")

# library name -> (main source, headers it includes)
SOURCES: Dict[str, tuple] = {
    "codec_bytes": ("codec_bytes.cu", ()),
    "planner_score": ("planner_score.cu", ("prob_expr.cuh",)),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built on this machine")


def _lib_path(name: str) -> Path:
    main, headers = SOURCES[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (main,) + tuple(headers):
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one library; returns (final path, tmp path, process)
    or (path, None, None) when it is already built."""
    out = _lib_path(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name][0])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp, proc) -> Path:
    if proc is None:
        return out
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return out


def build_all(names: Iterable[str] = tuple(SOURCES)) -> List[Path]:
    """Build every named library, all nvcc processes running at once."""
    names = list(names)
    started = [(n, *_start(n)) for n in names]
    return [_finish(n, out, tmp, proc) for n, out, tmp, proc in started]


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _finish(name, *_start(name))
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib
