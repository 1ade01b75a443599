"""Build and bind the port's CUDA kernels: nvcc -> one .so -> ctypes.

`csrc/*.cu` have a plain C interface and include no PyTorch header, so one
`nvcc` call builds them in seconds (no `torch.utils.cpp_extension`, no
ninja). The library lands in `build/kernels/` at the repo root, named by a
hash of the sources and flags, and is built at first use in a process: a
fresh checkout builds everything on its first kernel launch.

Wrappers pass raw pointers (`tensor.data_ptr()`) and PyTorch's current stream
(`torch.cuda.current_stream().cuda_stream`); every entry point returns a CUDA
error code, which `check` turns into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG.parent / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_SIGNATURES = {
    # name: (argtypes, restype)
    "zlt_error_string": ([ctypes.c_int], ctypes.c_char_p),
    "zlt_nms_keep_smem_bytes": ([ctypes.c_int], ctypes.c_int),
    "zlt_nms_keep": ([_P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_int, ctypes.c_int, _P],
                     ctypes.c_int),
    "zlt_conv1x1_bias_act": ([_P, _P, _P, _P] + [ctypes.c_int] * 6 + [_P],
                             ctypes.c_int),
    "zlt_conv1x1_wgmma": ([_P, _P, _P, _P] + [ctypes.c_int] * 8 + [_P],
                          ctypes.c_int),
    "zlt_tma_encode_us": ([_P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int], ctypes.c_double),
    "zlt_bias_silu_wave_threads": ([ctypes.c_int], ctypes.c_int),
    "zlt_bias_silu": ([_P, _P, _P] + [ctypes.c_int] * 5 + [_P], ctypes.c_int),
}


@dataclass
class Kernels:
    """The loaded library and how it was built."""
    lib: ctypes.CDLL
    path: Path
    build_log: str       # nvcc's output (ptxas registers / spills); "" if cached
    build_seconds: float  # 0.0 when the library was already built


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, /usr/local/cuda/bin or PATH; raises if none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found ($CUDA_HOME/bin, /usr/local/cuda/bin, "
                       "PATH): the CUDA kernels cannot be built")


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return _BUILD_DIR / f"libzlt_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple:
    """Compile csrc/*.cu into the hashed library unless it exists.
    Returns (path, nvcc output, seconds)."""
    out = _library_path()
    if out.exists():
        return out, "", 0.0
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *map(str, sorted(_CSRC.glob("*.cu")))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    return out, proc.stdout + proc.stderr, seconds


@functools.cache
def kernels() -> Kernels:
    """Build (once per source hash) and load the kernel library."""
    path, log, seconds = build()
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return Kernels(lib=lib, path=path, build_log=log, build_seconds=seconds)


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err:
        msg = kernels().lib.zlt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
