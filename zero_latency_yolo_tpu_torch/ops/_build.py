"""Build and bind the port's CUDA kernels: nvcc -> one .so -> ctypes.

`csrc/*.cu` have a plain C interface and include no PyTorch header, so
`nvcc` builds them in seconds (no `torch.utils.cpp_extension`, no ninja):
one compile a source, all started together, then one link. The library
lands in `build/kernels/` at the repo root, named by a hash of the sources
and flags, and is built at first use in a process: a fresh checkout builds
everything on its first kernel launch.

Wrappers pass raw pointers (`tensor.data_ptr()`) and PyTorch's current stream
(`torch.cuda.current_stream().cuda_stream`); every entry point returns a CUDA
error code, which `check` turns into an exception. Every failure to find
nvcc, build, or launch raises `KernelError`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG.parent / "build" / "kernels"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v")
LINK_FLAGS = ARCH_FLAGS + ("-shared",)

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
    "zlt_conv3x3_wgmma": ([_P, _P, _P, _P] + [ctypes.c_int] * 12 + [_P],
                          ctypes.c_int),
    "zlt_tma_encode_us": ([_P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int], ctypes.c_double),
    "zlt_bias_silu_wave_threads": ([ctypes.c_int], ctypes.c_int),
    "zlt_bias_silu": ([_P, _P, _P] + [ctypes.c_int] * 5 + [_P], ctypes.c_int),
    "zlt_conv_int8": ([_P] * 7 + [ctypes.c_int] * 14 + [_P], ctypes.c_int),
}


class KernelError(RuntimeError):
    """A kernel could not be built, loaded or launched."""


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
    raise KernelError("nvcc not found ($CUDA_HOME/bin, /usr/local/cuda/bin, "
                       "PATH): the CUDA kernels cannot be built")


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for p in sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return _BUILD_DIR / f"libzlt_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple:
    """Compile csrc/*.cu into the hashed library unless it exists: one nvcc
    a source, all started at once, then one link. Returns (path, nvcc
    output, seconds)."""
    out = _library_path()
    if out.exists():
        return out, "", 0.0
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmpdir:
        srcs = sorted(_CSRC.glob("*.cu"))
        objs = [Path(tmpdir) / f"{src.stem}.o" for src in srcs]
        cmds = [[nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(srcs, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        logs = [p.communicate()[0] for p in procs]
        tmp = Path(tmpdir) / out.name
        cmds.append([nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)])
        if all(p.returncode == 0 for p in procs):
            link = subprocess.run(cmds[-1], capture_output=True, text=True,
                                  check=False)
            procs.append(link)
            logs.append(link.stdout + link.stderr)
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise KernelError(f"nvcc failed (exit {proc.returncode}):\n"
                                  f"{' '.join(cmd)}\n{log}")
        # Atomic: a concurrent process never loads half a file.
        os.replace(tmp, out)
    return out, "".join(logs), time.perf_counter() - t0


@functools.cache
def kernels() -> Kernels:
    """Build (once per source hash) and load the kernel library."""
    path, log, seconds = build()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise KernelError(f"cannot load {path}: {e}") from e
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return Kernels(lib=lib, path=path, build_log=log, build_seconds=seconds)


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err:
        msg = kernels().lib.zlt_error_string(err).decode()
        raise KernelError(f"{name}: CUDA error {err} ({msg})")
