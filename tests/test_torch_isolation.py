"""The PyTorch port imports neither JAX nor the JAX package: the card's
machine has no `jax`, so one such import anywhere on its side breaks it.
Also the build plumbing of ops/_build.py, with a stand-in compiler."""

import ast
import os
import stat
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "zero_latency_yolo_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "zero_latency_yolo_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path):
    roots = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.append(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import(path):
    bad = [r for r in _imported_roots(path) if r in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_isolation_covers_the_mesh_and_the_fleet():
    """The serving mesh (parallel/) and the fleet manager (serve_fleet.py)
    are among the files the import checks above walk."""
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    assert {"zero_latency_yolo_tpu_torch/parallel/__init__.py",
            "zero_latency_yolo_tpu_torch/parallel/mesh.py",
            "zero_latency_yolo_tpu_torch/serve_fleet.py"} <= names


def test_package_imports_with_jax_blocked():
    """Every module of the port imports in a process where `import jax` and
    `import zero_latency_yolo_tpu` fail."""
    pytest.importorskip("torch")
    mods = sorted(
        "zero_latency_yolo_tpu_torch." + ".".join(
            p.relative_to(PORT).with_suffix("").parts).replace(".__init__", "")
        for p in PORT.rglob("*.py"))
    code = ("import sys\n"
            + "".join(f"sys.modules[{m!r}] = None\n" for m in FORBIDDEN)
            + "import importlib\n"
            + "".join(f"importlib.import_module({m!r})\n"
                      for m in ["zero_latency_yolo_tpu_torch"] + mods)
            + "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_build_runs_nvcc_once_per_source_hash(tmp_path, monkeypatch):
    """build() calls the nvcc it finds once a source (all started together)
    and once to link, installs the output atomically under a name hashed
    from sources and flags, and reuses it; a failing compiler raises with
    its output and leaves nothing behind."""
    from zero_latency_yolo_tpu_torch.ops import _build
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    log = tmp_path / "calls"
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\n"
                    f"echo \"$@\" >> {log}\n"
                    "while [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then echo lib > \"$2\"; fi; shift\n"
                    "done\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path / "build")
    assert _build.find_nvcc() == str(nvcc)

    path, _, _ = _build.build()
    assert path.parent == tmp_path / "build"
    assert path.name.startswith("libzlt_kernels_") and path.read_text() == "lib\n"
    args = log.read_text().split()
    assert "arch=compute_90a,code=sm_90a" in args
    assert str(PORT / "csrc" / "kernels.cu") in args
    calls = log.read_text().splitlines()
    sources = sorted((PORT / "csrc").glob("*.cu"))
    assert len(sources) >= 4 and len(calls) == len(sources) + 1
    assert sorted(c.split()[-1] for c in calls[:-1]) == [str(s)
                                                         for s in sources]
    assert all(" -c " in c for c in calls[:-1])
    assert "-shared" in calls[-1].split()          # one link of the objects
    assert _build.build() == (path, "", 0.0)       # cached: no second call
    assert len(log.read_text().splitlines()) == len(sources) + 1

    path.unlink()
    nvcc.write_text("#!/bin/sh\necho 'kernels.cu(1): error' >&2\nexit 2\n")
    with pytest.raises(_build.KernelError, match="nvcc failed"):
        _build.build()
    assert not list((tmp_path / "build").iterdir())  # no partial library


def test_find_nvcc_raises_when_absent(tmp_path, monkeypatch):
    from zero_latency_yolo_tpu_torch.ops import _build
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "Path", lambda p: tmp_path / "missing"
                        if str(p) == "/usr/local/cuda/bin/nvcc" else Path(p))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


NATIVE = PORT / "native"


@pytest.mark.parametrize("path", sorted(NATIVE.glob("*.[ch]*")),
                         ids=lambda p: p.name)
def test_native_sources_include_only_their_own_headers(path):
    """The port's C++ sources include system headers and their own
    directory's headers, nothing of the JAX package's native/ directory."""
    import re
    for line in path.read_text().splitlines():
        m = re.match(r'\s*#\s*include\s*"([^"]+)"', line)
        if m:
            assert (NATIVE / m.group(1)).resolve().parent == NATIVE, line
        assert "zero_latency_yolo_tpu/" not in line, line


def test_native_build_reads_only_the_port_sources(tmp_path, monkeypatch):
    """protocol/native.build() hands the compiler the port's own sources
    and writes into its build directory, never into a source tree; a
    failing compiler raises with its output and leaves no library."""
    from zero_latency_yolo_tpu_torch.protocol import native
    log = tmp_path / "argv"
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\n"
                   f"for a in \"$@\"; do echo \"$a\" >> {log}; done\n"
                   "while [ $# -gt 0 ]; do\n"
                   "  if [ \"$1\" = -o ]; then echo lib > \"$2\"; fi; shift\n"
                   "done\n")
    cxx.chmod(cxx.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "build")
    path = native.build()
    assert path.parent == tmp_path / "build" and path.read_text() == "lib\n"
    files = [a for a in log.read_text().split() if "/" in a and a != str(cxx)]
    sources = [f for f in files if f.endswith(".cpp")]
    assert sorted(Path(f).name for f in sources) == ["codec.cpp", "udp.cpp"]
    assert all(Path(f).parent == NATIVE for f in sources)
    assert all(Path(f).parent == tmp_path / "build" for f in files
               if f not in sources)
    assert not any("zero_latency_yolo_tpu/" in f for f in files)
    assert "-std=c++17" in log.read_text().split()
    path.unlink()
    cxx.write_text("#!/bin/sh\necho 'codec.cpp:1: error' >&2\nexit 1\n")
    with pytest.raises(RuntimeError, match="codec.cpp:1: error"):
        native.build()
    assert not list((tmp_path / "build").iterdir())
