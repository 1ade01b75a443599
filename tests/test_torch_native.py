"""The port's native codec (`zero_latency_yolo_tpu_torch/native/`) under ASan
and UBSan: `codec_test.cpp`'s checks (the JAX package's known answers, frame
headers and loopback transport, plus the port's granted buffer sizes and
SO_RXQ_OVFL drop count) and the 200,000-packet fuzz, built with the flags
of the root Makefile's `test-native-torch` (those of the JAX package's
`native/Makefile` `test-native`). Needs a g++ that accepts
-fsanitize=address,undefined; no JAX, no torch."""

import shutil
import subprocess
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
NATIVE = REPO / "zero_latency_yolo_tpu_torch" / "native"
FLAGS = ["-O1", "-g", "-Wall", "-std=c++17", "-fPIC",
         "-fsanitize=address,undefined", "-fno-omit-frame-pointer"]
FUZZ = 200000


@pytest.fixture(scope="module")
def codec_test(tmp_path_factory):
    """The sanitized test binary, or a skip where g++ cannot build one."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++")
    out = tmp_path_factory.mktemp("native") / "codec_test_asan"
    proc = subprocess.run(
        [gxx, *FLAGS, "-o", str(out), str(NATIVE / "codec.cpp"),
         str(NATIVE / "udp.cpp"), str(NATIVE / "codec_test.cpp")],
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0 and "sanitize" in proc.stderr:
        pytest.skip(f"g++ refuses the sanitizers: {proc.stderr[-500:]}")
    assert proc.returncode == 0, proc.stderr[-3000:]
    return out


def _run(binary, *args):
    return subprocess.run([str(binary), *args], capture_output=True,
                          text=True, timeout=300)


def test_codec_checks_pass_under_sanitizers(codec_test):
    proc = _run(codec_test)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    assert "udp transport: all checks passed" in proc.stdout
    assert "udp drops:" in proc.stdout
    assert "codec_test: all checks passed" in proc.stdout
    assert "runtime error" not in proc.stderr  # UBSan reports, recovered


def test_codec_fuzz_is_clean_under_sanitizers(codec_test):
    proc = _run(codec_test, "fuzz", str(FUZZ))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"fuzz: {FUZZ} iterations clean" in proc.stdout
    assert "runtime error" not in proc.stderr


def test_make_target_builds_the_port_sources():
    """`make test-native-torch` names the port's sources and the JAX
    target's flags, and builds into a git-ignored directory."""
    mk = (REPO / "Makefile").read_text()
    target = mk[mk.index("test-native-torch:"):]
    for src in ("codec.cpp", "udp.cpp", "codec_test.cpp"):
        assert f"$(TORCH_NATIVE)/{src}" in target
    assert "TORCH_NATIVE := zero_latency_yolo_tpu_torch/native" in mk
    assert "-fsanitize=address,undefined" in target
    assert "fuzz 200000" in target
    assert "build/" in (REPO / ".gitignore").read_text().splitlines()
    assert "TORCH_NATIVE_TEST := build/native-test/" in mk
