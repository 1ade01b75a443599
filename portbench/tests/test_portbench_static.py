"""What the harness may import, and that every kernel has a family."""

import ast
import re
from pathlib import Path

from portbench import tracing

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT.parent / "zero_latency_yolo_tpu_torch" / "csrc"
FORBIDDEN = {"jax", "jaxlib", "flax", "zero_latency_yolo_tpu"}


def imports(path: Path):
    """Top-level names of every module a file imports (relative imports
    are the harness's own)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(ROOT.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        bad = imports(f) & FORBIDDEN
        assert not bad, f"{f}: {bad}"
    # The port's name begins with the JAX package's; compared whole it is
    # not the JAX package.
    assert "zero_latency_yolo_tpu_torch" in imports(ROOT / "serving.py")


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((ROOT / "reference").rglob("*.py")):
        names = imports(f)
        assert "zero_latency_yolo_tpu_torch" not in names, f
        assert "portbench" not in names, f


def test_every_kernel_in_csrc_has_a_family():
    fams = tracing.families(ROOT)
    kernels = set()
    for src in sorted(CSRC.glob("*.cu")):
        kernels.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
            src.read_text()))
    assert len(kernels) >= 7
    for k in sorted(kernels):
        fam = tracing.family_of(f"void {k}<__nv_bfloat16, 64>(int)", fams)
        assert fam is not None and fam.get("launch_counter"), k
