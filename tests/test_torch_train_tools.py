"""The port's training tools against the JAX package's scripts of the same
name, on the CPU: `utils/bench_util.py`, `train_step_bench`, `eval_artifact`,
`train_variant_artifact`, `flywheel`, `assigner_compare`, `width_accuracy`
and `coco_to_yolo` (each `python -m zero_latency_yolo_tpu_torch.<tool>`,
run here in this process with `--device cpu` unless the test says
otherwise).

Where a tool trains, the JAX script would compile a train step for each
training (15-25 s each here); those tools are held to their scripts with
`--steps 0` (the same untrained init in both packages, then the fold, the
eval and the line: equal), and the port's run with a few steps shows the
training path.
"""

import ast
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_fixtures.cpu_threads  # noqa: E402,F401  (caps torch's CPU threads)
import jax  # noqa: E402

from zero_latency_yolo_tpu.models.weights import load_params as jload_params  # noqa: E402
from zero_latency_yolo_tpu.utils import bench_util as jbench  # noqa: E402

from zero_latency_yolo_tpu_torch import (  # noqa: E402
    assigner_compare, coco_to_yolo, eval_artifact, flywheel,
    train_step_bench, train_variant_artifact, width_accuracy)
from zero_latency_yolo_tpu_torch.config import ServerConfig  # noqa: E402
from zero_latency_yolo_tpu_torch.models import weights as pw  # noqa: E402
from zero_latency_yolo_tpu_torch.models.yolov8 import get_spec, init_params  # noqa: E402
from zero_latency_yolo_tpu_torch.runtime.capture import DatasetCapture  # noqa: E402
from zero_latency_yolo_tpu_torch.runtime.engine import (  # noqa: E402
    InferenceEngine, InferenceRequest)
from zero_latency_yolo_tpu_torch.train.loop import synthetic_batches  # noqa: E402
from zero_latency_yolo_tpu_torch.utils import bench_util as pbench  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"
WEIGHTS = REPO / "artifacts" / "yolov8n_trained_416.npz"
ENV = {**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu",
       "OMP_NUM_THREADS": "2"}


def _script(name, *args, timeout=300):
    """The JAX package's script as a process on the CPU: (rc, stdout,
    stderr)."""
    proc = subprocess.run([sys.executable, str(SCRIPTS / f"{name}.py"),
                           *args], cwd=REPO, env=ENV, capture_output=True,
                          text=True, timeout=timeout)
    return proc.returncode, proc.stdout, proc.stderr


def _port(tool, *args):
    """A port tool's main() in this process: (rc, stdout lines)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tool.main(list(args))
    return rc, out.getvalue().strip().splitlines()


def _json_lines(lines):
    return [json.loads(x) for x in lines if x.startswith("{")]


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# utils/bench_util.py
# ---------------------------------------------------------------------------

class _Clock:
    """A fake clock: each dispatch costs `step`, each readback `rtt`."""

    def __init__(self, step, rtt):
        self.t, self.step, self.rtt = 0.0, step, rtt
        self.dispatched = 0
        self.readbacks = 0

    def perf_counter(self):
        return self.t

    def run_once(self):
        self.t += self.step
        self.dispatched += 1
        return self

    def cpu(self):  # the port's readback
        self.t += self.rtt
        self.readbacks += 1
        return self

    def __array__(self, dtype=None, copy=None):  # the JAX package's
        self.cpu()
        return np.zeros(1, dtype or np.float32)


@pytest.mark.parametrize("n1,n2,repeats", [(10, 50, 2), (3, 9, 1)])
def test_pipeline_step_seconds_matches_jax_on_a_stub(monkeypatch, n1, n2,
                                                      repeats):
    """The pipeline method on a stub whose dispatch costs 2.5 ms and whose
    readback costs 40 ms: the port and the JAX package return the same
    step and readback times (the stub's), with one readback a pipeline
    and no other sync; a step faster than 1 us reads 1 us."""
    got = {}
    for name, mod in (("port", pbench), ("jax", jbench)):
        clock = _Clock(0.0025, 0.040)
        monkeypatch.setattr(mod.time, "perf_counter", clock.perf_counter)
        got[name] = mod.pipeline_step_seconds(clock.run_once, n1=n1, n2=n2,
                                              repeats=repeats)
        monkeypatch.undo()
        assert clock.readbacks == 2 + 2 * repeats
        assert clock.dispatched == 1 + 3 + repeats * (n1 + n2)
    assert got["port"] == pytest.approx(got["jax"], rel=1e-12)
    assert got["port"] == pytest.approx((0.0025, 0.040), rel=1e-9)
    clock = _Clock(0.0, 0.01)
    monkeypatch.setattr(pbench.time, "perf_counter", clock.perf_counter)
    assert pbench.pipeline_step_seconds(clock.run_once)[0] == 1e-6


def test_measure_cached_step_times_the_engine_cached_step():
    """measure_cached_step runs the engine's cached step (get_step_cached
    over a frame cache, packed slots/heights/widths) and returns a positive
    step time and a readback time."""
    cfg = ServerConfig.from_dict({
        "model_path": "/nonexistent.npz", "detection": {
            "model_width": 64, "model_height": 64},
        "tpu": {"dtype": "float32", "frame_buckets": [[64, 96]],
                "batch_buckets": [2]}})
    engine = InferenceEngine(cfg, params=init_params(0, get_spec("yolov8p",
                                                                 4)),
                             device="cpu")
    step_s, rtt_s = pbench.measure_cached_step(engine, 2, (64, 96), 60, 90)
    assert step_s > 0 and rtt_s >= 0


# ---------------------------------------------------------------------------
# train_step_bench
# ---------------------------------------------------------------------------

def _dict_keys(name, call):
    """The keys of the dict literal passed to `call` (e.g. "dumps",
    "append") in the JAX script `name`."""
    tree = ast.parse((SCRIPTS / f"{name}.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == call and node.args and isinstance(node.args[0], ast.Dict)):
            return sorted(k.value for k in node.args[0].keys)
    raise AssertionError(f"no {call}({{...}}) in {name}")


def test_train_step_bench_line_has_the_scripts_keys(monkeypatch):
    """One JSON line with the JAX script's keys and row keys (read from the
    script: the JAX package's own test runs it, and its compile takes
    about 25 s here), a row a batch, finite; on a virtual 2x1 mesh its
    `mesh` reads 2x1."""
    args = ("--device", "cpu", "--variant", "yolov8p", "--size", "32",
            "--batches", "2,4", "--pipeline", "2,4")
    rc, lines = _port(train_step_bench, *args)
    got = _json_lines(lines)
    assert rc == 0 and len(got) == 1
    got = got[0]
    assert sorted(got) == _dict_keys("train_step_bench", "dumps")
    assert [sorted(r) for r in got["rows"]] == [
        _dict_keys("train_step_bench", "append")] * 2
    assert [r["batch"] for r in got["rows"]] == [2, 4]
    assert all(np.isfinite(v) for r in got["rows"] for v in r.values())
    assert got["mesh"] is None and got["device"] == "cpu"
    from zero_latency_yolo_tpu_torch.parallel import mesh as pmesh
    monkeypatch.setattr(pmesh, "available_devices",
                        lambda device="cuda": [torch.device("cpu")] * 2)
    rc, lines = _port(train_step_bench, *args, "--mesh-data", "2")
    got = _json_lines(lines)[0]
    assert rc == 0 and got["mesh"] == "2x1"
    assert all(np.isfinite(r["final_loss"]) for r in got["rows"])


def test_train_step_bench_distills_and_checks_the_teacher(tmp_path):
    teacher = tmp_path / "teacher.npz"
    pw.save_params(init_params(5, get_spec("yolov8p", 4)), str(teacher))
    rc, lines = _port(train_step_bench, "--device", "cpu", "--variant",
                      "yolov8p", "--size", "32", "--batches", "2",
                      "--pipeline", "2,3", "--distill-from", str(teacher))
    got = _json_lines(lines)[0]
    assert rc == 0 and got["distill_from"] == str(teacher)
    wrong = tmp_path / "nc2.npz"
    pw.save_params(init_params(5, get_spec("yolov8p", 2)), str(wrong))
    with pytest.raises(SystemExit, match="student needs nc=4"):
        train_step_bench.main(["--device", "cpu", "--variant", "yolov8p",
                               "--distill-from", str(wrong)])


# ---------------------------------------------------------------------------
# eval_artifact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task", ["blob", "crowded", "ood2"])
def test_eval_artifact_line_equals_the_scripts(task):
    """The deployed weights at 128 px on 8 images of the task: the port's
    line equals the JAX script's but for the wall time (the f32 eval gate
    of the trainer: the same detections decided)."""
    args = ("--weights", str(WEIGHTS), "--size", "128", "--images", "8",
            "--task", task, "--topk", "64")
    rc, out, err = _script("eval_artifact", *args)
    assert rc == 0, err[-2000:]
    want = json.loads(out.strip().splitlines()[-1])
    rc, lines = _port(eval_artifact, *args, "--device", "cpu")
    got = _json_lines(lines)[0]
    assert rc == 0
    want.pop("eval_s"), got.pop("eval_s")
    assert got == want
    assert want["mAP"] > 0


def test_eval_artifact_reads_a_directory_as_the_script(tmp_path):
    """--data: a YOLO directory of PNGs and labels, the same line."""
    import cv2
    images, targets = next(synthetic_batches(6, 128, seed=777))
    (tmp_path / "images").mkdir()
    (tmp_path / "labels").mkdir()
    for i, (img, t) in enumerate(zip(images, targets)):
        cv2.imwrite(str(tmp_path / "images" / f"im{i}.png"),
                    cv2.cvtColor((img * 255).astype(np.uint8),
                                 cv2.COLOR_RGB2BGR))
        (tmp_path / "labels" / f"im{i}.txt").write_text("".join(
            f"{int(r[0])} {r[1]:.6f} {r[2]:.6f} {r[3]:.6f} {r[4]:.6f}\n"
            for r in t if r[0] >= 0))
    args = ("--weights", str(WEIGHTS), "--size", "128", "--data",
            str(tmp_path), "--images", "0")
    rc, out, err = _script("eval_artifact", *args)
    assert rc == 0, err[-2000:]
    want = json.loads(out.strip().splitlines()[-1])
    rc, lines = _port(eval_artifact, *args, "--device", "cpu")
    got = _json_lines(lines)[0]
    want.pop("eval_s"), got.pop("eval_s")
    assert got == want and got["images"] == 6


@pytest.mark.parametrize("args,message", [
    (("--images", "-1"), "--images must be >= 0"),
    (("--images", "0"), "requires --data"),
])
def test_eval_artifact_argument_checks_as_the_script(args, message):
    rc, out, err = _script("eval_artifact", "--weights", str(WEIGHTS), *args)
    assert rc != 0 and message in err
    with pytest.raises(SystemExit, match=message):
        eval_artifact.main(["--weights", str(WEIGHTS), "--device", "cpu",
                            *args])


def test_eval_artifact_refuses_an_unknown_format(tmp_path):
    bad = tmp_path / "w.bin"
    bad.write_bytes(b"x")
    with pytest.raises(SystemExit, match="unknown weight format"):
        eval_artifact.main(["--weights", str(bad), "--device", "cpu"])


# ---------------------------------------------------------------------------
# train_variant_artifact
# ---------------------------------------------------------------------------

def test_train_variant_artifact_equals_the_script_untrained(tmp_path):
    """--stage1-steps 0 --steps 0: both packages write the folded init of
    the variant (equal within f32's last bits: the two folds) and print the
    same metrics."""
    args = ("--variant", "yolov8p", "--stage1-steps", "0", "--steps", "0",
            "--size", "64", "--eval-images", "8")
    rc, out, err = _script("train_variant_artifact", *args, "--out",
                           str(tmp_path / "jax.npz"))
    assert rc == 0, err[-2000:]
    want = json.loads(out.strip().splitlines()[-1])
    rc, lines = _port(train_variant_artifact, *args, "--out",
                      str(tmp_path / "port.npz"), "--device", "cpu")
    got = _json_lines(lines)[-1]
    for line in (want, got):
        line.pop("train_s"), line.pop("out")
    assert rc == 0 and got == want
    a = pw.flatten(pw.load_params(str(tmp_path / "jax.npz")))
    b = pw.flatten(pw.load_params(str(tmp_path / "port.npz")))
    assert sorted(a) == sorted(b) and not any("/bn/" in k for k in a)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_train_variant_artifact_is_read_by_both_packages(tmp_path):
    """A few steps of both stages: the artifact is a folded npz that the
    JAX package's load_params and the port's read alike, of the variant
    asked for, and the port's serving engine loads and serves it."""
    out = tmp_path / "a.npz"
    rc, lines = _port(train_variant_artifact, "--variant",
                      "yolov8-d0.17-w0.125-mc256", "--stage1-steps", "2",
                      "--steps", "2", "--size", "64", "--batch", "2",
                      "--eval-images", "4", "--out", str(out), "--device",
                      "cpu", "--schedule", "cosine")
    row = _json_lines(lines)[-1]
    assert rc == 0 and row["out"] == str(out)
    assert 0.0 <= row["mAP"] <= 1.0
    theirs = pw.flatten(jload_params(str(out)))
    ours = pw.flatten(pw.load_params(str(out)))
    assert sorted(theirs) == sorted(ours)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])
    assert not any("/bn/" in k for k in ours)
    assert (pw.infer_spec_from_params(pw.load_params(str(out))).variant
            == "yolov8-d0.17-w0.125-mc256")
    cfg = ServerConfig.from_dict({
        "model_path": str(out), "detection": {
            "model_width": 64, "model_height": 64},
        "tpu": {"dtype": "float32", "frame_buckets": [[64, 64]],
                "batch_buckets": [1]}})
    engine = InferenceEngine(cfg, device="cpu")
    assert not engine.simulation
    frame = (next(synthetic_batches(1, 64, seed=3))[0][0] * 255).astype(
        np.uint8)
    res = engine.infer_batch([InferenceRequest(
        client_id=1, frame_id=0, timestamp=0, width=64, height=64,
        data=frame)])
    assert len(res) == 1


# ---------------------------------------------------------------------------
# flywheel
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def base_weights(tmp_path_factory):
    p = tmp_path_factory.mktemp("w") / "base_pico.npz"
    pw.save_params(init_params(0, get_spec("yolov8p", 4), folded=True),
                   str(p))
    return str(p)


@pytest.fixture(scope="module")
def capture_dir(tmp_path_factory):
    """A capture directory written by the port's own capture
    (`runtime/capture.py`): 24 blob frames offered as keyframes, each
    paired with its boxes as the served detections."""
    root = tmp_path_factory.mktemp("cap")
    cap = DatasetCapture(str(root), sample_every=1, max_images=100,
                         min_confidence=0.25)
    images, targets = next(synthetic_batches(24, 64, seed=7))
    for i, (img, t) in enumerate(zip(images, targets)):
        cap.offer_keyframe(1, i, (img * 255).astype(np.uint8))
        cap.on_result(1, i, [SimpleNamespace(
            class_id=int(r[0]), x=float(r[1]), y=float(r[2]),
            width=float(r[3]), height=float(r[4]), confidence=0.9)
            for r in t if r[0] >= 0])
        # The writer's queue sheds when full: let it write each pair.
        deadline = time.monotonic() + 10
        while cap.written <= i and time.monotonic() < deadline:
            time.sleep(0.005)
    cap.stop()
    assert cap.written == 24
    return str(root)


def test_flywheel_split_equals_the_scripts():
    """The stem-hash split is the JAX script's: the same buckets, disjoint,
    stable under order and growth, near the fraction asked for."""
    jfw = _load_script("flywheel")
    pairs = [(f"/x/images/zl{i}_c1_f{i}.jpg", f"/x/labels/zl{i}_c1_f{i}.txt")
             for i in range(200)]
    tr1, ho1 = flywheel._split_pairs(pairs, 0.25)
    assert (tr1, ho1) == jfw._split_pairs(pairs, 0.25)
    tr2, ho2 = flywheel._split_pairs(list(reversed(pairs)), 0.25)
    assert set(tr1) | set(ho1) == set(pairs)
    assert not (set(tr1) & set(ho1))
    assert set(ho1) == set(ho2)
    tr3, ho3 = flywheel._split_pairs(pairs[:100], 0.25)
    assert set(ho3) <= set(ho1) and set(tr3) <= set(tr1)
    assert 0.10 <= len(ho1) / len(pairs) <= 0.40
    assert flywheel.EVAL_FLOOR == jfw.EVAL_FLOOR


def _flywheel(*args):
    proc = subprocess.run(
        [sys.executable, "-m", "zero_latency_yolo_tpu_torch.flywheel",
         *args, "--device", "cpu"], cwd=REPO, env=ENV, capture_output=True,
        text=True, timeout=600)
    rows = _json_lines(proc.stdout.strip().splitlines())
    return proc, rows[-1] if rows else None


def test_flywheel_finetune_gate_and_promote(base_weights, capture_dir,
                                            tmp_path):
    """Same-variant fine-tune, the gate passed, the candidate promoted by
    an atomic byte-faithful copy, no work directory left (the JAX test's
    case, on the port)."""
    out = tmp_path / "cand.npz"
    live = tmp_path / "serving" / "model.npz"
    live.parent.mkdir()
    live.write_bytes(open(base_weights, "rb").read())
    proc, row = _flywheel("--capture-dir", capture_dir, "--base",
                          base_weights, "--out", str(out), "--steps", "2",
                          "--batch", "2", "--size", "64", "--no-distill",
                          "--holdout-frac", "0.3", "--allow-small-eval",
                          "--min-gain", "-1", "--promote", str(live))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert row is not None and row["passed"] and row["promoted"]
    assert row["variant"] == "yolov8p" and row["mode"] == "finetune"
    assert row["train_images"] + row["eval"]["images"] == 24
    for side in ("base", "candidate"):
        assert set(row["eval"][side]) == {"mAP", "mAP50_95", "recall"}
    assert live.read_bytes() == out.read_bytes()
    assert not any(p.name.endswith(".flywheel.tmp")
                   for p in live.parent.iterdir())
    assert not [p for p in out.parent.iterdir()
                if p.name.startswith("flywheel-")]
    assert sorted(pw.flatten(jload_params(str(out)))) == sorted(
        pw.flatten(pw.load_params(base_weights)))


def test_flywheel_cross_variant_distills_and_refuses_hot_promote(
        base_weights, capture_dir, tmp_path):
    out = tmp_path / "student.npz"
    live = tmp_path / "model.npz"
    live.write_bytes(open(base_weights, "rb").read())
    before = live.read_bytes()
    proc, row = _flywheel("--capture-dir", capture_dir, "--base",
                          base_weights, "--out", str(out),
                          "--student-variant", "yolov8-d0.17-w0.125-mc256",
                          "--steps", "2", "--batch", "2", "--size", "64",
                          "--holdout-frac", "0.3", "--allow-small-eval",
                          "--min-gain", "-1", "--promote", str(live))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert row["mode"] == "distill" and row["passed"]
    assert not row["promoted"] and "roll" in row["note"]
    assert live.read_bytes() == before
    assert (pw.infer_spec_from_params(pw.load_params(str(out))).variant
            == "yolov8-d0.17-w0.125-mc256")


def test_flywheel_refuses_an_unreliable_small_eval(base_weights, capture_dir,
                                                   tmp_path):
    with pytest.raises(SystemExit, match="unreliable"):
        flywheel.main(["--capture-dir", capture_dir, "--base", base_weights,
                       "--out", str(tmp_path / "c.npz"), "--steps", "1",
                       "--size", "64", "--device", "cpu"])


def test_flywheel_gate_fails_with_rc_1(base_weights, capture_dir, tmp_path,
                                       monkeypatch):
    """A candidate below --min-gain: rc 1, nothing promoted (the evals
    stubbed: the base scores 0.5, the candidate 0.25)."""
    scores = iter([0.5, 0.25])

    def fake_eval(weights, data, size, conf, device, images=0):
        return {"images": 64, "mAP": next(scores), "mAP50_95": 0.1,
                "recall": 0.5}
    monkeypatch.setattr(flywheel, "_eval_artifact", fake_eval)
    live = tmp_path / "model.npz"
    live.write_bytes(b"live")
    rc, lines = _port(flywheel, "--capture-dir", capture_dir, "--base",
                      base_weights, "--out", str(tmp_path / "c.npz"),
                      "--steps", "1", "--batch", "2", "--size", "64",
                      "--no-distill", "--allow-small-eval", "--promote",
                      str(live), "--device", "cpu")
    row = _json_lines(lines)[-1]
    assert rc == 1 and not row["passed"] and not row["promoted"]
    assert row["gain"] == -0.25 and live.read_bytes() == b"live"


# ---------------------------------------------------------------------------
# assigner_compare, width_accuracy
# ---------------------------------------------------------------------------

def _row_keys(name):
    """The keys of the dict the JAX script prints a line of."""
    tree = ast.parse((SCRIPTS / f"{name}.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", "") == "row"):
            return sorted(k.value for k in node.value.keys)
    raise AssertionError(f"no row dict in {name}")


@pytest.mark.parametrize("tool,name,args", [
    (assigner_compare, "assigner_compare", ("--task", "blob")),
    (width_accuracy, "width_accuracy", ("--widths", "0.125", "--task",
                                        "blob")),
])
def test_comparison_tools_equal_their_scripts_untrained(tool, name, args):
    """--steps 0: the JAX script and the port print the same lines (the
    same untrained init scored on the same held-out seed), then the port
    trains two steps: its lines keep the script's keys."""
    common = ("--steps", "0", "--batch", "2", "--size", "64",
              "--eval-images", "8", *args)
    rc, out, err = _script(name, *common)
    assert rc == 0, err[-2000:]
    want = _json_lines(out.strip().splitlines())
    rc, lines = _port(tool, *common, "--device", "cpu")
    got = _json_lines(lines)
    for line in want + got:
        line.pop("train_s")
    assert rc == 0 and got == want and len(got) >= 1
    trained = ("--steps", "2", "--batch", "2", "--size", "64",
               "--eval-images", "4", *args, "--device", "cpu")
    rc, lines = _port(tool, *trained)
    got = _json_lines(lines)
    assert rc == 0 and len(got) == len(want)
    assert all(sorted(g) == _row_keys(name) for g in got)


# ---------------------------------------------------------------------------
# coco_to_yolo
# ---------------------------------------------------------------------------

def test_coco_to_yolo_equals_the_scripts(tmp_path):
    """A small COCO file (sparse category ids, a crowd box, an image
    without annotations): the port's directory and line equal the JAX
    script's, with and without --keep-crowd."""
    src = tmp_path / "src"
    src.mkdir()
    for name in ("a.jpg", "b.jpg", "c.jpg"):
        (src / name).write_bytes(b"\xff\xd8fake")
    ann = {
        "images": [{"id": 1, "file_name": "a.jpg", "width": 200,
                    "height": 100},
                   {"id": 2, "file_name": "b.jpg", "width": 50,
                    "height": 80},
                   {"id": 3, "file_name": "c.jpg", "width": 64,
                    "height": 64}],
        "categories": [{"id": 7, "name": "cat"}, {"id": 3, "name": "dog"},
                       {"id": 90, "name": "car"}],
        "annotations": [
            {"id": 1, "image_id": 1, "category_id": 7,
             "bbox": [10, 20, 30, 40], "iscrowd": 0},
            {"id": 2, "image_id": 1, "category_id": 90,
             "bbox": [100, 0, 100, 100], "iscrowd": 0},
            {"id": 3, "image_id": 2, "category_id": 3,
             "bbox": [0, 0, 25, 40], "iscrowd": 1},
            {"id": 4, "image_id": 2, "category_id": 3,
             "bbox": [5, 5, 10, 10], "iscrowd": 0}]}
    ann_path = tmp_path / "ann.json"
    ann_path.write_text(json.dumps(ann))

    def tree(root):
        out = {}
        for p in sorted(Path(root).rglob("*")):
            if p.is_file() or p.is_symlink():
                out[str(p.relative_to(root))] = (
                    os.readlink(p) if p.is_symlink() else p.read_text())
        return out

    for extra in ((), ("--keep-crowd",)):
        jdir, pdir = tmp_path / f"jax{len(extra)}", tmp_path / f"port{len(extra)}"
        rc, out, err = _script("coco_to_yolo", "--ann", str(ann_path),
                               "--images", str(src), "--out", str(jdir),
                               *extra)
        assert rc == 0, err[-2000:]
        rc2, lines = _port(coco_to_yolo, "--ann", str(ann_path), "--images",
                           str(src), "--out", str(pdir), *extra, "--device",
                           "cpu")
        assert rc2 == 0
        assert lines[-1].replace(str(pdir), "OUT") == out.strip().replace(
            str(jdir), "OUT")
        assert tree(pdir) == tree(jdir) and tree(pdir)


def test_tools_refuse_a_card_they_do_not_see(monkeypatch):
    """With no CUDA device and no --device cpu every training tool exits
    with an error (the tools' device rule)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool, args in (
            (train_step_bench, ()), (eval_artifact, ("--weights", "x.npz")),
            (train_variant_artifact, ("--variant", "yolov8p", "--out", "x")),
            (flywheel, ("--capture-dir", "x", "--base", "x", "--out", "x")),
            (assigner_compare, ()), (width_accuracy, ()),
            (coco_to_yolo, ("--ann", "x", "--images", "x", "--out", "x"))):
        with pytest.raises(SystemExit, match="no CUDA device"):
            tool.main(list(args))
