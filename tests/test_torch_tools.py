"""The PyTorch port's operator tools held against the JAX package's scripts
on the CPU, on the same inputs (made with numpy from a seed): the media
sources (`runtime/media.py`), the host CPU accounting of `utils/stats.py`,
the offline detect CLI (`python -m zero_latency_yolo_tpu_torch.detect
--device cpu` against `scripts/detect.py`), the tracker benchmark and the
ONNX export (`models/ultra.py`, `export_onnx`), and every tool's refusal to
run on a card it does not see. The loopback tools (stream client, load
test, soak) are in tests/test_torch_tools_live.py.

Tolerances: detect's confidences within DET_CONF_TOL and boxes within
DET_BOX_TOL after the JSON rounding (4 and 6 decimals), counts and classes
equal; a detection within THRESH_TOL of --conf, or a pair of the same class
within THRESH_TOL of the IoU threshold, decides on a threshold and is named
and excused. The tracker's scores are equal (times excluded). The export's
initializers are bit-identical; the twin's decoded output is within
TWIN_TOL of the port's plain forward."""

import importlib.util
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

from torch_fixtures import cpu_threads  # caps torch's threads on import

cv2 = pytest.importorskip("cv2")
torch = pytest.importorskip("torch")

from zero_latency_yolo_tpu_torch.models.weights import (  # noqa: E402
    flatten, from_onnx, load_params, params_from_jax, read_onnx_initializers,
    save_params, unflatten)
from zero_latency_yolo_tpu_torch.models.yolov8 import (  # noqa: E402
    fold_batchnorm, forward_decoded, get_spec, init_params)
from chip_smoke import detect_lines_gate  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET_CONF_TOL = 2e-4
DET_BOX_TOL = 1e-5
THRESH_TOL = 1e-4
TWIN_TOL = 1e-4
CONF, NMS = 0.01, 0.45


def _script_module(name):
    """A JAX package script (scripts/<name>.py) as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _spread_tree(seed):
    """A yolov8p tree (NumPy, folded) whose class scores spread over (0, 1)
    rather than sitting at 0.5, so detections differ in confidence."""
    tree = init_params(seed, get_spec("yolov8p", 4), folded=True)
    for lvl in tree["m22"]["cv3"]:
        lvl[2]["w"] = lvl[2]["w"] * 8.0
        lvl[2]["b"] = np.linspace(-2, 2, 4).astype(np.float32)
    return tree


def _noise(tree, seed):
    """Every leaf perturbed, so no two tensors are value-identical (the ONNX
    exporter deduplicates equal initializers)."""
    rng = np.random.default_rng(seed)
    return unflatten({k: np.asarray(v, np.float32)
                      + rng.normal(0, 0.05, np.shape(v)).astype(np.float32)
                      for k, v in flatten(tree).items()})


# ---------------------------------------------------------------------------
# media
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """3 PNGs and a 6-frame MJPG clip (48x64), written by cv2."""
    root = tmp_path_factory.mktemp("media")
    imgs = root / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        arr = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
        cv2.imwrite(str(imgs / f"im{i}.png"), arr)
    video = root / "clip.avi"
    vw = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"MJPG"),
                         10, (64, 48))
    assert vw.isOpened(), "cv2 VideoWriter MJPG unavailable"
    for i in range(6):
        vw.write(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    vw.release()
    return root


@pytest.mark.parametrize("stride,resize", [(1, None), (2, None), (1, (40, 30))])
def test_iter_frames_matches_jax(media, stride, resize):
    """The same names and bit-equal frames over a PNG directory, a clip and
    a directly named image, with a video stride and a resize."""
    from zero_latency_yolo_tpu.runtime.media import iter_frames as jax_iter
    from zero_latency_yolo_tpu_torch.runtime.media import iter_frames
    paths = [str(media / "imgs"), str(media / "clip.avi"),
             str(media / "imgs" / "im1.png")]
    got = list(iter_frames(paths, stride, resize=resize))
    want = list(jax_iter(paths, stride, resize=resize))
    assert [n for n, _ in got] == [n for n, _ in want]
    assert len(got) == 3 + len(range(0, 6, stride)) + 1
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == np.uint8 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_iter_frames_errors_match_jax(tmp_path):
    """An undecodable file inside a directory is skipped; a directly named
    undecodable image or unopenable video raises the same ValueError."""
    from zero_latency_yolo_tpu.runtime.media import iter_frames as jax_iter
    from zero_latency_yolo_tpu_torch.runtime.media import iter_frames
    d = tmp_path / "d"
    d.mkdir()
    (d / "bad.png").write_bytes(b"not an image")
    cv2.imwrite(str(d / "ok.png"), np.zeros((8, 8, 3), np.uint8))
    assert ([n for n, _ in iter_frames([str(d)])]
            == [n for n, _ in jax_iter([str(d)])] == [str(d / "ok.png")])
    for bad, match in ((d / "bad.png", "cannot decode"),
                       (tmp_path / "nope.mp4", "cannot open video")):
        if not bad.exists():
            bad.write_bytes(b"not a video")
        msgs = []
        for fn in (iter_frames, jax_iter):
            with pytest.raises(ValueError, match=match) as e:
                list(fn([str(bad)]))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------

PROC_STATS = [
    "cpu  4705 356 584 3699 23 23 0 0 0 0\n",
    "cpu  5705 356 684 4699 23 23 0 90 0 0\n",
    "cpu  5705 356 684 4699 23 23 0\n",          # no steal column
    "intr 1 2 3\n",                               # no cpu line
    "cpu  a b c\n",                               # malformed
]


def test_cpu_times_and_steal_pct_match_jax(monkeypatch):
    """cpu_times and steal_pct of the port and of the JAX package on the
    same /proc/stat text, including the None cases."""
    from zero_latency_yolo_tpu.utils import stats as jax_stats
    from zero_latency_yolo_tpu_torch.utils import stats

    def reader(text):
        return lambda *a, **k: io.StringIO(text)

    snaps = []
    for text in PROC_STATS:
        got = []
        for mod in (stats, jax_stats):
            monkeypatch.setattr(mod, "open", reader(text), raising=False)
            got.append(mod.cpu_times())
        assert got[0] == got[1]
        snaps.append(got[0])
    for mod in (stats, jax_stats):
        def missing(*a, **k):
            raise OSError("no /proc/stat")
        monkeypatch.setattr(mod, "open", missing, raising=False)
        assert mod.cpu_times() is None
    assert snaps[0] is not None and snaps[3] is None and snaps[4] is None
    pairs = [(a, b) for a in snaps for b in snaps] + [(snaps[0], snaps[0])]
    for a, b in pairs:
        assert stats.steal_pct(a, b) == jax_stats.steal_pct(a, b)
    assert stats.steal_pct(snaps[0], snaps[1]) == round(100 * 90 / 2190, 1)


def test_stopwatch_matches_jax(monkeypatch):
    """Stopwatch gives the JAX one's elapsed time on the same clock and
    records it into the RollingStats it is given."""
    import time
    from zero_latency_yolo_tpu.utils import stats as jax_stats
    from zero_latency_yolo_tpu_torch.utils import stats
    ticks = iter([10.0, 10.0125, 20.0, 20.0125, 30.0, 30.5])
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    got = []
    for mod in (stats, jax_stats):
        rs = mod.RollingStats()
        with mod.Stopwatch(rs) as sw:
            pass
        got.append((sw.elapsed_ms, rs.snapshot()["count"],
                    rs.snapshot()["max_ms"]))
    assert got[0] == got[1]
    with stats.Stopwatch() as sw:   # no stats: only elapsed_ms
        pass
    assert sw.elapsed_ms == pytest.approx(500.0)


# ---------------------------------------------------------------------------
# detect
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """One yolov8p npz, saved once and read by both CLIs."""
    p = tmp_path_factory.mktemp("w") / "pico.npz"
    save_params(_spread_tree(3), str(p))
    return str(p)


DETECT_ARGS = ["--size", "64", "--conf", str(CONF), "--nms", str(NMS),
               "--batch", "2", "--video-stride", "3"]


def _detect(cmd, labels):
    r = subprocess.run(cmd + ["--labels-dir", str(labels)],
                       capture_output=True, text=True, cwd=REPO, timeout=600,
                       env={**os.environ, "PYTHONPATH": REPO,
                            "JAX_PLATFORMS": "cpu",
                            "OMP_NUM_THREADS": str(cpu_threads.THREADS)})
    assert r.returncode == 0, r.stderr[-2000:]
    rows = [json.loads(line) for line in r.stdout.splitlines() if line]
    files = {n: (labels / n).read_text() for n in sorted(os.listdir(labels))}
    return rows, files


@pytest.fixture(scope="module")
def detect_runs(weights, media, tmp_path_factory):
    """(JAX rows and label files, port rows and label files) of one run each
    over the images and the clip."""
    inputs = [str(media / "imgs"), str(media / "clip.avi")]
    out = tmp_path_factory.mktemp("detect")
    jax_run = _detect([sys.executable, os.path.join(REPO, "scripts",
                                                    "detect.py"),
                       "--weights", weights, *inputs, *DETECT_ARGS],
                      out / "jax")
    port_run = _detect([sys.executable, "-m",
                        "zero_latency_yolo_tpu_torch.detect", "--device",
                        "cpu", "--weights", weights, *inputs, *DETECT_ARGS],
                       out / "port")
    return jax_run, port_run


def _gate(want, got):
    """chip_smoke.detect_lines_gate at this file's tolerances; the
    detections it excuses on a threshold are printed by name."""
    g = detect_lines_gate(want, got, CONF, NMS, DET_CONF_TOL, DET_BOX_TOL,
                          THRESH_TOL)
    for note in g["excused"]:
        print("excused on a threshold:", note)
    assert g["ok"], g["failed"][:5]
    return g


def _label_lines(files):
    """Label files as detect's JSON lines (a label carries no confidence:
    1.0 on both sides), so that the same gate twins them."""
    return [{"source": n, "width": 0, "height": 0, "detections": [
        {"class": int(p[0]), "confidence": 1.0,
         **dict(zip(("cx", "cy", "w", "h"), map(float, p[1:])))}
        for p in (line.split() for line in files[n].splitlines())]}
        for n in sorted(files)]


def test_detect_sources_and_counts_match_jax(detect_runs):
    (jax_rows, _), (port_rows, _) = detect_runs
    assert [r["source"] for r in port_rows] == [r["source"] for r in jax_rows]
    assert [r["source"].rsplit("#", 1)[-1] for r in port_rows[3:]] == [
        "frame0", "frame3"]
    assert [(r["width"], r["height"]) for r in port_rows] == [
        (r["width"], r["height"]) for r in jax_rows]
    g = _gate(jax_rows, port_rows)
    assert g["detections"] > 0
    if not g["excused"]:
        assert [[d["class"] for d in r["detections"]] for r in port_rows] == [
            [d["class"] for d in r["detections"]] for r in jax_rows]


def test_detect_labels_match_jax(detect_runs):
    """The same --labels-dir file names, and contents within the detect
    tolerances."""
    (_, jax_files), (_, port_files) = detect_runs
    assert sorted(port_files) == sorted(jax_files) and len(jax_files) == 5
    assert any(jax_files.values())
    _gate(_label_lines(jax_files), _label_lines(port_files))


def test_detect_annotated_video_and_stills(weights, media, tmp_path):
    """--save-dir writes one annotated .avi for a video source (the frames
    processed) and one .jpg a still, as the JAX script does."""
    from zero_latency_yolo_tpu_torch import detect
    save = tmp_path / "ann"
    with redirect_stdout(io.StringIO()) as out:
        rc = detect.main(["--device", "cpu", "--weights", weights,
                          str(media / "clip.avi"), str(media / "imgs"),
                          "--size", "64", "--conf", "0.01",
                          "--video-stride", "2", "--save-dir", str(save),
                          "--names", "a,b,c,d"])
    assert rc == 0 and len(out.getvalue().splitlines()) == 3 + 3
    outs = sorted(os.listdir(save))
    assert len(outs) == 4 and sum(o.endswith("_annotated.avi")
                                  for o in outs) == 1
    cap = cv2.VideoCapture(str(save / next(o for o in outs
                                           if o.endswith(".avi"))))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 3  # frames 0, 2, 4 of the 6-frame clip


def test_detect_hash_in_a_file_name_is_a_still(weights, tmp_path):
    """A '#' in a still's file name keeps the still's label stem (the
    '#frameN' rule applies to video frames only)."""
    from zero_latency_yolo_tpu_torch import detect
    img = tmp_path / "photo#1.png"
    cv2.imwrite(str(img), np.full((48, 64, 3), 90, np.uint8))
    labels = tmp_path / "lb"
    with redirect_stdout(io.StringIO()):
        assert detect.main(["--device", "cpu", "--weights", weights,
                            str(img), "--size", "64", "--labels-dir",
                            str(labels)]) == 0
    names = os.listdir(labels)
    assert len(names) == 1 and names[0].endswith("photo#1.txt")


@pytest.mark.parametrize("args,match", [
    (["--size", "65"], "multiple of 32"),
    (["--batch", "0"], ">= 1"),
    (["--video-stride", "0"], ">= 1"),
])
def test_detect_rejects_bad_args(weights, media, args, match):
    from zero_latency_yolo_tpu_torch import detect
    with pytest.raises(SystemExit, match=match):
        detect.main(["--device", "cpu", "--weights", weights,
                     str(media / "imgs"), *args])


def test_detect_bad_inputs_exit_with_the_error(weights, tmp_path):
    from zero_latency_yolo_tpu_torch import detect
    bad = tmp_path / "nope.mp4"
    bad.write_bytes(b"not a video")
    with pytest.raises(SystemExit, match="cannot open video"):
        detect.main(["--device", "cpu", "--weights", weights, str(bad)])
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit, match="no decodable inputs"):
        detect.main(["--device", "cpu", "--weights", weights, str(empty)])
    with pytest.raises(SystemExit, match="unknown weight format"):
        detect.main(["--device", "cpu", "--weights", str(tmp_path / "w.bin"),
                     str(empty)])


# ---------------------------------------------------------------------------
# track_bench
# ---------------------------------------------------------------------------

SCORES = ("targets", "mota", "id_switches", "fragments", "misses",
          "false_positives", "gt_boxes", "mostly_tracked")


@pytest.fixture(scope="module")
def jax_track_bench():
    return _script_module("track_bench")


@pytest.mark.parametrize("scenario", ["clean", "noisy", "lossy_wire",
                                      "heavy_miss", "crossing_32"])
def test_track_bench_scores_match_jax(jax_track_bench, scenario):
    """Each scenario's scores equal the JAX script's for the same seed
    (--frames 300 --targets 4 --seeds 1); update_ms_* are times."""
    from zero_latency_yolo_tpu_torch import track_bench
    assert track_bench.SCENARIOS == jax_track_bench.SCENARIOS
    got = track_bench.simulate(300, 4, seed=100,
                               **track_bench.SCENARIOS[scenario])
    want = jax_track_bench.simulate(300, 4, seed=100,
                                    **jax_track_bench.SCENARIOS[scenario])
    assert set(got) == set(want)
    assert {k: got[k] for k in SCORES} == {k: want[k] for k in SCORES}


def test_track_bench_cli_line_matches_jax(jax_track_bench, capsys,
                                          monkeypatch):
    """The JSON line of the port's CLI against the JAX script's: the same
    keys, and the same scores over two seeds."""
    from zero_latency_yolo_tpu_torch import track_bench
    args = ["--frames", "120", "--targets", "4", "--seeds", "2",
            "--scenario", "noisy"]
    assert track_bench.main(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.splitlines()[-1])
    monkeypatch.setattr(sys, "argv", ["track_bench.py"] + args)
    assert jax_track_bench.main() == 0
    want = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert set(got) == set(want)
    assert {k: got[k] for k in ("frames", "targets", "seeds", "assoc")} == {
        k: want[k] for k in ("frames", "targets", "seeds", "assoc")}
    g, w = got["scenarios"]["noisy"], want["scenarios"]["noisy"]
    assert g["mota_runs"] == w["mota_runs"]
    assert {k: g[k] for k in SCORES} == {k: w[k] for k in SCORES}


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def test_export_cli_matches_jax_export(tmp_path):
    """The port's CLI and the JAX script export the same npz: the port's
    file reads back (from_onnx) bit-identical to the npz, and its
    initializers equal the JAX export's bit for bit."""
    src = str(tmp_path / "src.npz")
    save_params(_noise(fold_batchnorm(init_params(
        5, get_spec("yolov8p", 4), folded=False)), 105), src)
    outs, lines = {}, {}
    for name, cmd in (
            ("port", [sys.executable, "-m",
                      "zero_latency_yolo_tpu_torch.export_onnx",
                      "--device", "cpu"]),
            ("jax", [sys.executable,
                     os.path.join(REPO, "scripts", "export_onnx.py")])):
        outs[name] = str(tmp_path / f"{name}.onnx")
        r = subprocess.run(cmd + ["--weights", src, "--variant", "yolov8p",
                                  "--size", "64", "--out", outs[name]],
                           capture_output=True, text=True, cwd=REPO,
                           timeout=300, env={
                               **os.environ, "PYTHONPATH": REPO,
                               "JAX_PLATFORMS": "cpu",
                               "OMP_NUM_THREADS": str(cpu_threads.THREADS)})
        assert r.returncode == 0, r.stderr[-2000:]
        lines[name] = json.loads(r.stdout.strip().splitlines()[-1])
    assert lines["port"]["roundtrip_max_diff"] == 0.0
    assert set(lines["port"]) == set(lines["jax"])
    assert lines["port"]["bytes"] == lines["jax"]["bytes"]
    want = flatten(load_params(src))
    back = flatten(from_onnx(outs["port"]))
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    a, b = read_onnx_initializers(outs["port"]), read_onnx_initializers(
        outs["jax"])
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


def test_twin_matches_the_port_forward():
    """The twin built from a params tree decodes within TWIN_TOL of the
    port's plain forward_decoded on the same tree."""
    from zero_latency_yolo_tpu_torch.models.ultra import (
        UltralyticsTwin, decoded_reference, load_params_into_twin)
    spec = get_spec("yolov8p", 4)
    tree = _noise(fold_batchnorm(init_params(2, spec, folded=False)), 102)
    twin = load_params_into_twin(UltralyticsTwin(spec), tree)
    x = np.random.default_rng(4).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    want = decoded_reference(twin, x)
    with torch.no_grad():
        got = forward_decoded(params_from_jax(tree), spec,
                              torch.from_numpy(x), plain=True).numpy()
    assert got.shape == want.shape == (2, 84, 8)
    np.testing.assert_allclose(got, want, atol=TWIN_TOL, rtol=TWIN_TOL)


def test_unfolded_tree_folds_on_export(tmp_path):
    """A BN-carrying tree is folded before export: the file reads back as
    the folded tree (within 1e-6, the JAX test's tolerance) and equal to
    the JAX package's export of the same tree within it."""
    from zero_latency_yolo_tpu.models import get_spec as jax_spec
    from zero_latency_yolo_tpu.models.ultra import (
        export_deployment_onnx as jax_export)
    from zero_latency_yolo_tpu_torch.models.ultra import export_deployment_onnx
    spec = get_spec("yolov8p", 4)
    tree = _noise(init_params(1, spec, folded=False), 9)
    paths = [str(tmp_path / "port.onnx"), str(tmp_path / "jax.onnx")]
    export_deployment_onnx(tree, spec, paths[0], 64)
    jax_export(tree, jax_spec("yolov8p", 4), paths[1], 64)
    want = flatten(fold_batchnorm(tree))
    backs = [flatten(from_onnx(p)) for p in paths]
    for back in backs:
        assert set(back) == set(want)
        for k in want:
            np.testing.assert_allclose(back[k], want[k], atol=1e-6,
                                       err_msg=k)
    for k in want:
        np.testing.assert_allclose(backs[0][k], backs[1][k], atol=1e-6,
                                   err_msg=k)


def test_wrong_spec_raises_with_shapes():
    """A tree that does not fit the twin raises with the shapes, as the
    JAX package's twin does, with the same message."""
    from zero_latency_yolo_tpu.models.ultra import (
        UltralyticsTwin as JaxTwin, load_params_into_twin as jax_load)
    from zero_latency_yolo_tpu.models import get_spec as jax_spec
    from zero_latency_yolo_tpu_torch.models.ultra import (
        UltralyticsTwin, load_params_into_twin)
    tree = _noise(fold_batchnorm(init_params(0, get_spec("yolov8p", 4),
                                             folded=False)), 100)
    msgs = []
    for twin, load in ((UltralyticsTwin(get_spec("yolov8p", 7)),
                        load_params_into_twin),
                       (JaxTwin(jax_spec("yolov8p", 7)), jax_load)):
        with pytest.raises(ValueError, match="shape|source param") as e:
            load(twin, tree)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_degenerate_weights_refused(tmp_path):
    """Fresh folded params carry identical all-zero biases, which the
    exporter would deduplicate: the export refuses and leaves no file."""
    from zero_latency_yolo_tpu_torch.models.ultra import export_deployment_onnx
    spec = get_spec("yolov8p", 4)
    path = str(tmp_path / "degenerate.onnx")
    with pytest.raises(ValueError, match="dedup"):
        export_deployment_onnx(init_params(6, spec, folded=True), spec,
                               path, 64)
    assert not os.path.exists(path)


def test_export_cli_refuses_contradicting_classes(tmp_path):
    from zero_latency_yolo_tpu_torch import export_onnx
    src = str(tmp_path / "src.npz")
    save_params(_spread_tree(0), src)
    with pytest.raises(SystemExit, match="contradicts"):
        export_onnx.main(["--device", "cpu", "--weights", src, "--classes",
                          "7", "--out", str(tmp_path / "x.onnx")])


# ---------------------------------------------------------------------------
# --device
# ---------------------------------------------------------------------------

TOOLS = {
    "detect": ["--weights", "w.npz", "img.png"],
    "stream_client": ["clip.avi"],
    "loadtest": [],
    "soak": [],
    "track_bench": [],
    "export_onnx": ["--weights", "w.npz", "--out", "x.onnx"],
}


@pytest.mark.parametrize("tool", sorted(TOOLS))
@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_tool_refuses_a_card_it_does_not_see(tool, device, monkeypatch):
    """Without a CUDA device, every tool exits with an error unless given
    --device cpu (its default is the card): no CPU run."""
    import importlib
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"zero_latency_yolo_tpu_torch.{tool}")
    argv = TOOLS[tool] + ([] if device is None else ["--device", device])
    with pytest.raises(SystemExit, match="no CUDA device") as e:
        mod.main(argv)
    assert f"{tool}:" in str(e.value)


@pytest.mark.parametrize("tool", ["detect", "loadtest"])
def test_tool_refusal_exits_nonzero_as_a_process(tool):
    """Run as `python -m` on a machine without a card (or with the card
    hidden), the tool exits non-zero with the error on stderr."""
    r = subprocess.run([sys.executable, "-m",
                        f"zero_latency_yolo_tpu_torch.{tool}", *TOOLS[tool]],
                       capture_output=True, text=True, cwd=REPO, timeout=120,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert r.stdout == ""
