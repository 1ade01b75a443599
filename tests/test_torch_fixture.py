"""The port's f32 serving step against the JAX package's, through the
committed fixtures tests/torch_fixtures/jax_f32_step_416.npz (yolov8n at 416)
and jax_f32_step_s640.npz (yolov8s at 640 and at its 512 rung): the port's
plain f32 step (CPU) is held to them at the 1e-3 gate of
tests/test_model_parity.py:54-63, with the comparison chip_smoke.py uses on
the card (`fixture_gate`), and the 416 fixture is held to the JAX step it
records. The int8 fixture jax_int8_f32_step_416.npz (yolov8n at 416 with
tpu.quantize_int8) holds the port's plain int8 step to the JAX int8 step
run op by op, and, with the jitted JAX run's calibration carried across,
to the jitted step within the JAX package's own spread between the two
(`int8_fixture_gate`, the card's gate). The train fixture
jax_train_f32_n416.npz holds the port's f32 train steps at 416 (yolov8n,
batch 2, 3 steps) to the JAX package's by losses and per-leaf norms and
probes (`train_fixture_gate`), and the port's f32 evaluate of the deployed
weights to the JAX package's (`eval_fixture_gate`): the card's gates."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_fixtures.cpu_threads  # noqa: E402,F401  (caps torch's CPU threads)
import chip_smoke  # noqa: E402
from zero_latency_yolo_tpu_torch.config import ServerConfig  # noqa: E402
from zero_latency_yolo_tpu_torch.runtime import engine as pt_engine  # noqa: E402

_SCRIPT = Path(__file__).resolve().parent / "torch_fixtures" / "make_jax_fixture.py"
_spec = importlib.util.spec_from_file_location("make_jax_fixture", _SCRIPT)
make_jax_fixture = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_jax_fixture)


def _fixture():
    return np.load(chip_smoke.FIXTURE)


def _port_config():
    cfg = ServerConfig.load(str(chip_smoke.CONFIG), create_if_missing=False)
    cfg.model_path = str(chip_smoke.ROOT / cfg.model_path)
    return cfg


def test_fixture_records_what_made_it():
    fx = _fixture()
    cfg = _port_config()
    assert int(fx["task_seed"]) == make_jax_fixture.TASK_SEED
    assert tuple(fx["game_seeds"]) == make_jax_fixture.GAME_SEEDS
    assert tuple(fx["task_bucket"]) == make_jax_fixture.TASK_BUCKET
    assert float(fx["confidence_threshold"]) == cfg.confidence_threshold
    assert float(fx["nms_threshold"]) == cfg.nms_threshold
    frames = chip_smoke.fixture_frames(fx)
    for name, want in make_jax_fixture.frame_sets().items():
        assert all(np.array_equal(a, b) for a, b in zip(frames[name], want))
    fcfg = chip_smoke.fixture_config(cfg, fx)
    assert fcfg.tpu.dtype == "float32" and cfg.tpu.dtype == "bfloat16"
    assert [tuple(b) for b in fcfg.tpu.frame_buckets] == [
        tuple(b) for b in make_jax_fixture.config_dict()["tpu"]["frame_buckets"]]


@pytest.mark.parametrize("name", ["task", "game"])
def test_plain_f32_step_matches_jax_fixture(name):
    """The deployed yolov8n at 416 px in f32 through dispatch (plain kernel
    versions on the CPU): counts and classes equal, boxes and scores within
    1e-3 of the JAX step, frame by frame."""
    fx = _fixture()
    cfg = _port_config()
    eng = pt_engine.InferenceEngine(chip_smoke.fixture_config(cfg, fx),
                                    device="cpu")
    assert not eng.simulation
    frames = chip_smoke.fixture_frames(fx)[name]
    out = eng.dispatch(chip_smoke.frame_requests(
        pt_engine.InferenceRequest, frames)).out.numpy()
    gate = chip_smoke.fixture_gate(out, fx[name], cfg.confidence_threshold,
                                   cfg.nms_threshold)
    assert sum(gate["counts_jax"]) > 0, "vacuous: no detections"
    assert all(gate["strict"]), gate["notes"]


def test_fixture_is_the_jax_f32_step():
    """The JAX engine, run again, gives the committed packed outputs within
    the same gate (not bit for bit: XLA's CPU code may differ between
    machines)."""
    fx = _fixture()
    for name, packed in make_jax_fixture.jax_packed().items():
        gate = chip_smoke.fixture_gate(packed, fx[name], 0.5, 0.45)
        assert all(gate["strict"]), (name, gate["notes"])


def test_fixture_gate_excuses_only_decisions_on_a_threshold():
    """A detection that one run lacks passes only when its score or its
    overlap sits within 1e-3 of a threshold; the gate prints it either way."""
    want = _fixture()["game"].copy()
    n = int(want[0, 0])
    assert n >= 2
    got = want.copy()
    got[0, 0] = n - 1  # the port lost frame 0's last detection
    margin = chip_smoke.fixture_gate(got, want, float(want[0, 1 + 4 * 32 + n - 1])
                                     - 5e-4, 0.45)
    assert margin["ok"][0] and not margin["strict"][0]
    assert "excused, on a threshold" in margin["notes"][0]
    far = chip_smoke.fixture_gate(got, want, 0.1, 0.45)
    assert not far["ok"][0] and "not excused" in far["notes"][0]
    assert all(far["ok"][1:]) and all(far["strict"][1:])


def _fixture_s640():
    return np.load(chip_smoke.FIXTURE_S640)


def test_s640_fixture_records_what_made_it():
    fx = _fixture_s640()
    cfg = ServerConfig.load(str(chip_smoke.CONFIG_S640),
                            create_if_missing=False)
    assert int(fx["task_seed"]) == make_jax_fixture.TASK_SEED_S640
    assert tuple(fx["game_seeds"]) == make_jax_fixture.GAME_SEEDS_S640
    assert tuple(fx["rungs"]) == make_jax_fixture.RUNGS_S640 == tuple(
        cfg.tpu.serve_sizes)
    assert tuple(fx["task_bucket"]) == make_jax_fixture.TASK_BUCKET_S640
    assert float(fx["confidence_threshold"]) == cfg.confidence_threshold
    assert float(fx["nms_threshold"]) == cfg.nms_threshold
    frames = chip_smoke.fixture_frames_s640(fx)
    for name, want in make_jax_fixture.frame_sets_s640().items():
        assert all(np.array_equal(a, b) for a, b in zip(frames[name], want))
        for rung in make_jax_fixture.RUNGS_S640:
            assert fx[f"{name}_{rung}"].shape == (len(want), 1 + 6 * 32)


@pytest.mark.parametrize("rung", [640, 512])
def test_plain_f32_step_matches_jax_s640_fixture(rung):
    """yolov8s of server-16stream-640-s.json in f32 at each rung of its
    ladder, through dispatch(size=rung) (plain kernel versions on the CPU):
    both frame sets within the 1e-3 gate of the JAX step, frame by frame."""
    fx = _fixture_s640()
    cfg = ServerConfig.load(str(chip_smoke.CONFIG_S640),
                            create_if_missing=False)
    cfg.model_path = str(chip_smoke.ROOT / cfg.model_path)
    eng = pt_engine.InferenceEngine(chip_smoke.fixture_config(cfg, fx),
                                    device="cpu")
    assert not eng.simulation and eng.serve_sizes == (640, 512)
    total = 0
    for name, frames in chip_smoke.fixture_frames_s640(fx).items():
        pending = eng.dispatch(chip_smoke.frame_requests(
            pt_engine.InferenceRequest, frames), size=rung)
        assert pending.serve_size == rung
        gate = chip_smoke.fixture_gate(
            pending.out.numpy(), fx[f"{name}_{rung}"],
            cfg.confidence_threshold, cfg.nms_threshold)
        total += sum(gate["counts_jax"])
        assert all(gate["strict"]), (name, gate["notes"])
    assert total > 0, "vacuous: no detections"


def _fixture_int8():
    return np.load(chip_smoke.FIXTURE_INT8)


def _int8_engine(fx):
    cfg = chip_smoke.fixture_config(_port_config(), fx)
    cfg.tpu.quantize_int8 = True
    return pt_engine.InferenceEngine(cfg, device="cpu")


def test_int8_fixture_records_what_made_it():
    from zero_latency_yolo_tpu_torch.ops import quant
    fx = _fixture_int8()
    cfg = _port_config()
    assert int(fx["task_seed"]) == make_jax_fixture.TASK_SEED
    assert tuple(fx["game_seeds"]) == make_jax_fixture.GAME_SEEDS
    assert tuple(fx["task_bucket"]) == make_jax_fixture.TASK_BUCKET
    assert float(fx["confidence_threshold"]) == cfg.confidence_threshold
    assert float(fx["nms_threshold"]) == cfg.nms_threshold
    assert make_jax_fixture.int8_config_dict()["tpu"]["quantize_int8"]
    for key in ("task", "game", "task_eager", "game_eager"):
        assert fx[key].shape == (8, 1 + 6 * 32), key
    paths = [str(p) for p in fx["x_scale_paths"]]
    eng = _int8_engine(fx)
    assert sorted(paths) == paths == sorted(quant.x_scales(eng._params))
    assert fx["x_scale"].dtype == fx["x_scale_eager"].dtype == np.float32
    assert len(paths) == 44


def test_plain_int8_step_equals_the_jax_int8_step_run_op_by_op():
    """The deployed yolov8n at 416 with tpu.quantize_int8, f32, plain
    kernel versions on the CPU: the engine's own calibration equals the
    JAX engine's run op by op bit for bit, and its step equals that JAX
    step within the 1e-3 gate (counts and classes equal) on both frame
    sets."""
    from zero_latency_yolo_tpu_torch.ops import quant
    fx = _fixture_int8()
    cfg = _port_config()
    eng = _int8_engine(fx)
    own = quant.x_scales(eng._params)
    assert [own[str(p)] for p in fx["x_scale_paths"]] == \
        fx["x_scale_eager"].tolist()
    for name, frames in chip_smoke.fixture_frames(fx).items():
        out = eng.dispatch(chip_smoke.frame_requests(
            pt_engine.InferenceRequest, frames)).out.numpy()
        gate = chip_smoke.fixture_gate(out, fx[f"{name}_eager"],
                                       cfg.confidence_threshold,
                                       cfg.nms_threshold)
        assert sum(gate["counts_jax"]) > 0, "vacuous: no detections"
        assert all(gate["strict"]), (name, gate["notes"])


def test_plain_int8_step_with_the_jax_scales_within_the_jax_spread():
    """The JAX engine's (jitted) calibration carried across: the port's
    int8 step against the jitted JAX int8 step at detection level, at most
    twice the detections without a twin that the JAX package's own step
    run op by op has against it (chip_smoke.int8_fixture_gate, the card's
    gate); on the CPU not more than that at all."""
    from zero_latency_yolo_tpu_torch.ops import quant
    fx = _fixture_int8()
    cfg = _port_config()
    eng = _int8_engine(fx)
    quant.set_x_scales(eng._params, dict(zip(
        (str(p) for p in fx["x_scale_paths"]), fx["x_scale"].tolist())))
    for name, frames in chip_smoke.fixture_frames(fx).items():
        out = eng.dispatch(chip_smoke.frame_requests(
            pt_engine.InferenceRequest, frames)).out.numpy()
        gate = chip_smoke.int8_fixture_gate(out, fx, name,
                                            cfg.confidence_threshold,
                                            cfg.nms_threshold)
        print(f"{name}: twinless detections {gate['odd']} (JAX op by op: "
              f"{gate['odd_jax_eager']}); 1e-3 gate {gate['strict']}")
        assert gate["ok"], (name, gate)
        assert sum(gate["odd"]) <= sum(gate["odd_jax_eager"]), (name, gate)


def _fixture_train():
    return np.load(chip_smoke.FIXTURE_TRAIN)


def test_train_fixture_records_what_made_it():
    """The train fixture's recipe is make_jax_fixture.TRAIN, its leaves are
    the port's training form's, in tree_leaves order, and it holds one norm
    and one probe a leaf for each tree, one loss a step."""
    from zero_latency_yolo_tpu_torch.models.weights import tree_leaves
    from zero_latency_yolo_tpu_torch.models.yolov8 import get_spec, init_params
    fx = _fixture_train()
    t = json.loads(str(fx["config"]))
    assert t == make_jax_fixture.TRAIN
    tree = init_params(t["init_seed"], get_spec(t["variant"], t["classes"]),
                       folded=False)
    names = make_jax_fixture.leaf_paths(tree)
    assert [str(n) for n in fx["leaf_names"]] == names
    assert len(tree_leaves(tree)) == len(names)
    for k in ("loss", "box", "cls", "dfl"):
        assert fx[k].shape == (t["steps"],) and np.isfinite(fx[k]).all()
    for name in ("grad1", "params3", "ema3"):
        assert fx[f"{name}_norm"].shape == fx[f"{name}_dot"].shape == \
            (len(names),)
    keys = [str(k) for k in fx["eval_keys"]]
    assert "mAP" in keys and "mAP50_95" in keys
    assert dict(zip(keys, fx["eval_values"]))["mAP"] > 0.5


def test_port_train_steps_match_the_jax_train_fixture():
    """The port's f32 steps on the CPU at the fixture's size (yolov8n at
    416, batch 2, 3 steps) against the JAX package's, with the card's gate
    (chip_smoke.train_fixture_gate): losses, every leaf's norm and probe
    within TRAIN_TOL of their scales; on the CPU within a tenth of that
    (TRAIN_TOL was set from this comparison)."""
    fx = _fixture_train()
    run = chip_smoke.train_fixture_run(torch, "cpu", fx)
    gate = chip_smoke.train_fixture_gate(run, fx)
    print(gate["worst"])
    assert gate["ok"], gate["worst"]
    for k, v in gate["worst"].items():
        assert v <= chip_smoke.TRAIN_TOL / 10, (k, v)


def test_port_evaluate_matches_the_jax_eval_fixture():
    """The port's f32 evaluate of the deployed weights (folded, served by
    the plain kernel versions on the CPU) over the fixture's 32 images at
    416 equals the JAX package's within chip_smoke.EVAL_TOL."""
    from zero_latency_yolo_tpu_torch.models.weights import load_params
    from zero_latency_yolo_tpu_torch.models.yolov8 import get_spec
    from zero_latency_yolo_tpu_torch.train.eval import evaluate
    fx = _fixture_train()
    t = json.loads(str(fx["config"]))
    images, targets = chip_smoke.eval_images(fx)
    got = evaluate(load_params(str(chip_smoke.ROOT / t["eval_weights"])),
                   get_spec(t["variant"], t["classes"]), images, targets,
                   batch=t["eval_batch"], device="cpu")
    gate = chip_smoke.eval_fixture_gate(got, fx)
    assert gate["ok"], (got, gate)
