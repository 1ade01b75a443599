#!/usr/bin/env python3
"""Write the JAX engine's f32 serving steps as fixtures for the PyTorch port,
beside this file: `jax_f32_step_416.npz` (yolov8n at 416),
`jax_f32_step_s640.npz` (yolov8s at 640 and at its 512 rung) and
`jax_int8_f32_step_416.npz` (yolov8n at 416 with tpu.quantize_int8), and
the JAX train step's and evaluator's as `jax_train_f32_n416.npz`.

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_jax_fixture.py [--only 416|s640|int8|train]

Runs the JAX package's `InferenceEngine` on the CPU in f32, through the
configured `letterbox_mxu` preprocess, with `artifacts/yolov8n_trained_416.npz`
and the thresholds of `configs/examples/server-cs16-416.json`, on two
batches of 8 frames made by `chip_smoke.py` (one definition of the frames):

- "task": `task_frames(8, 416, seed=777)`, frames of the weights' own task,
  in a 416x416 frame bucket (identity letterbox);
- "game": `synthetic_frame(800, 600, seed=s, t=0.3 * s)` for s in 4..11, in
  the deployed 608x800 bucket (a scaled, padded letterbox).

The file holds each batch's packed (8, 1 + 6*32) f32 output (`nms.pack_outputs`
layout), the frame seeds and the thresholds. The port's f32 step is held to
it at the 1e-3 gate of tests/test_model_parity.py:54-63: on the CPU by
tests/test_torch_fixture.py, on the card by chip_smoke.py (NumPy only there).

The yolov8s fixture is the same for `configs/examples/server-16stream-640-s.json`
with `artifacts/yolov8s_trained_ms640.npz`, at batch 4: "task" is
`task_frames(4, 640, seed=640)` in a 640x640 bucket, "game" is
`synthetic_frame(800, 600, seed=s, t=0.3 * s)` for s in 20..23 in the 608x800
bucket, each through the step at 640 and at 512 (keys task_640, game_640,
task_512, game_512).

The int8 fixture is the 416 one with `tpu.quantize_int8` set: the JAX
engine quantizes the weights and calibrates its static activation scales
at construction. It holds the same two batches' packed outputs (`task`,
`game`) and the calibrated scales (`x_scale`, one an int8 conv, named by
`x_scale_paths` as `models/weights.py` `flatten` names the blocks), and
the same again from the same engine run eagerly, op by op, under
`jax.disable_jit()` (`task_eager`, `game_eager`, `x_scale_eager`): the
spread of the JAX package's own int8 step between two ways of running the
same function. A value that one run rounds to int8 up and the other down
(their f32 inputs a rounding apart) moves every later conv's input and its
maxima, so the two runs' later scales and their detections differ.

The train fixture records the JAX package's f32 training (`TRAIN`):
yolov8n at 416, `init_params(PRNGKey(0), folded=False)`, batch 2 of
`synthetic_batches(2, 416, seed=0)`, 3 steps of the const chain
(`clip_by_global_norm(10)`, `adamw(1e-3, weight_decay=1e-4)`) with the EMA
on, center assigner. Whole trees would be 12.6 MB of f32, so it stores, per
step, the loss and its box, cls and dfl parts, and, for step 1's gradient
and for the params and the EMA after step 3, each leaf's L2 norm and its
dot product with a seeded probe (`chip_smoke.leaf_probes`: one standard
normal array a leaf, in `jax.tree.leaves` order, from
`default_rng(TRAIN["probe_seed"])`).
Beside it, the JAX package's `evaluate` in f32 of
`artifacts/yolov8n_trained_416.npz` over `synthetic_batches(32, 416,
seed=TRAIN["eval_seed"])`'s first batch (default thresholds, batch 8).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
sys.path.insert(0, str(REPO))

OUT = HERE / "jax_f32_step_416.npz"
CONFIG = REPO / "configs" / "examples" / "server-cs16-416.json"
TASK_SEED = 777
GAME_SEEDS = tuple(range(4, 12))
# The deployed frame buckets with a 416x416 bucket in front, so that the
# task frames take an identity letterbox.
TASK_BUCKET = (416, 416)

OUT_INT8 = HERE / "jax_int8_f32_step_416.npz"

OUT_S640 = HERE / "jax_f32_step_s640.npz"
CONFIG_S640 = REPO / "configs" / "examples" / "server-16stream-640-s.json"
TASK_SEED_S640 = 640
GAME_SEEDS_S640 = tuple(range(20, 24))
TASK_BUCKET_S640 = (640, 640)
RUNGS_S640 = (640, 512)


OUT_TRAIN = HERE / "jax_train_f32_n416.npz"
TRAIN = {"variant": "yolov8n", "classes": 4, "size": 416, "batch": 2,
         "steps": 3, "lr": 1e-3, "ema_decay": 0.9998, "init_seed": 0,
         "data_seed": 0, "probe_seed": 1234, "eval_images": 32,
         "eval_seed": 416, "eval_batch": 8,
         "eval_weights": "artifacts/yolov8n_trained_416.npz"}


def leaf_paths(tree, prefix=""):
    """The leaves' "m0/bn/var" names in `jax.tree.leaves` order (dict keys
    sorted, lists in order)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k],
                                                            f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in leaf_paths(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def jax_train_fixture() -> dict:
    import jax
    import jax.numpy as jnp
    import optax
    from zero_latency_yolo_tpu.models import get_spec, init_params
    from zero_latency_yolo_tpu.models.weights import load_params
    from zero_latency_yolo_tpu.models.yolov8 import forward_raw
    from zero_latency_yolo_tpu.train import (detection_loss, init_train_state,
                                             make_train_step)
    from zero_latency_yolo_tpu.train.eval import evaluate
    from zero_latency_yolo_tpu.train.loop import synthetic_batches
    from chip_smoke import eval_images, leaf_probes, norms_and_dots

    t = TRAIN
    hw = (t["size"], t["size"])
    spec = get_spec(t["variant"], t["classes"])
    tree = init_params(jax.random.PRNGKey(t["init_seed"]), spec,
                       folded=False, device=False)
    names = leaf_paths(tree)
    leaves0 = jax.tree.leaves(tree)
    assert len(names) == len(leaves0)
    probes = leaf_probes([a.shape for a in leaves0], t["probe_seed"])
    gen = synthetic_batches(t["batch"], t["size"], seed=t["data_seed"])
    batches = [next(gen) for _ in range(t["steps"])]

    def loss_fn(p, images, targets):
        outs = forward_raw(p, spec, images, dtype=jnp.float32,
                           accum_f32=False)
        return detection_loss(spec, outs, targets, hw)[0]
    params = jax.tree.map(jnp.asarray, tree)
    grad1 = jax.jit(jax.grad(loss_fn))(params, jnp.asarray(batches[0][0]),
                                       jnp.asarray(batches[0][1]))
    tx = optax.chain(optax.clip_by_global_norm(10.0),
                     optax.adamw(t["lr"], weight_decay=1e-4))
    state = init_train_state(params, tx, ema=True)
    step = make_train_step(spec, tx, hw, dtype=jnp.float32,
                           ema_decay=t["ema_decay"])
    metrics = {k: [] for k in ("loss", "box", "cls", "dfl")}
    for images, targets in batches:
        state, m = step(state, jnp.asarray(images), jnp.asarray(targets))
        for k in metrics:
            metrics[k].append(float(m[k]))
        print(f"train step: loss {metrics['loss'][-1]:.6f}", flush=True)
    out = {k: np.array(v, np.float64) for k, v in metrics.items()}
    for name, leaves in (("grad1", jax.tree.leaves(grad1)),
                         ("params3", jax.tree.leaves(state.params)),
                         ("ema3", jax.tree.leaves(state.ema_params))):
        out[f"{name}_norm"], out[f"{name}_dot"] = norms_and_dots(
            [np.asarray(a) for a in leaves], probes)
    images, targets = eval_images({"config": json.dumps(t)})
    ev = evaluate(load_params(str(REPO / t["eval_weights"])), spec, images,
                  targets, batch=t["eval_batch"], dtype=jnp.float32)
    print(f"eval: {ev}", flush=True)
    out.update(
        leaf_names=np.array(names), config=np.array(json.dumps(t)),
        eval_keys=np.array(sorted(ev)),
        eval_values=np.array([float(ev[k]) for k in sorted(ev)], np.float64))
    return out


def frame_sets():
    """{name: list of (h, w, 3) uint8 frames} for the two batches."""
    from chip_smoke import synthetic_frame, task_frames
    return {"task": list(task_frames(8, 416, seed=TASK_SEED)),
            "game": [synthetic_frame(800, 600, seed=s, t=0.3 * s)
                     for s in GAME_SEEDS]}


def frame_sets_s640():
    """{name: list of (h, w, 3) uint8 frames} for the yolov8s fixture."""
    from chip_smoke import synthetic_frame, task_frames
    return {"task": list(task_frames(4, 640, seed=TASK_SEED_S640)),
            "game": [synthetic_frame(800, 600, seed=s, t=0.3 * s)
                     for s in GAME_SEEDS_S640]}


def config_dict(path: Path = CONFIG, task_bucket=TASK_BUCKET) -> dict:
    """A config file's config in f32, with the task bucket added in front."""
    cfg = json.loads(path.read_text())
    cfg["model_path"] = str(REPO / cfg["model_path"])
    cfg["tpu"]["dtype"] = "float32"
    cfg["tpu"]["frame_buckets"] = ([list(task_bucket)]
                                   + cfg["tpu"]["frame_buckets"])
    return cfg


def jax_packed(cfg_dict=None, sets=None, sizes=(None,), out_engine=None
               ) -> dict:
    """{name: packed (B, 193) f32} of the JAX engine's f32 step, one entry a
    frame set and serve size (named "<set>_<size>" when a size is given);
    by default the 416 fixture's. `out_engine`, a list, receives the
    engine."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from zero_latency_yolo_tpu.config import ServerConfig
    from zero_latency_yolo_tpu.runtime.engine import (InferenceEngine,
                                                      InferenceRequest)
    cfg = ServerConfig.from_dict(cfg_dict or config_dict())
    assert cfg.tpu.preprocess == "letterbox_mxu", cfg.tpu.preprocess
    engine = InferenceEngine(cfg)
    assert not engine.simulation, f"{cfg.model_path} did not load"
    if out_engine is not None:
        out_engine.append(engine)
    packed = {}
    for name, frames in (sets or frame_sets()).items():
        reqs = [InferenceRequest(client_id=i + 1, frame_id=i, timestamp=i,
                                 width=f.shape[1], height=f.shape[0], data=f)
                for i, f in enumerate(frames)]
        for size in sizes:
            out = np.asarray(engine.dispatch(reqs, size=size).out, np.float32)
            assert out.shape == (len(frames), 1 + 6 * 32), out.shape
            packed[name if size is None else f"{name}_{size}"] = out
    return packed


def int8_config_dict() -> dict:
    cfg = config_dict()
    cfg["tpu"]["quantize_int8"] = True
    return cfg


def jax_x_scales(engine) -> dict:
    """{block path: x_scale} of a JAX int8 engine's calibrated params."""
    from zero_latency_yolo_tpu.models.weights import flatten
    return {k[:-len("/x_scale")]: float(v)
            for k, v in flatten(engine._params).items()
            if k.endswith("/x_scale")}


def main() -> None:
    only = sys.argv[sys.argv.index("--only") + 1] if "--only" in sys.argv \
        else None
    if only in (None, "416"):
        packed = jax_packed()
        for name, out in packed.items():
            print(f"{name}: counts {out[:, 0].astype(int).tolist()}",
                  flush=True)
        cfg = config_dict()
        np.savez_compressed(
            OUT, task=packed["task"], game=packed["game"],
            task_seed=np.int64(TASK_SEED), game_seeds=np.array(GAME_SEEDS),
            confidence_threshold=np.float64(cfg["confidence_threshold"]),
            nms_threshold=np.float64(cfg["nms_threshold"]),
            task_bucket=np.array(TASK_BUCKET))
        print(f"wrote {OUT.relative_to(REPO)} ({OUT.stat().st_size} bytes)")
    if only in (None, "int8"):
        import jax
        runs = {}
        for mode in ("jit", "eager"):
            engines = []
            with (jax.disable_jit() if mode == "eager"
                  else contextlib.nullcontext()):
                packed = jax_packed(int8_config_dict(), out_engine=engines)
            runs[mode] = (packed, jax_x_scales(engines[0]))
            for name, out in packed.items():
                print(f"int8 {mode} {name}: counts "
                      f"{out[:, 0].astype(int).tolist()}", flush=True)
        (packed, scales), (eager, eager_scales) = runs["jit"], runs["eager"]
        assert set(eager_scales) == set(scales)
        paths = sorted(scales)
        rel = max(abs(eager_scales[k] / scales[k] - 1) for k in paths)
        print(f"int8: {len(paths)} calibrated convs; eager against jit "
              f"calibration: max relative difference {rel:.3g}, "
              f"{sum(eager_scales[k] == scales[k] for k in paths)} equal",
              flush=True)
        cfg = int8_config_dict()
        np.savez_compressed(
            OUT_INT8, task=packed["task"], game=packed["game"],
            task_eager=eager["task"], game_eager=eager["game"],
            x_scale_paths=np.array(paths),
            x_scale=np.array([scales[k] for k in paths], np.float32),
            x_scale_eager=np.array([eager_scales[k] for k in paths],
                                   np.float32),
            task_seed=np.int64(TASK_SEED), game_seeds=np.array(GAME_SEEDS),
            confidence_threshold=np.float64(cfg["confidence_threshold"]),
            nms_threshold=np.float64(cfg["nms_threshold"]),
            task_bucket=np.array(TASK_BUCKET))
        print(f"wrote {OUT_INT8.relative_to(REPO)} "
              f"({OUT_INT8.stat().st_size} bytes)")
    if only in (None, "train"):
        np.savez_compressed(OUT_TRAIN, **jax_train_fixture())
        print(f"wrote {OUT_TRAIN.relative_to(REPO)} "
              f"({OUT_TRAIN.stat().st_size} bytes)")
    if only in (None, "s640"):
        cfg = config_dict(CONFIG_S640, TASK_BUCKET_S640)
        packed = jax_packed(cfg, frame_sets_s640(), RUNGS_S640)
        for name, out in packed.items():
            print(f"{name}: counts {out[:, 0].astype(int).tolist()}",
                  flush=True)
        np.savez_compressed(
            OUT_S640, **packed, task_seed=np.int64(TASK_SEED_S640),
            game_seeds=np.array(GAME_SEEDS_S640),
            rungs=np.array(RUNGS_S640),
            confidence_threshold=np.float64(cfg["confidence_threshold"]),
            nms_threshold=np.float64(cfg["nms_threshold"]),
            task_bucket=np.array(TASK_BUCKET_S640))
        print(f"wrote {OUT_S640.relative_to(REPO)} "
              f"({OUT_S640.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
