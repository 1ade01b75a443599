"""The serving mesh's scheduling overhead: the `tpu.mesh_data=2` engine
against the single-device engine, both under the production batcher.

    python -m zero_latency_yolo_tpu_torch.spmd_overhead [--streams 4]
        [--fps 30] [--batch 4] [--mode equal-per-shard|equal-total]
        [--duration 10] [--reps 3] [--device cuda]

  arm A  the single-device engine, the ContinuousBatcher, a paced load of
         S streams at R fps, max_batch B
  arm B  the mesh_data=2 engine on a 2x1 mesh. --mode equal-per-shard
         (default): 2S streams, max_batch 2B (equal work a device; on one
         device the second row's work serializes and inflates the delta).
         --mode equal-total: S streams and max_batch B, B/2 a data row (the
         same total work, so the delta is the split's dispatch and
         assembly).

With two or more CUDA devices arm B runs on cuda:0 and cuda:1; with fewer
(one card, or --device cpu) on a virtual 2x1 mesh over the one device
(`parallel/mesh.py`: the mesh's code path, the batch split and the
gathers, with both rows on one device), and the output says
`"virtual": true`. Both arms serve real compute (the port's seeded
`init_params`) through the server's path: batcher thread -> infer_batch ->
packed readback -> results. Before the load, both arms serve one batch of
the same frames in float32 (engines of their own): `results_equal` holds
when counts and classes are equal and boxes and confidences within 1e-3;
the tool exits 1 when they are not.

Per arm: detect avg and p99 (submit to result), the engine's pipeline avg
and p99, served fps, results, with the reps interleaved A/B/A/B (host
drift cancels) and each key's median over the reps. Defaults: the JAX
package's pico model (yolov8p at 96, f32, top-K 64); `chip_smoke.py`
runs yolov8n at 416 in bf16. One JSON line, the JAX package's
`scripts/spmd_overhead.py` keys plus `device` (the card's name and power
limit), `virtual` and `results_equal`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .utils.device import require_device


def build_engine(args, mesh_data: int, batch: int, dtype: str, mesh_devices):
    from .config import ServerConfig
    from .runtime.engine import InferenceEngine
    from .utils.bench_util import seeded_params
    cfg = ServerConfig.from_dict({
        "confidence_threshold": 0.1,
        "detection": {"model_width": args.size, "model_height": args.size},
        "tpu": {"variant": args.variant, "num_classes": 4, "dtype": dtype,
                "pre_nms_topk": args.topk,
                "batch_buckets": sorted({batch, max(batch // 2, 1)}),
                "frame_buckets": [[args.size, args.size]],
                "mesh_data": mesh_data},
    })
    return InferenceEngine(cfg, params=seeded_params(args.variant),
                           device=args.device, mesh_devices=mesh_devices)


def mesh_devices(device: str):
    """(the two devices of arm B's mesh, whether they are one device)."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= 2:
        return [torch.device("cuda", 0), torch.device("cuda", 1)], False
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return [dev, dev], True


def requests(frames, n: int, fid: int = 0) -> list:
    from .runtime.engine import InferenceRequest
    return [InferenceRequest(client_id=i + 1, frame_id=fid, timestamp=0,
                             width=frames.shape[2], height=frames.shape[1],
                             data=frames[i % len(frames)]) for i in range(n)]


def results_agree(a, b, tol: float = 1e-3) -> dict:
    """Detection-level agreement of two arms' results on the same frames:
    counts and classes equal, boxes and confidences within `tol`."""
    worst = 0.0
    for ra, rb in zip(a, b):
        da = sorted(ra.detections, key=lambda d: (-d.confidence, d.class_id))
        db = sorted(rb.detections, key=lambda d: (-d.confidence, d.class_id))
        if len(da) != len(db) or [d.class_id for d in da] != [
                d.class_id for d in db]:
            return {"equal": False, "reason": f"frame {ra.frame_id}: "
                    f"{len(da)} vs {len(db)} detections or classes differ"}
        for x, y in zip(da, db):
            worst = max(worst, *(abs(getattr(x, k) - getattr(y, k)) for k in
                                 ("x", "y", "width", "height", "confidence")))
    return {"equal": len(a) == len(b) and worst <= tol, "max_abs_diff": worst,
            "detections": sum(len(r.detections) for r in a)}


def run_arm(engine, streams: int, fps: float, max_batch: int,
            duration_s: float, frames: np.ndarray) -> dict:
    from .runtime.engine import InferenceRequest
    from .runtime.scheduler import ContinuousBatcher

    lat = []
    done = []

    def on_result(results):
        now = time.perf_counter()
        for r in results:
            # recv_t carries the request's enqueue time through the batcher:
            # now - recv_t is the server's detect latency.
            lat.append((now - r.recv_t) * 1e3)
        done.append(len(results))

    b = ContinuousBatcher(engine, on_result, max_batch=max_batch,
                          batch_window_ms=1.0)
    b.start()
    h, w = frames.shape[1:3]
    try:
        # Warm the serving steps through the batcher before timing.
        deadline = time.perf_counter() + 600.0
        while sum(done) < 3 * max_batch and time.perf_counter() < deadline:
            for i in range(max_batch):
                b.submit(InferenceRequest(client_id=i + 1, frame_id=0,
                                          timestamp=0, width=w, height=h,
                                          data=frames[i % len(frames)]))
            time.sleep(0.5)
        if not sum(done):
            raise RuntimeError("warmup produced no results in 600 s")
        lat.clear()
        done.clear()

        interval = 1.0 / fps
        t_end = time.perf_counter() + duration_s
        fid = 1
        next_t = time.perf_counter()
        while time.perf_counter() < t_end:
            # One tick submits a frame for every stream.
            for c in range(streams):
                b.submit(InferenceRequest(client_id=c + 1, frame_id=fid,
                                          timestamp=0, width=w, height=h,
                                          data=frames[(fid + c) % len(frames)]))
            fid += 1
            next_t += interval
            dt = next_t - time.perf_counter()
            if dt > 0:
                time.sleep(dt)
        time.sleep(1.0)  # drain
    finally:
        b.stop()
    arr = np.asarray(lat) if lat else np.zeros(1)
    st = engine.status()
    return {
        "streams": streams, "max_batch": max_batch,
        "offered_fps": round(streams * fps, 1),
        "served_fps": round(sum(done) / duration_s, 1),
        "detect_avg_ms": round(float(arr.mean()), 2),
        "detect_p99_ms": round(float(np.percentile(arr, 99)), 2),
        "pipeline_avg_ms": round(float(st.get("pipeline_avg_ms", 0.0)), 2),
        "pipeline_p99_ms": round(float(st.get("pipeline_p99_ms", 0.0)), 2),
        "results": int(sum(done)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=__doc__.split("\n\n", 1)[1])
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--mode", default="equal-per-shard",
                    choices=("equal-per-shard", "equal-total"))
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--variant", default="yolov8p")
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--topk", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    require_device(args.device, "spmd_overhead")

    from .utils.bench_util import device_label

    per_shard = args.mode == "equal-per-shard"
    if not per_shard and args.batch % 2:
        # The dp2 engine drops odd buckets (the data axis must divide them)
        # and would batch smaller than the single arm.
        raise SystemExit("--mode equal-total needs an even --batch "
                         "(the dp2 engine shards it batch/2 a data row)")
    dp2_batch = 2 * args.batch if per_shard else args.batch
    dp2_streams = 2 * args.streams if per_shard else args.streams
    devices, virtual = mesh_devices(args.device)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (16, args.size, args.size, 3),
                          dtype=np.uint8)

    # The arms' results on one batch of the same frames, in float32.
    check = [build_engine(args, md, dp2_batch, "float32", devices)
             for md in (1, 2)]
    if check[1].mesh is None:
        raise SystemExit("spmd_overhead: the dp2 engine built no mesh")
    reqs = requests(frames, dp2_batch)
    agree = results_agree(*(e.infer_batch(reqs) for e in check))
    del check

    single = build_engine(args, 1, args.batch, args.dtype, devices)
    dp2 = build_engine(args, 2, dp2_batch, args.dtype, devices)
    rows = {"single": [], "dp2": []}
    for rep in range(args.reps):
        rows["single"].append(run_arm(single, args.streams, args.fps,
                                      args.batch, args.duration, frames))
        rows["dp2"].append(run_arm(dp2, dp2_streams, args.fps, dp2_batch,
                                   args.duration, frames))
        print(f"# rep {rep}: single p99 {rows['single'][-1]['detect_p99_ms']}"
              f" ms, dp2 p99 {rows['dp2'][-1]['detect_p99_ms']} ms",
              file=sys.stderr, flush=True)

    def med(key, arm):
        vals = sorted(r[key] for r in rows[arm])
        return vals[(len(vals) - 1) // 2]

    out = {
        "method": f"interleaved A/B, real compute ({args.variant}@{args.size} "
                  f"{args.dtype}), production batcher, {args.mode}; "
                  + ("virtual 2x1 mesh over one device" if virtual
                     else "2x1 mesh over two devices"),
        "single": {k: med(k, "single") for k in rows["single"][0]},
        "dp2": {k: med(k, "dp2") for k in rows["dp2"][0]},
        "reps": args.reps,
        "detect_avg_delta_ms": round(med("detect_avg_ms", "dp2")
                                     - med("detect_avg_ms", "single"), 2),
        "detect_p99_delta_ms": round(med("detect_p99_ms", "dp2")
                                     - med("detect_p99_ms", "single"), 2),
        "pipeline_avg_delta_ms": round(med("pipeline_avg_ms", "dp2")
                                       - med("pipeline_avg_ms", "single"), 2),
        "device": device_label(devices[0]), "virtual": virtual,
        "mesh": dp2.status()["mesh"], "results_equal": agree,
    }
    print(json.dumps(out), flush=True)
    if not agree["equal"]:
        print(f"spmd_overhead: the arms' results differ: {agree}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
