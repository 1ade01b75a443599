"""Offline detection CLI of the PyTorch port: run a weight file over images,
image directories and video files through the deployed inference functions
(forward + DFL decode, class-weighted NMS; host letterbox with the serving
geometry and gray fill), with no server.

    python -m zero_latency_yolo_tpu_torch.detect \
        --weights artifacts/yolov8n_trained_416.npz \
        photo.jpg frames_dir/ clip.mp4 [--save-dir out/] [--labels-dir lb/] \
        [--device cpu]

The port's copy of the JAX package's `scripts/detect.py`, with the same
arguments, output lines and exit codes, except that `--device` (default
`cuda`) takes the place of `--platform` (default `cpu` there). Without a CUDA
device and without `--device cpu` it exits with an error. On the card the
forward launches the port's kernels: each 1x1 conv on the 1x1 kernel's
CUDA-core route (`csrc/kernels.cu` `mm_bias_act_kernel`, the route of f32),
bias+SiLU after every other conv, and the NMS kernel once a batch. On the CPU
every kernel runs its plain PyTorch version.

One JSON line per frame on stdout: {"source", "width", "height",
"detections": [{"class", "confidence", "cx", "cy", "w", "h"}]} with boxes
center-format, normalized to the ORIGINAL frame (the wire Detection
convention, protocol/packets.py). --save-dir writes annotated copies (one
annotated .avi for a video source); --labels-dir writes YOLO-convention label
files, so a directory of images becomes a self-labeled dataset.

Compute is f32 in full precision (`runtime/engine.py` `full_f32_precision`:
no TF32 on the card); serving configs may run bf16, so scores can differ at
the last decimal near thresholds. One fixed batch shape (the last batch
padded), params placed on the device once, one readback a batch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def annotate(rgb, dets, names=None):
    import cv2
    out = cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR).copy()
    h, w = out.shape[:2]
    for d in dets:
        x1 = int((d["cx"] - d["w"] / 2) * w)
        y1 = int((d["cy"] - d["h"] / 2) * h)
        x2 = int((d["cx"] + d["w"] / 2) * w)
        y2 = int((d["cy"] + d["h"] / 2) * h)
        cv2.rectangle(out, (x1, y1), (x2, y2), (0, 220, 0), 2)
        label = (names[d["class"]] if names and d["class"] < len(names)
                 else str(d["class"]))
        cv2.putText(out, f"{label} {d['confidence']:.2f}",
                    (x1, max(y1 - 4, 12)), cv2.FONT_HERSHEY_SIMPLEX,
                    0.5, (0, 220, 0), 1, cv2.LINE_AA)
    return out


def make_runner(params, spec, device, conf: float, nms: float):
    """run(x, scale, pad, wh) on NumPy host arrays -> the packed (B, 1 +
    6*MAX_DET) f32 output as NumPy (`ops/nms.py` `pack_outputs`): the f32
    forward and postprocess with the params placed on `device` once."""
    import torch

    from .models.weights import params_from_jax, place_params
    from .models.yolov8 import forward_decoded
    from .ops.nms import pack_outputs, postprocess_batch
    from .runtime.engine import full_f32_precision

    dev = torch.device(device)
    placed = place_params(params_from_jax(params), dev, torch.float32)
    cw = torch.ones((spec.num_classes,), dtype=torch.float32, device=dev)

    def run(x, scale, pad, wh):
        with torch.inference_mode(), full_f32_precision():
            t = [torch.from_numpy(a).to(dev) for a in (x, scale, pad, wh)]
            pred = forward_decoded(placed, spec, t[0])
            out = postprocess_batch(pred, cw, conf, nms, t[1], t[2], t[3])
            return pack_outputs(out).cpu().numpy()
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="offline detection over images/dirs/videos")
    ap.add_argument("inputs", nargs="+",
                    help="image files, image directories, video files")
    ap.add_argument("--weights", required=True, help=".npz/.pt/.onnx artifact")
    ap.add_argument("--size", type=int, default=416,
                    help="letterbox target (32-multiple)")
    ap.add_argument("--conf", type=float, default=0.5)
    ap.add_argument("--nms", type=float, default=0.45)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--video-stride", type=int, default=1,
                    help="process every Nth video frame")
    ap.add_argument("--save-dir", default="",
                    help="write annotated copies here (video sources write "
                         "ONE annotated .avi (MJPG) each instead of per-frame "
                         "stills; stride-skipped frames are omitted)")
    ap.add_argument("--labels-dir", default="",
                    help="write YOLO-convention label files here "
                         "(self-labeling a directory of images)")
    ap.add_argument("--names", default="",
                    help="comma-separated class names for annotations")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs every "
                         "kernel's plain PyTorch version)")
    args = ap.parse_args(argv)
    if args.size <= 0 or args.size % 32:
        raise SystemExit("--size must be a positive multiple of 32")
    if args.batch < 1 or args.video_stride < 1:
        raise SystemExit("--batch and --video-stride must be >= 1")

    from .utils.device import require_device
    require_device(args.device, "detect")

    from .models.weights import infer_spec_from_params, load_artifact
    from .ops.nms import unpack_outputs
    from .runtime.media import iter_frames
    from .train.data import letterbox_image

    try:
        params = load_artifact(args.weights)
    except ValueError as e:
        raise SystemExit(str(e))
    spec = infer_spec_from_params(params)
    names = [n.strip() for n in args.names.split(",")] if args.names else None
    size, batch = args.size, args.batch
    run = make_runner(params, spec, args.device, args.conf, args.nms)

    for d in (args.save_dir, args.labels_dir):
        if d:
            os.makedirs(d, exist_ok=True)

    def flush(bufs):
        n = len(bufs)
        if not n:
            return
        x = np.zeros((batch, size, size, 3), np.float32)
        scale = np.ones((batch,), np.float32)
        pad = np.zeros((batch, 2), np.float32)
        wh = np.ones((batch, 2), np.float32)
        for i, (_src, rgb) in enumerate(bufs):
            # fill=114: the serving letterbox's gray pad (ops/preprocess
            # FILL) so offline confidences match what the server computes.
            lb, s, px, py = letterbox_image(rgb, size, fill=114)
            x[i] = lb.astype(np.float32) / 255.0
            scale[i] = s
            pad[i] = (px, py)
            wh[i] = (rgb.shape[1], rgb.shape[0])
        out = unpack_outputs(run(x, scale, pad, wh))
        boxes, scores = out["boxes"], out["scores"]
        classes, counts = out["classes"], out["count"]
        for i, (src, rgb) in enumerate(bufs):
            k = int(counts[i])
            dets = [{
                "class": int(classes[i, j]),
                "confidence": round(float(scores[i, j]), 4),
                "cx": round(float(boxes[i, j, 0]), 6),
                "cy": round(float(boxes[i, j, 1]), 6),
                "w": round(float(boxes[i, j, 2]), 6),
                "h": round(float(boxes[i, j, 3]), 6),
            } for j in range(k)]
            print(json.dumps({"source": src,
                              "width": int(rgb.shape[1]),
                              "height": int(rgb.shape[0]),
                              "detections": dets}), flush=True)
            # Path-derived stem (separators -> "_"): same-named inputs from
            # different directories must not overwrite each other's labels.
            # rsplit + frame-prefix check: iter_frames names video frames
            # "<path>#frameN", but a literal '#' in a user's FILE name
            # (photo#1.jpg) must not route a still down the video-writer
            # path against a nonexistent capture.
            path_part, _, tail = src.rpartition("#")
            if path_part and tail.startswith("frame"):
                suffix = tail
            else:
                path_part, suffix = src, ""
            base = os.path.splitext(os.path.normpath(path_part))[0]
            base = base.replace(os.sep, "_").lstrip("._")
            stem = f"{base}_{suffix}" if suffix else base
            if args.save_dir:
                import cv2
                ann = annotate(rgb, dets, names)
                if suffix:
                    # Video frame: append to ONE annotated video per source
                    # (processed frames only; stride-skipped ones omitted).
                    vw = video_writers.get(path_part)
                    if vw is None:
                        cap = cv2.VideoCapture(path_part)
                        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
                        cap.release()
                        fps = max(float(fps or 30.0) / args.video_stride, 1.0)
                        vw = cv2.VideoWriter(
                            os.path.join(args.save_dir,
                                         base + "_annotated.avi"),
                            cv2.VideoWriter_fourcc(*"MJPG"), fps,
                            (rgb.shape[1], rgb.shape[0]))
                        video_writers[path_part] = vw
                    vw.write(ann)
                else:
                    cv2.imwrite(os.path.join(args.save_dir, stem + ".jpg"),
                                ann)
            if args.labels_dir:
                with open(os.path.join(args.labels_dir, stem + ".txt"),
                          "w") as f:
                    for d in dets:
                        f.write(f"{d['class']} {d['cx']:.6f} {d['cy']:.6f} "
                                f"{d['w']:.6f} {d['h']:.6f}\n")
        bufs.clear()

    bufs = []
    video_writers = {}
    n_frames = 0
    try:
        # Generator: decode errors surface during iteration.
        for src, rgb in iter_frames(args.inputs, args.video_stride):
            bufs.append((src, rgb))
            n_frames += 1
            if len(bufs) == batch:
                flush(bufs)
        flush(bufs)
    except ValueError as e:
        raise SystemExit(str(e))
    finally:
        for vw in video_writers.values():
            vw.release()
    if not n_frames:
        raise SystemExit("no decodable inputs found")
    return 0


if __name__ == "__main__":
    sys.exit(main())
