#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the repo root with one card: `python3 chip_smoke.py`. It needs a
CUDA device and nvcc, and imports torch, numpy, the stdlib and
`zero_latency_yolo_tpu_torch` only. Phases, in order; any failure raises
and the script exits non-zero:

1. device: a CUDA device must be present; prints the card's name and power
   limit as nvidia-smi reports them.
2. build: nvcc builds csrc/*.cu into one library (ops/_build.py), in under
   60 s and with no register spills.
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   on the inputs the serving step gives it (recorded from one plain step of
   the deployed config at batch 8: 24 1x1 convs, 39 bias+SiLU epilogues,
   one NMS keep mask), in bf16 and f32, plus the NMS kernel on seeded boxes
   (B 8, K 256, 70% valid), exact. The 1x1 GEMM runs each call on both
   routes: every bf16 call must plan onto the tensor-core kernel, and the
   CUDA-core kernel is checked in bf16 and f32. Times (CUDA events, after
   warm-up) for the kernel, its plain version and the one PyTorch call
   that computes the same function, beside the least time the card could
   take for the same bytes and operations, in all and call by call (the
   1x1 GEMM on both routes; bias+SiLU and NMS beside the device time of a
   launch that moves one vector); the host cost of a TMA map encode.
4. main path: the deployed config (configs/examples/server-cs16-416.json:
   yolov8n, 416, bf16, real weights) through InferenceEngine.infer_batch and
   dispatch/complete_many, with every kernel's launch count reset just
   before and read just after; every 1x1 conv of the bf16 path must have
   run on the tensor cores. Then the f32 step with kernels against the
   f32 step with plain versions, and against the JAX package's f32 step
   (the committed fixture tests/torch_fixtures/jax_f32_step_416.npz, read
   with NumPy; fixture_gate), both with counts and classes equal and boxes
   and scores within 1e-3, under PyTorch's default TF32 settings, so that
   the step's own switch to full f32 is what is checked; the bf16
   detection gate against f32 (twins with IoU > 0.85, the same class,
   confidence within 0.03; see bf16_gate for the decisions on a
   threshold); and the step time per batch bucket: wall time, device busy
   time by kernel (torch.profiler) and the idle share; at batch 8 also
   each port kernel's device time inside the step, the kernels the step
   launches, and the device time and kernels of its NMS stage.
5. server: the port's DetectionServer in this process on the card, with
   the deployed config (free loopback ports, warmup, no device frame
   cache), driven over loopback UDP by the port's SimClient: 8 clients
   handshake and stream raw 160x120 frames at 60 fps for 4 s from client
   threads. Gates: every client gets results; frames sent = results +
   the drops /statusz counts (engine drops and the kernel's receive-buffer
   drops), short by at most SERVER_SLACK frames; each kernel's launch count
   rose during the load (the 1x1 GEMM on the tensor cores); GET /statusz
   answers 200 with the engine's status; the native codec served. Then a
   second server on the same engine with tracking off serves 8 frames one
   at a time, each result equal to engine.infer_batch on the same frame
   through a fresh adapter (counts, classes and ids equal; boxes and
   confidences within 1e-3); without cv2 a JPEG keyframe raises
   bad_packets and the server keeps serving. Printed, not gated: the
   server's detect latency p50 and p99, results a second, batch sizes, the
   device idle share during the load (torch.profiler), beside the card's
   name and power limit; the load's launches on a `server kernels:` line.
6. report: a `kernels:` line, one JSON line of kernel numbers, and the
   result line `{"ok": true, "device": {...}}` last.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "examples" / "server-cs16-416.json"
FIXTURE = ROOT / "tests" / "torch_fixtures" / "jax_f32_step_416.npz"

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and
# operations/s by operand type (bf16 on the tensor cores, f32 on the CUDA
# cores). The bound of a kernel call is the larger of bytes / HBM rate and
# operations / peak.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

DEVICE = "cuda"

# (atol, rtol): |kernel - plain| <= atol + rtol * |plain|, with the reason:
TOLERANCE = {
    # f32: the same products summed in another order.
    ("conv1x1_bias_act", "float32"): (1e-4, 1e-4),
    # bf16: that order may move the one rounding to bf16 by one ulp.
    ("conv1x1_bias_act", "bfloat16"): (1e-2, 2.0 ** -7),
    # f32: the same formula; exp may differ in the last bit, which may move
    # the rounding to bf16 by one ulp.
    ("bias_silu", "float32"): (1e-6, 1e-6),
    ("bias_silu", "bfloat16"): (1e-5, 2.0 ** -7),
}

KERNELS = {
    # name: (route, source, the TPU kernel it replaces)
    "nms_keep": ("cuda", "zero_latency_yolo_tpu_torch/csrc/nms_sm90.cu",
                 "zero_latency_yolo_tpu/ops/nms_pallas.py:33"),
    "conv1x1_bias_act": ("cuda", "zero_latency_yolo_tpu_torch/csrc/conv1x1_sm90.cu",
                         "zero_latency_yolo_tpu/ops/conv1x1_pallas.py:57"),
    "bias_silu": ("cuda", "zero_latency_yolo_tpu_torch/csrc/kernels.cu",
                  "zero_latency_yolo_tpu/ops/act_pallas.py:40"),
}
# The device functions of each kernel, as the profiler names them.
KERNEL_SYMBOLS = {
    "nms_keep": ("nms_keep_kernel",),
    "conv1x1_bias_act": ("conv1x1_wgmma_kernel", "mm_bias_act_kernel"),
    "bias_silu": ("bias_silu_vec_kernel", "bias_silu_kernel"),
}


# Server phase: clients, their frame rate and size (raw RGB that fits one
# datagram: 57,600 B), seconds of load, and the frames that may still be in
# flight when the counts are read (one a client).
SERVER_CLIENTS = 8
SERVER_FPS = 60.0
SERVER_SECONDS = 4.0
SERVER_FRAME = (160, 120)
SERVER_SLACK = SERVER_CLIENTS


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


class Phase:
    """Prints a phase's name on entry and its seconds on exit."""

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "Phase":
        print(f"== phase {self.name}", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if exc[0] is None:
            print(f"== phase {self.name} done in "
                  f"{time.perf_counter() - self.t0:.2f} s", flush=True)


def synthetic_frame(width: int, height: int, seed: int = 0,
                    t: float = 0.0) -> np.ndarray:
    """Deterministic synthetic game frame: gradient background + moving blobs
    (a copy of the JAX package's runtime/simulator.py synthetic_frame)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    frame = np.stack([
        (xx * 255 // max(width - 1, 1)).astype(np.uint8),
        (yy * 255 // max(height - 1, 1)).astype(np.uint8),
        np.full((height, width), 64, np.uint8)], axis=-1)
    for i in range(3):
        cx = int((0.2 + 0.2 * i + 0.1 * np.sin(t + i)) * width) % width
        cy = int((0.3 + 0.15 * i + 0.1 * np.cos(t + i)) * height) % height
        hw, hh = width // 20, height // 8
        x0, x1 = max(cx - hw, 0), min(cx + hw, width)
        y0, y1 = max(cy - hh, 0), min(cy + hh, height)
        frame[y0:y1, x0:x1] = rng.integers(0, 255, 3, dtype=np.uint8)
    return frame


def task_frames(n: int, size: int, seed: int, max_boxes: int = 4) -> np.ndarray:
    """Frames of the task the deployed weights were trained on: a gray field
    with colored rectangles (the scene drawing of the JAX package's
    train/loop.py synthetic_batches, same random stream), as uint8."""
    rng = np.random.default_rng(seed)
    images = np.full((n, size, size, 3), 0.35, np.float32)
    for b in range(n):
        for _ in range(rng.integers(1, max_boxes + 1)):
            w = rng.uniform(0.15, 0.5)
            h = rng.uniform(0.15, 0.5)
            cx = rng.uniform(w / 2, 1 - w / 2)
            cy = rng.uniform(h / 2, 1 - h / 2)
            cls = rng.integers(0, 4)
            color = np.zeros(3, np.float32)
            color[cls % 3] = 0.9 if cls < 3 else 0.6
            images[b, int((cy - h / 2) * size):int((cy + h / 2) * size),
                   int((cx - w / 2) * size):int((cx + w / 2) * size)] = color
    return np.round(images * 255).astype(np.uint8)


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` calls (CUDA events). The calls
    are queued behind a spin of the GPU (torch.cuda._sleep) long enough for
    the host to enqueue them all, so the host's launch overhead does not
    show as idle time between the launches the events bracket."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0 * iters * host_ms + 1.0, 2000.0) * 2e6))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(torch, fn, iters: int = 10, warmup: int = 3) -> float:
    """Mean host-clock time of fn() with the device synchronized."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def profile_step(torch, fn, iters: int = 5, top: int = 0) -> tuple:
    """Device time of fn() by kernel (bench_host.step_profile: torch.profiler,
    CUDA activity; only the kernel and copy events are summed, not the CPU
    ops that launched them). Returns (the profile, {port kernel: device ms})
    per call and prints the `top` kernels."""
    from zero_latency_yolo_tpu_torch.bench_host import step_profile
    prof = step_profile(torch, fn, iters)
    for ms, n, key in prof["rows"][:top]:
        print(f"  {ms:8.4f} ms/step  {n:4d} launches/step  {key[:90]}")
    own = {name: sum(ms for ms, _, key in prof["rows"]
                     if any(sym in key for sym in syms))
           for name, syms in KERNEL_SYMBOLS.items()}
    return prof, own


def compare(torch, got, want, atol: float, rtol: float):
    """(max |got - want|, whether every element is within atol + rtol|want|)."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    ok = bool(torch.isfinite(g).all()) and bool((d <= atol + rtol * w.abs()).all())
    return float(d.max()), ok


# f32 operations of one IoU test as ops/nms_cuda.py computes it: two max,
# two min, two subtractions and two clamps for the overlap, its product,
# the union's add, subtract and clamp, the divide and the compare.
NMS_PAIR_OPS = 14


def nms_bound(boxes, classes, valid, thr: float) -> tuple:
    """(bytes, operations) that greedy NMS must spend on these inputs:
    boxes, classes and valid flags read once and the keep mask written
    once; one IoU test for each kept box i and each candidate j > i of its
    class still alive when i is reached (the pairs this data needs)."""
    boxes, classes, valid = (t.cpu().numpy() for t in (boxes, classes, valid))
    b, k = valid.shape
    nbytes = b * k * (16 + 4 + 1 + 1)
    pairs = 0
    f = np.float32
    for fr in range(b):
        cx, cy, w, h = (boxes[fr, :, c] for c in range(4))
        x1, y1, x2, y2 = cx - w / f(2), cy - h / f(2), cx + w / f(2), cy + h / f(2)
        area = np.maximum(w, f(0)) * np.maximum(h, f(0))
        alive = valid[fr].copy()
        for i in range(k):
            if not alive[i]:
                continue
            cols = np.zeros(k, bool)
            cols[i + 1:] = alive[i + 1:] & (classes[fr, i + 1:] == classes[fr, i])
            pairs += int(cols.sum())
            iw = np.maximum(np.minimum(x2[i], x2) - np.maximum(x1[i], x1), f(0))
            ih = np.maximum(np.minimum(y2[i], y2) - np.maximum(y1[i], y1), f(0))
            inter = iw * ih
            iou = inter / np.maximum(area[i] + area - inter, f(1e-9))
            alive[cols & (iou > f(thr))] = False
    return nbytes, NMS_PAIR_OPS * pairs


def record_path_calls(engine, frames_d, hs, ws):
    """Run one plain bf16 step and record the inputs it hands each kernel's
    plain version: the serving path's own shapes and values."""
    from zero_latency_yolo_tpu_torch.models import yolov8 as ym
    from zero_latency_yolo_tpu_torch.ops import nms as nms_mod
    calls = {"conv1x1_bias_act": [], "bias_silu": [], "nms_keep": []}
    saved = (ym.conv1x1_bias_act_plain, ym.bias_silu_plain,
             nms_mod.nms_keep_plain)

    def recorder(name, fn):
        def rec(*args, **kwargs):
            calls[name].append((args, kwargs))
            return fn(*args, **kwargs)
        return rec

    ym.conv1x1_bias_act_plain = recorder("conv1x1_bias_act", saved[0])
    ym.bias_silu_plain = recorder("bias_silu", saved[1])
    nms_mod.nms_keep_plain = recorder("nms_keep", saved[2])
    try:
        engine._build_step(plain=True)(
            engine._params, frames_d, hs, ws, engine._class_weights,
            engine.config.confidence_threshold, engine.config.nms_threshold)
    finally:
        (ym.conv1x1_bias_act_plain, ym.bias_silu_plain,
         nms_mod.nms_keep_plain) = saved
    return calls


def check_kernels(torch, calls, thr: float, dev):
    """Phase 3: every recorded call through the kernel and its plain version
    in bf16 and f32; bf16 times. Returns per-kernel report fields."""
    import torch.nn.functional as F
    from zero_latency_yolo_tpu_torch.ops import (_build, act_cuda, conv1x1_cuda,
                                                 nms_cuda)
    report = {}

    # 1x1 conv GEMM + bias (+SiLU): every path call on the tensor-core
    # route (bf16) and on the CUDA-core route (bf16 forced, and f32), each
    # against the plain version; times of both routes on the same call.
    errs = {"bfloat16": 0.0, "float32": 0.0}
    ms = ms_simt = plain_ms = lib_ms = bound_ms = bytes_s = ops_s = 0.0
    routes = {r: 0 for r in conv1x1_cuda.ROUTES}
    print("conv1x1 path calls (bf16; us per call): M Cin Cout act route bn "
          "grid | wgmma simt addmm+silu bound", flush=True)
    for (x, w, b), kw in calls["conv1x1_bias_act"]:
        act = kw.get("act", True)
        # w as the path gives it (placed K-major), and row-major, the
        # layout the CUDA-core kernel reads fastest.
        w_row = w.contiguous()
        route = conv1x1_cuda.conv1x1_plan(x, w)
        routes[route.route] += 1
        for dt, cast, ww, forced in (
                ("bfloat16", torch.bfloat16, w, None),
                ("bfloat16", torch.bfloat16, w_row, "simt"),
                ("float32", torch.float32, w, None)):
            xx, ww = x.to(cast), ww.to(cast)  # .to keeps the layout
            err, ok = compare(torch, conv1x1_cuda.conv1x1_bias_act(
                xx, ww, b, act, route=forced),
                conv1x1_cuda.conv1x1_bias_act_plain(xx, ww, b, act),
                *TOLERANCE[("conv1x1_bias_act", dt)])
            require(ok, f"conv1x1 {dt} route={forced or 'plan'} "
                        f"{tuple(x.shape)}x{tuple(w.shape)} act={act}: max err "
                        f"{err:.3g} outside tolerance")
            errs[dt] = max(errs[dt], err)
        m, cin = x.shape
        cout = w.shape[1]
        bl = b.to(x.dtype)
        t_tc = time_ms(torch, lambda: conv1x1_cuda.conv1x1_bias_act(
            x, w, b, act))
        t_simt = time_ms(torch, lambda: conv1x1_cuda.conv1x1_bias_act(
            x, w_row, b, act, route="simt"))
        t_lib = time_ms(torch, (lambda: F.silu(torch.addmm(bl, x, w))) if act
                        else (lambda: torch.addmm(bl, x, w)))
        ms, ms_simt, lib_ms = ms + t_tc, ms_simt + t_simt, lib_ms + t_lib
        plain_ms += time_ms(torch, lambda: conv1x1_cuda.conv1x1_bias_act_plain(
            x, w, b, act))
        t_bytes = ((m * cin + cin * cout + m * cout) * x.element_size()
                   + cout * 4) / HBM_BYTES_PER_S
        t_ops = 2.0 * m * cin * cout / PEAK_OPS_PER_S["bfloat16"]
        bound_ms += 1e3 * max(t_bytes, t_ops)
        bytes_s, ops_s = bytes_s + t_bytes, ops_s + t_ops
        print(f"  {m:6d} {cin:4d} {cout:4d} {int(act)} {route.route} "
              f"{route.bn:3d} {route.grid:4d} | {1e3 * t_tc:8.2f} "
              f"{1e3 * t_simt:8.2f} {1e3 * t_lib:8.2f} "
              f"{1e6 * max(t_bytes, t_ops):8.2f}", flush=True)
    require(routes["wgmma"] == len(calls["conv1x1_bias_act"]),
            f"bf16 path calls by route {routes}: all must take the tensor "
            "cores")
    x = calls["conv1x1_bias_act"][0][0][0]
    enc_us = _build.kernels().lib.zlt_tma_encode_us(
        x.data_ptr(), x.shape[0], x.shape[1], 64, 2000)
    require(enc_us >= 0, "cuTensorMapEncodeTiled unavailable")
    n_calls = len(calls["conv1x1_bias_act"])
    print(f"TMA map encode on the host: {enc_us:.3f} us each, 2 a call, "
          f"{2 * n_calls * enc_us:.1f} us a step of {n_calls} calls",
          flush=True)
    report["conv1x1_bias_act"] = dict(
        calls=n_calls, max_abs_err=errs["bfloat16"],
        max_abs_err_f32=errs["float32"], ms=ms, ms_simt=ms_simt,
        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
        bound_by="bytes" if bytes_s >= ops_s else "operations",
        routes=routes, encode_us=enc_us)

    # Bias + SiLU, with the device time of a launch that does no work to
    # speak of (one 16-byte vector): the per-launch floor.
    errs = {"bfloat16": 0.0, "float32": 0.0}
    ms = plain_ms = lib_ms = bound_ms = bytes_s = ops_s = 0.0
    tiny = torch.ones(1, 1, 1, 8, dtype=torch.bfloat16, device=dev)
    tiny_b = torch.zeros(8, device=dev)
    floor_ms = time_ms(torch, lambda: act_cuda.bias_silu(tiny, tiny_b))
    print(f"bias_silu path calls (bf16; us per call): shape | kernel "
          f"F.silu(y+b) bound kernel-floor; launch floor (one vector) "
          f"{1e3 * floor_ms:.2f} us", flush=True)
    for (y, b), _ in calls["bias_silu"]:
        for dt, cast in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            yy = y.to(cast).contiguous()
            err, ok = compare(torch, act_cuda.bias_silu(yy, b),
                              act_cuda.bias_silu_plain(yy, b),
                              *TOLERANCE[("bias_silu", dt)])
            require(ok, f"bias_silu {dt} {tuple(y.shape)}: max err {err:.3g} "
                        "outside tolerance")
            errs[dt] = max(errs[dt], err)
        bl = b.to(y.dtype)
        t_k = time_ms(torch, lambda: act_cuda.bias_silu(y, b))
        t_lib = time_ms(torch, lambda: F.silu(y + bl))
        ms, lib_ms = ms + t_k, lib_ms + t_lib
        plain_ms += time_ms(torch, lambda: act_cuda.bias_silu_plain(y, b))
        n = y.numel()
        t_bytes = (2 * n * y.element_size() + b.numel() * 4) / HBM_BYTES_PER_S
        t_ops = 4.0 * n / PEAK_OPS_PER_S["float32"]  # add, exp, add, divide
        bound_ms += 1e3 * max(t_bytes, t_ops)
        bytes_s, ops_s = bytes_s + t_bytes, ops_s + t_ops
        print(f"  {'x'.join(map(str, y.shape)):>16} | {1e3 * t_k:7.2f} "
              f"{1e3 * t_lib:7.2f} {1e6 * max(t_bytes, t_ops):7.2f} "
              f"{1e3 * (t_k - floor_ms):7.2f}", flush=True)
    report["bias_silu"] = dict(
        calls=len(calls["bias_silu"]), max_abs_err=errs["bfloat16"],
        max_abs_err_f32=errs["float32"], ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, bound_ms=bound_ms, floor_ms=floor_ms,
        bound_by="bytes" if bytes_s >= ops_s else "operations")

    # NMS keep mask: the path's own inputs, then seeded boxes at B = 8,
    # K = 256, 70% valid (the seeded case of every earlier run), exact.
    mismatches = 0
    for (boxes, classes, valid, t), _ in calls["nms_keep"]:
        mismatches += int((nms_cuda.nms_keep(boxes, classes, valid, t)
                           != nms_cuda.nms_keep_plain(boxes, classes, valid, t)
                           ).sum())
    g = torch.Generator().manual_seed(0)
    boxes = torch.rand(8, 256, 4, generator=g) * 416
    boxes[..., 2:] = boxes[..., 2:] * 0.4 + 20
    classes = torch.randint(0, 4, (8, 256), generator=g)
    valid = (torch.rand(8, 256, generator=g) > 0.3).to(dev)
    boxes, classes = boxes.to(dev), classes.to(dev, torch.int32)
    keep = nms_cuda.nms_keep(boxes, classes, valid, thr)
    mismatches += int((keep != nms_cuda.nms_keep_plain(
        boxes, classes, valid, thr)).sum())
    require(mismatches == 0, f"nms_keep: {mismatches} keep entries differ "
                             "from the plain version (must be exact)")
    # Where the time goes: the same launch with no valid candidate (stage,
    # launch and output only), and with every box of its own class (no IoU
    # to compute; the scan keeps every valid box).
    none = torch.zeros_like(valid)
    t_none = time_ms(torch, lambda: nms_cuda.nms_keep(boxes, classes, none,
                                                      thr))
    own = torch.arange(256, dtype=torch.int32, device=dev).expand(8, 256)
    own = own.contiguous()
    t_own = time_ms(torch, lambda: nms_cuda.nms_keep(boxes, own, valid, thr))
    print(f"nms_keep seeded case, us a launch: no valid candidate "
          f"{1e3 * t_none:.2f}, one class a box {1e3 * t_own:.2f}", flush=True)
    nbytes, nops = nms_bound(boxes, classes, valid, thr)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / PEAK_OPS_PER_S["float32"]
    report["nms_keep"] = dict(
        calls=len(calls["nms_keep"]), max_abs_err=0.0, max_abs_err_f32=0.0,
        ms=time_ms(torch, lambda: nms_cuda.nms_keep(boxes, classes, valid, thr)),
        plain_ms=time_ms(torch, lambda: nms_cuda.nms_keep_plain(
            boxes, classes, valid, thr), iters=10),
        library_ms=None, bound_ms=1e3 * max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        floor_ms=floor_ms, kept=int(keep.sum()), valid=int(valid.sum()))
    print(f"nms_keep seeded case (B 8, K 256): {report['nms_keep']['valid']} "
          f"valid, {report['nms_keep']['kept']} kept; bound {nbytes} bytes "
          f"({1e6 * t_bytes:.4f} us), {nops} f32 operations "
          f"({1e6 * t_ops:.4f} us); launch floor {1e3 * floor_ms:.2f} us",
          flush=True)
    for name, r in report.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        tol = ("exact" if name == "nms_keep" else
               f"(atol, rtol) bf16 {TOLERANCE[(name, 'bfloat16')]} "
               f"f32 {TOLERANCE[(name, 'float32')]}")
        simt = (f" simt_ms={r['ms_simt']:.4f} routes={r['routes']}"
                if "ms_simt" in r else "")
        if "floor_ms" in r:
            simt = f" launch_floor_ms={r['floor_ms']:.4f}"
        print(f"kernel {name}: calls/step={r['calls']} max_abs_err "
              f"bf16={r['max_abs_err']:.3g} f32={r['max_abs_err_f32']:.3g} "
              f"(tolerance {tol}) kernel_ms={r['ms']:.4f}{simt} "
              f"plain_ms={r['plain_ms']:.4f} library_ms={lib} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
    return report


def _iou_to(d, boxes: np.ndarray) -> np.ndarray:
    """IoU of one center-format detection with (N, 4) cxcywh boxes."""
    ix = np.maximum(np.minimum(d[0] + d[2] / 2, boxes[:, 0] + boxes[:, 2] / 2)
                    - np.maximum(d[0] - d[2] / 2, boxes[:, 0] - boxes[:, 2] / 2), 0)
    iy = np.maximum(np.minimum(d[1] + d[3] / 2, boxes[:, 1] + boxes[:, 3] / 2)
                    - np.maximum(d[1] - d[3] / 2, boxes[:, 1] - boxes[:, 3] / 2), 0)
    inter = ix * iy
    return inter / (d[2] * d[3] + boxes[:, 2] * boxes[:, 3] - inter + 1e-9)


def _rows(dets) -> np.ndarray:
    """Detections as (N, 6) rows: cx, cy, w, h, confidence, class."""
    return np.array([[d.x, d.y, d.width, d.height, d.confidence, d.class_id]
                     for d in dets], np.float64).reshape(-1, 6)


def twin_match(ref: np.ndarray, other: np.ndarray):
    """Pair each row of `ref` with its own twin in `other`: the unused row of
    highest IoU, a twin when IoU > 0.85, the class is the same and the
    confidence is within 0.03 (the twin test of
    tests/test_model_parity.py:137-191). Returns (unmatched ref rows,
    unmatched other rows, worst IoU, worst confidence delta) over the
    pairs made."""
    used, lost, worst_iou, worst_conf = set(), [], 1.0, 0.0
    for i, d in enumerate(ref):
        iou = _iou_to(d, other[:, :4]) if len(other) else np.zeros(0)
        iou[list(used)] = -1.0
        j = int(np.argmax(iou)) if len(iou) else -1
        if (j < 0 or iou[j] <= 0.85 or other[j, 5] != d[5]
                or abs(other[j, 4] - d[4]) >= 0.03):
            lost.append(i)
            continue
        used.add(j)
        worst_iou = min(worst_iou, float(iou[j]))
        worst_conf = max(worst_conf, float(abs(other[j, 4] - d[4])))
    extra = [j for j in range(len(other)) if j not in used]
    return lost, extra, worst_iou, worst_conf


def boundary_candidates(torch, eng32, frames: np.ndarray, conf: float,
                        nms: float) -> list:
    """The f32 decisions that sit on one of the postprocess's thresholds,
    per frame (square frames at the model size, so candidate boxes need no
    un-letterboxing). Returns, per frame, (candidates as _rows plus two
    columns: weighted score, greatest IoU with a kept higher-ranked box of
    the class; edge; tie):

    edge[c]: candidate c's weighted score is within the gate's 0.03 of the
      confidence threshold, or its greatest IoU with a kept higher-ranked
      box of its class is within 0.01 of the NMS threshold: whether it is
      kept goes either way with rounding.
    tie[c, d]: c and d are of one class, overlap beyond the NMS threshold
      and score within 0.01 of each other: which of the two is kept (their
      rank) goes either way with rounding.

    bf16 moves a box edge by about 1e-3 of the frame, a pair's IoU by a few
    1e-3 and a score by up to 1e-2, in any implementation."""
    from zero_latency_yolo_tpu_torch.models.yolov8 import forward_decoded
    from zero_latency_yolo_tpu_torch.ops import nms as nms_mod
    from zero_latency_yolo_tpu_torch.ops.nms_cuda import greedy_nms_mask_plain
    from zero_latency_yolo_tpu_torch.ops.preprocess import letterbox_batch_mxu
    from zero_latency_yolo_tpu_torch.runtime.engine import full_f32_precision
    size = frames.shape[1]
    dev = eng32.device
    with torch.inference_mode(), full_f32_precision():
        hw = torch.full((len(frames),), size, dtype=torch.int32, device=dev)
        x = letterbox_batch_mxu(torch.from_numpy(frames).to(dev), hw, hw, size)
        pred = forward_decoded(eng32._params, eng32.spec, x)
        boxes, scores, classes, valid = nms_mod._select_one(
            pred, eng32._class_weights, conf - 0.03, eng32.pre_nms_topk)
        iou = nms_mod._iou_matrix_center(boxes)
        same = classes[:, :, None] == classes[:, None, :]
        keep = greedy_nms_mask_plain(iou, same, valid & (scores >= conf), nms)
        k = keep.shape[1]
        above = torch.ones(k, k, dtype=torch.bool, device=dev).triu(1)
        sup = torch.where(keep[:, :, None] & same & above[None], iou,
                          torch.zeros((), device=dev)).amax(dim=1)
        edge = ((scores - conf).abs() < 0.03) | ((sup - nms).abs() < 0.01)
        tie = (same & (iou > nms) & ~torch.eye(k, dtype=torch.bool, device=dev)
               & ((scores[:, :, None] - scores[:, None, :]).abs() < 0.01))
    out = []
    for f in range(len(frames)):
        v = valid[f].cpu().numpy()
        sc = scores[f].cpu().numpy()[v]
        rows = np.concatenate([
            boxes[f].cpu().numpy()[v] / size, np.minimum(sc, 1.0)[:, None],
            classes[f].cpu().numpy()[v][:, None], sc[:, None],
            sup[f].cpu().numpy()[v][:, None]], axis=1)
        out.append((rows, edge[f].cpu().numpy()[v],
                    tie[f].cpu().numpy()[v][:, v]))
    return out


def _twin_ids(d: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Indices of the rows that pass the twin test against detection d."""
    if not len(rows):
        return np.zeros(0, int)
    ok = ((_iou_to(d, rows[:, :4]) > 0.85) & (rows[:, 5] == d[5])
          & (np.abs(rows[:, 4] - d[4]) < 0.03))
    return np.flatnonzero(ok)


def bf16_gate(torch, eng16, eng32, reqs, frames, conf: float, nms: float):
    """bf16 against f32 at detection level, per frame.

    literal: the gate of tests/test_model_parity.py:137-191 (same count,
    a twin for every detection).
    margin: every detection of either run has a twin in the other, except
    a detection that twins an f32 candidate on the edge of a threshold, and
    a pair (one detection of each run) that twins two f32 candidates tied
    in rank (boundary_candidates); those are counted as excused and
    described in `notes`.
    """
    rb = eng16.infer_batch(reqs)
    rf = eng32.infer_batch(reqs)
    bounds = boundary_candidates(torch, eng32, frames, conf, nms)
    literal, margin, excused, notes = [], [], [], []
    worst_iou, worst_conf = 1.0, 0.0
    for n, (f, b, (cand, edge, tie)) in enumerate(zip(rf, rb, bounds)):
        fr, br = _rows(f.detections), _rows(b.detections)
        lost, extra, wi, wc = twin_match(fr, br)
        worst_iou, worst_conf = min(worst_iou, wi), max(worst_conf, wc)
        literal.append(not lost and not extra)
        odd_f, odd_b = [], []
        for run, odd, dets in (("f32", odd_f, [fr[i] for i in lost]),
                               ("bf16", odd_b, [br[j] for j in extra])):
            for d in dets:
                ids = _twin_ids(d, cand[:, :6])
                on_edge = ids[edge[ids]]
                if len(on_edge):
                    c = cand[on_edge[0]]
                    notes.append(f"frame {n}: {run}-only class {int(d[5])} "
                                 f"conf {d[4]:.4f}, f32 candidate score "
                                 f"{c[6]:.4f}, IoU with a kept box {c[7]:.4f}")
                else:
                    odd.append(d)
        for d in list(odd_f):
            ids = _twin_ids(d, cand[:, :6])
            for e in odd_b:
                pair = np.argwhere(tie[np.ix_(ids, _twin_ids(e, cand[:, :6]))])
                if len(pair):
                    c1 = cand[ids[pair[0][0]]]
                    c2 = cand[_twin_ids(e, cand[:, :6])[pair[0][1]]]
                    notes.append(f"frame {n}: class {int(d[5])} twin anchors "
                                 f"swapped, f32 scores {c1[6]:.4f} and "
                                 f"{c2[6]:.4f}")
                    odd_f = [x for x in odd_f if x is not d]
                    odd_b = [x for x in odd_b if x is not e]
                    break
        excused.append(len(lost) + len(extra) - len(odd_f) - len(odd_b))
        margin.append(not odd_f and not odd_b)
    return dict(literal=literal, margin=margin, excused=excused, notes=notes,
                counts_bf16=[len(r.detections) for r in rb],
                counts_f32=[len(r.detections) for r in rf],
                worst_iou=worst_iou, worst_conf=worst_conf)


def frame_requests(request_cls, frames) -> list:
    """One request a frame, client and frame ids 1.., 0.."""
    return [request_cls(client_id=i + 1, frame_id=i, timestamp=i,
                        width=f.shape[1], height=f.shape[0], data=f)
            for i, f in enumerate(frames)]


def fixture_frames(fx) -> dict:
    """The JAX fixture's two batches, remade from its seeds
    (tests/torch_fixtures/make_jax_fixture.py makes them the same way)."""
    return {"task": list(task_frames(8, 416, seed=int(fx["task_seed"]))),
            "game": [synthetic_frame(800, 600, seed=int(s), t=0.3 * int(s))
                     for s in fx["game_seeds"]]}


def fixture_config(cfg, fx):
    """The config the fixture was made with: cfg in f32, with the fixture's
    task bucket in front of its frame buckets."""
    out = copy.deepcopy(cfg)
    out.tpu.dtype = "float32"
    out.tpu.frame_buckets = ([[int(v) for v in fx["task_bucket"]]]
                             + [list(b) for b in cfg.tpu.frame_buckets])
    return out


def _packed_rows(u: dict, f: int) -> np.ndarray:
    n = int(u["count"][f])
    return np.concatenate([u["boxes"][f, :n], u["scores"][f, :n, None],
                           u["classes"][f, :n, None]], axis=1).astype(np.float64)


def fixture_gate(got: np.ndarray, want: np.ndarray, conf: float,
                 nms: float) -> dict:
    """A packed f32 step (B, 1 + 6*32) against the JAX step's, frame by frame.

    strict: the 1e-3 gate of tests/test_model_parity.py:54-63 (counts and
    classes equal, boxes and scores within 1e-3).
    ok: strict, or the same detections in another order (each paired with
    one of its class within 1e-3), or every detection left unpaired sits on
    a threshold in f32: its score within 1e-3 of the confidence threshold,
    or its IoU with a detection of its class of the other run within 1e-3
    of the NMS threshold. `notes` lists each such detection with both
    margins, excused or not."""
    from zero_latency_yolo_tpu_torch.ops.nms import unpack_outputs
    g, w = unpack_outputs(got), unpack_outputs(want)
    strict, ok, notes = [], [], []
    box_err = score_err = 0.0
    for f in range(len(w["count"])):
        gr, wr = _packed_rows(g, f), _packed_rows(w, f)
        if len(gr) == len(wr) and np.array_equal(gr[:, 5], wr[:, 5]):
            be = float(np.abs(gr[:, :4] - wr[:, :4]).max(initial=0.0))
            se = float(np.abs(gr[:, 4] - wr[:, 4]).max(initial=0.0))
            box_err, score_err = max(box_err, be), max(score_err, se)
            if be < 1e-3 and se < 1e-3:
                strict.append(True)
                ok.append(True)
                continue
        strict.append(False)
        used, odd = set(), []
        for d in wr:
            close = [j for j in range(len(gr)) if j not in used
                     and gr[j, 5] == d[5]
                     and np.abs(gr[j, :5] - d[:5]).max() < 1e-3]
            if close:
                used.add(close[0])
            else:
                odd.append(("JAX", d, gr))
        odd += [("port", gr[j], wr) for j in range(len(gr)) if j not in used]
        if not odd:
            notes.append(f"frame {f}: the same detections in another order")
        bad = 0
        for run, d, other in odd:
            mates = other[other[:, 5] == d[5]]
            iou = float(_iou_to(d, mates[:, :4]).max(initial=0.0))
            on_edge = abs(d[4] - conf) < 1e-3 or abs(iou - nms) < 1e-3
            bad += not on_edge
            notes.append(
                f"frame {f}: {run}-only class {int(d[5])} conf {d[4]:.6f} "
                f"(minus the confidence threshold {d[4] - conf:+.3e}), "
                f"greatest IoU with a class-{int(d[5])} detection of the "
                f"other run {iou:.6f} (minus the NMS threshold "
                f"{iou - nms:+.3e}): "
                + ("excused, on a threshold" if on_edge else "not excused"))
        ok.append(bad == 0)
    return dict(strict=strict, ok=ok, notes=notes, box_err=box_err,
                score_err=score_err, counts=g["count"].tolist(),
                counts_jax=w["count"].tolist())


def server_frames() -> list:
    """Eight 160x120 frames: four of the task the weights were trained on
    (cropped from 160x160), four synthetic game frames."""
    w, h = SERVER_FRAME
    task = [np.ascontiguousarray(f[:h]) for f in task_frames(4, w, seed=31)]
    return task + [synthetic_frame(w, h, seed=40 + i, t=0.4 * i)
                   for i in range(4)]


def launch_counts() -> dict:
    from zero_latency_yolo_tpu_torch.ops import act_cuda, conv1x1_cuda, nms_cuda
    return {"nms_keep": nms_cuda.launches,
            "conv1x1_bias_act": conv1x1_cuda.launches,
            "conv1x1_wgmma": conv1x1_cuda.launches_by_route["wgmma"],
            "bias_silu": act_cuda.launches}


def reset_launch_counts() -> None:
    from zero_latency_yolo_tpu_torch.ops import act_cuda, conv1x1_cuda, nms_cuda
    nms_cuda.launches = conv1x1_cuda.launches = act_cuda.launches = 0
    conv1x1_cuda.launches_by_route = {r: 0 for r in conv1x1_cuda.ROUTES}


def server_phase(torch, device: str, smi_line: str) -> dict:
    """Phase 5 (see the module docstring). Returns the load's numbers and
    the launches it made."""
    from zero_latency_yolo_tpu_torch.bench_server import (
        ServerThread, deployed_config, http_get, run_load)
    from zero_latency_yolo_tpu_torch.protocol import FrameDataPacket, native
    from zero_latency_yolo_tpu_torch.runtime import frames as frames_mod
    from zero_latency_yolo_tpu_torch.runtime.adapters import get_adapter
    from zero_latency_yolo_tpu_torch.runtime.engine import InferenceRequest
    from zero_latency_yolo_tpu_torch.runtime.server import DetectionServer
    from zero_latency_yolo_tpu_torch.runtime.simulator import SimClient

    codec = (f"native ({native._LIB._name})" if native.HAVE_NATIVE
             else "pure Python")
    has_cv2 = frames_mod.cv2 is not None
    print(f"server codec: {codec}; cv2 present: {has_cv2}", flush=True)
    require(native.HAVE_NATIVE, "the native codec did not build")
    w, h = SERVER_FRAME
    cfg = deployed_config(tracking=True)
    t_start = time.perf_counter()
    srv = ServerThread(DetectionServer(cfg, device=device)).start(warmup=True)
    server, engine = srv.server, srv.server.engine
    print(f"server up on udp/{server.port} (web {cfg.network.web_port}) in "
          f"{time.perf_counter() - t_start:.2f} s, warmup included; engine "
          f"{engine.status()['engine']} on {engine.device}, simulation "
          f"{engine.simulation}", flush=True)
    try:
        require(not engine.simulation, "server engine in simulation mode")
        reset_launch_counts()
        load = run_load(torch, server, "threads", SERVER_CLIENTS, SERVER_FPS,
                        SERVER_SECONDS)
        launches = launch_counts()
        code, body = http_get(cfg.network.web_port, "/statusz")
        require(code == 200, f"GET /statusz answered {code}")
        st = json.loads(body)
    finally:
        srv.stop()
    n_sent, results = sum(load["sent"]), load["results"]
    unaccounted = (n_sent - sum(results) - load["engine_drops"]
                   - load["kernel_drops"])
    print(f"server load: {SERVER_CLIENTS} clients (threads of this process) "
          f"x raw {w}x{h} frames at {SERVER_FPS:g} fps for {SERVER_SECONDS:g}"
          f" s: sent {n_sent}, server received {load['frames_received']}, "
          f"results {sum(results)} (per client {results}), engine drops "
          f"{load['engine_drops']}, kernel drops {load['kernel_drops']}, bad "
          f"packets {load['bad_packets']}; unaccounted {unaccounted} "
          f"(allowed 0..{SERVER_SLACK}); socket receive buffer "
          f"{load['rcvbuf']} B; the machine's UDP and IP drop counters over "
          f"the load {load['net']}", flush=True)
    print(f"server statusz: engine {st['engine']['engine']} on "
          f"{st['engine']['device']}, inferences {st['engine']['inferences']}, "
          f"errors {st['engine']['errors']}, avg batch "
          f"{st['engine']['avg_batch']}", flush=True)
    require(all(r > 0 for r in results), f"a client got no results: {results}")
    require(0 <= unaccounted <= SERVER_SLACK,
            f"{unaccounted} frames unaccounted for (the machine's counters "
            f"over the load: {load['net']})")
    require(st["engine"]["engine"] == "torch-cuda"
            and st["engine"]["device"].startswith(device)
            and st["engine"]["errors"] == "0",
            f"statusz engine status: {st['engine']}")
    print("server kernels: " + ", ".join(
        f"{k} launches={v}" for k, v in launches.items()), flush=True)
    require(all(launches[k] > 0 for k in KERNELS),
            f"a kernel was not launched while serving: {launches}")
    require(launches["conv1x1_wgmma"] == launches["conv1x1_bias_act"],
            f"bf16 1x1 convs off the tensor cores while serving: {launches}")
    idle = load["idle_share"]
    print(f"server on {smi_line}: detect latency p50 {load['p50_ms']:.3f} ms,"
          f" p99 {load['p99_ms']:.3f} ms (last {load['latency_samples']} "
          f"results, arrival to result sent); served "
          f"{load['results_per_s']:.1f} results/s; batch sizes "
          f"{load['batch_sizes']}; engine.dispatch host ms p50 "
          f"{load['dispatch_ms_p50']:.2f}, p90 {load['dispatch_ms_p90']:.2f}; "
          f"device busy {load['busy_ms']:.1f} ms of {load['wall_ms']:.1f} ms, "
          f"idle share {'not measured' if idle is None else f'{idle:.3f}'} "
          "(profiler, last second of the load)", flush=True)

    # Exactness: tracking off, one frame at a time, against infer_batch
    # through a fresh adapter of the same config.
    cfg2 = deployed_config(tracking=False)
    srv2 = ServerThread(DetectionServer(cfg2, engine=engine,
                                        device=device)).start(warmup=False)
    server2 = srv2.server
    frames = server_frames()
    c = SimClient(("127.0.0.1", server2.port), screen_width=w,
                  screen_height=h)
    try:
        c.connect()
        c.start_receiver()
        got = []
        for f in frames:
            fid = c.send_raw_frame(f)
            res = c.wait_results(len(got) + 1, timeout=30)
            require(len(res) == len(got) + 1 and res[-1].frame_id == fid,
                    f"frame {fid} unanswered")
            got.append(res[-1])
        # A JPEG keyframe: without cv2 a bad packet; serving goes on.
        bad0 = server2.bad_packets.value
        if has_cv2:
            c.send_jpeg_keyframe(frames[0])
        else:
            c._send(FrameDataPacket(
                frame_id=10 ** 6, frame_timestamp=0, width=w, height=h,
                keyframe=True,
                data=b"\xff\xd8\xff\xe0" + bytes(4096)).serialize())
            deadline = time.perf_counter() + 10
            while (server2.bad_packets.value == bad0
                   and time.perf_counter() < deadline):
                time.sleep(0.02)
            require(server2.bad_packets.value == bad0 + 1,
                    "a JPEG keyframe without cv2 did not count a bad packet")
        fid = c.send_raw_frame(frames[0])
        res = c.wait_results(len(got) + 1 + has_cv2, timeout=30)
        require(res and res[-1].frame_id == fid,
                "the server stopped serving after the JPEG keyframe")
        print(f"server JPEG keyframe (cv2 "
              f"{'present: served' if has_cv2 else 'absent: refused'}): bad "
              f"packets {bad0} -> {server2.bad_packets.value}; the next raw "
              "frame was served", flush=True)
    finally:
        c.stop()
        srv2.stop()
    game = next((n for n, g in cfg2.game_adapters.items() if g.enabled),
                "cs16")
    adapter = get_adapter(game, cfg2.game_adapters[game],
                          enable_tracking=False)
    adapter.register_client(1, w, h, 1)
    worst = 0.0
    counts = []
    for i, (f, r) in enumerate(zip(frames, got)):
        want = engine.infer_batch([InferenceRequest(
            client_id=1, frame_id=r.frame_id, timestamp=r.frame_timestamp,
            width=w, height=h, data=f)])[0].detections
        want = adapter.process_detections(1, want)[:32]
        counts.append(len(want))
        require(len(r.detections) == len(want)
                and [d.class_id for d in r.detections]
                == [d.class_id for d in want]
                and [d.track_id for d in r.detections]
                == [d.track_id for d in want],
                f"server frame {i}: {len(r.detections)} detections vs "
                f"infer_batch {len(want)}, or classes or ids differ")
        for a, b in zip(r.detections, want):
            worst = max(worst, *(abs(getattr(a, k) - getattr(b, k)) for k in
                                 ("x", "y", "width", "height", "confidence")))
    print(f"server exactness: 8 frames one at a time, tracking off, against "
          f"engine.infer_batch + a fresh adapter: counts {counts} equal, "
          f"classes and ids equal, max box/confidence difference "
          f"{worst:.3g} (tolerance 1e-3)", flush=True)
    require(worst <= 1e-3, "server results differ from infer_batch by more "
                           "than 1e-3")
    require(sum(counts) > 0, "exactness check vacuous: no detections")
    return dict(load, launches=launches)


def main() -> None:
    with Phase("device"):
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: no CUDA device")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
        smi_line = smi.stdout.strip().splitlines()[0]
        print(smi_line, flush=True)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]} "
              f"device {torch.cuda.get_device_name(0)}", flush=True)
        sys.path.insert(0, str(ROOT))
        from zero_latency_yolo_tpu_torch.config import ServerConfig
        from zero_latency_yolo_tpu_torch.ops import (_build, act_cuda,
                                                     conv1x1_cuda, nms_cuda)
        from zero_latency_yolo_tpu_torch.ops.nms import unpack_outputs
        from zero_latency_yolo_tpu_torch.runtime.engine import (
            InferenceEngine, InferenceRequest)
        dev = torch.device(DEVICE)

    with Phase("build"):
        k = _build.kernels()
        print(f"built {k.path.name} in {k.build_seconds:.2f} s (nvcc only)",
              flush=True)
        spills = []
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  ptxas: " + line.split("ptxas info    :")[-1].strip())
            if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" \
                    not in line:
                spills.append(line.strip())
        require(not spills, f"register spills: {spills}")
        require(k.build_seconds < 60.0,
                f"nvcc took {k.build_seconds:.1f} s (limit 60 s)")

    cfg = ServerConfig.load(str(CONFIG), create_if_missing=False)
    cfg.model_path = str(ROOT / cfg.model_path)
    bucket = (608, 800)

    def staged(frames):
        b = len(frames)
        buf = np.zeros((b,) + bucket + (3,), np.uint8)
        for i, f in enumerate(frames):
            buf[i, :f.shape[0], :f.shape[1]] = f
        hs = torch.tensor([f.shape[0] for f in frames], dtype=torch.int32,
                          device=dev)
        ws = torch.tensor([f.shape[1] for f in frames], dtype=torch.int32,
                          device=dev)
        return torch.from_numpy(buf).to(dev), hs, ws

    with Phase("kernels"):
        engine = InferenceEngine(cfg, device=DEVICE)
        require(not engine.simulation, f"engine in simulation mode: "
                                       f"{cfg.model_path} did not load")
        with torch.inference_mode():
            frames_d, hs, ws = staged([synthetic_frame(800, 600, seed=s)
                                       for s in range(4, 12)])
            calls = record_path_calls(engine, frames_d, hs, ws)
            require(len(calls["conv1x1_bias_act"]) == 24
                    and len(calls["bias_silu"]) == 39
                    and len(calls["nms_keep"]) == 1,
                    f"unexpected path: {[(n, len(c)) for n, c in calls.items()]}")
            report = check_kernels(torch, calls, cfg.nms_threshold, dev)
            torch.cuda.synchronize()
        del calls

    with Phase("main path"):
        engine.warmup()
        reqs = [InferenceRequest(client_id=i + 1, frame_id=i, timestamp=i,
                                 width=w, height=h,
                                 data=synthetic_frame(w, h, seed=4 + i, t=0.3 * i))
                for i, (w, h) in enumerate([(800, 600)] * 11 + [(1920, 1080)] * 2)]
        nms_cuda.launches = conv1x1_cuda.launches = act_cuda.launches = 0
        conv1x1_cuda.launches_by_route = {r: 0 for r in conv1x1_cuda.ROUTES}
        results = engine.infer_batch(reqs)
        pend = [engine.dispatch(reqs[:4]), engine.dispatch(reqs[4:8])]
        results += [r for rs in engine.complete_many(pend) for r in rs]
        torch.cuda.synchronize()
        launches = {"nms_keep": nms_cuda.launches,
                    "conv1x1_bias_act": conv1x1_cuda.launches,
                    "bias_silu": act_cuda.launches}
        by_route = dict(conv1x1_cuda.launches_by_route)
        print(f"main path: {len(results)} results from 5 steps, launches "
              f"{launches}, conv1x1 by route {by_route}", flush=True)
        require(len(results) == len(reqs) + 8, "missing results")
        require(all(n > 0 for n in launches.values()),
                f"a kernel was not launched on the main path: {launches}")
        require(by_route["wgmma"] == launches["conv1x1_bias_act"],
                f"bf16 1x1 convs off the tensor cores: {by_route}")
        ndet = sum(len(r.detections) for r in results)
        require(ndet > 0, "no detections on the main path")
        require(all(0.0 <= v <= 1.0 for r in results for d in r.detections
                    for v in (d.x, d.y, d.width, d.height, d.confidence)),
                "a detection outside [0, 1]")
        print(f"main path: {ndet} detections, classes "
              f"{sorted({d.class_id for r in results for d in r.detections})}",
              flush=True)

        # f32: the step with kernels against the step with plain versions.
        cfg32 = copy.deepcopy(cfg)
        cfg32.tpu.dtype = "float32"
        eng32 = InferenceEngine(cfg32, device=DEVICE)
        frames_d, hs, ws = staged([synthetic_frame(800, 600, seed=s, t=0.3 * s)
                                   for s in range(4, 12)])
        args = (eng32._params, frames_d, hs, ws, eng32._class_weights,
                cfg.confidence_threshold, cfg.nms_threshold)
        got = eng32.get_step(8, bucket)(*args).cpu().numpy()
        want = eng32._build_step(plain=True)(*args).cpu().numpy()
        require(got.shape == (8, 1 + 6 * 32) and np.isfinite(got).all(),
                f"packed output {got.shape} not finite (8, 193)")
        g, w = unpack_outputs(got), unpack_outputs(want)
        require(np.array_equal(g["count"], w["count"]),
                f"f32 counts differ: {g['count']} vs plain {w['count']}")
        valid = np.arange(32)[None, :] < w["count"][:, None]
        require(np.array_equal(g["classes"][valid], w["classes"][valid]),
                "f32 classes differ from the plain step")
        box_err = float(np.abs(g["boxes"] - w["boxes"])[valid].max(initial=0))
        score_err = float(np.abs(g["scores"] - w["scores"])[valid].max(initial=0))
        print(f"f32 kernels vs plain: counts {w['count'].tolist()} equal, "
              f"classes equal, max box err {box_err:.3g}, max score err "
              f"{score_err:.3g} (tolerance 1e-3)", flush=True)
        require(box_err < 1e-3 and score_err < 1e-3,
                "f32 boxes or scores outside 1e-3 of the plain step")

        # f32 against the JAX package's f32 step (the committed fixture),
        # under PyTorch's default TF32 settings: only the step's own switch
        # to full f32 keeps its convs out of TF32.
        require(torch.backends.cudnn.allow_tf32,
                "cuDNN TF32 is not at PyTorch's default (on)")
        fx = np.load(FIXTURE)
        conf, nms = cfg.confidence_threshold, cfg.nms_threshold
        require(float(fx["confidence_threshold"]) == conf
                and float(fx["nms_threshold"]) == nms,
                "the fixture's thresholds are not the config's")
        engfx = InferenceEngine(fixture_config(cfg, fx), device=DEVICE)
        for name, frames in fixture_frames(fx).items():
            out = engfx.dispatch(frame_requests(InferenceRequest, frames)).out
            gate = fixture_gate(out.cpu().numpy(), fx[name], conf, nms)
            print(f"f32 step vs JAX f32 step ({name} frames, fixture): "
                  f"counts {gate['counts']} vs {gate['counts_jax']}; 1e-3 "
                  f"gate per frame {gate['strict']}; max box err "
                  f"{gate['box_err']:.3g}, max score err "
                  f"{gate['score_err']:.3g}; passed per frame {gate['ok']}",
                  flush=True)
            for note in gate["notes"]:
                print(f"  {note}", flush=True)
            require(sum(gate["counts_jax"]) > 0,
                    f"fixture gate vacuous on the {name} frames")
            require(all(gate["ok"]), f"f32 step differs from the JAX f32 "
                                     f"step on the {name} frames")
        del engfx

        # bf16 against f32, detection level, on frames of the task the
        # weights were trained on (as tests/test_model_parity.py:137-191).
        task = task_frames(8, 416, seed=777)
        treqs = frame_requests(InferenceRequest, list(task))
        g = bf16_gate(torch, engine, eng32, treqs, task, conf, nms)
        print(f"bf16 vs f32 (task frames): counts {g['counts_bf16']} vs "
              f"{g['counts_f32']}; literal gate per frame {g['literal']}; "
              f"margin gate per frame {g['margin']} (detections decided on "
              f"a threshold, excused: {g['excused']}); worst twin IoU "
              f"{g['worst_iou']:.4f}, worst conf delta {g['worst_conf']:.4f}",
              flush=True)
        for note in g["notes"]:
            print(f"  on a threshold: {note}", flush=True)
        require(sum(g["counts_f32"]) > 0, "bf16 gate vacuous: no detections")
        require(all(g["margin"]), "bf16 detection gate failed")
        # The game frames, reported and not gated: the weights were not
        # trained on them.
        rb, rf = engine.infer_batch(reqs), eng32.infer_batch(reqs)
        lit = [twin_match(_rows(f.detections), _rows(b.detections))[:2]
               for f, b in zip(rf, rb)]
        print(f"bf16 vs f32 (game frames, not gated): literal gate "
              f"{sum(not a and not b for a, b in lit)}/{len(lit)} frames; "
              f"counts {[len(r.detections) for r in rb]} vs "
              f"{[len(r.detections) for r in rf]}", flush=True)

        step_ms, step_prof = {n: None for n in KERNELS}, None
        for b in engine.batch_buckets:
            frames_d, hs, ws = staged([synthetic_frame(800, 600, seed=s)
                                       for s in range(b)])
            step = engine.get_step(b, bucket)

            def run():
                return step(engine._params, frames_d, hs, ws,
                            engine._class_weights, cfg.confidence_threshold,
                            cfg.nms_threshold)
            wall = wall_ms(torch, run)
            prof, own = profile_step(torch, run, top=14 if b == 8 else 0)
            pwall, busy = prof["wall_ms"], prof["busy_ms"]
            if b == 8:
                step_ms, step_prof = own, prof
                print("in-step device time, batch 8 (profiler): " + ", ".join(
                    f"{n} {ms:.4f} ms/step" for n, ms in own.items()),
                    flush=True)
                print(f"step batch 8: {prof['kernels']} CUDA kernels "
                      f"launched a step; NMS stage {prof['nms_stage_ms']:.4f} "
                      f"ms device time in {prof['nms_stage_kernels']:g} "
                      "kernels a step (profiler)", flush=True)
                require(prof["nms_stage_ms"] >= own["nms_keep"] > 0,
                        "the NMS kernel is not inside the profiled NMS stage")
                require(not any("nms_suppress_kernel" in key
                                for _, _, key in prof["rows"]),
                        "the earlier NMS scan kernel ran in the step")
            print(f"step bf16 batch {b} bucket {bucket[0]}x{bucket[1]}: wall "
                  f"{wall:.3f} ms/batch ({wall / b:.3f} ms/frame); device "
                  f"busy {busy:.3f} ms/batch (profiler; wall under it "
                  f"{pwall:.3f} ms), idle share {max(0.0, 1 - busy / wall):.3f}",
                  flush=True)

    with Phase("server"):
        server_phase(torch, DEVICE, smi_line)

    print("kernels: " + ", ".join(f"{n} launches={launches[n]}"
                                  for n in KERNELS), flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": route, "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": report[name]["max_abs_err"],
         "ms": report[name]["ms"], "plain_ms": report[name]["plain_ms"],
         "bound_ms": report[name]["bound_ms"],
         "bound_by": report[name]["bound_by"],
         "library_ms": report[name]["library_ms"],
         "step_ms": step_ms[name],
         **({"nms_stage_ms": step_prof["nms_stage_ms"],
             "nms_stage_kernels": step_prof["nms_stage_kernels"],
             "floor_ms": report[name]["floor_ms"]}
            if name == "nms_keep" else {}),
         **({"launches_by_route": by_route, "ms_simt": report[name]["ms_simt"]}
            if name == "conv1x1_bias_act" else {})}
        for name, (route, source, replaces) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
