#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the repo root with one card: `python3 chip_smoke.py`. It needs a
CUDA device and nvcc, and imports torch, numpy, the stdlib and
`zero_latency_yolo_tpu_torch` only. Phases, in order; any failure raises
and the script exits non-zero:

1. device: a CUDA device must be present; prints the card's name and power
   limit as nvidia-smi reports them.
2. build: nvcc builds csrc/*.cu into one library (ops/_build.py; one
   compile a source, all at once, then one link), in under 60 s and with no
   register spills.
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
5. frame cache: the port's DeviceFrameCache on the card at the deployed
   geometry (10 slots of 1080x1920): 8 clients' 720x1280 keyframes, then
   in one flush three overlapping ROIs of one slot, an ROI at a frame's
   corner and a full-frame ROI; a slot frozen by a shed; a slot released
   and reused. After each step the card's cache must equal, byte for byte,
   the same writes composited on the host in NumPy. Then
   dispatch_from_cache at batch 8 (real weights) must equal, to the last
   bit, dispatch on the composited frames (both at the 1080x1920 bucket),
   with every kernel's count reset just before and read just after, each
   > 0; it must return with the stream still busy (a torch.cuda._sleep
   queued before it). Printed: the flush's host and device time for 1, 8
   and 64 ROI writes and 1 and 8 keyframes; the lock hold of the server's
   flush (8 keyframes of 160x120 and the gather); the cached step (gather
   + step at 1080x1920) beside the hosted step at 608x800, wall and device
   busy, at batch 1/2/4/8; the letterbox's device time at both buckets.
6. server: the port's DetectionServer in this process on the card, with
   the deployed config (free loopback ports, warmup), driven over loopback
   UDP by the port's SimClient: 8 clients handshake and stream raw 160x120
   frames at 60 fps for 4 s from client threads; twice, first with the
   device frame cache (the default: every frame is written to the cache
   and every batch gathered out of it), then without it. Gates, each run:
   every client gets results; frames sent = results + the drops /statusz
   counts (engine drops and the kernel's receive-buffer drops), short by
   at most SERVER_SLACK frames; each kernel's launch count rose during the
   load (the 1x1 GEMM on the tensor cores); GET /statusz answers 200 with
   the engine's status, and with the cache its frame_cache shows one slot
   a client during the load and none after the clients left; the native
   codec served. Then a server on the same engine with tracking off,
   without the cache, serves 8 raw frames one at a time, each result equal
   to engine.infer_batch on the same frame through a fresh adapter (counts,
   classes and ids equal; boxes and confidences within 1e-3); without cv2
   a JPEG keyframe raises bad_packets and the server keeps serving. And a
   server with the cache serves the 8 raw frames and, with cv2, a JPEG
   keyframe and an ROI update, each equal to engine.infer_batch_cached on
   the frame composited on the host. Printed, not gated: each load's detect
   latency p50 and p99, results a second, batch sizes, the host time of
   the step launch and (with the cache) of the lock hold, the device idle
   share (torch.profiler), beside the card's name and power limit; each
   load's launches on a `server ... kernels:` line.
7. ladder, yolov8s@640: configs/examples/server-16stream-640-s.json
   (yolov8s, 640 with a 512 rung, bf16, pre_nms_topk 128, real weights).
   The card's f32 step at each rung against the JAX package's f32 step
   (the committed fixture tests/torch_fixtures/jax_f32_step_s640.npz,
   batch 4 of task and game frames; fixture_gate); the bf16 detection gate
   against f32 at each rung (bf16_gate, task frames drawn at the rung's
   size); every kernel against its plain version on the batch-16 640
   step's own inputs (check_kernels, NMS at K = 128); the path through the
   entry points (16 frames at 640 through infer_batch, 16 at 512 through
   dispatch(size=512)) with each kernel's count reset just before and read
   just after, each > 0 and every 1x1 on the tensor cores; wall time,
   device time (CUDA events) and device busy time (profiler) of the step
   at each rung at batch 1, 8 and 16, the cached step at batch 16 over the
   1080x1920 cache, and the phase's peak device memory.
8. step variants: yolov8n at 416 (the deployed config), real weights, batch
   8, f32: tpu.preprocess "letterbox" and "stretch", tpu.select "perlevel",
   tpu.c2f "split" and tpu.stem "s2d", each one batch through dispatch with
   the counts reset just before and read just after (each > 0), and the
   step with kernels against the step with plain versions (counts and
   classes equal, boxes and scores within 1e-3); its packed output against
   the default step's is printed, not gated (another computation). Then
   tpu.c2f "auto" at batch 32 in bf16, which resolves to the split form:
   50 1x1 GEMM, 47 bias+SiLU and 1 NMS launches a step, on the tensor
   cores, and the bf16 detection gate against the f32 default step.
9. adaptive policy: configs/examples/server-64stream-adaptive.json (yolov8n,
   416 with a 320 rung). warmup certifies both rungs; dispatch/complete
   with the SLO at 0.001 ms must step down to 320, where a batch equals, to
   the last bit, infer_batch of an engine of model size 320; with the SLO
   at 10 s it must step back up. Then one load of phase 6's clients on the
   cached default server of that config with its SLO at 1 ms (below any
   p99 the load reaches): the gates of phase 6's loads, size_downshifts >=
   1 in /statusz, results at both rungs, and every batch stepped under the
   load replayed (the step at its rung on its frames) equal to the last
   bit to what it served.
10. weights .pt/.onnx: a seeded yolov8n tree written as `.npz`, as a
   state-dict `.pt` and as an `.onnx` initializer file; an engine booted on
   each serves the model (not simulation), and the `.pt` and `.onnx`
   engines' steps equal the `.npz` engine's to the last bit.
11. int8: the deployed config with tpu.quantize_int8 (batch buckets
   1/2/4/8/16/32). The f32 int8 engine's own calibration against the JAX
   package's (the committed fixture tests/torch_fixtures/
   jax_int8_f32_step_416.npz: m1 within 1e-5, every conv within
   CALIB_STEPS int8 steps of the jitted run's); its step, with the JAX
   calibration carried across, against the JAX int8 step at detection
   level (int8_fixture_gate: at most twice the detections without a twin
   that the JAX package's own jitted run and its run op by op have between
   them). The int8
   conv kernel against its plain version at every int8 call of the bf16
   batch-8 and batch-16 steps, in bf16 and f32 (int32 accumulators equal,
   outputs within one ulp), and once with a dynamic device scale; its
   back-to-back time, plain time, bound (bytes at 3.35 TB/s, int8
   operations at 1,979 TOPS) and torch._int_mm's time on the 1x1 calls it
   accepts. The bf16 int8 forward against the bf16 and f32 forwards
   without int8 (mean probability error and median box error under 0.05,
   tests/test_quant.py's limits), and the detections against bf16 (not
   gated). The int8 path through the entry points (infer_batch, dispatch /
   complete_many, infer_batch_cached, a hot reload re-quantized and
   re-calibrated) with every count reset just before and read just after,
   all four kernels > 0; a step's launches at batch 8 and at batch 32
   (c2f auto resolves to split; int8 blocks run the slice form): 44 int8
   convs, 6 1x1 (tensor cores), 13 bias+SiLU, 1 NMS. Device busy, device
   and wall time of the int8 and the bf16 step at batch 1, 8 and 16. The
   int8 server: a load of phase 6's clients on the cached default server
   with its gates, the exactness of its results without and with the
   cache, then a second load during which /profilez captures
   PROFILEZ_CAPTURES times from PROFILEZ_DELAY on (each ok, each trace
   naming all four kernels; a POST during the first answers 409) and the
   load's gates still hold.
12. train: the port's trainer (`train/`). f32: yolov8n at 416, batch 2,
   3 steps of the const chain with the EMA on, from the JAX package's
   init, against the JAX package's steps (the committed fixture
   tests/torch_fixtures/jax_train_f32_n416.npz: losses, and each leaf's
   norm and probe of step 1's gradient and of the params and EMA after;
   train_fixture_gate, TRAIN_TOL), under PyTorch's default TF32 settings.
   bf16 at full width: yolov8n at 416, batch 16, TRAIN_STEPS steps on the
   synthetic task with the center and the TAL assigner (every loss finite,
   the loss falls); yolov8s at 640, batch 16, TRAIN_S640_STEPS steps
   (finite); printed, not gated: wall ms a step and images/s, device busy
   ms and the top kernels (profiler), peak memory, beside the card's name
   and power limit. A checkpoint at step TRAIN_RESUME_AT restored into a
   fresh state and run to TRAIN_STEPS equals the uninterrupted run bit for
   bit (cuDNN deterministic, no autotuning), and the card's checkpoint
   restores on the CPU. evaluate of the center run's params in bf16 with
   the kernels against their plain versions (mAP and mAP50-95 equal), each
   kernel's launches reset just before and read just after (> 0, the 1x1
   on the tensor cores); the same for the deployed weights; and their f32
   evaluate against the JAX package's in the fixture (EVAL_TOL).
13. mesh: the deployed config on virtual 2x1 and 1x2 serving meshes over
   cuda:0 (`parallel/mesh.py`; `available_devices` replaced by a repeated
   cuda:0), at batch 8. f32, hosted (dispatch) and cached (a slot-sharded
   DeviceFrameCache whose every batch row's slots live on another data
   row's shard): counts and classes equal to the single-device engine's,
   boxes and scores within 1e-3 (cuDNN may pick another algorithm at a
   halved Cout), the largest differences printed; bf16 against the
   single-device f32 engine through bf16_gate. Every kernel against its
   plain version at data row 0's channel-sharded shapes (check_kernels),
   the 1x1 calls on the tensor cores out of all; the mesh path through
   the entry points (infer_batch and dispatch_from_cache) with the counts
   reset just before and read just after; the meshed step's device busy
   and wall time beside the single-device step's. Then both dp2 example
   configs boot on the card and serve a batch: on one card single-device,
   with the engine's warning; on two or more on a real mesh.
14. fleet: `python -m zero_latency_yolo_tpu_torch.serve_fleet` with two
   shards of the deployed config on one UDP port, both on the card (free
   loopback ports). Both shards' /statusz must show the engine warmed on
   cuda; the load of phase 6 (8 SimClients of raw 160x120 frames at 60 fps
   for 4 s) on the fleet's port: every client served, per shard received
   = results + engine drops, all clients' frames sent = the shards'
   results + engine drops + their sockets' own overflows (within
   SERVER_SLACK); each shard's results a second, detect latency p50 and
   p99 and system_udp printed. Then a SIGHUP roll under the same load, the
   clients re-handshaking on a drain notice: the roll completes, both
   shards respawn, every client is served after it, and the frames
   unaccounted for (sent, less the clients' results and the frames every
   shard process dropped or refused: its drops, cache rejects and frames
   from senders without a session, from the last count its stop() logs
   once the fleet is stopped with SIGTERM; and the datagrams the kernel
   dropped at a shard's full socket, by the sockets' own counts or, where
   they have none, the machine's Udp.RcvbufErrors over the roll) are at
   most those in flight at each change of the shard group; the roll's
   time, the longest gap between two results of a client, the accounting
   by shard process and a timeline of the roll's steps printed. The
   manager exits with rc 0 and no shard left.
15. report: a `kernels:` line, one JSON line of kernel numbers (launches on
   the main path (the int8 path for the int8 conv), and by path: main,
   frame cache, each server load, the ladder, each variant, the adaptive
   load, the int8 path, its steps and its server loads, the train eval,
   the mesh path; each kernel's
   numbers at the yolov8s 640 batch-16 shapes, the int8 conv's at the int8
   batch-16 shapes), and the result line `{"ok": true, "device": {...}}`
   last.
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
# The serve-size ladder's configs: yolov8s at 640 with its 512 rung, and its
# JAX fixture; yolov8n at 416 with its 320 rung under the adaptive policy.
CONFIG_S640 = ROOT / "configs" / "examples" / "server-16stream-640-s.json"
FIXTURE_S640 = ROOT / "tests" / "torch_fixtures" / "jax_f32_step_s640.npz"
CONFIG_ADAPTIVE = ROOT / "configs" / "examples" / "server-64stream-adaptive.json"
# The JAX package's int8 f32 step at 416 (yolov8n, the deployed weights),
# its calibrated scales, and the same step run op by op.
FIXTURE_INT8 = ROOT / "tests" / "torch_fixtures" / "jax_int8_f32_step_416.npz"
# The JAX package's f32 training at 416 (yolov8n, batch 2, 3 steps of the
# const chain with the EMA on) and its f32 evaluate of the deployed weights
# (tests/torch_fixtures/make_jax_fixture.py --only train).
FIXTURE_TRAIN = ROOT / "tests" / "torch_fixtures" / "jax_train_f32_n416.npz"

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
    # A port-side kernel: the JAX package's int8 conv is an XLA op (the
    # "w_q" branch of _conv), no Pallas kernel.
    "conv_int8": ("cuda", "zero_latency_yolo_tpu_torch/csrc/conv_int8_sm90.cu",
                  "zero_latency_yolo_tpu/models/yolov8.py:287"),
}
# The kernels every path without int8 launches (the int8 conv runs only
# with tpu.quantize_int8).
PATH3 = ("nms_keep", "conv1x1_bias_act", "bias_silu")
# The device functions of each kernel, as the profiler names them.
KERNEL_SYMBOLS = {
    "nms_keep": ("nms_keep_kernel",),
    "conv1x1_bias_act": ("conv1x1_wgmma_kernel", "mm_bias_act_kernel"),
    "bias_silu": ("bias_silu_vec_kernel", "bias_silu_kernel"),
    "conv_int8": ("conv_int8_kernel",),
}


# Server phase: clients, their frame rate and size (raw RGB that fits one
# datagram: 57,600 B), seconds of load, and the frames that may still be in
# flight when the counts are read (one a client).
SERVER_CLIENTS = 8
SERVER_FPS = 60.0
SERVER_SECONDS = 4.0
SERVER_FRAME = (160, 120)
SERVER_SLACK = SERVER_CLIENTS
# Frame cache phase: the clients' frames (h, w), large enough that dispatch
# also takes the cache's bucket (1080x1920), so both run the same step.
CACHE_FRAME = (720, 1280)


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


def step_device_ms(torch, fn, reps: int = 5) -> float:
    """Median device time of one fn() (CUDA events around a single call
    queued behind a spin). A serving step launches some 365 kernels; the
    launches of several steps overflow what the host can queue ahead of
    the spin, and the events then time the host, so steps are timed one at
    a time."""
    return float(np.median([time_ms(torch, fn, iters=1, warmup=int(i == 0))
                            for i in range(reps)]))


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


def profile_step(torch, fn, iters: int = 5, top: int = 0,
                 nms_stages: int = 1) -> tuple:
    """Device time of fn() by kernel (bench_host.step_profile: torch.profiler,
    CUDA activity; only the kernel and copy events are summed, not the CPU
    ops that launched them; fn runs `nms_stages` NMS stages). Returns (the
    profile, {port kernel: device ms}) per call and prints the `top`
    kernels."""
    from zero_latency_yolo_tpu_torch.bench_host import step_profile
    prof = step_profile(torch, fn, iters, nms_stages)
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


def ulp_distance(torch, a, b):
    """Elementwise distance of two f32 or bf16 tensors of one type in units
    in the last place (0: equal bits; NaN counts as far), as int64."""
    bits, sign = {torch.float32: (torch.int32, 1 << 31),
                  torch.bfloat16: (torch.int16, 1 << 15)}[a.dtype]

    def ordered(t):
        i = t.contiguous().view(bits).long()
        return torch.where(i < 0, -(i + sign), i)
    d = (ordered(a) - ordered(b)).abs()
    return torch.where(torch.isnan(a) | torch.isnan(b),
                       torch.full_like(d, 1 << 40), d)


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


def record_path_calls(engine, frames_d, hs, ws, size=None):
    """Run one plain bf16 step (at serve size `size`, default the model
    size) and record the inputs it hands each kernel's plain version: the
    serving path's own shapes and values."""
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
        engine._build_step(int(frames_d.shape[0]), size, plain=True)(
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


def fixture_frames_s640(fx) -> dict:
    """The yolov8s fixture's two batches of 4, remade from its seeds."""
    return {"task": list(task_frames(4, 640, seed=int(fx["task_seed"]))),
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


def kernels_vs_plain(got: np.ndarray, want: np.ndarray, label: str,
                     against: str = "plain") -> None:
    """The packed f32 step with kernels against the plain step (or another
    step, named by `against`): counts and classes equal, boxes and scores
    within 1e-3."""
    from zero_latency_yolo_tpu_torch.ops.nms import unpack_outputs
    g, w = unpack_outputs(got), unpack_outputs(want)
    require(np.array_equal(g["count"], w["count"]),
            f"{label} counts differ: {g['count']} vs {against} {w['count']}")
    valid = np.arange(32)[None, :] < w["count"][:, None]
    require(np.array_equal(g["classes"][valid], w["classes"][valid]),
            f"{label} classes differ from the {against} step")
    box_err = float(np.abs(g["boxes"] - w["boxes"])[valid].max(initial=0))
    score_err = float(np.abs(g["scores"] - w["scores"])[valid].max(initial=0))
    print(f"{label} vs {against}: counts {w['count'].tolist()} equal, "
          f"classes equal, max box err {box_err:.3g}, max score err "
          f"{score_err:.3g} (tolerance 1e-3)", flush=True)
    require(box_err < 1e-3 and score_err < 1e-3,
            f"{label} boxes or scores outside 1e-3 of the {against} step")


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


def int8_fixture_gate(got: np.ndarray, fx, name: str, conf: float,
                      nms: float) -> dict:
    """An int8 f32 step (B, 1 + 6*32) against the JAX package's int8 f32
    step (fx[name]), at detection level: the detections of either run
    without a twin in the other (twin_match: IoU > 0.85, the same class,
    confidence within 0.03), summed over the batch, must number at most
    twice those of the JAX package's own int8 step run op by op against
    its jitted one (fx[name + "_eager"]). int8 rounds activations to a
    step of 1/127 of their range, so an f32 input a rounding apart can move
    one int8 value a whole step and every later conv with it: the JAX
    package gives detections that differ between its two ways of running
    the same step, and another run (another summation order) differs by
    about as much again. A wrong scale, rounding or layout leaves most
    detections without a twin. `strict` is the 1e-3 fixture_gate, for the
    record."""
    from zero_latency_yolo_tpu_torch.ops.nms import unpack_outputs

    def odd(a: np.ndarray) -> list:
        ua, uw = unpack_outputs(a), unpack_outputs(fx[name])
        out = []
        for f in range(len(uw["count"])):
            lost, extra, _, _ = twin_match(_packed_rows(uw, f),
                                           _packed_rows(ua, f))
            out.append(len(lost) + len(extra))
        return out

    mine, jax_eager = odd(got), odd(fx[f"{name}_eager"])
    gate = fixture_gate(got, fx[name], conf, nms)
    return dict(odd=mine, odd_jax_eager=jax_eager,
                ok=sum(mine) <= 2 * sum(jax_eager), strict=gate["strict"],
                box_err=gate["box_err"], score_err=gate["score_err"],
                counts=gate["counts"], counts_jax=gate["counts_jax"])


def server_frames() -> list:
    """Eight 160x120 frames: four of the task the weights were trained on
    (cropped from 160x160), four synthetic game frames."""
    w, h = SERVER_FRAME
    task = [np.ascontiguousarray(f[:h]) for f in task_frames(4, w, seed=31)]
    return task + [synthetic_frame(w, h, seed=40 + i, t=0.4 * i)
                   for i in range(4)]


def ultralytics_state_dict(tree) -> dict:
    """A BN-folded NumPy tree (HWIO kernels) as the state_dict of a fused
    ultralytics model: "model.<i>.<path>.conv.weight" (OIHW) and
    ".conv.bias", the detect head's tips as bare Conv2d (".weight",
    ".bias"). The inverse of models/weights.py from_ultralytics_state_dict
    on folded trees."""
    from zero_latency_yolo_tpu_torch.models.weights import flatten
    out = {}
    for key, val in flatten(tree).items():
        *path, leaf = key.split("/")
        tip = path[0] == "m22" and path[-1] == "2"
        name = ".".join(["model", path[0][1:]] + path[1:]
                        + ([] if tip else ["conv"])
                        + ["weight" if leaf == "w" else "bias"])
        out[name] = (np.ascontiguousarray(val.transpose(3, 2, 0, 1))
                     if leaf == "w" else np.asarray(val))
    return out


def _varint(n: int) -> bytes:
    out = b""
    while True:
        byte, n = n & 0x7F, n >> 7
        out += bytes([byte | (0x80 if n else 0)])
        if not n:
            return out


def _field(num: int, wire: int, payload: bytes) -> bytes:
    tag = _varint((num << 3) | wire)
    return tag + (_varint(len(payload)) + payload if wire == 2 else payload)


def onnx_initializers_bytes(tensors: dict) -> bytes:
    """An ONNX ModelProto whose graph holds only `tensors` as f32
    initializers (dims, FLOAT, name, raw little-endian data): what the
    port's `.onnx` reader reads of an ultralytics export."""
    graph = b""
    for name, arr in tensors.items():
        msg = b"".join(_field(1, 0, _varint(d)) for d in arr.shape)
        msg += _field(2, 0, _varint(1))
        msg += _field(8, 2, name.encode())
        msg += _field(9, 2, np.asarray(arr, "<f4").tobytes())
        graph += _field(5, 2, msg)
    return _field(7, 2, graph)


def write_weight_files(tree, directory) -> dict:
    """The tree as `.npz`, as a state-dict `.pt` and as an `.onnx`
    initializer file in `directory`: {extension: path}."""
    import torch
    from zero_latency_yolo_tpu_torch.models.weights import flatten
    directory = Path(directory)
    paths = {ext: str(directory / f"model.{ext}") for ext in ("npz", "pt",
                                                               "onnx")}
    np.savez(paths["npz"], **flatten(tree))
    sd = ultralytics_state_dict(tree)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, paths["pt"])
    Path(paths["onnx"]).write_bytes(onnx_initializers_bytes(sd))
    return paths


def launch_counts() -> dict:
    from zero_latency_yolo_tpu_torch.ops import (act_cuda, conv1x1_cuda,
                                                 conv_int8_cuda, nms_cuda)
    return {"nms_keep": nms_cuda.launches,
            "conv1x1_bias_act": conv1x1_cuda.launches,
            "conv1x1_wgmma": conv1x1_cuda.launches_by_route["wgmma"],
            "bias_silu": act_cuda.launches,
            "conv_int8": conv_int8_cuda.launches}


def reset_launch_counts() -> None:
    from zero_latency_yolo_tpu_torch.ops import (act_cuda, conv1x1_cuda,
                                                 conv_int8_cuda, nms_cuda)
    nms_cuda.launches = conv1x1_cuda.launches = act_cuda.launches = 0
    conv_int8_cuda.launches = 0
    conv1x1_cuda.launches_by_route = {r: 0 for r in conv1x1_cuda.ROUTES}


class HostComposite:
    """The frames a DeviceFrameCache should hold, composited on the host in
    NumPy from the same writes: a keyframe zeroes its slot and fills its
    top-left (h, w); an ROI pastes over the slot's frame, in order."""

    def __init__(self, cache) -> None:
        self.cache = cache
        self.frames = np.zeros(tuple(cache._cache.shape), np.uint8)
        self.dims = {}

    def keyframe(self, cid: int, frame: np.ndarray) -> None:
        require(self.cache.write_keyframe(cid, frame),
                f"keyframe of client {cid} refused")
        slot = self.cache.slot(cid)
        h, w = frame.shape[:2]
        self.frames[slot] = 0
        self.frames[slot, :h, :w] = frame
        self.dims[cid] = (h, w)

    def roi(self, cid: int, region: np.ndarray, x: int, y: int,
            applied: bool = True) -> None:
        require(self.cache.write_roi(cid, region, x, y),
                f"ROI of client {cid} at ({x}, {y}) refused")
        if applied:
            rh, rw = region.shape[:2]
            self.frames[self.cache.slot(cid), y:y + rh, x:x + rw] = region

    def check(self, torch, what: str) -> None:
        self.cache.run_locked(lambda c: c)
        got = self.cache._cache.cpu().numpy()
        bad = int((got != self.frames).any(axis=-1).sum())
        require(bad == 0, f"frame cache after {what}: {bad} pixels differ "
                          "from the host composite")


def flush_ms(torch, cache, write) -> tuple:
    """(host ms, device ms) of one flush of what `write()` queues: the
    host time of run_locked (it does not wait for the device), and CUDA
    events around it, synchronized (the uploads and pastes on the card)."""
    cache.run_locked(lambda c: c)
    torch.cuda.synchronize()
    write()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    t0 = time.perf_counter()
    cache.run_locked(lambda c: c)
    host = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    return host, start.elapsed_time(end)


def frame_cache_phase(torch, engine, cfg, smi_line: str) -> dict:
    """Phase 5 (see the module docstring). Returns the launches of the
    cached batch-8 dispatch and the timings printed."""
    from zero_latency_yolo_tpu_torch.ops.preprocess import letterbox_batch_mxu
    from zero_latency_yolo_tpu_torch.ops.roi import DeviceFrameCache
    from zero_latency_yolo_tpu_torch.runtime.engine import InferenceRequest
    max_h = max(b[0] for b in cfg.tpu.frame_buckets)
    max_w = max(b[1] for b in cfg.tpu.frame_buckets)
    cache = DeviceFrameCache(cfg.max_clients, max_h, max_w, device=DEVICE)
    comp = HostComposite(cache)
    rng = np.random.default_rng(8)
    fh, fw = CACHE_FRAME
    # Eight clients' keyframes, then their ROI updates in one flush: three
    # overlapping ROIs of client 1, an ROI at the corner of client 2's
    # frame, a full-frame ROI of client 3, one small ROI each for 4..8.
    for cid in range(1, 9):
        comp.keyframe(cid, synthetic_frame(fw, fh, seed=60 + cid, t=0.3 * cid))
    comp.check(torch, "8 keyframes")
    for x, y in [(100, 80), (140, 100), (120, 60)]:
        comp.roi(1, rng.integers(0, 256, (96, 160, 3), dtype=np.uint8), x, y)
    comp.roi(2, rng.integers(0, 256, (40, 56, 3), dtype=np.uint8),
             fw - 56, fh - 40)
    comp.roi(3, synthetic_frame(fw, fh, seed=90), 0, 0)
    for cid in range(4, 9):
        comp.roi(cid, rng.integers(0, 256, (16, 16, 3), dtype=np.uint8),
                 8 * cid, 4 * cid)
    comp.check(torch, "overlapping, edge and full-frame ROIs")
    # A shed-frozen slot: client 9 floods past the pending bound; all its
    # queued ROIs are shed, the slot freezes and keeps its keyframe.
    comp.keyframe(9, synthetic_frame(640, 360, seed=99))
    comp.check(torch, "client 9's keyframe")
    bound, cache._max_pending = cache._max_pending, 4
    for i in range(5):
        comp.roi(9, rng.integers(0, 256, (32, 32, 3), dtype=np.uint8),
                 4 * i, 4 * i, applied=False)
    cache._max_pending = bound
    frozen = cache.drain_frozen()
    comp.roi(9, rng.integers(0, 256, (8, 8, 3), dtype=np.uint8), 0, 0,
             applied=False)  # frozen: accepted and shed
    require(frozen == [9] and cache.frozen_clients() == [9],
            f"shed froze {frozen}, not client 9")
    comp.check(torch, "a shed-frozen slot")
    # Release, then a new client reuses the slot.
    comp.keyframe(10, synthetic_frame(800, 600, seed=10))
    comp.check(torch, "client 10's keyframe")
    slot10 = cache.slot(10)
    cache.release(10)
    comp.keyframe(11, synthetic_frame(320, 240, seed=11))
    require(cache.slot(11) == slot10, "the released slot was not reused")
    comp.check(torch, "a release and the slot's reuse")
    print(f"frame cache on the card: {cache.num_slots} slots of {max_h}x"
          f"{max_w}; keyframes, overlapping and edge ROIs, a shed-frozen "
          f"slot and a reused slot byte-equal to the host composite "
          f"(flushes {cache.flushes}, writes {cache.writes_flushed}, shed "
          f"{cache.writes_shed})", flush=True)

    # dispatch_from_cache at batch 8 against dispatch on the composited
    # frames: same engine, batch and bucket (fh x fw lands in max_h x max_w),
    # so the packed outputs must be equal to the last bit.
    ids = list(range(1, 9))
    reqs = [InferenceRequest(client_id=c, frame_id=c, timestamp=c, width=fw,
                             height=fh, data=comp.frames[cache.slot(c), :fh,
                                                         :fw].copy())
            for c in ids]
    want = engine.dispatch(reqs)
    want.event.synchronize()
    reset_launch_counts()
    got = cache.dispatch_with(
        lambda c, s, h, w: engine.dispatch_from_cache(reqs, c, s, h, w), ids)
    got.event.synchronize()
    launches = launch_counts()
    require(want.staging_key[1:] == (max_h, max_w),
            f"dispatch picked the bucket {want.staging_key[1:]}")
    require(np.array_equal(got.host.numpy(), want.host.numpy()),
            "dispatch_from_cache differs from dispatch on the composited "
            "frames")
    n_det = [len(r.detections) for r in engine.complete(got)]
    engine.complete(want)
    require(all(launches[k] > 0 for k in PATH3),
            f"a kernel was not launched by dispatch_from_cache: {launches}")
    print(f"dispatch_from_cache batch 8 ({fh}x{fw} frames in the {max_h}x"
          f"{max_w} cache) equal to the last bit to dispatch on the "
          f"composited frames; detections {n_det}; launches {launches}",
          flush=True)
    # It returns with the stream still busy.
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9))
    t0 = time.perf_counter()
    pend = cache.dispatch_with(
        lambda c, s, h, w: engine.dispatch_from_cache(reqs, c, s, h, w), ids)
    host_s = time.perf_counter() - t0
    busy = not torch.cuda.current_stream().query()
    engine.complete(pend)
    require(busy, f"dispatch_from_cache returned with the stream idle "
                  f"({host_s:.3f} s)")
    print(f"dispatch_from_cache returned in {1e3 * host_s:.2f} ms with the "
          "stream still busy", flush=True)

    # Flush times by write count (64x64 ROIs; keyframes of fh x fw).
    times = {}
    region = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    for n in (1, 8, 64):
        times[f"roi_{n}"] = flush_ms(torch, cache, lambda n=n: [
            cache.write_roi(ids[i % 8], region, 4 * (i % 16), 4 * (i // 16))
            for i in range(n)])
    for n in (1, 8):
        times[f"keyframe_{n}"] = flush_ms(torch, cache, lambda n=n: [
            cache.write_keyframe(ids[i], reqs[i].data) for i in range(n)])
    print(f"flush on {smi_line}, host ms / device ms: " + ", ".join(
        f"{k} {h:.3f} / {d:.3f}" for k, (h, d) in times.items()), flush=True)
    # What the batcher holds the cache lock for in the server phase's load,
    # in this quiet process: 8 keyframes of the clients' raw frames flushed
    # and the batch-8 gather.
    small, holds = server_frames(), []
    for _ in range(12):
        for i, c in enumerate(ids):
            cache.write_keyframe(c, small[i])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache.dispatch_with(engine.gather_from_cache, ids)
        holds.append((time.perf_counter() - t0) * 1e3)
    hold_ms = float(np.median(holds[2:]))
    print(f"cache lock hold, quiet: 8 keyframes of {SERVER_FRAME[0]}x"
          f"{SERVER_FRAME[1]} flushed and the batch-8 gather, host ms p50 "
          f"{hold_ms:.3f} (max {max(holds[2:]):.3f})", flush=True)

    # The cached step (gather + step at the cache's bucket) beside the
    # hosted step at the bucket raw 160x120 frames take (608x800).
    args = (engine._class_weights, cfg.confidence_threshold,
            cfg.nms_threshold)
    small = min(engine.frame_buckets, key=lambda b: b[0] * b[1])
    steps = {}
    for b in engine.batch_buckets:
        shw = torch.tensor([[cache.slot(c) for c in ids[:b]], [fh] * b,
                            [fw] * b], dtype=torch.int32, device=DEVICE)
        frames = torch.zeros((b,) + tuple(small) + (3,), dtype=torch.uint8,
                             device=DEVICE)
        frames[:, :SERVER_FRAME[1], :SERVER_FRAME[0]] = torch.from_numpy(
            server_frames()[0]).to(DEVICE)
        hs = torch.full((b,), SERVER_FRAME[1], dtype=torch.int32,
                        device=DEVICE)
        ws = torch.full((b,), SERVER_FRAME[0], dtype=torch.int32,
                        device=DEVICE)
        cached = engine.get_step_cached(b, (max_h, max_w))
        hosted = engine.get_step(b, small)
        row = {}
        for name, fn in (
                ("cached", lambda: cached(engine._params, cache._cache, shw,
                                          *args)),
                ("hosted", lambda: hosted(engine._params, frames, hs, ws,
                                          *args))):
            wall = wall_ms(torch, fn)
            prof, _ = profile_step(torch, fn)
            row[name] = (wall, prof["busy_ms"])
        steps[b] = row
        print(f"step batch {b} on {smi_line}: cached (gather + step at "
              f"{max_h}x{max_w}) wall {row['cached'][0]:.3f} ms, device busy "
              f"{row['cached'][1]:.3f} ms; hosted (step at {small[0]}x"
              f"{small[1]}) wall {row['hosted'][0]:.3f} ms, device busy "
              f"{row['hosted'][1]:.3f} ms", flush=True)
    lb = {}
    for bk in (tuple(small), (max_h, max_w)):
        x = torch.zeros((8,) + bk + (3,), dtype=torch.uint8, device=DEVICE)
        h8 = torch.full((8,), SERVER_FRAME[1], dtype=torch.int32,
                        device=DEVICE)
        w8 = torch.full((8,), SERVER_FRAME[0], dtype=torch.int32,
                        device=DEVICE)
        lb[bk] = time_ms(torch, lambda: letterbox_batch_mxu(
            x, h8, w8, engine.model_size, engine.dtype))
    print("letterbox device time, batch 8 (CUDA events): " + ", ".join(
        f"{bk[0]}x{bk[1]} {ms:.4f} ms" for bk, ms in lb.items()), flush=True)
    return dict(launches=launches, flush_ms=times, hold_ms=hold_ms,
                steps=steps, letterbox_ms=lb)


def server_load(torch, device: str, smi_line: str, cache: bool,
                engine=None, config: Path = CONFIG, slo_ms=None,
                label=None, before=None, tweak=None, also=None,
                kernels=PATH3) -> dict:
    """One load of the server phase (see the module docstring) on a fresh
    DetectionServer, with the device frame cache or without it, and its
    gates. `config` is the config file served, `slo_ms` replaces its
    tpu.adaptive_slo_ms, `tweak(cfg)` changes the config before the server
    is built, `before(server)` is called just before the load and
    `also(server, web_port)` during it (its result under "also"); every
    kernel of `kernels` must launch. Returns the load's
    numbers, its launches, the engine and the /statusz body read after the
    load."""
    from zero_latency_yolo_tpu_torch.bench_server import (
        ServerThread, deployed_config, http_get, run_load)
    from zero_latency_yolo_tpu_torch.runtime.server import DetectionServer
    label = label or ("cached" if cache else "hosted (no cache)")
    w, h = SERVER_FRAME
    cfg = deployed_config(tracking=True, config=config)
    if slo_ms is not None:
        cfg.tpu.adaptive_slo_ms = float(slo_ms)
    if tweak is not None:
        tweak(cfg)
    web = cfg.network.web_port
    t_start = time.perf_counter()
    srv = ServerThread(DetectionServer(
        cfg, engine=engine, device=device,
        use_device_cache=cache)).start(warmup=True)
    server, engine = srv.server, srv.server.engine
    print(f"server {label} up on udp/{server.port} (web {web}) in "
          f"{time.perf_counter() - t_start:.2f} s, warmup included; engine "
          f"{engine.status()['engine']} on {engine.device}, simulation "
          f"{engine.simulation}", flush=True)
    try:
        require(not engine.simulation, "server engine in simulation mode")
        if before is not None:
            before(server)
        extra = {}

        def during():
            status = http_get(web, "/statusz")
            if also is not None:
                extra["also"] = also(server, web)
            return status
        reset_launch_counts()
        load = run_load(torch, server, "threads", SERVER_CLIENTS, SERVER_FPS,
                        SERVER_SECONDS, during=during)
        launches = launch_counts()
        code, body = http_get(web, "/statusz")
        require(code == 200, f"GET /statusz answered {code}")
        st = json.loads(body)
        # After the clients' DISCONNECT every cache slot is released.
        deadline = time.perf_counter() + 10
        while cache and (st["frame_cache"]["slots_used"] != 0
                         and time.perf_counter() < deadline):
            time.sleep(0.05)
            st = json.loads(http_get(web, "/statusz")[1])
    finally:
        srv.stop()
    code, body = load["during"]
    require(code == 200, f"GET /statusz during the load answered {code}")
    fc_during, fc_after = json.loads(body)["frame_cache"], st["frame_cache"]
    print(f"server {label} statusz frame_cache during the load {fc_during}; "
          f"after the clients left {fc_after}", flush=True)
    if cache:
        require(fc_during["slots_used"] == SERVER_CLIENTS,
                f"slots used during the load: {fc_during['slots_used']}, "
                f"not the {SERVER_CLIENTS} clients")
        require(fc_after["slots_used"] == 0,
                f"{fc_after['slots_used']} cache slots still used after "
                "every client left")
        require(fc_after["cache_rejects"] == 0 and fc_after["writes_shed"] == 0,
                f"the cache refused or shed writes: {fc_after}")
    else:
        require(fc_during is None and fc_after is None,
                "a frame cache in the server without one")
    n_sent, results = sum(load["sent"]), load["results"]
    unaccounted = (n_sent - sum(results) - load["engine_drops"]
                   - load["kernel_drops"])
    print(f"server {label} load: {SERVER_CLIENTS} clients (threads of this "
          f"process) x raw {w}x{h} frames at {SERVER_FPS:g} fps for "
          f"{SERVER_SECONDS:g} s: sent {n_sent}, server received "
          f"{load['frames_received']}, results {sum(results)} (per client "
          f"{results}), engine drops {load['engine_drops']}, kernel drops "
          f"{load['kernel_drops']}, bad packets {load['bad_packets']}; "
          f"unaccounted {unaccounted} (allowed 0..{SERVER_SLACK}); the "
          f"machine's UDP and IP drop counters over the load {load['net']}",
          flush=True)
    sock = load["socket"]
    print(f"server {label} sockets: server rcvbuf {sock['rcvbuf']} B, "
          f"sndbuf {sock['sndbuf']} B (granted), its own receive overflows "
          f"{sock['rx_overflows']} ({sock['rx_overflows_source']}); "
          f"system-wide UDP since the server's bind {sock['system_udp']}; "
          f"clients' receive overflows (SO_RXQ_OVFL, results lost at the "
          f"client) {load['client_overflows']}", flush=True)
    print(f"server {label} statusz: engine {st['engine']['engine']} on "
          f"{st['engine']['device']}, inferences {st['engine']['inferences']}, "
          f"errors {st['engine']['errors']}, avg batch "
          f"{st['engine']['avg_batch']}", flush=True)
    require(all(r > 0 for r in results), f"a client got no results: {results}")
    require(0 <= unaccounted <= SERVER_SLACK,
            f"{unaccounted} frames unaccounted for (the machine's counters "
            f"over the load: {load['net']}; sockets: {sock}; clients' "
            f"receive overflows {load['client_overflows']})")
    require(st["engine"]["engine"] == "torch-cuda"
            and st["engine"]["device"].startswith(device)
            and st["engine"]["errors"] == "0",
            f"statusz engine status: {st['engine']}")
    print(f"server {label} kernels: " + ", ".join(
        f"{k} launches={v}" for k, v in launches.items()), flush=True)
    require(all(launches[k] > 0 for k in kernels),
            f"a kernel was not launched while serving: {launches}")
    require(launches["conv1x1_wgmma"] == launches["conv1x1_bias_act"],
            f"bf16 1x1 convs off the tensor cores while serving: {launches}")
    idle = load["idle_share"]
    lock = (f"; cache lock held ms p50 {load['lock_ms_p50']:.3f}, p90 "
            f"{load['lock_ms_p90']:.3f} (flush + gather)" if cache else "")
    print(f"server {label} on {smi_line}: detect latency p50 "
          f"{load['p50_ms']:.3f} ms, p99 {load['p99_ms']:.3f} ms (last "
          f"{load['latency_samples']} results, arrival to result sent); "
          f"served {load['results_per_s']:.1f} results/s; batch sizes "
          f"{load['batch_sizes']}; step launch host ms "
          f"({'dispatch_gathered' if cache else 'engine.dispatch'}) p50 "
          f"{load['dispatch_ms_p50']:.2f}, p90 {load['dispatch_ms_p90']:.2f}"
          f"{lock}; device busy {load['busy_ms']:.1f} ms of "
          f"{load['wall_ms']:.1f} ms, idle share "
          f"{'not measured' if idle is None else f'{idle:.3f}'} (profiler, "
          "last second of the load)", flush=True)
    return dict(load, launches=launches, engine=engine, statusz=st, **extra)


def _served(c, got: list, send) -> None:
    """Send one frame with `send()`, wait for its result, append it."""
    fid = send()
    res = c.wait_results(len(got) + 1, timeout=30)
    require(len(res) == len(got) + 1 and res[-1].frame_id == fid,
            f"frame {fid} unanswered")
    got.append(res[-1])


def server_exactness(torch, engine, device: str, cache: bool,
                     has_cv2: bool) -> None:
    """A second server on the same engine, tracking off, serves frames one
    at a time; each result equals the engine on the frame the server
    served (through a fresh adapter; counts, classes and ids equal, boxes
    and confidences within 1e-3). Without the cache: 8 raw frames against
    infer_batch, then a JPEG keyframe (served with cv2, else a bad packet)
    and a raw frame. With the cache: the 8 raw frames, and with cv2 a JPEG
    keyframe and an ROI update, against infer_batch_cached on the frame
    composited on the host (the cache's bucket, batch 1)."""
    from zero_latency_yolo_tpu_torch.bench_server import (
        ServerThread, deployed_config)
    from zero_latency_yolo_tpu_torch.protocol import FrameDataPacket
    from zero_latency_yolo_tpu_torch.runtime.adapters import get_adapter
    from zero_latency_yolo_tpu_torch.runtime.engine import InferenceRequest
    from zero_latency_yolo_tpu_torch.runtime.frames import (
        decode_frame_payload, encode_jpeg)
    from zero_latency_yolo_tpu_torch.runtime.server import DetectionServer
    from zero_latency_yolo_tpu_torch.runtime.simulator import SimClient
    label = "cached" if cache else "hosted (no cache)"
    w, h = SERVER_FRAME
    cfg2 = deployed_config(tracking=False)
    srv2 = ServerThread(DetectionServer(
        cfg2, engine=engine, device=device,
        use_device_cache=cache)).start(warmup=False)
    server2 = srv2.server
    frames = server_frames()
    served = list(frames)  # the frame each result was computed on
    c = SimClient(("127.0.0.1", server2.port), screen_width=w,
                  screen_height=h)
    got = []
    try:
        c.connect()
        c.start_receiver()
        for f in frames:
            _served(c, got, lambda f=f: c.send_raw_frame(f))
        if not cache:
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
                        "a JPEG keyframe without cv2 did not count a bad "
                        "packet")
            fid = c.send_raw_frame(frames[0])
            res = c.wait_results(len(got) + 1 + has_cv2, timeout=30)
            require(res and res[-1].frame_id == fid,
                    "the server stopped serving after the JPEG keyframe")
            print(f"server JPEG keyframe (cv2 "
                  f"{'present: served' if has_cv2 else 'absent: refused'}): "
                  f"bad packets {bad0} -> {server2.bad_packets.value}; the "
                  "next raw frame was served", flush=True)
        elif has_cv2:
            # A JPEG keyframe, then an ROI update over it, through the
            # cache; the host composite decodes the same JPEG bytes.
            kf = decode_frame_payload(encode_jpeg(frames[1], 85), w, h).pixels
            _served(c, got, lambda: c.send_jpeg_keyframe(frames[1]))
            served.append(kf)
            x, y, rw, rh = 40, 30, 64, 48
            region = np.ascontiguousarray(frames[2][y:y + rh, x:x + rw])
            comp = kf.copy()
            comp[y:y + rh, x:x + rw] = decode_frame_payload(
                encode_jpeg(region, 85), rw, rh).pixels
            _served(c, got, lambda: c.send_roi_update(region, x=x, y=y))
            served.append(comp)
            print("server cached: a JPEG keyframe and an ROI update over "
                  "the wire served", flush=True)
        else:
            print("server cached: cv2 absent, the JPEG keyframe and ROI "
                  "update over the wire not run", flush=True)
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
    for i, (f, r) in enumerate(zip(served, got)):
        req = InferenceRequest(client_id=1, frame_id=r.frame_id,
                               timestamp=r.frame_timestamp, width=w, height=h,
                               data=f)
        if cache:
            bh = max(b[0] for b in engine.frame_buckets)
            bw = max(b[1] for b in engine.frame_buckets)
            slot = torch.zeros((1, bh, bw, 3), dtype=torch.uint8,
                               device=device)
            slot[0, :h, :w] = torch.from_numpy(f).to(device)
            req.data = None
            want = engine.infer_batch_cached([req], slot, np.array([h]),
                                             np.array([w]))
        else:
            want = engine.infer_batch([req])
        want = adapter.process_detections(1, want[0].detections)[:32]
        counts.append(len(want))
        require(len(r.detections) == len(want)
                and [d.class_id for d in r.detections]
                == [d.class_id for d in want]
                and [d.track_id for d in r.detections]
                == [d.track_id for d in want],
                f"server {label} frame {i}: {len(r.detections)} detections "
                f"vs the engine's {len(want)}, or classes or ids differ")
        for a, b in zip(r.detections, want):
            worst = max(worst, *(abs(getattr(a, k) - getattr(b, k)) for k in
                                 ("x", "y", "width", "height", "confidence")))
    ref = "infer_batch_cached" if cache else "infer_batch"
    print(f"server {label} exactness: {len(got)} frames one at a time, "
          f"tracking off, against engine.{ref} + a fresh adapter: counts "
          f"{counts} equal, classes and ids equal, max box/confidence "
          f"difference {worst:.3g} (tolerance 1e-3)", flush=True)
    require(worst <= 1e-3, f"server {label} results differ from {ref} by "
                           "more than 1e-3")
    require(sum(counts) > 0, "exactness check vacuous: no detections")


def server_phase(torch, device: str, smi_line: str) -> dict:
    """Phase 6 (see the module docstring): the load on the cached default
    server, then on the server without the cache, then the exactness of
    each. Returns both loads' numbers and launches."""
    from zero_latency_yolo_tpu_torch.protocol import native
    from zero_latency_yolo_tpu_torch.runtime import frames as frames_mod
    codec = (f"native ({native._LIB._name})" if native.HAVE_NATIVE
             else "pure Python")
    has_cv2 = frames_mod.cv2 is not None
    print(f"server codec: {codec}; cv2 present: {has_cv2}", flush=True)
    require(native.HAVE_NATIVE, "the native codec did not build")
    cached = server_load(torch, device, smi_line, cache=True)
    engine = cached.pop("engine")
    hosted = server_load(torch, device, smi_line, cache=False, engine=engine)
    hosted.pop("engine")
    server_exactness(torch, engine, device, False, has_cv2)
    server_exactness(torch, engine, device, True, has_cv2)
    return {"cached": cached, "hosted": hosted}

def reset_and_read(fn) -> dict:
    """Every kernel's count set to 0, fn() run, the device synchronized and
    the counts read: the launches of fn's path."""
    import torch
    reset_launch_counts()
    fn()
    torch.cuda.synchronize()
    return launch_counts()


def require_launched(launches: dict, label: str, tensor_cores: bool = True,
                     kernels=PATH3):
    require(all(launches[k] > 0 for k in kernels),
            f"a kernel was not launched on the {label} path: {launches}")
    if tensor_cores:
        require(launches["conv1x1_wgmma"] == launches["conv1x1_bias_act"],
                f"bf16 1x1 convs off the tensor cores ({label}): {launches}")


def staged_batch(torch, frames, bucket, dev):
    """Frames padded into one (B, H, W, 3) bucket on the device, with their
    heights and widths."""
    buf = np.zeros((len(frames),) + tuple(bucket) + (3,), np.uint8)
    for i, f in enumerate(frames):
        buf[i, :f.shape[0], :f.shape[1]] = f
    hs = torch.tensor([f.shape[0] for f in frames], dtype=torch.int32,
                      device=dev)
    ws = torch.tensor([f.shape[1] for f in frames], dtype=torch.int32,
                      device=dev)
    return torch.from_numpy(buf).to(dev), hs, ws


def load_config(path: Path):
    from zero_latency_yolo_tpu_torch.config import ServerConfig
    cfg = ServerConfig.load(str(path), create_if_missing=False)
    cfg.model_path = str(ROOT / cfg.model_path)
    return cfg


def ladder_phase(torch, smi_line: str) -> dict:
    """Phase 7, the serve-size ladder of yolov8s at 640 (see the module
    docstring). Returns the kernels' report at the batch-16 640 shapes and
    the phase's launches."""
    from zero_latency_yolo_tpu_torch.runtime.engine import (InferenceEngine,
                                                            InferenceRequest)
    dev = torch.device(DEVICE)
    cfg = load_config(CONFIG_S640)
    fx = np.load(FIXTURE_S640)
    conf, nms = cfg.confidence_threshold, cfg.nms_threshold
    require(float(fx["confidence_threshold"]) == conf
            and float(fx["nms_threshold"]) == nms,
            "the yolov8s fixture's thresholds are not the config's")
    # Both engines with the fixture's 640x640 bucket in front, so square
    # frames at a rung's size take an identity letterbox.
    cfg16 = fixture_config(cfg, fx)
    cfg16.tpu.dtype = cfg.tpu.dtype
    eng16 = InferenceEngine(cfg16, device=DEVICE)
    eng32 = InferenceEngine(fixture_config(cfg, fx), device=DEVICE)
    require(not eng16.simulation and not eng32.simulation,
            f"{cfg.model_path} did not load")
    require(eng16.serve_sizes == (640, 512) and eng16.spec.variant == "yolov8s",
            f"ladder {eng16.serve_sizes} of {eng16.spec.variant}")
    require(eng16.dtype == torch.bfloat16, "the yolov8s config is not bf16")

    # f32 against the JAX f32 step at each rung (the committed fixture),
    # under PyTorch's default TF32 settings.
    require(torch.backends.cudnn.allow_tf32,
            "cuDNN TF32 is not at PyTorch's default (on)")
    for rung in (int(r) for r in fx["rungs"]):
        found = 0
        for name, frames in fixture_frames_s640(fx).items():
            pend = eng32.dispatch(frame_requests(InferenceRequest, frames),
                                  size=rung)
            require(pend.serve_size == rung, f"served at {pend.serve_size}")
            gate = fixture_gate(pend.out.cpu().numpy(), fx[f"{name}_{rung}"],
                                conf, nms)
            print(f"yolov8s f32 step at {rung} vs JAX f32 step ({name} "
                  f"frames, fixture): counts {gate['counts']} vs "
                  f"{gate['counts_jax']}; 1e-3 gate per frame "
                  f"{gate['strict']}; max box err {gate['box_err']:.3g}, max "
                  f"score err {gate['score_err']:.3g}; passed per frame "
                  f"{gate['ok']}", flush=True)
            for note in gate["notes"]:
                print(f"  {note}", flush=True)
            require(all(gate["ok"]), f"yolov8s f32 step at {rung} differs "
                                     f"from the JAX f32 step ({name} frames)")
            found += sum(gate["counts_jax"])
        require(found > 0, f"fixture gate vacuous at {rung}")

    # bf16 against the card's f32 at each rung, on task frames drawn at the
    # rung's size (square: an identity letterbox at that rung).
    for rung in (640, 512):
        eng16._serve_size = eng32._serve_size = rung
        task = task_frames(8, rung, seed=777)
        g = bf16_gate(torch, eng16, eng32,
                      frame_requests(InferenceRequest, list(task)), task,
                      conf, nms)
        print(f"yolov8s bf16 vs f32 at {rung} (task frames): counts "
              f"{g['counts_bf16']} vs {g['counts_f32']}; literal gate per "
              f"frame {g['literal']}; margin gate per frame {g['margin']} "
              f"(excused: {g['excused']}); worst twin IoU "
              f"{g['worst_iou']:.4f}, worst conf delta {g['worst_conf']:.4f}",
              flush=True)
        for note in g["notes"]:
            print(f"  on a threshold: {note}", flush=True)
        require(sum(g["counts_f32"]) > 0, f"bf16 gate vacuous at {rung}")
        require(all(g["margin"]), f"yolov8s bf16 gate failed at {rung}")
    eng16._serve_size = eng32._serve_size = 640
    del eng32

    # Every kernel against its plain version on the batch-16 640 step's own
    # inputs (NMS at K = pre_nms_topk = 128).
    bucket = (608, 800)
    game = [synthetic_frame(800, 600, seed=s, t=0.3 * s) for s in range(16)]
    with torch.inference_mode():
        frames_d, hs, ws = staged_batch(torch, game, bucket, dev)
        calls = record_path_calls(eng16, frames_d, hs, ws, 640)
        require(len(calls["conv1x1_bias_act"]) == 24
                and len(calls["bias_silu"]) == 39
                and len(calls["nms_keep"]) == 1,
                f"unexpected path: {[(n, len(c)) for n, c in calls.items()]}")
        (boxes, _, _, _), _ = calls["nms_keep"][0]
        require(tuple(boxes.shape) == (16, 128, 4),
                f"NMS candidates {tuple(boxes.shape)}, not (16, 128, 4)")
        report = check_kernels(torch, calls, nms, dev)
        # check_kernels times NMS on its seeded case (B 8, K 256); here the
        # path's own call (B 16, K 128) is timed and bounded.
        from zero_latency_yolo_tpu_torch.ops import nms_cuda
        args = calls["nms_keep"][0][0]
        nbytes, nops = nms_bound(*args)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = nops / PEAK_OPS_PER_S["float32"]
        report["nms_keep"].update(
            ms=time_ms(torch, lambda: nms_cuda.nms_keep(*args)),
            plain_ms=time_ms(torch, lambda: nms_cuda.nms_keep_plain(*args),
                             iters=10),
            bound_ms=1e3 * max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")
        print(f"nms_keep on the path's call (B 16, K 128): "
              f"{1e3 * report['nms_keep']['ms']:.2f} us a launch, plain "
              f"{report['nms_keep']['plain_ms']:.3f} ms; bound {nbytes} "
              f"bytes, {nops} f32 operations "
              f"({1e6 * max(t_bytes, t_ops):.4f} us)", flush=True)
        torch.cuda.synchronize()
    del calls

    # The path, through the entry points: 16 frames at 640, 16 at 512.
    reqs = frame_requests(InferenceRequest, game)

    def path():
        out = eng16.infer_batch(reqs)
        out += eng16.complete(eng16.dispatch(reqs, size=512))
        require(len(out) == 32 and sorted({r.serve_size for r in out})
                == [512, 640], "the ladder path did not serve both rungs")
        require(all(0.0 <= v <= 1.0 for r in out for d in r.detections
                    for v in (d.x, d.y, d.width, d.height, d.confidence)),
                "a detection outside [0, 1]")
    launches = reset_and_read(path)
    print(f"ladder path (yolov8s, 16 frames at 640 and 16 at 512): "
          f"launches {launches}", flush=True)
    require_launched(launches, "ladder")

    # Step times per rung and batch: wall, device (CUDA events), device busy
    # (profiler); the cached step at batch 16 over the 1080x1920 cache.
    torch.cuda.reset_peak_memory_stats()
    for rung in (640, 512):
        for b in (1, 8, 16):
            frames_d, hs, ws = staged_batch(torch, game[:b], bucket, dev)
            step = eng16.get_step(b, bucket, rung)

            def run():
                return step(eng16._params, frames_d, hs, ws,
                            eng16._class_weights, conf, nms)
            wall = wall_ms(torch, run)
            ev = step_device_ms(torch, run)
            prof, own = profile_step(torch, run)
            print(f"yolov8s bf16 step at {rung}, batch {b}, bucket "
                  f"{bucket[0]}x{bucket[1]} on {smi_line}: wall {wall:.3f} ms, "
                  f"device {ev:.3f} ms (CUDA events around one step queued "
                  f"behind a spin, median of 5), device busy "
                  f"{prof['busy_ms']:.3f} ms (profiler), "
                  f"{prof['kernels']} CUDA kernels a step; in-step ms "
                  + ", ".join(f"{n} {ms:.4f}" for n, ms in own.items()),
                  flush=True)
        cache = torch.zeros((16, 1080, 1920, 3), dtype=torch.uint8,
                            device=dev)
        shw = torch.zeros((3, 16), dtype=torch.int32)
        shw[1], shw[2] = 1080, 1920
        shw = shw.to(dev)
        cached = eng16.get_step_cached(16, (1080, 1920), rung)

        def run_cached():
            return cached(eng16._params, cache, shw, eng16._class_weights,
                          conf, nms)
        ev = step_device_ms(torch, run_cached)
        prof, _ = profile_step(torch, run_cached)
        print(f"yolov8s bf16 cached step (gather + step) at {rung}, batch 16, "
              f"1080x1920: device {ev:.3f} ms (CUDA events, one step), "
              f"device busy {prof['busy_ms']:.3f} ms (profiler)", flush=True)
        del cache
    print(f"max memory allocated in the ladder phase: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    return {"report": report, "launches": launches}


STEP_VARIANTS = {
    "letterbox": {"preprocess": "letterbox"},
    "stretch": {"preprocess": "stretch"},
    "perlevel": {"select": "perlevel"},
    "split": {"c2f": "split"},
    "s2d": {"stem": "s2d"},
}


def variants_phase(torch, smi_line: str) -> dict:
    """Phase 8, the engine's step variants on yolov8n at 416 (see the module
    docstring). Returns the launches of each variant's batch."""
    from zero_latency_yolo_tpu_torch.runtime.engine import (InferenceEngine,
                                                            InferenceRequest)
    dev = torch.device(DEVICE)
    base = load_config(CONFIG)
    base.tpu.dtype = "float32"
    base.tpu.batch_buckets = (8,)
    bucket = (608, 800)
    game = [synthetic_frame(800, 600, seed=s, t=0.3 * s) for s in range(4, 12)]
    reqs = frame_requests(InferenceRequest, game)
    frames_d, hs, ws = staged_batch(torch, game, bucket, dev)
    ref = InferenceEngine(base, device=DEVICE)
    conf, nms = base.confidence_threshold, base.nms_threshold
    default = ref.dispatch(reqs).out.cpu().numpy()
    out = {}
    for name, over in STEP_VARIANTS.items():
        cfg = copy.deepcopy(base)
        for key, value in over.items():
            setattr(cfg.tpu, key, value)
        eng = InferenceEngine(cfg, device=DEVICE)
        pend = []
        launches = reset_and_read(lambda: pend.append(eng.dispatch(reqs)))
        got = pend[0].out.cpu().numpy()
        want = eng._build_step(8, plain=True)(
            eng._params, frames_d, hs, ws, eng._class_weights, conf,
            nms).cpu().numpy()
        kernels_vs_plain(got, want, f"variant {name} f32")
        diff = np.abs(got - default)
        print(f"variant {name} against the default step (not gated): counts "
              f"{got[:, 0].astype(int).tolist()} vs "
              f"{default[:, 0].astype(int).tolist()}, max packed difference "
              f"{diff.max():.3g}; launches a batch-8 step {launches}",
              flush=True)
        require_launched(launches, f"variant {name}", tensor_cores=False)
        out[name] = launches
    # tpu.c2f="auto" at batch 32 in bf16: the split form, on the tensor
    # cores; the bf16 detection gate against the f32 default step.
    cfg = load_config(CONFIG)
    cfg.tpu.batch_buckets = (32,)
    eng = InferenceEngine(cfg, device=DEVICE)
    require(cfg.tpu.c2f == "auto" and eng._c2f_form(32, 416) == "split",
            "c2f='auto' at batch 32 does not resolve to the split form")
    task = task_frames(8, 416, seed=777)
    treqs = frame_requests(InferenceRequest, list(task))
    launches = reset_and_read(lambda: eng.infer_batch(treqs))
    print(f"variant auto@32 (bf16, split C2f): launches a step {launches}",
          flush=True)
    require(launches["conv1x1_bias_act"] == 50 and launches["bias_silu"] == 47
            and launches["nms_keep"] == 1,
            f"split C2f launches a step {launches}, not 50 / 47 / 1")
    require_launched(launches, "auto@32")
    ref_cfg = load_config(CONFIG)
    ref_cfg.tpu.dtype = "float32"
    g = bf16_gate(torch, eng, InferenceEngine(ref_cfg, device=DEVICE), treqs,
                  task, conf, nms)
    print(f"variant auto@32 bf16 vs f32 (task frames): counts "
          f"{g['counts_bf16']} vs {g['counts_f32']}; margin gate per frame "
          f"{g['margin']} (excused: {g['excused']})", flush=True)
    for note in g["notes"]:
        print(f"  on a threshold: {note}", flush=True)
    require(sum(g["counts_f32"]) > 0 and all(g["margin"]),
            "the split C2f's bf16 gate failed")
    out["auto@32"] = launches
    return out


def capture_gathered(engine, store: list) -> None:
    """Wrap engine.dispatch_gathered so that every batch it steps leaves its
    served client frames (the top-left SERVER_FRAME crop of each gathered
    slot; the rest of a slot is zero after a keyframe), its (3, B) slots,
    heights and widths, its rung and its packed output in `store`."""
    w, h = SERVER_FRAME
    inner = engine.dispatch_gathered

    def dispatch_gathered(requests, gathered, size=None):
        pb = inner(requests, gathered, size)
        if gathered is not None and pb.out is not None:
            store.append(dict(crop=gathered.frames[:, :h, :w].clone(),
                              bucket=tuple(gathered.frames.shape[1:3]),
                              shw=gathered.shw.clone(), size=pb.serve_size,
                              out=pb.out.clone(), n=len(requests)))
        return pb
    engine.dispatch_gathered = dispatch_gathered


def adaptive_phase(torch, smi_line: str) -> dict:
    """Phase 9, the adaptive policy (see the module docstring). Returns the
    launches of the server load."""
    from zero_latency_yolo_tpu_torch.runtime.engine import (InferenceEngine,
                                                            InferenceRequest)
    dev = torch.device(DEVICE)
    cfg = load_config(CONFIG_ADAPTIVE)
    engine = InferenceEngine(cfg, device=DEVICE)
    require(not engine.simulation and engine.serve_sizes == (416, 320)
            and engine.adaptive_slo_ms > 0,
            f"adaptive config: ladder {engine.serve_sizes}, SLO "
            f"{engine.adaptive_slo_ms}, simulation {engine.simulation}")
    t0 = time.perf_counter()
    engine.warmup()
    print(f"adaptive warmup: {time.perf_counter() - t0:.2f} s over batches "
          f"{engine.batch_buckets} x buckets {engine.frame_buckets} x rungs "
          f"{engine.serve_sizes}; certified {engine._warmed_sizes}", flush=True)
    require(engine._warmed_sizes == (416, 320), "warmup did not certify both "
                                                "rungs")
    reqs = frame_requests(InferenceRequest, [
        synthetic_frame(800, 600, seed=s, t=0.3 * s) for s in range(4, 12)])

    def drive(until, limit_s=30.0):
        t0, steps = time.perf_counter(), 0
        while not until() and time.perf_counter() - t0 < limit_s:
            for r in reqs:  # a fresh submit time: e2e is this step's
                r.enqueue_t = time.perf_counter()
            engine.complete(engine.dispatch(reqs))
            steps += 1
        return steps, time.perf_counter() - t0

    require(engine.update_adaptive_slo(0.001), "SLO enable refused")
    steps, secs = drive(lambda: engine._serve_size != 416)
    p99 = engine.e2e_latency.snapshot()["p99_ms"]
    print(f"adaptive: SLO 0.001 ms: downshift to {engine._serve_size} after "
          f"{steps} batch-8 steps, {secs:.2f} s (e2e p99 {p99:.3f} ms)",
          flush=True)
    require(engine._serve_size == 320 and engine.size_downshifts == 1,
            f"no downshift: serve size {engine._serve_size}")
    served = engine.complete(engine.dispatch(reqs))
    static = load_config(CONFIG_ADAPTIVE)
    static.detection.model_width = static.detection.model_height = 320
    static.tpu.serve_sizes, static.tpu.adaptive_slo_ms = (), 0.0
    want = InferenceEngine(static, device=DEVICE).infer_batch(reqs)
    require(all(r.serve_size == 320 for r in served), "not served at 320")
    require(_result_rows(served) == _result_rows(want),
            "results at 320 differ from a 320 engine's infer_batch")
    print(f"adaptive: results at 320 equal, to the last bit, to infer_batch "
          f"of an engine of model size 320 "
          f"({sum(len(r.detections) for r in want)} detections)", flush=True)
    require(engine.update_adaptive_slo(1e4), "SLO change refused")
    steps, secs = drive(lambda: engine._serve_size != 320)
    print(f"adaptive: SLO 10000 ms: upshift to {engine._serve_size} after "
          f"{steps} batch-8 steps, {secs:.2f} s", flush=True)
    require(engine._serve_size == 416 and engine.size_upshifts == 1,
            f"no upshift: serve size {engine._serve_size}")
    del engine

    # The cached default server under load with an SLO below its p99.
    store = []
    load = server_load(torch, DEVICE, smi_line, True, config=CONFIG_ADAPTIVE,
                       slo_ms=1.0, label="adaptive (cached, SLO 1 ms)",
                       before=lambda server: capture_gathered(server.engine,
                                                              store))
    engine = load["engine"]
    st = load["statusz"]["engine"]
    print(f"adaptive server: statusz serve_size {st['serve_size']}, "
          f"size_downshifts {st['size_downshifts']}, size_upshifts "
          f"{st['size_upshifts']}; results by serve size "
          f"{load['serve_sizes']}", flush=True)
    require(int(st["size_downshifts"]) >= 1, "the server did not downshift")
    require(set(load["serve_sizes"]) == {416, 320},
            f"results not served at both rungs: {load['serve_sizes']}")
    # Every batch stepped under the load, replayed: the step at its rung on
    # its frames gives its packed output to the last bit.
    w, h = SERVER_FRAME
    conf, nms = cfg.confidence_threshold, cfg.nms_threshold
    by_size = {}
    for rec in store:
        shw = rec["shw"].cpu()
        require(int(shw[1].max()) <= h and int(shw[2].max()) <= w,
                "a served frame larger than the captured crop")
        b = int(rec["crop"].shape[0])
        canvas = torch.zeros((b,) + rec["bucket"] + (3,), dtype=torch.uint8,
                             device=dev)
        canvas[:, :h, :w] = rec["crop"]
        again = engine.get_step(b, rec["bucket"], rec["size"])(
            engine._params, canvas, rec["shw"][1], rec["shw"][2],
            engine._class_weights, conf, nms)
        require(torch.equal(again, rec["out"]),
                f"a served batch at {rec['size']} differs from the engine's "
                "step at that rung")
        by_size[rec["size"]] = by_size.get(rec["size"], 0) + rec["n"]
    require(sum(by_size.values()) == sum(load["serve_sizes"].values()),
            f"batches replayed {by_size} do not cover the results "
            f"{load['serve_sizes']}")
    print(f"adaptive server: {len(store)} batches replayed, each equal to "
          f"the last bit to the engine's step at its rung; frames by rung "
          f"{by_size}", flush=True)
    return {"launches": load["launches"]}


def _result_rows(results) -> list:
    return [(r.client_id, r.frame_id, [(d.x, d.y, d.width, d.height,
                                        d.confidence, d.class_id)
                                       for d in r.detections])
            for r in results]


def weights_phase(torch, smi_line: str) -> None:
    """Phase 10, `.pt` and `.onnx` weights (see the module docstring)."""
    import tempfile
    from zero_latency_yolo_tpu_torch.models.yolov8 import get_spec, init_params
    from zero_latency_yolo_tpu_torch.runtime.engine import (InferenceEngine,
                                                            InferenceRequest)
    tree = init_params(0, get_spec("yolov8n", 4))
    for lvl in tree["m22"]["cv3"]:  # spread the class scores
        lvl[2]["w"] = lvl[2]["w"] * 8.0
        lvl[2]["b"] = np.linspace(-2, 2, 4).astype(np.float32)
    reqs = frame_requests(InferenceRequest, [
        synthetic_frame(800, 600, seed=s, t=0.3 * s) for s in range(4, 12)])
    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_weight_files(tree, tmp)
        for ext, path in paths.items():
            cfg = load_config(CONFIG)
            cfg.model_path = path
            eng = InferenceEngine(cfg, device=DEVICE)
            require(not eng.simulation, f"the {ext} engine is in simulation")
            outs[ext] = eng.dispatch(reqs).out.cpu()
            print(f"weights {ext}: {Path(path).stat().st_size} bytes, "
                  f"simulation {eng.simulation}, counts "
                  f"{outs[ext][:, 0].int().tolist()}", flush=True)
    for ext in ("pt", "onnx"):
        require(torch.equal(outs[ext], outs["npz"]),
                f"the {ext} engine's step differs from the npz engine's")
    require(int(outs["npz"][:, 0].sum()) > 0, "weights phase vacuous")
    print("weights: the .pt and .onnx engines' steps equal the .npz "
          "engine's to the last bit", flush=True)


INT8_BATCHES = (1, 2, 4, 8, 16, 32)
# The bf16 steps whose int8 calls are checked and timed (the largest), and
# the batches at which the int8 and bf16 steps are timed.
INT8_CHECK_BATCHES = (8, 16)
INT8_BUSY_BATCHES = (1, 8, 16)
# The /profilez captures made during the int8 phase's second server load
# (a load of phase 6), each this many seconds, starting this far into it.
PROFILEZ_CAPTURES = 3
PROFILEZ_SECONDS = 0.25
PROFILEZ_DELAY = 1.0
# int8 a step for yolov8n (the int8 convs; the unquantized stem and head
# keep 6 1x1 convs, 13 bias+SiLU passes, and NMS runs once).
INT8_STEP_LAUNCHES = {"conv_int8": 44, "conv1x1_bias_act": 6,
                      "conv1x1_wgmma": 6, "bias_silu": 13, "nms_keep": 1}
PEAK_INT8_OPS_PER_S = 1979e12
# The card's calibration against the JAX package's: int8 steps a later
# conv's scale may move (int8_calibration_gate).
CALIB_STEPS = 6


def int8_config(cfg, dtype: str = "bfloat16"):
    """cfg with tpu.quantize_int8, in `dtype`, over INT8_BATCHES."""
    out = copy.deepcopy(cfg)
    out.tpu.quantize_int8 = True
    out.tpu.dtype = dtype
    out.tpu.batch_buckets = list(INT8_BATCHES)
    return out


def record_int8_calls(engine, frames_d, hs, ws) -> list:
    """The inputs one plain step of `engine` hands the int8 conv's plain
    version: the serving path's own shapes and values."""
    from zero_latency_yolo_tpu_torch.models import yolov8 as ym
    calls = []
    saved = ym.conv_int8_plain

    def rec(*args):
        calls.append(args)
        return saved(*args)
    ym.conv_int8_plain = rec
    try:
        engine._build_step(int(frames_d.shape[0]), plain=True)(
            engine._params, frames_d, hs, ws, engine._class_weights,
            engine.config.confidence_threshold, engine.config.nms_threshold)
    finally:
        ym.conv_int8_plain = saved
    return calls


def int8_call_vs_plain(torch, x, xs, w, ws, b, k, stride, act) -> tuple:
    """One int8 conv call through the kernel and its plain version: the
    int32 accumulators must be equal and the outputs within one ulp of x's
    type (the same f32 arithmetic in the same order; exp may differ in the
    last bit). Returns (max ulp, elements not bit-equal, elements, max abs
    error)."""
    from zero_latency_yolo_tpu_torch.ops import conv_int8_cuda as ci
    acc = ci.conv_int8_acc(x, xs, w, k, stride)
    want_acc = ci.conv_int8_acc_plain(x, xs, w, k, stride)
    require(torch.equal(acc, want_acc),
            f"conv_int8 {tuple(x.shape)} k{k} s{stride}: "
            f"{int((acc != want_acc).sum())} int32 accumulators differ from "
            "the plain version's")
    got = ci.conv_int8(x, xs, w, ws, b, k, stride, act)
    want = ci.conv_int8_plain(x, xs, w, ws, b, k, stride, act)
    ulp = ulp_distance(torch, got, want)
    top = int(ulp.max())
    require(top <= 1, f"conv_int8 {tuple(x.shape)} k{k} s{stride} "
                      f"{x.dtype}: outputs {top} ulp from the plain version")
    return (top, int((ulp > 0).sum()), ulp.numel(),
            float((got.float() - want.float()).abs().max()))


def int8_bound(x, w, k, stride, cout) -> tuple:
    """(bytes, int8 operations) of one int8 conv call: x (the slice it
    reads) once, the packed weight, scales and bias once, the output once;
    2 * M * Cout * K operations."""
    b, h, wd, cin = x.shape
    pad = (k - 1) // 2
    ho = (h + 2 * pad - k) // stride + 1
    wo = (wd + 2 * pad - k) // stride + 1
    m = b * ho * wo
    nbytes = (x.numel() * x.element_size() + w.numel() + 8 * cout + 4
              + m * cout * x.element_size())
    return nbytes, 2.0 * m * cout * k * k * cin


def check_int8_kernel(torch, calls_by_batch: dict) -> dict:
    """Every recorded int8 call against the plain version in bf16 (as the
    step gives it) and in f32 (the same input widened), plus the first
    call with a dynamic scale computed on the device; then, at the largest
    batch's calls, the kernel's back-to-back time, the plain version's, the
    bound, and torch._int_mm's time on the 1x1 calls it accepts (the GEMM
    alone over inputs already quantized: no quantize, no epilogue)."""
    from zero_latency_yolo_tpu_torch.ops import conv_int8_cuda as ci
    tops, not_equal, total, abs_err = {}, {}, {}, 0.0
    for batch, calls in calls_by_batch.items():
        for x, xs, w, ws, b, k, stride, act in calls:
            for dt in (torch.bfloat16, torch.float32):
                t, ne, n, e = int8_call_vs_plain(torch, x.to(dt), xs, w, ws,
                                                 b, k, stride, act)
                key = str(dt).split(".")[-1]
                tops[key] = max(tops.get(key, 0), t)
                not_equal[key] = not_equal.get(key, 0) + ne
                total[key] = total.get(key, 0) + n
                if dt == torch.bfloat16:
                    abs_err = max(abs_err, e)
    x, xs, w, ws, b, k, stride, act = next(iter(calls_by_batch.values()))[0]
    dyn = ci.dynamic_scale(x)
    t, ne, n, _ = int8_call_vs_plain(torch, x, dyn, w, ws, b, k, stride, act)
    print(f"conv_int8 against its plain version at every int8 call of the "
          f"bf16 step at batch {sorted(calls_by_batch)} "
          f"({sum(len(c) for c in calls_by_batch.values())} calls, each in "
          f"bf16 and f32): int32 accumulators equal in all; outputs max ulp "
          f"{tops}, elements not bit-equal {not_equal} of {total}; a dynamic "
          f"device scale ({float(dyn):.6g}): max ulp {t}, {ne} of {n} not "
          f"bit-equal", flush=True)
    batch = max(calls_by_batch)
    ms = plain_ms = bound_ms = bytes_s = ops_s = 0.0
    lib_ms = ms_lib_calls = 0.0
    lib_calls = 0
    print(f"conv_int8 calls of the bf16 batch-{batch} step (us per call): H W "
          "Cin Cout k stride | kernel plain _int_mm bound", flush=True)
    for x, xs, w, ws, b, k, stride, act in calls_by_batch[batch]:
        cout = w.shape[0]
        t_k = time_ms(torch, lambda: ci.conv_int8(x, xs, w, ws, b, k, stride,
                                                  act))
        t_p = time_ms(torch, lambda: ci.conv_int8_plain(
            x, xs, w, ws, b, k, stride, act), iters=3, warmup=1)
        nbytes, nops = int8_bound(x, w, k, stride, cout)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / PEAK_INT8_OPS_PER_S
        t_lib = None
        if k == 1 and stride == 1:
            cin = x.shape[-1]
            xq = ci.quantize_activations(x, xs).to(torch.int8).reshape(-1, cin)
            wt = w[:, :cin].contiguous().t()
            try:
                torch._int_mm(xq, wt)
                t_lib = time_ms(torch, lambda: torch._int_mm(xq, wt))
            except RuntimeError as e:
                print(f"  torch._int_mm refuses {tuple(xq.shape)} x "
                      f"{tuple(wt.shape)}: {str(e).splitlines()[0]}")
        ms, plain_ms = ms + t_k, plain_ms + t_p
        bound_ms += 1e3 * max(t_bytes, t_ops)
        bytes_s, ops_s = bytes_s + t_bytes, ops_s + t_ops
        if t_lib is not None:
            lib_ms, ms_lib_calls, lib_calls = (lib_ms + t_lib,
                                               ms_lib_calls + t_k,
                                               lib_calls + 1)
        print(f"  {x.shape[1]:4d} {x.shape[2]:4d} {x.shape[3]:4d} {cout:4d} "
              f"{k} {stride} | {1e3 * t_k:8.2f} {1e3 * t_p:9.2f} "
              f"{'-' if t_lib is None else f'{1e3 * t_lib:8.2f}'} "
              f"{1e6 * max(t_bytes, t_ops):8.2f}", flush=True)
    return dict(calls=len(calls_by_batch[batch]), batch=batch,
                max_abs_err=abs_err, max_ulp=tops, not_bit_equal=not_equal,
                elements=total, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms if lib_calls else None,
                library_calls=lib_calls, ms_library_calls=ms_lib_calls,
                bound_ms=bound_ms,
                bound_by="bytes" if bytes_s >= ops_s else "operations")


def int8_calibration_gate(own: dict, fx) -> dict:
    """The card's own f32 calibration against the JAX package's (fixture:
    jitted, and run op by op): the first int8 conv, whose input is the
    unquantized stem's output, within 1e-5 relative of both (the formula,
    its margin and its float64); every conv within CALIB_STEPS int8 steps
    (CALIB_STEPS / 127 relative) of the jitted run's. A rounding to int8
    that goes the other way on the card than on the CPU moves every later
    conv's inputs by whole steps, as it does between JAX's own two runs
    (1.6% apart)."""
    paths = [str(p) for p in fx["x_scale_paths"]]
    require(sorted(own) == paths, f"calibrated convs {sorted(own)} are not "
                                  f"the fixture's {paths}")
    jit = dict(zip(paths, fx["x_scale"].tolist()))
    eager = dict(zip(paths, fx["x_scale_eager"].tolist()))
    spread = max(abs(eager[k] / jit[k] - 1) for k in paths)
    rel_jit = {k: abs(own[k] / jit[k] - 1) for k in paths}
    rel_eager = {k: abs(own[k] / eager[k] - 1) for k in paths}
    out = dict(max_rel_jit=max(rel_jit.values()),
               max_rel_eager=max(rel_eager.values()),
               equal_jit=sum(own[k] == jit[k] for k in paths),
               equal_eager=sum(own[k] == eager[k] for k in paths),
               n=len(paths), jax_spread=spread,
               m1_rel=(rel_jit["m1"], rel_eager["m1"]))
    print(f"int8 calibration on the card (f32) against the JAX package's: "
          f"{out['equal_jit']}/{len(paths)} scales equal to its jitted run's, "
          f"{out['equal_eager']}/{len(paths)} to its run op by op; max "
          f"relative difference {out['max_rel_jit']:.3g} / "
          f"{out['max_rel_eager']:.3g}; m1 {rel_jit['m1']:.3g} / "
          f"{rel_eager['m1']:.3g}; the JAX package's own spread between its "
          f"two runs {spread:.3g}", flush=True)
    require(max(out["m1_rel"]) <= 1e-5,
            f"m1's calibrated scale {own['m1']} is not the JAX package's "
            f"({jit['m1']}, {eager['m1']}) within 1e-5")
    require(out["max_rel_jit"] <= CALIB_STEPS / 127,
            f"calibration differs from JAX's by {out['max_rel_jit']:.3g}, "
            f"over {CALIB_STEPS} int8 steps")
    return out


def profilez_captures(web: int) -> dict:
    """During a load: PROFILEZ_CAPTURES POST /profilez captures of
    PROFILEZ_SECONDS, from PROFILEZ_DELAY on; while the first runs, GET
    reports it and a second POST answers 409. Returns each capture's
    result, the 409's body and the port kernels each trace names."""
    import threading
    from zero_latency_yolo_tpu_torch.bench_server import http_get
    time.sleep(PROFILEZ_DELAY)
    path = f"/profilez?seconds={PROFILEZ_SECONDS}"
    results, first = [], {}
    t = threading.Thread(target=lambda: first.update(
        zip(("code", "body"), http_get(web, path, "POST"))))
    t.start()
    deadline = time.perf_counter() + 30
    while not json.loads(http_get(web, "/profilez")[1])["capturing"]:
        require(time.perf_counter() < deadline and t.is_alive(),
                "GET /profilez never reported the capture running")
        time.sleep(0.005)
    busy = http_get(web, path, "POST")
    t.join(timeout=120)
    results.append((first["code"], json.loads(first["body"])))
    for _ in range(PROFILEZ_CAPTURES - 1):
        code, body = http_get(web, path, "POST")
        results.append((code, json.loads(body)))
    for code, out in results:
        print(f"/profilez capture: {code}, cost ms {out.get('cost_ms')}, "
              f"files {out.get('files')}", flush=True)
    named = []
    for code, out in results:
        if code != 200:
            named.append(None)
            continue
        trace = (Path(out["dir"]) / "trace.json").read_text()
        named.append(sorted(n for n, syms in KERNEL_SYMBOLS.items()
                            if any(s in trace for s in syms)))
    return dict(results=results, busy=busy, named=named)


def int8_phase(torch, smi_line: str, has_cv2: bool) -> dict:
    """Phase 11, the int8 serving path (see the module docstring). Returns
    the int8 kernel's report, the launches of the int8 path and of its
    server loads."""
    import threading
    from zero_latency_yolo_tpu_torch.models.weights import flatten, load_params
    from zero_latency_yolo_tpu_torch.models.yolov8 import forward_decoded
    from zero_latency_yolo_tpu_torch.ops import quant
    from zero_latency_yolo_tpu_torch.runtime.engine import (
        InferenceEngine, InferenceRequest, full_f32_precision)
    dev = torch.device(DEVICE)
    cfg = load_config(CONFIG)
    conf, nms = cfg.confidence_threshold, cfg.nms_threshold
    bucket = (608, 800)
    fx = np.load(FIXTURE_INT8)
    require(float(fx["confidence_threshold"]) == conf
            and float(fx["nms_threshold"]) == nms,
            "the int8 fixture's thresholds are not the config's")

    # 1-2. The f32 int8 engine: its own calibration against the JAX
    # package's, then its step with the JAX calibration carried across
    # against the JAX int8 step (int8_fixture_gate).
    require(torch.backends.cudnn.allow_tf32,
            "cuDNN TF32 is not at PyTorch's default (on)")
    eng32 = InferenceEngine(int8_config(fixture_config(cfg, fx), "float32"),
                            device=DEVICE)
    calib = int8_calibration_gate(quant.x_scales(eng32._params), fx)
    quant.set_x_scales(eng32._params, dict(zip(
        (str(p) for p in fx["x_scale_paths"]), fx["x_scale"].tolist())))
    fixture = {}
    for name, frames in fixture_frames(fx).items():
        out = eng32.dispatch(frame_requests(InferenceRequest, frames)).out
        g = int8_fixture_gate(out.cpu().numpy(), fx, name, conf, nms)
        fixture[name] = g
        print(f"int8 f32 step vs JAX int8 f32 step ({name} frames, fixture, "
              f"the JAX calibration carried across): counts {g['counts']} vs "
              f"{g['counts_jax']}; detections without a twin per frame "
              f"{g['odd']} (sum {sum(g['odd'])}), the JAX package's own step "
              f"run op by op {g['odd_jax_eager']} (sum "
              f"{sum(g['odd_jax_eager'])}); 1e-3 gate per frame (not gated) "
              f"{g['strict']}, max box err {g['box_err']:.3g}, max score err "
              f"{g['score_err']:.3g}", flush=True)
        require(sum(g["counts_jax"]) > 0, f"int8 fixture gate vacuous on the "
                                          f"{name} frames")
        require(g["ok"], f"int8 f32 step on the {name} frames further from "
                         "the JAX int8 step than twice JAX's own runs are")
    del eng32

    # 3. The kernel against its plain version at every int8 call of the
    # bf16 batch-8 and batch-16 steps.
    cfg8 = int8_config(cfg)
    eng = InferenceEngine(cfg8, device=DEVICE)
    require(len(quant.x_scales(eng._params)) == 44,
            "the bf16 int8 engine did not calibrate its 44 int8 convs")
    calls = {}
    with torch.inference_mode():
        for b in INT8_CHECK_BATCHES:
            frames_d, hs, ws = staged_batch(torch, [
                synthetic_frame(800, 600, seed=s, t=0.3 * s)
                for s in range(b)], bucket, dev)
            calls[b] = record_int8_calls(eng, frames_d, hs, ws)
            require(len(calls[b]) == 44, f"{len(calls[b])} int8 calls at "
                                         f"batch {b}, not 44")
        report = check_int8_kernel(torch, calls)
    del calls

    # 4. bf16 int8 against the port's engines without int8, as
    # tests/test_quant.py holds the JAX package's int8 forward.
    eng16 = InferenceEngine(cfg, device=DEVICE)
    cfg32 = copy.deepcopy(cfg)
    cfg32.tpu.dtype = "float32"
    eng32 = InferenceEngine(cfg32, device=DEVICE)
    task = task_frames(8, 416, seed=777)
    x = torch.from_numpy(task).to(dev).float() / 255.0
    with torch.inference_mode():
        got = forward_decoded(eng._params, eng.spec, x,
                              dtype=torch.bfloat16).float()
        for label, ref_eng, dt in (("bf16", eng16, torch.bfloat16),
                                   ("f32", eng32, torch.float32)):
            with full_f32_precision():
                ref = forward_decoded(ref_eng._params, ref_eng.spec, x,
                                      dtype=dt).float()
            prob = float((got[..., 4:] - ref[..., 4:]).abs().mean())
            box = float(((got[..., :4] - ref[..., :4]).abs() / 416).median())
            print(f"int8 bf16 forward vs {label} forward (task frames): mean "
                  f"probability error {prob:.4g} (limit 0.05), median box "
                  f"error {box:.4g} of the frame (limit 0.05)", flush=True)
            require(prob < 0.05 and box < 0.05,
                    f"int8 forward too far from {label}")
    treqs = frame_requests(InferenceRequest, list(task))
    ri, rb = eng.infer_batch(treqs), eng16.infer_batch(treqs)
    lit = [twin_match(_rows(b.detections), _rows(i.detections))
           for i, b in zip(ri, rb)]
    print(f"int8 bf16 vs bf16 detections (task frames, not gated): counts "
          f"{[len(r.detections) for r in ri]} vs "
          f"{[len(r.detections) for r in rb]}; frames with every detection "
          f"twinned {sum(not a and not b for a, b, _, _ in lit)}/{len(lit)}; "
          f"worst twin IoU {min(w for _, _, w, _ in lit):.4f}, worst "
          f"confidence delta {max(c for _, _, _, c in lit):.4f}", flush=True)

    # 5. The int8 path through the entry points, counts at 0 just before
    # and read just after: infer_batch, dispatch / complete_many, the
    # cached path, and a hot reload applied on this thread.
    eng.warmup()
    reqs = [InferenceRequest(client_id=i + 1, frame_id=i, timestamp=i,
                             width=w, height=h,
                             data=synthetic_frame(w, h, seed=4 + i, t=0.3 * i))
            for i, (w, h) in enumerate([(800, 600)] * 11 + [(1920, 1080)] * 2)]
    reload_dir = ROOT / "build" / "int8_reload"
    reload_dir.mkdir(parents=True, exist_ok=True)
    model = reload_dir / "model.npz"
    tree = load_params(cfg.model_path)
    np.savez(model, **flatten(tree))
    eng.config.model_path = str(model)

    def int8_path():
        res = eng.infer_batch(reqs)
        pend = [eng.dispatch(reqs[:4]), eng.dispatch(reqs[4:8])]
        res += [r for rs in eng.complete_many(pend) for r in rs]
        cache = torch.zeros((8,) + bucket + (3,), dtype=torch.uint8,
                            device=dev)
        cache[:, :600] = torch.from_numpy(np.stack(
            [r.data for r in reqs[:8]])).to(dev)
        res += eng.infer_batch_cached(reqs[:8], cache, np.full(8, 600),
                                      np.full(8, 800))
        before = quant.x_scales(eng._params)
        np.savez(model, **{k: (v * np.float32(1.05) if k.endswith("/w")
                               else v) for k, v in flatten(tree).items()})
        require(eng.maybe_reload(), "the hot reload was not staged")
        res += eng.infer_batch(reqs[:8])
        after = quant.x_scales(eng._params)
        require(sorted(after) == sorted(before) and after != before,
                "the reload was not quantized and calibrated anew")
        return res
    results = []
    path_launches = reset_and_read(lambda: results.extend(int8_path()))
    print(f"int8 path: {len(results)} results (infer_batch, dispatch / "
          f"complete_many, infer_batch_cached, a hot reload re-quantized and "
          f"re-calibrated on this thread), launches {path_launches}",
          flush=True)
    require(len(results) == len(reqs) + 8 + 8 + 8, "missing int8 results")
    require_launched(path_launches, "int8", kernels=tuple(KERNELS))
    require(sum(len(r.detections) for r in results) > 0,
            "no detections on the int8 path")

    # Launches a step: batch 8, and batch 32 where tpu.c2f="auto" resolves
    # to the split form, which int8 blocks run in the slice form.
    require(eng._c2f_form(32, 416) == "split",
            "c2f auto does not resolve to split at batch 32")
    reqs32 = [InferenceRequest(client_id=i + 1, frame_id=i, timestamp=i,
                               width=800, height=600,
                               data=synthetic_frame(800, 600, seed=i))
              for i in range(32)]
    per_step = {}
    for b in (8, 32):
        per_step[b] = reset_and_read(lambda b=b: eng.complete(
            eng.dispatch(reqs32[:b])))
        print(f"int8 step batch {b} ({eng._c2f_form(b, 416)} form "
              f"resolved): launches {per_step[b]}", flush=True)
        require(per_step[b] == INT8_STEP_LAUNCHES,
                f"int8 step at batch {b}: launches {per_step[b]}, want "
                f"{INT8_STEP_LAUNCHES}")

    # 6. Device busy of the int8 and the bf16 step, in this process.
    busy = {}
    for b in INT8_BUSY_BATCHES:
        frames_d, hs, ws = staged_batch(torch, [
            synthetic_frame(800, 600, seed=s) for s in range(b)], bucket, dev)
        for label, e in (("int8", eng), ("bf16", eng16)):
            step = e.get_step(b, bucket)

            def run(step=step, e=e):
                return step(e._params, frames_d, hs, ws, e._class_weights,
                            conf, nms)
            wall = wall_ms(torch, run)
            prof, own = profile_step(torch, run)
            dev_ms = step_device_ms(torch, run)
            busy[(label, b)] = (prof["busy_ms"], dev_ms, wall)
            print(f"step {label} batch {b} bucket {bucket[0]}x{bucket[1]} on "
                  f"{smi_line}: device busy {prof['busy_ms']:.3f} ms "
                  f"(profiler), device {dev_ms:.3f} ms (CUDA events), wall "
                  f"{wall:.3f} ms, {prof['kernels']} kernels; in-step "
                  + ", ".join(f"{n} {ms:.4f}" for n, ms in own.items())
                  + " ms", flush=True)
            if label == "int8" and b == 8:
                report["step_ms"] = own["conv_int8"]
    report.setdefault("step_ms", None)
    del eng16, eng32

    # 8-9. The int8 server: a load on the cached default server, the
    # exactness of its results without and with the cache, then a load
    # with /profilez captures.
    def tweak(c):
        c.tpu.quantize_int8 = True
        c.tpu.batch_buckets = list(INT8_BATCHES)
    load = server_load(torch, DEVICE, smi_line, cache=True, tweak=tweak,
                       label="int8 cached", kernels=tuple(KERNELS))
    srv_engine = load.pop("engine")
    require(srv_engine.config.tpu.quantize_int8
            and len(quant.x_scales(srv_engine._params)) == 44,
            "the int8 server's engine is not calibrated int8")
    server_exactness(torch, srv_engine, DEVICE, False, has_cv2)
    server_exactness(torch, srv_engine, DEVICE, True, has_cv2)
    caps = {}

    def start_captures(server):
        # Just before the load starts: the captures run inside it.
        web = server.config.network.web_port
        caps["thread"] = threading.Thread(
            target=lambda: caps.update(profilez_captures(web)))
        caps["thread"].start()

    def captures_done(server, web):
        caps.pop("thread").join(timeout=120)
        return caps
    prof_load = server_load(torch, DEVICE, smi_line, cache=True,
                            engine=srv_engine, tweak=tweak,
                            label="int8 cached, /profilez captures",
                            before=start_captures, also=captures_done,
                            kernels=tuple(KERNELS))
    prof_load.pop("engine")
    require("results" in caps, "the /profilez captures did not finish")
    print(f"/profilez during the int8 load: {len(caps['results'])} captures "
          f"of {PROFILEZ_SECONDS} s: answers "
          f"{[c for c, _ in caps['results']]}, cost ms (gate held to start, "
          f"to stop; export) {[o.get('cost_ms') for _, o in caps['results']]}"
          f", trace files "
          f"{[o.get('files') for _, o in caps['results']]}; kernels each "
          f"trace names {caps['named']}; a POST during the first answered "
          f"{caps['busy'][0]} {caps['busy'][1][:80]!r}", flush=True)
    require(all(c == 200 and o.get("ok") for c, o in caps["results"]),
            f"a /profilez capture failed: {caps['results']}")
    require(caps["busy"][0] == 409, f"a POST during a capture answered "
                                    f"{caps['busy'][0]}, not 409")
    require(all(n == sorted(KERNELS) for n in caps["named"]),
            f"a /profilez trace misses a port kernel: {caps['named']}")
    return dict(report=report, launches=path_launches, per_step=per_step,
                calibration=calib, fixture=fixture, busy=busy,
                server=load["launches"], server_profilez=prof_load["launches"])


# Training (phase 12). The f32 steps' gate against the JAX fixture: each
# step's loss and its parts within TRAIN_TOL * max(|jax|, 1) (a part under
# 1 is a difference of terms of order 1); per leaf of step 1's gradient and
# of the params and the EMA after the steps, the L2 norm within TRAIN_TOL *
# the JAX norm, and the dot product with the leaf's probe within TRAIN_TOL *
# the JAX norm * the probe's norm (the dot's own scale). An element-wise
# gate does not hold: Adam's first update is close to lr * sign(g) wherever
# |g| is near its eps, so those elements follow the last bits of their
# gradients. Set from the port against the JAX package on the CPU at the
# fixture's size (tests/test_torch_fixture.py): at most 6.9e-6 there, so
# ten times that, rounded up.
TRAIN_TOL = 1e-4
# The f32 evaluate of the deployed weights against the JAX package's, and
# with the kernels against their plain versions: every number within
# EVAL_TOL (the same detections decided).
EVAL_TOL = 1e-6
# bf16 evaluate with the kernels against their plain versions: mAP and
# mAP50-95 within EVAL_BF16_TOL. In bf16 a kernel's output may round one
# bf16 step away from its plain version's (TOLERANCE), which moves a
# detection that sits on a threshold; one such detection moves one class's
# AP on the 32-image set by up to about 0.03 and the mAP by a quarter of
# that. The card measured 0.0069 and 0.0047 (one detection each);
# the limit allows two to three. In f32 the two are equal (EVAL_TOL).
EVAL_BF16_TOL = 0.02
# bf16 at full width: yolov8n at TRAIN_N_SIZE and yolov8s at TRAIN_S_SIZE,
# batch TRAIN_BATCH; the resume check stops at TRAIN_RESUME_AT.
TRAIN_BATCH = 16
TRAIN_N_SIZE, TRAIN_S_SIZE = 416, 640
TRAIN_STEPS = 20
TRAIN_S640_STEPS = 5
TRAIN_RESUME_AT = 10


def leaf_probes(shapes, seed: int) -> list:
    """One standard normal f32 probe a leaf, in order, from one seed."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def norms_and_dots(leaves, probes) -> tuple:
    """(L2 norms, dot products with the probes) of the leaves, in float64."""
    norms, dots = [], []
    for a, p in zip(leaves, probes):
        a = np.asarray(a, np.float64).ravel()
        norms.append(float(np.sqrt(np.dot(a, a))))
        dots.append(float(np.dot(a, p.astype(np.float64).ravel())))
    return np.array(norms), np.array(dots)


def train_fixture_run(torch, device: str, fx) -> dict:
    """The port's run of the train fixture's recipe (its `config`) in f32 on
    `device`: the per-step metrics, and (norms, dots) of step 1's gradient
    and of the params and the EMA after the steps, with the probes' norms.
    The step runs in full f32 (`full_f32_precision`) whatever PyTorch's TF32
    settings."""
    from zero_latency_yolo_tpu_torch.models.weights import (
        train_params_from_jax, tree_leaves)
    from zero_latency_yolo_tpu_torch.models.yolov8 import (
        forward_train_raw, get_spec, init_params)
    from zero_latency_yolo_tpu_torch.runtime.engine import full_f32_precision
    from zero_latency_yolo_tpu_torch.train.loop import synthetic_batches
    from zero_latency_yolo_tpu_torch.train.loss import detection_loss
    from zero_latency_yolo_tpu_torch.train.optim import make_optimizer
    from zero_latency_yolo_tpu_torch.train.step import (init_train_state,
                                                         make_train_step)
    t = json.loads(str(fx["config"]))
    hw = (t["size"], t["size"])
    spec = get_spec(t["variant"], t["classes"])
    tx = make_optimizer(t["lr"])
    state = init_train_state(train_params_from_jax(
        init_params(t["init_seed"], spec, folded=False), device=device), tx,
        ema=True)
    leaves = tree_leaves(state.params)
    probes = leaf_probes([tuple(p.shape) for p in leaves], t["probe_seed"])
    gen = synthetic_batches(t["batch"], t["size"], seed=t["data_seed"])
    batches = [next(gen) for _ in range(t["steps"])]
    images, targets = (torch.from_numpy(a).to(device) for a in batches[0])
    with full_f32_precision():
        outs = forward_train_raw(state.params, spec, images)
        grad1 = torch.autograd.grad(
            detection_loss(spec, outs, targets, hw)[0], leaves)
    out = {"grad1": norms_and_dots([g.cpu().numpy() for g in grad1], probes),
           "probe_norms": np.array([np.linalg.norm(p.astype(np.float64))
                                    for p in probes])}
    step = make_train_step(spec, tx, hw, dtype=torch.float32,
                           ema_decay=t["ema_decay"])
    metrics = {k: [] for k in ("loss", "box", "cls", "dfl")}
    for images, targets in batches:
        state, m = step(state, images, targets)
        for k in metrics:
            metrics[k].append(float(m[k]))
    out["metrics"] = metrics
    out["params3"] = norms_and_dots(
        [p.detach().cpu().numpy() for p in tree_leaves(state.params)], probes)
    out["ema3"] = norms_and_dots(
        [p.cpu().numpy() for p in tree_leaves(state.ema_params)], probes)
    return out


def train_fixture_gate(run: dict, fx) -> dict:
    """A train_fixture_run against the fixture: the worst error of each
    quantity as a fraction of its scale (see TRAIN_TOL), and whether every
    one is within its tolerance."""
    worst = {}
    for k in ("loss", "box", "cls", "dfl"):
        want, got = fx[k], np.array(run["metrics"][k])
        worst[k] = float(np.max(np.abs(got - want)
                                / np.maximum(np.abs(want), 1.0)))
    for name in ("grad1", "params3", "ema3"):
        norms, dots = run[name]
        jn, jd = fx[f"{name}_norm"], fx[f"{name}_dot"]
        scale = np.maximum(jn, 1e-30)
        worst[f"{name}_norm"] = float(np.max(np.abs(norms - jn) / scale))
        worst[f"{name}_dot"] = float(np.max(
            np.abs(dots - jd) / (scale * run["probe_norms"])))
    ok = all(v <= TRAIN_TOL for v in worst.values())
    return {"worst": worst, "ok": ok}


def eval_fixture_gate(got: dict, fx) -> dict:
    """The port's evaluate against the JAX package's in the fixture: the
    largest difference over every key, and whether it is within EVAL_TOL."""
    keys = [str(k) for k in fx["eval_keys"]]
    want = dict(zip(keys, fx["eval_values"].tolist()))
    same_keys = sorted(str(k) for k in got) == keys
    err = max(abs(float(got.get(k, np.inf)) - want[k]) for k in keys)
    return {"err": err, "want": want, "ok": same_keys and err <= EVAL_TOL}


def eval_images(fx) -> tuple:
    """The train fixture's eval images and targets (NumPy)."""
    from zero_latency_yolo_tpu_torch.train.loop import synthetic_batches
    t = json.loads(str(fx["config"]))
    return next(synthetic_batches(t["eval_images"], t["size"],
                                  seed=t["eval_seed"]))


class deterministic:
    """cuDNN's deterministic algorithms (no autotuning) and PyTorch's
    deterministic mode for the duration; the settings are restored after."""

    def __init__(self, torch) -> None:
        self.torch = torch

    def __enter__(self):
        t = self.torch
        self.saved = (t.backends.cudnn.deterministic, t.backends.cudnn.benchmark,
                      t.are_deterministic_algorithms_enabled(),
                      t.is_deterministic_algorithms_warn_only_enabled())
        t.backends.cudnn.deterministic = True
        t.backends.cudnn.benchmark = False
        t.use_deterministic_algorithms(True, warn_only=True)
        return self

    def __exit__(self, *exc):
        t = self.torch
        t.backends.cudnn.deterministic, t.backends.cudnn.benchmark = \
            self.saved[:2]
        t.use_deterministic_algorithms(self.saved[2], warn_only=self.saved[3])
        return False


def _train_run(torch, spec, batches, size: int, assigner: str = "center",
               schedule: str = "const", state=None, tx=None):
    """bf16 steps of a fresh yolov8 state (init seed 0, EMA on), or of
    `state` / `tx` when given, over `batches`. Returns (state, tx, per-step
    losses, per-step host seconds, the step)."""
    from zero_latency_yolo_tpu_torch.models.weights import train_params_from_jax
    from zero_latency_yolo_tpu_torch.models.yolov8 import init_params
    from zero_latency_yolo_tpu_torch.train.optim import make_optimizer
    from zero_latency_yolo_tpu_torch.train.step import (init_train_state,
                                                         make_train_step)
    if state is None:
        tx = make_optimizer(1e-3, schedule, steps=2 * TRAIN_RESUME_AT,
                            warmup_steps=2)
        state = init_train_state(train_params_from_jax(
            init_params(0, spec, folded=False), device=DEVICE), tx, ema=True)
    step = make_train_step(spec, tx, (size, size), assigner=assigner)
    losses, secs = [], []
    for images, targets in batches:
        t0 = time.perf_counter()
        state, m = step(state, images, targets)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    return state, tx, losses, secs, step


def _state_leaves(tx, state) -> list:
    """Params, EMA (tensors) and the optimizer's leaves (NumPy) of a state."""
    from zero_latency_yolo_tpu_torch.models.weights import tree_leaves
    return ([p.detach() for p in tree_leaves(state.params)]
            + tree_leaves(state.ema_params) + tx.state_leaves(state.opt_state))


def train_phase(torch, smi_line: str) -> dict:
    """Phase 12 (see the module docstring). Returns the eval path's
    launches and the phase's numbers."""
    import tempfile
    from zero_latency_yolo_tpu_torch.models.weights import (load_params,
                                                            tree_leaves)
    from zero_latency_yolo_tpu_torch.models.yolov8 import get_spec
    from zero_latency_yolo_tpu_torch.train.checkpoint import CheckpointManager
    from zero_latency_yolo_tpu_torch.train.eval import evaluate
    from zero_latency_yolo_tpu_torch.train.loop import synthetic_batches
    fx = np.load(FIXTURE_TRAIN)
    t = json.loads(str(fx["config"]))

    # f32 against the JAX package's steps, under PyTorch's default TF32
    # settings: only the step's own switch to full f32 keeps it out of TF32.
    require(torch.backends.cudnn.allow_tf32,
            "cuDNN TF32 is not at PyTorch's default (on)")
    run = train_fixture_run(torch, DEVICE, fx)
    gate = train_fixture_gate(run, fx)
    print(f"train f32 vs JAX (yolov8n {t['size']}, batch {t['batch']}, "
          f"{t['steps']} steps, const chain, EMA): losses "
          f"{[round(v, 6) for v in run['metrics']['loss']]} vs "
          f"{[round(float(v), 6) for v in fx['loss']]}; worst error over its "
          f"scale {gate['worst']} (limit {TRAIN_TOL:g})", flush=True)
    require(gate["ok"], f"f32 train steps differ from the JAX fixture: "
                        f"{gate['worst']}")

    # bf16 at full width: yolov8n at 416, batch 16, both assigners.
    spec_n = get_spec("yolov8n", 4)
    n_size, s_size = TRAIN_N_SIZE, TRAIN_S_SIZE
    gen = synthetic_batches(TRAIN_BATCH, n_size, seed=1)
    batches = [next(gen) for _ in range(TRAIN_STEPS)]
    numbers = {}
    for assigner in ("center", "tal"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, tx, losses, secs, step = _train_run(
            torch, spec_n, batches, n_size, assigner=assigner)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        require(all(np.isfinite(losses)), f"{assigner}: a loss not finite: "
                                          f"{losses}")
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        require(last < first, f"{assigner}: the loss did not fall: {losses}")
        ms = float(np.median(secs[3:])) * 1e3
        prof = train_profile(torch, lambda: step(state, *batches[0]))
        if assigner == "center":
            center_state = state
        numbers[assigner] = {"losses": losses, "wall_ms": ms,
                             "images_per_s": TRAIN_BATCH / ms * 1e3,
                             "busy_ms": prof["busy_ms"],
                             "kernels": prof["kernels"], "peak_gib": peak}
        print(f"train bf16 yolov8n {n_size} batch {TRAIN_BATCH}, {assigner} "
              f"assigner, {TRAIN_STEPS} steps on {smi_line}: loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f} (mean of the first five "
              f"{first:.4f}, of the last five {last:.4f}); wall "
              f"{ms:.2f} ms/step (host clock, median of steps 4-{TRAIN_STEPS}, "
              f"the loss read back each step), {TRAIN_BATCH / ms * 1e3:.1f} "
              f"images/s; device busy {prof['busy_ms']:.2f} ms/step in "
              f"{prof['kernels']:g} kernels (profiler); peak memory "
              f"{peak:.3f} GiB", flush=True)

    # yolov8s at 640, batch 16, 5 steps.
    spec_s = get_spec("yolov8s", 4)
    gen = synthetic_batches(TRAIN_BATCH, s_size, seed=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    s_state, _, losses, secs, step = _train_run(
        torch, spec_s, [next(gen) for _ in range(TRAIN_S640_STEPS)], s_size)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    require(all(np.isfinite(losses)), f"yolov8s {s_size}: a loss not finite: "
                                      f"{losses}")
    require(all(bool(torch.isfinite(p).all())
                for p in tree_leaves(s_state.params)),
            f"yolov8s {s_size}: a parameter not finite")
    ms = float(np.median(secs[2:])) * 1e3
    prof = train_profile(torch, lambda: step(s_state, *next(gen)), iters=2)
    numbers["s640"] = {"losses": losses, "wall_ms": ms,
                       "images_per_s": TRAIN_BATCH / ms * 1e3,
                       "busy_ms": prof["busy_ms"], "kernels": prof["kernels"],
                       "peak_gib": peak}
    print(f"train bf16 yolov8s {s_size} batch {TRAIN_BATCH}, {TRAIN_S640_STEPS} "
          f"steps on {smi_line}: losses {[round(v, 4) for v in losses]}; "
          f"wall {ms:.2f} ms/step (median of steps 3-{TRAIN_S640_STEPS}), "
          f"{TRAIN_BATCH / ms * 1e3:.1f} images/s; device busy "
          f"{prof['busy_ms']:.2f} ms/step in {prof['kernels']:g} kernels "
          f"(profiler); peak memory {peak:.3f} GiB", flush=True)
    del s_state

    # Resume: a checkpoint at step 10 restored into a fresh state and run 10
    # more steps equals 20 uninterrupted steps, bit for bit (cuDNN's
    # deterministic algorithms: its autotuned weight gradients are not).
    # The cosine schedule, so the schedule's count is restored too.
    with deterministic(torch), tempfile.TemporaryDirectory() as tmp:
        whole, wtx, _, _, _ = _train_run(torch, spec_n, batches, n_size,
                                         schedule="cosine")
        half, htx, _, _, _ = _train_run(
            torch, spec_n, batches[:TRAIN_RESUME_AT], n_size,
            schedule="cosine")
        mgr = CheckpointManager(tmp)
        mgr.save(half, htx)
        fresh, ftx, _, _, _ = _train_run(torch, spec_n, [], n_size,
                                         schedule="cosine")
        resumed = mgr.restore(fresh, ftx)
        require(resumed.step == TRAIN_RESUME_AT, "resumed at the wrong step")
        resumed, _, _, _, _ = _train_run(
            torch, spec_n, batches[TRAIN_RESUME_AT:], n_size, state=resumed,
            tx=ftx)
        a, b = _state_leaves(wtx, whole), _state_leaves(ftx, resumed)
        require(len(a) == len(b), "resumed state has other leaves")
        differ = [i for i, (x, y) in enumerate(zip(a, b)) if not (
            torch.equal(x, y) if isinstance(x, torch.Tensor)
            else np.array_equal(x, y))]
        print(f"train resume: checkpoint at step {TRAIN_RESUME_AT}, restored "
              f"into a fresh state, {TRAIN_STEPS - TRAIN_RESUME_AT} more "
              f"steps against {TRAIN_STEPS} uninterrupted (bf16, cosine, "
              f"EMA, deterministic cuDNN): {len(differ)} of {len(a)} state "
              f"leaves differ", flush=True)
        require(not differ, f"the resumed run differs in leaves {differ[:8]}")
        cpu_tx = ftx.__class__(ftx.lr)
        on_cpu = mgr.restore(_cpu_template(torch, spec_n, cpu_tx), cpu_tx)
        got = [x.detach().numpy() for x in tree_leaves(on_cpu.params)]
        want = [x.detach().cpu().numpy() for x in tree_leaves(half.params)]
        require(on_cpu.step == TRAIN_RESUME_AT and all(
            np.array_equal(x, y) for x, y in zip(got, want)),
            "the card's checkpoint did not restore on the CPU")
        print("train resume: the card's checkpoint restored through the "
              "port's CPU path, equal", flush=True)
        del whole, half, fresh, resumed

    # Eval through the kernels: the trained params (the center run: its
    # steps and the profiled ones) and the deployed weights, in bf16 and in
    # f32, kernels against plain versions; the launches of the bf16 eval of
    # the trained params, reset just before and read just after.
    images, targets = eval_images(fx)
    weights = load_params(str(ROOT / t["eval_weights"]))
    launches = None
    for what, params in (("the center run's params", center_state.params),
                         (t["eval_weights"], weights)):
        for dtype, tol in ((torch.bfloat16, EVAL_BF16_TOL),
                           (torch.float32, EVAL_TOL)):
            def run(plain=False):
                return evaluate(params, spec_n, images, targets, dtype=dtype,
                                device=DEVICE, plain=plain)
            if launches is None:
                launches = reset_and_read(run)
                require_launched(launches, "train eval")
            ev_k, ev_p = run(), run(plain=True)
            err = max(abs(ev_k[k] - ev_p[k]) for k in ("mAP", "mAP50_95"))
            print(f"train eval, {str(dtype)[6:]}, {what}: kernels mAP "
                  f"{ev_k['mAP']:.6f} mAP50_95 {ev_k['mAP50_95']:.6f}, plain "
                  f"{ev_p['mAP']:.6f} / {ev_p['mAP50_95']:.6f}; difference "
                  f"{err:.3g} (limit {tol:g})", flush=True)
            require(err <= tol, f"eval of {what} with kernels differs from "
                                f"eval with plain versions in {dtype}")
    print(f"train eval launches (bf16, the center run's params): {launches}",
          flush=True)
    require(ev_k["mAP"] > 0.5, "eval of the deployed weights vacuous")
    # f32 against the JAX package's evaluate of the same weights and images.
    ev32 = evaluate(weights, spec_n, images, targets, batch=t["eval_batch"],
                    dtype=torch.float32, device=DEVICE)
    eg = eval_fixture_gate(ev32, fx)
    print(f"train eval, f32, {t['eval_weights']}, {t['eval_images']} images "
          f"at {t['size']}: {ev32} vs JAX {eg['want']}; largest difference "
          f"{eg['err']:.3g} (limit {EVAL_TOL:g})", flush=True)
    require(eg["ok"], "f32 evaluate differs from the JAX package's")
    return {"launches": launches, "numbers": numbers, "gate": gate["worst"]}


def train_profile(torch, fn, iters: int = 3, top: int = 6) -> dict:
    """Device time of fn(), one train step, by kernel (torch.profiler, CUDA
    activity, kernels and copies only), per step over `iters` steps:
    `busy_ms`, `kernels` (launches, copies and memsets not counted) and the
    `top` kernels, printed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 1e3 / iters, e.count // iters,
                    e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    for ms, n, key in rows[:top]:
        print(f"  {ms:8.4f} ms/step  {n:5d} launches/step  {key[:90]}")
    return {"busy_ms": sum(r[0] for r in rows),
            "kernels": sum(n for _, n, key in rows
                           if not key.startswith(("Memcpy", "Memset"))),
            "top": [(round(ms, 4), n, key[:90]) for ms, n, key in rows[:top]]}


def _cpu_template(torch, spec, tx):
    from zero_latency_yolo_tpu_torch.models.weights import train_params_from_jax
    from zero_latency_yolo_tpu_torch.models.yolov8 import init_params
    from zero_latency_yolo_tpu_torch.train.step import init_train_state
    return init_train_state(train_params_from_jax(
        init_params(0, spec, folded=False), device="cpu"), tx, ema=True)


# Phase 13, the serving mesh: the virtual meshes the deployed config runs on
# over cuda:0, and the two dp2 example configs.
MESH_SHAPES = ((2, 1), (1, 2))
MESH_BATCH = 8
DP2_CONFIGS = (ROOT / "configs" / "examples" / "server-64stream-dp2.json",
               ROOT / "configs" / "examples" / "server-16stream-640-dp2.json")


class _Warnings:
    """The warnings a logger emits while it is attached."""

    def __init__(self, name: str) -> None:
        import logging
        self.logger = logging.getLogger(name)
        self.messages = []
        self.handler = logging.Handler(logging.WARNING)
        self.handler.emit = lambda record: self.messages.append(
            record.getMessage())

    def __enter__(self) -> "_Warnings":
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc) -> None:
        self.logger.removeHandler(self.handler)


def _host_out(engine, pending) -> np.ndarray:
    """complete() a pending batch and return its packed output."""
    engine.complete(pending)
    out = pending.host if pending.host is not None else pending.out
    return out.cpu().numpy().copy()


def _cached_out(engine, frames, max_hw) -> tuple:
    """The frames written as keyframes of clients 1..n into a frame cache of
    the engine's mesh (slots n-1..0: each batch row's slots on another data
    row's shard) and served with dispatch_from_cache. Returns (packed
    output, the cache)."""
    from zero_latency_yolo_tpu_torch.ops.roi import DeviceFrameCache
    from zero_latency_yolo_tpu_torch.runtime.engine import InferenceRequest
    cache = DeviceFrameCache(len(frames), *max_hw, device=DEVICE,
                             mesh=engine.mesh)
    ids = list(range(1, len(frames) + 1))
    for cid, f in zip(ids, frames):
        require(cache.write_keyframe(cid, f), "keyframe refused")
    reqs = [InferenceRequest(client_id=cid, frame_id=i, timestamp=i,
                             width=f.shape[1], height=f.shape[0], data=None)
            for i, (cid, f) in enumerate(zip(ids, frames))]
    return _host_out(engine, cache.dispatch_with(
        lambda c, sl, hs, ws: engine.dispatch_from_cache(reqs, c, sl, hs, ws),
        ids)), cache


def record_mesh_calls(engine, frames_d, hs, ws) -> dict:
    """The inputs that data row 0 of a meshed engine hands each kernel's
    plain version in one plain bf16 step of its rows (record_path_calls on
    the row's placed tree: the channel-sharded shapes)."""
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
        engine._build_step(MESH_BATCH, plain=True)(
            engine._params[0], frames_d, hs, ws,
            engine._row_class_weights[0], engine.config.confidence_threshold,
            engine.config.nms_threshold)
    finally:
        (ym.conv1x1_bias_act_plain, ym.bias_silu_plain,
         nms_mod.nms_keep_plain) = saved
    return calls


def mesh_phase(torch, smi_line: str) -> dict:
    """Phase 13, the serving mesh (see the module docstring). Returns the
    launches of the mesh path (both meshes) and each mesh's kernel
    report."""
    from zero_latency_yolo_tpu_torch.parallel import mesh as pt_mesh
    from zero_latency_yolo_tpu_torch.runtime.engine import (InferenceEngine,
                                                            InferenceRequest)
    dev0 = torch.device(DEVICE, 0) if DEVICE == "cuda" else torch.device(DEVICE)
    cfg = load_config(CONFIG)
    conf, nms = cfg.confidence_threshold, cfg.nms_threshold
    cfg32 = copy.deepcopy(cfg)
    cfg32.tpu.dtype = "float32"
    bucket = (608, 800)
    max_hw = (max(b[0] for b in cfg.tpu.frame_buckets),
              max(b[1] for b in cfg.tpu.frame_buckets))
    game = [synthetic_frame(800, 600, seed=s, t=0.3 * s)
            for s in range(4, 4 + MESH_BATCH)]
    reqs = frame_requests(InferenceRequest, game)
    task = task_frames(MESH_BATCH, 416, seed=777)
    treqs = frame_requests(InferenceRequest, list(task))
    single16 = InferenceEngine(cfg, device=DEVICE)
    single32 = InferenceEngine(cfg32, device=DEVICE)
    single16.warmup(batches=[MESH_BATCH])
    # The f32 gates on frames of the task the weights were trained on.
    want_hosted = _host_out(single32, single32.dispatch(treqs))
    want_cached, _ = _cached_out(single32, list(task), max_hw)
    require(want_hosted[:, 0].sum() > 0, "mesh f32 gate vacuous: no "
                                         "detections")
    frames_d, hs, ws = staged_batch(torch, game, bucket, dev0)
    step1 = single16.get_step(MESH_BATCH, bucket)

    def single_step():
        return step1(single16._params, frames_d, hs, ws,
                     single16._class_weights, conf, nms)
    single_prof = profile_step(torch, single_step)[0]
    single_busy, single_kernels = single_prof["busy_ms"], single_prof["kernels"]
    single_wall = wall_ms(torch, single_step)
    out = {"launches": {n: 0 for n in ("nms_keep", "conv1x1_bias_act",
                                       "conv1x1_wgmma", "bias_silu",
                                       "conv_int8")},
           "report": {}}
    real = pt_mesh.available_devices
    try:
        for d, m in MESH_SHAPES:
            label = f"mesh {d}x{m}"
            pt_mesh.available_devices = (
                lambda device="cuda", n=d * m: [dev0] * n)
            cm16 = copy.deepcopy(cfg)
            cm16.tpu.mesh_data, cm16.tpu.mesh_model = d, m
            cm32 = copy.deepcopy(cm16)
            cm32.tpu.dtype = "float32"
            e16 = InferenceEngine(cm16, device=DEVICE)
            e32 = InferenceEngine(cm32, device=DEVICE)
            st = e16.status()
            require(e16.mesh is not None and e16.mesh.virtual
                    and st["mesh"] == f"{d}x{m}",
                    f"{label}: engine status {st}")
            print(f"{label}: {e16.mesh.describe()}, batch buckets "
                  f"{e16.batch_buckets}; statusz mesh {st['mesh']} devices "
                  f"{st['mesh_devices']} virtual {st['mesh_virtual']}",
                  flush=True)
            e16.warmup()
            # f32, hosted and cached, against the single-device engine.
            kernels_vs_plain(_host_out(e32, e32.dispatch(treqs)), want_hosted,
                             f"{label} f32 hosted",
                             against="single-device")
            got, cache = _cached_out(e32, list(task), max_hw)
            if d > 1:
                per = cache.num_slots // d
                rows = pt_mesh.batch_rows(e32.mesh, MESH_BATCH)
                require(all(cache.slot(c + 1) // per != r
                            for r, sl in enumerate(rows)
                            for c in range(sl.start, sl.stop)),
                        f"{label}: a batch row's slot on its own shard")
                print(f"{label} cached: every batch row's {per} slots live "
                      "on the other data row's shard", flush=True)
            kernels_vs_plain(got, want_cached, f"{label} f32 cached",
                             against="single-device")
            del cache
            # bf16 against the single-device f32 engine, detection level.
            g = bf16_gate(torch, e16, single32, treqs, task, conf, nms)
            print(f"{label} bf16 vs single-device f32 (task frames): counts "
                  f"{g['counts_bf16']} vs {g['counts_f32']}; literal gate "
                  f"{g['literal']}; margin gate {g['margin']} (excused "
                  f"{g['excused']}); worst twin IoU {g['worst_iou']:.4f}, "
                  f"worst conf delta {g['worst_conf']:.4f}", flush=True)
            for note in g["notes"]:
                print(f"  on a threshold: {note}", flush=True)
            require(sum(g["counts_f32"]) > 0 and all(g["margin"]),
                    f"{label}: bf16 detection gate failed")
            # Every kernel against its plain version at the sharded shapes
            # of data row 0 (bf16, the deployed dtype).
            bp = MESH_BATCH // d
            fr, hr, wr = staged_batch(torch, game[:bp], bucket, dev0)
            with torch.inference_mode():
                calls = record_mesh_calls(e16, fr, hr, wr)
                print(f"{label} row 0 kernel calls a step: " + ", ".join(
                    f"{n} {len(c)}" for n, c in calls.items()) + "; 1x1 "
                    "Cout " + str(sorted({int(a[1].shape[1]) for a, _ in
                                          calls["conv1x1_bias_act"]})),
                    flush=True)
                out["report"][label] = check_kernels(torch, calls, nms, dev0)
                torch.cuda.synchronize()
            routes = out["report"][label]["conv1x1_bias_act"]["routes"]
            print(f"{label}: 1x1 calls on the tensor cores {routes['wgmma']} "
                  f"of {sum(routes.values())}", flush=True)
            # The mesh path through the entry points, counts reset just
            # before and read just after.
            launches = reset_and_read(lambda: (
                e16.infer_batch(reqs), _cached_out(e16, game, max_hw)))
            require_launched(launches, label)
            print(f"{label} path launches (infer_batch + dispatch_from_cache, "
                  f"batch {MESH_BATCH}): {launches}", flush=True)
            for n in out["launches"]:
                out["launches"][n] += launches[n]
            # Device busy of the meshed step beside the single-device one.
            rows16 = [staged_batch(torch, game[sl], bucket, dev0)
                      for sl in pt_mesh.batch_rows(e16.mesh, MESH_BATCH)]

            def meshed_step():
                return e16._step_rows(cfg.detection.model_width, MESH_BATCH,
                                      e16._params, rows16)
            prof = profile_step(torch, meshed_step, nms_stages=d)[0]
            wall = wall_ms(torch, meshed_step)
            out["report"][label]["busy_ms"] = prof["busy_ms"]
            print(f"{label} bf16 step batch {MESH_BATCH} on {smi_line}: "
                  f"device busy {prof['busy_ms']:.3f} ms (single-device "
                  f"{single_busy:.3f} ms), {prof['kernels']} kernels (single-"
                  f"device {single_kernels}); "
                  f"wall {wall:.3f} ms (single-device {single_wall:.3f} ms); "
                  "profiler and host clock", flush=True)
            del e16, e32
    finally:
        pt_mesh.available_devices = real
    out["single_busy_ms"] = single_busy

    # The dp2 example configs on the cards there are: one card serves them
    # single-device with a warning, two or more on a real mesh.
    count = torch.cuda.device_count()
    for path in DP2_CONFIGS:
        dcfg = load_config(path)
        with _Warnings("zlt.engine") as warned:
            eng = InferenceEngine(dcfg, device=DEVICE)
        st = eng.status()
        require(not eng.simulation, f"{path.name}: simulation mode")
        if count >= 2:
            require(eng.mesh is not None and not eng.mesh.virtual,
                    f"{path.name} on {count} cards: no real mesh ({st})")
        else:
            require(eng.mesh is None and st["mesh"] == "1x1"
                    and any("single-device" in w for w in warned.messages),
                    f"{path.name} on one card: {st}, warnings "
                    f"{warned.messages}")
        b = min(eng.batch_buckets)
        res = eng.infer_batch(frame_requests(InferenceRequest, game[:b]))
        require(len(res) == b and all(
            0.0 <= v <= 1.0 for r in res for dd in r.detections
            for v in (dd.x, dd.y, dd.width, dd.height, dd.confidence)),
            f"{path.name}: {len(res)} results of {b}")
        print(f"{path.name} on {count} card(s): mesh {st['mesh']} (asked "
              f"{st['mesh_requested']}) devices {st['mesh_devices']}; "
              f"warning: {warned.messages[:1]}; served a batch of {b}: "
              f"{sum(len(r.detections) for r in res)} detections", flush=True)
        del eng
    return out


# Phase 14, the fleet: shards of the deployed config on one UDP port, all
# on the one card; the load of phase 6 on it, then a SIGHUP roll under
# load. Each change of the port's shard group in a roll (a shard leaves, a
# shard joins: two a shard) may lose each client's frames in flight: those
# queued for it at the shard it leaves (max_queue_size), those in the
# shard's batches in flight (tpu.max_inflight), and the one sent before the
# drain notice or the re-hash's session-loss answer reaches it.
FLEET_SHARDS = 2
FLEET_BOOT_S = 180.0
FLEET_ROLL_S = 120.0


def _fleet_config(directory: Path) -> tuple:
    """The deployed config for the fleet on free loopback ports (web_port
    and web_port + 1 free too), written to `directory`: (path, udp port,
    web port)."""
    from zero_latency_yolo_tpu_torch.bench_server import (RECV_BUFFER_BYTES,
                                                          free_port)
    import socket as _socket
    d = json.loads(CONFIG.read_text())
    d["model_path"] = str(ROOT / d["model_path"])
    while True:
        web = free_port(_socket.SOCK_STREAM)
        try:
            with _socket.socket() as probe:
                probe.bind(("127.0.0.1", web + 1))
            break
        except OSError:
            continue
    port = free_port()
    d.update(port=port, web_port=web, use_cpu_affinity=False)
    d["network"] = {"bind_address": "127.0.0.1",
                    "web_bind_address": "127.0.0.1",
                    "recv_buffer_size": RECV_BUFFER_BYTES}
    d["logging"] = {"log_file": str(directory / "server.log")}
    d["analytics"] = {"stats_file": str(directory / "stats.json")}
    path = directory / "server.json"
    path.write_text(json.dumps(d))
    return path, port, web


def _statusz(web: int):
    from zero_latency_yolo_tpu_torch.bench_server import http_get
    try:
        code, body = http_get(web, "/statusz")
    except OSError:
        return None
    return json.loads(body) if code == 200 else None


# A shard process's frame counts: those of the server's frame_counts(),
# which its stop() logs as its last, and its socket's own receive-buffer
# drops (rx_overflows; not the port's kernel_drops, which every shard of
# the port counts again). The roll counts a frame that a shard dropped or
# refused (its drops, cache rejects and frames from senders without a
# session) or that the kernel dropped at a shard's full socket as
# accounted for. Where no shard's socket has a count of its own (gVisor,
# the card's machine), the kernel counts those only machine-wide, in
# Udp.RcvbufErrors; in the roll's window only its own sockets take
# datagrams, so the machine's count over the window stands for them.
COUNT_KEYS = ("frames_received", "results_sent", "dropped", "frames_paused",
              "cache_rejects", "bad_packets", "frames_unknown_sender",
              "rx_overflows")


def _shard_counts(st: dict) -> dict:
    """The frame counts (COUNT_KEYS) of one shard's /statusz."""
    tr, fc = st["transport"], st.get("frame_cache") or {}
    return dict(frames_received=st["frames_received"],
                results_sent=st["results_sent"],
                dropped=int(st["engine"]["dropped"]),
                frames_paused=st["frames_paused"],
                cache_rejects=fc.get("cache_rejects", 0),
                bad_packets=tr["bad_packets"],
                frames_unknown_sender=tr["frames_unknown_sender"],
                rx_overflows=tr.get("rx_overflows") or 0)


def _udp_rx_queues(port: int) -> list:
    """The bytes queued in each UDP socket bound to `port`, from
    /proc/net/udp (Linux; empty where the file is missing)."""
    try:
        lines = Path("/proc/net/udp").read_text().splitlines()[1:]
    except OSError:
        return []
    return [int(f[4].split(":")[1], 16) for f in map(str.split, lines)
            if len(f) > 4 and int(f[1].rsplit(":", 1)[1], 16) == port]


def _stopped_counts(directory: Path) -> dict:
    """The last frame counts (COUNT_KEYS) that every shard process which
    stopped logged to its shard's log under `directory`, by pid."""
    import re
    out = {}
    for path in sorted(directory.glob("server-*.log*")):
        for m in re.finditer(r"server stopped: (\{.*\})",
                             path.read_text(errors="replace")):
            d = json.loads(m.group(1))
            out[d["pid"]] = {k: d.get(k) or 0 for k in COUNT_KEYS}
    return out


def _roll_stream(client, frames, fps: float, t0: float, stop, stats) -> None:
    """Stream raw frames at fps from t0 until `stop` is set, re-handshaking
    on the same socket after a drain notice (a skipped frame is not
    sent)."""
    i = 0
    while not stop.is_set():
        delay = t0 + i / fps - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        i += 1
        if client.server_disconnected:
            if not client.reconnect():
                stats["skipped"] += 1
                continue
            stats["rehandshakes"] += 1
        client.send_raw_frame(frames[i % len(frames)])
        stats["sent"] += 1


def _alive(pid: int) -> bool:
    """Whether process `pid` exists and is not a zombie."""
    try:
        stat = Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return False
    return stat.rsplit(")", 1)[1].split()[0] != "Z"


def fleet_phase(torch, smi_line: str) -> dict:
    """Phase 14, the fleet (see the module docstring). Returns the load's
    and the roll's numbers."""
    import tempfile
    import threading
    from zero_latency_yolo_tpu_torch.bench_server import (Clients,
                                                          client_frames,
                                                          net_counters)
    from zero_latency_yolo_tpu_torch.runtime.simulator import SimClient
    from zero_latency_yolo_tpu_torch.utils.netstats import snmp_counters
    import signal as _signal
    from zero_latency_yolo_tpu_torch.protocol import CommandType
    disconnect = int(CommandType.DISCONNECT)
    tmp = Path(tempfile.mkdtemp(prefix="zlt-fleet-"))
    cfg_path, port, web = _fleet_config(tmp)
    fcfg = json.loads(cfg_path.read_text())
    inflight_per_change = (int(fcfg.get("max_queue_size", 8))
                           + int(fcfg["tpu"].get("max_inflight", 2)) + 1)
    webs = [web + i for i in range(FLEET_SHARDS)]
    log_path = tmp / "fleet.log"
    t_start = time.perf_counter()
    with open(log_path, "w", encoding="utf-8") as logf:
        mgr = subprocess.Popen(
            [sys.executable, "-m", "zero_latency_yolo_tpu_torch.serve_fleet",
             "--config", str(cfg_path), "--shards", str(FLEET_SHARDS),
             "--device", DEVICE, "--status-interval", "0",
             "--roll-warm-grace", str(FLEET_ROLL_S),
             "--roll-drain-grace", "15"],
            cwd=ROOT, stdout=logf, stderr=subprocess.STDOUT)

    def log_tail(n=3000):
        text = log_path.read_text(errors="replace")
        return text if n is None else text[-n:]

    def pids():
        import re
        return [int(x) for x in re.findall(r"shard \d+: pid=(\d+)",
                                           log_path.read_text(errors="replace"))]
    def stop_fleet():
        """SIGTERM the manager (it stops every shard) and wait for it: its
        exit code, None if it had to be killed."""
        if mgr.poll() is None:
            mgr.send_signal(_signal.SIGTERM)
        try:
            return mgr.wait(timeout=60)
        except subprocess.TimeoutExpired:
            mgr.kill()
            mgr.wait(timeout=10)
            return None
    out = {}
    clients = None
    try:
        deadline = time.perf_counter() + FLEET_BOOT_S
        sts = [None] * FLEET_SHARDS
        while time.perf_counter() < deadline and not all(
                s and s["engine"]["warmed"] == "true" for s in sts):
            require(mgr.poll() is None, f"fleet manager exited: {log_tail()}")
            time.sleep(0.5)
            sts = [_statusz(w) for w in webs]
        require(all(s and s["engine"]["warmed"] == "true" for s in sts),
                f"fleet shards not warmed in {FLEET_BOOT_S:g} s: {log_tail()}")
        for i, s in enumerate(sts):
            require(s["port"] == port and s["engine"]["device"].startswith(
                DEVICE) and s["engine"]["simulation"] == "false",
                f"shard {i} statusz: port {s['port']}, engine {s['engine']}")
        print(f"fleet: {FLEET_SHARDS} shards on udp/{port} (web {webs}), "
              f"engines on {[s['engine']['device'] for s in sts]}, up and "
              f"warmed in {time.perf_counter() - t_start:.2f} s", flush=True)

        # The load of phase 6 on the fleet port.
        base = [_statusz(w) for w in webs]
        clients = Clients(port, SERVER_CLIENTS)
        t0 = time.perf_counter() + 0.05
        clients.start(SERVER_FPS, SERVER_SECONDS, t0)
        time.sleep(max(t0 + 3.0 - time.perf_counter(), 0))
        during = [_statusz(w) for w in webs]
        clients.join()
        last, still = None, time.perf_counter()
        while time.perf_counter() - still < 1.0:
            time.sleep(0.05)
            now = clients.results()
            if now != last:
                last, still = now, time.perf_counter()
        after = [_statusz(w) for w in webs]
        sent, results = [c[0] for c in clients.sent], clients.results()
        shard_rows = []
        for i, (b0, st) in enumerate(zip(base, after)):
            d = {k: v - _shard_counts(b0)[k]
                 for k, v in _shard_counts(st).items()}
            res, recv, drops = (d["results_sent"], d["frames_received"],
                                d["dropped"])
            kdrops = d["rx_overflows"]
            lat = st["detect_latency"]
            shard_rows.append(dict(
                clients=during[i]["clients"], received=recv, results=res,
                engine_drops=drops, socket_overflows=kdrops,
                results_per_s=res / SERVER_SECONDS, p50_ms=lat["p50_ms"],
                p99_ms=lat["p99_ms"],
                system_udp=st["transport"]["system_udp"]))
            print(f"fleet shard {i} ({st['engine']['device']}) on "
                  f"{smi_line}: clients {during[i]['clients']}, received "
                  f"{recv}, results {res} ({res / SERVER_SECONDS:.1f}/s over "
                  f"the {SERVER_SECONDS:g} s load), engine drops {drops}, "
                  f"socket overflows {kdrops} (rcvbuf "
                  f"{st['transport']['rcvbuf']} B, per-socket count "
                  f"{st['transport']['rx_overflows_source']}); detect "
                  f"latency p50 "
                  f"{lat['p50_ms']:.3f} ms p99 {lat['p99_ms']:.3f} ms "
                  f"(the shard's window); system_udp "
                  f"{st['transport']['system_udp']}", flush=True)
            require(0 <= recv - res - drops <= SERVER_SLACK,
                    f"shard {i}: received {recv} != results {res} + drops "
                    f"{drops}")
        accounted = sum(r["results"] + r["engine_drops"]
                        + r["socket_overflows"] for r in shard_rows)
        unaccounted = sum(sent) - accounted
        print(f"fleet load: {SERVER_CLIENTS} clients x raw "
              f"{SERVER_FRAME[0]}x{SERVER_FRAME[1]} at {SERVER_FPS:g} fps for "
              f"{SERVER_SECONDS:g} s: sent {sum(sent)}, results at the "
              f"clients {sum(results)} (per client {results}), the shards' "
              f"results + drops {accounted}; unaccounted {unaccounted} "
              f"(allowed 0..{SERVER_SLACK}); sessions by shard "
              f"{[r['clients'] for r in shard_rows]}", flush=True)
        require(all(r > 0 for r in results), f"a client got no results: "
                                             f"{results}")
        require(sum(r["clients"] for r in shard_rows) == SERVER_CLIENTS,
                f"sessions by shard {[r['clients'] for r in shard_rows]}")
        require(0 <= unaccounted <= SERVER_SLACK,
                f"{unaccounted} frames unaccounted for on the fleet")
        clients.stop()
        out["load"] = dict(sent=sum(sent), results=results,
                           unaccounted=unaccounted, shards=shard_rows)

        # The shards evict the load's clients before the roll's base is read.
        deadline = time.perf_counter() + 5.0
        while time.perf_counter() < deadline and any(
                st is None or st["clients"] for st in map(_statusz, webs)):
            time.sleep(0.1)

        # A SIGHUP roll under load.
        boot = pids()
        roll = [SimClient(("127.0.0.1", port), screen_width=SERVER_FRAME[0],
                          screen_height=SERVER_FRAME[1])
                for _ in range(SERVER_CLIENTS)]
        for c in roll:
            c.connect()
            c.start_receiver()
        # Each shard process's frame counts, by pid. The boot shards' at the
        # roll's start are the base (a replacement's is zero). A process's
        # last count is the one its stop() logs, read once the fleet has
        # stopped; one that logged none is counted by its last /statusz.
        snaps, polled, sources = {}, [0.0], {}
        # The roll's steps as the manager logs them, each with the time
        # since the SIGHUP and the machine's UDP receive-buffer drops then.
        timeline, t_hup = [], None

        def read_shards() -> None:
            for w in webs:
                st = _statusz(w)
                if st is not None:
                    snaps[st["pid"]] = _shard_counts(st)
                    sources[st["pid"]] = st["transport"]["rx_overflows_source"]
            polled[0] = time.perf_counter()
            if t_hup is not None:
                steps = [ln.split("rolling restart", 1)[1].strip(": ")
                         for ln in log_tail(None).splitlines()
                         if "rolling restart" in ln]
                for step in steps[len(timeline) - 1:]:
                    timeline.append((round(polled[0] - t_hup, 2), step,
                                     snmp_counters().get("Udp.RcvbufErrors"),
                                     _udp_rx_queues(port)))

        read_shards()
        base = dict(snaps)
        net0 = net_counters()
        require(sorted(base) == sorted(boot),
                f"boot shards {boot}, read at the roll's start {sorted(base)}")
        stats = [dict(sent=0, skipped=0, rehandshakes=0) for _ in roll]
        stop = threading.Event()
        t0 = time.perf_counter() + 0.05
        threads = [threading.Thread(
            target=_roll_stream, args=(c, client_frames(i), SERVER_FPS,
                                       t0 + i / (SERVER_FPS * len(roll)),
                                       stop, stats[i]), daemon=True)
            for i, c in enumerate(roll)]
        for t in threads:
            t.start()
        counts = [0] * len(roll)
        seen = [time.perf_counter()] * len(roll)
        gaps = [0.0] * len(roll)

        def watch(until: float) -> None:
            while time.perf_counter() < until:
                time.sleep(0.01)
                now = time.perf_counter()
                for i, c in enumerate(roll):
                    n = c.results_total
                    if n != counts[i]:
                        counts[i], seen[i] = n, now
                    gaps[i] = max(gaps[i], now - seen[i])
                if now - polled[0] >= 0.1:
                    read_shards()
        try:
            watch(t0 + 1.0)
            gaps[:] = [0.0] * len(roll)
            t_hup = time.perf_counter()
            timeline.append((0.0, "SIGHUP",
                             snmp_counters().get("Udp.RcvbufErrors"),
                             _udp_rx_queues(port)))
            mgr.send_signal(_signal.SIGHUP)
            deadline = t_hup + FLEET_SHARDS * FLEET_ROLL_S + 30.0
            while "rolling restart complete" not in log_tail(20000):
                require(time.perf_counter() < deadline
                        and "ABORTED" not in log_tail(20000)
                        and mgr.poll() is None,
                        f"the roll did not complete: {log_tail()}")
                watch(time.perf_counter() + 0.5)
            roll_s = time.perf_counter() - t_hup
            before = list(counts)
            watch(time.perf_counter() + 2.0)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10)
        served_after = [c - b for c, b in zip(counts, before)]
        new = [p for p in pids() if p not in boot]
        read_shards()
        final = [_statusz(w) for w in webs]
        # Stop the fleet with the clients' receivers still running, so that
        # what the shards send while they stop reaches them too.
        rc = stop_fleet()
        deadline = time.perf_counter() + 5.0
        while time.perf_counter() < deadline:
            time.sleep(0.2)
            if sum(c.results_total for c in roll) == sum(counts):
                break
            counts = [c.results_total for c in roll]
        got = sum(c.results_total for c in roll)
        net1 = net_counters()
        net = {k: net1[k] - net0[k] for k in net0
               if k in net1 and k != "lo_mtu"}
        logged = _stopped_counts(tmp)
        by_pid = {pid: {k: v - base.get(pid, {}).get(k, 0)
                        for k, v in logged.get(pid, snaps.get(pid)).items()}
                  for pid in sorted(set(snaps) | set(logged))}
        unlogged = sorted(set(snaps) - set(logged))
        tot = {k: sum(d[k] for d in by_pid.values()) for k in COUNT_KEYS}
        if sources and None not in sources.values():
            overflows, where = tot["rx_overflows"], "their sockets' own counts"
        else:
            overflows = net.get("Udp.RcvbufErrors", 0)
            where = ("the machine's Udp.RcvbufErrors over the roll: no socket "
                     "of a shard counts its own")
        refused = (tot["dropped"] + tot["cache_rejects"]
                   + tot["frames_unknown_sender"] + overflows)
        sent = sum(st["sent"] for st in stats)
        rehs = sum(st["rehandshakes"] for st in stats)
        unaccounted = sent - got - refused
        in_flight = inflight_per_change * 2 * FLEET_SHARDS * len(roll)
        allowed = in_flight + SERVER_SLACK
        breakdown = (
            f"sent {sent}; taken in by the shards {tot['frames_received']}, "
            f"so not taken in {sent - tot['frames_received']}; results sent "
            f"by the shards {tot['results_sent']}, at the clients {got}; "
            f"taken in and neither answered nor counted "
            f"{tot['frames_received'] - tot['results_sent'] - tot['dropped'] - tot['cache_rejects'] - tot['frames_paused'] - tot['bad_packets']}"
            f"; the shards' counts {tot}; the machine's UDP and IP drop "
            f"counters over the roll {net}; by shard process {by_pid}; "
            f"processes that logged no last count (their last /statusz "
            f"stands) {unlogged}")
        print(f"fleet roll (SIGHUP under the load) on {smi_line}: complete "
              f"in {roll_s:.2f} s, shards respawned as pids {new} (boot "
              f"{boot}); sent {sent}, results {got}, dropped or refused by "
              f"the shard processes {refused} (drops {tot['dropped']} + cache "
              f"rejects {tot['cache_rejects']} + from senders without a "
              f"session {tot['frames_unknown_sender']} + socket overflows "
              f"{overflows}, from {where}), "
              f"re-handshakes {rehs}, frames skipped while re-handshaking "
              f"{sum(st['skipped'] for st in stats)}; "
              f"unaccounted {unaccounted} (allowed 0..{allowed}: "
              f"{inflight_per_change} in flight a client and group change, "
              f"{2 * FLEET_SHARDS} changes, {len(roll)} clients, + "
              f"{SERVER_SLACK}); "
              f"longest gap between two results of a client "
              f"{max(gaps):.3f} s (per client "
              f"{[round(g, 3) for g in gaps]}); results per client in the "
              f"2 s after the roll {served_after}; system_udp "
              f"{[s['transport']['system_udp'] if s else None for s in final]}",
              flush=True)
        print("fleet roll per client: re-handshakes "
              f"{[st['rehandshakes'] for st in stats]}, drain notices "
              f"{[sum(1 for k in c.commands if k.command_type == disconnect) for c in roll]}"
              f", session-loss NAKs {[c.errors_seen for c in roll]}, sent "
              f"{[st['sent'] for st in stats]}, results "
              f"{[c.results_total for c in roll]}", flush=True)
        print(f"fleet roll accounting: {breakdown}", flush=True)
        print("fleet roll timeline (s after the SIGHUP, step, the machine's "
              "Udp.RcvbufErrors, bytes queued in each socket of the port): "
              f"{timeline}", flush=True)
        for c in roll:
            try:
                c.stop()
            except OSError:
                pass
        require(len(new) == FLEET_SHARDS, f"respawned pids {new}")
        require(all(n > 0 for n in served_after),
                f"a client was not served after the roll: {served_after}")
        require(0 <= unaccounted <= allowed,
                f"{unaccounted} frames unaccounted for across the roll "
                f"(allowed 0..{allowed}): {breakdown}")
        out["roll"] = dict(seconds=roll_s, sent=sent, results=got,
                           rehandshakes=rehs, unaccounted=unaccounted,
                           gap_s=max(gaps))
    finally:
        if clients is not None:
            clients.stop()
        rc = stop_fleet()
    orphans = [p for p in pids() if _alive(p)]
    for p in orphans:
        import os as _os
        _os.kill(p, 9)
    tail = log_tail()
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    require(rc == 0 and not orphans,
            f"fleet manager rc {rc}, orphan shards {orphans}: {tail}")
    print(f"fleet stopped: manager rc {rc}, no shard left", flush=True)
    return out


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
        from zero_latency_yolo_tpu_torch.ops import (_build, act_cuda,
                                                     conv1x1_cuda, nms_cuda)
        from zero_latency_yolo_tpu_torch.runtime import frames as frames_mod
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

    cfg = load_config(CONFIG)
    bucket = (608, 800)

    def staged(frames):
        return staged_batch(torch, frames, bucket, dev)

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
        reset_launch_counts()
        results = engine.infer_batch(reqs)
        pend = [engine.dispatch(reqs[:4]), engine.dispatch(reqs[4:8])]
        results += [r for rs in engine.complete_many(pend) for r in rs]
        torch.cuda.synchronize()
        counts = launch_counts()
        launches = {n: counts[n] for n in PATH3}
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
        want = eng32._build_step(8, plain=True)(*args).cpu().numpy()
        require(got.shape == (8, 1 + 6 * 32) and np.isfinite(got).all(),
                f"packed output {got.shape} not finite (8, 193)")
        kernels_vs_plain(got, want, "f32")

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

    with Phase("frame cache"):
        fc = frame_cache_phase(torch, engine, cfg, smi_line)

    with Phase("server"):
        srv = server_phase(torch, DEVICE, smi_line)

    with Phase("ladder, yolov8s@640"):
        ladder = ladder_phase(torch, smi_line)

    with Phase("step variants"):
        variants = variants_phase(torch, smi_line)

    with Phase("adaptive policy"):
        adaptive = adaptive_phase(torch, smi_line)

    with Phase("weights .pt/.onnx"):
        weights_phase(torch, smi_line)

    with Phase("int8"):
        int8 = int8_phase(torch, smi_line, frames_mod.cv2 is not None)

    with Phase("train"):
        train = train_phase(torch, smi_line)

    with Phase("mesh"):
        mesh = mesh_phase(torch, smi_line)

    with Phase("fleet"):
        fleet_phase(torch, smi_line)

    # The int8 conv's own path is the int8 path; every other kernel's is
    # the main path of phase 4.
    launches["conv_int8"] = int8["launches"]["conv_int8"]
    report["conv_int8"] = int8["report"]
    step_ms["conv_int8"] = int8["report"]["step_ms"]
    by_path = {n: {"main": counts[n], "frame_cache": fc["launches"][n],
                   "server_cached": srv["cached"]["launches"][n],
                   "server_hosted": srv["hosted"]["launches"][n],
                   "ladder_s640": ladder["launches"][n],
                   **{f"variant_{v}": variants[v][n] for v in variants},
                   "adaptive_server": adaptive["launches"][n],
                   "int8": int8["launches"][n],
                   **{f"int8_step_b{b}": int8["per_step"][b][n]
                      for b in int8["per_step"]},
                   "int8_server_cached": int8["server"][n],
                   "int8_server_profilez": int8["server_profilez"][n],
                   "train_eval": train["launches"][n],
                   "mesh": mesh["launches"][n]}
               for n in KERNELS}
    s640 = ladder["report"]
    print("kernels: " + ", ".join(
        f"{n} launches={launches[n]} (by path {by_path[n]})" for n in KERNELS),
        flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": route, "source": source, "replaces": replaces,
         "launches": launches[name], "launches_by_path": by_path[name],
         "max_abs_err": report[name]["max_abs_err"],
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
            if name == "conv1x1_bias_act" else {}),
         **({"at_yolov8s_640_b16": {k: s640[name][k] for k in (
             "calls", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")}} if name in s640 else {}),
         **({k: report[name][k] for k in (
             "batch", "calls", "max_ulp", "not_bit_equal", "elements",
             "library_calls", "ms_library_calls")}
            if name == "conv_int8" else {})}
        for name, (route, source, replaces) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
