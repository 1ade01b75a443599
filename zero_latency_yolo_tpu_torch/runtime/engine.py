"""Inference engine on an NVIDIA GPU: one serving step per (batch, frame-bucket).

The PyTorch counterpart of the JAX package's `runtime/engine.py`
`InferenceEngine`. One step runs

    uint8 frames -> letterbox -> YOLOv8 -> DFL decode -> weighted NMS -> pack

on the device, so one H2D copy (the padded frame batch) and one small D2H copy
(the packed (B, 1 + 6*32) f32 result) happen per batch. The convs and the
suppression scan go through the port's CUDA kernels (see `models/yolov8.py`
and `ops/nms.py`). `dispatch` starts the D2H copy into a pinned host buffer
right after the step and records a CUDA event behind it, so the batcher can
ask whether a batch is done (`PendingBatch.event`) and `complete` reads the
buffer without a second copy.

Batches are padded up to a batch bucket and frames into a frame bucket; the
true per-frame (h, w) are runtime tensors. Simulation mode serves random
detections when the model file cannot be loaded, as the JAX engine does
(reference onnx_engine.cpp:70-75, :1133-1177).

Frames held in the device frame cache (`ops/roi.py` `DeviceFrameCache`)
are served without a host copy: `dispatch_from_cache` uploads one packed
(3, B) int32 slots/heights/widths array from pinned memory, gathers the
batch's slots out of the cache on the device (`cache.index_select`) and
runs the same step on the cache's own bucket. The server's batcher splits
that into `gather_from_cache`, run under the cache's lock, and
`dispatch_gathered`, run after it (see scheduler.py).

Steps are cached by (batch bucket, serve size): the frame bucket changes no
step in PyTorch, but the C2f form may change with the batch (`resolve_c2f`)
and the letterbox target with the serve rung. The serve-size ladder
(tpu.serve_sizes) and its adaptive policy are the JAX engine's: under a
sustained p99 above tpu.adaptive_slo_ms the engine steps down the ladder,
and back up when the margin is wide (`_maybe_adapt`); a client's accuracy
floor (min_serve_size) snaps up the ladder (`effective_serve_size`). Every
tpu.preprocess, tpu.select, tpu.c2f and tpu.stem value is served; the
synthetic step (tpu.synthetic_step_ms / synthetic_step_profile(s)) replaces
the device with a host-only fake lane whose step times come from the config.

tpu.quantize_int8 serves the int8 backbone (`ops/quant.py`): per-channel
int8 weights and static activation scales calibrated on synthetic
letterboxed samples at construction and at every hot reload, applied on the
dispatch thread (`_quantize_and_calibrate`); the int8 convs run the int8
conv kernel (`ops/conv_int8_cuda.py`), the stem and the head stay in the
engine's dtype. The TPU kernel switches tpu.nms / tpu.act / tpu.conv1x1 and
tpu.dot1x1 have no effect here.

A serving mesh (tpu.mesh_data x tpu.mesh_model > 1, `parallel/mesh.py`) is
built from `parallel.mesh.available_devices()` as the JAX engine builds
its: with fewer devices than the mesh the engine logs a warning and serves
on one device (its own: never the CPU when it was asked for the card), and
under a mesh the batch buckets that mesh_data does not divide are dropped.
On the mesh every batch splits into mesh_data rows, each staged
`non_blocking` onto its row's lead device and stepped there; params are
placed by `parallel/mesh.py` `shard_params` (conv output channels over the
model axis, run through `models/yolov8.py` `tp_conv`; int8 blocks whole);
the rows' packed results are copied into one pinned host buffer, behind
one event a device. A hot reload re-shards; int8 calibration runs on the
whole tree before it is sharded, as in the JAX engine.

`create_engine` picks the engine from `config.inference_engine` under the
JAX package's registry names: "jax" and "onnx" select `InferenceEngine`,
"simulation" `SimulationEngine`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import CS16_CLASS_NAMES, ServerConfig
from ..models.weights import (file_sha256, load_model, params_from_jax,
                              place_params)
from ..models.yolov8 import (ModelSpec, forward_decoded,
                             forward_decoded_levels, get_spec, tp_conv)
from ..ops import nms as nms_ops
from ..ops import preprocess as pre_ops
from ..ops._build import KernelError
from ..ops.preprocess import letterbox_params
from ..ops.quant import (calibrate_activations, quantize_params, set_x_scales,
                         x_scales)
from ..parallel import mesh as mesh_mod
from ..protocol import Detection
from ..utils.logging import get_logger
from ..utils.stats import Counter, RollingStats

log = get_logger("engine")

# tpu.c2f="auto": the JAX package's per-(serving config, batch bucket) choice
# of the C2f form, copied so that both engines run the same computation for
# each bucket (the split form where the JAX package measured it faster on its
# TPU: yolov8n at 416 in bf16, batch 32; the slice form everywhere else). The
# port has no measurement of its own behind this table.
C2F_AUTO_SPLIT = {("yolov8n", 416, "bfloat16"): frozenset({32})}


def resolve_c2f(flag: str, batch: int, variant: str = "yolov8n",
                size: int = 416, dtype: str = "bfloat16") -> str:
    """The C2f form of one (serving config, batch bucket) for tpu.c2f="auto";
    explicit "slice"/"split" values pass through for every bucket."""
    if flag == "auto":
        split = C2F_AUTO_SPLIT.get((variant, size, dtype), frozenset())
        return "split" if batch in split else "slice"
    return flag


@dataclass
class InferenceRequest:
    client_id: int
    frame_id: int
    timestamp: int
    width: int
    height: int
    data: Optional[np.ndarray]  # (h, w, 3) uint8 RGB
    keyframe: bool = False
    # Accuracy floor (the client's min_serve_size): the adaptive policy may
    # step the fleet down the ladder, but this request is served at a rung
    # >= min_size (0 = follow the fleet). The scheduler groups a batch by
    # effective rung before dispatching.
    min_size: int = 0
    enqueue_t: float = field(default_factory=time.perf_counter)
    # Stamped at payload-decode completion (the server rewinds enqueue_t to
    # datagram arrival).
    decoded_t: float = field(default_factory=time.perf_counter)


@dataclass
class PendingBatch:
    """A dispatched-but-unread device step (see InferenceEngine.dispatch)."""
    requests: List[InferenceRequest]
    out: Optional[torch.Tensor]
    t0: float
    n: int
    simulated: Optional[List["EngineResult"]] = None
    # Pinned host staging buffers (frames and packed heights and widths, or
    # a cached batch's packed slots, heights and widths): held until the
    # batch's results are read back (which proves their H2D copies
    # finished), then recycled.
    staging_key: Optional[Tuple] = None
    staging_buf: Optional[Tuple[torch.Tensor, ...]] = None
    # CUDA only: an event recorded on the stream after the step and after
    # the D2H copy of `out` into the pinned buffer `host` (when the copy was
    # started at dispatch: max_inflight <= 2). The event says whether the
    # batch is done without waiting for it. On a serving mesh `out` is the
    # list of the data rows' outputs, every row's copy into `host` starts
    # at dispatch, and `event` is an `_Events` over one event a device.
    event: Optional[Any] = None
    host: Optional[torch.Tensor] = None
    # Synthetic step only: when the fake device step "finishes" (complete()
    # waits until then, the batcher's _ready polls against it) and the step
    # time charged to this batch.
    ready_at: Optional[float] = None
    step_ms: float = 0.0
    # The serve rung the batch ran at; stamped onto each EngineResult.
    serve_size: int = 0

    @property
    def is_real_device(self) -> bool:
        """True when completion needs a real device readback (the only kind
        that can wedge): not simulated, not a synthetic step."""
        return (self.out is not None and self.ready_at is None
                and self.simulated is None)


@dataclass
class GatheredBatch:
    """A batch gathered out of the device frame cache and not yet stepped
    (InferenceEngine.gather_from_cache): its (B, H, W, 3) frames, a new
    tensor on the device; the device copy of its packed (3, B) int32 slots,
    heights and widths; and the pinned staging buffer that copy came from.
    On a serving mesh `frames` and `shw` are lists, one entry a data row
    ((B / data, H, W, 3) and (3, B / data), on the row's lead device)."""
    frames: Any
    shw: Any
    staging_key: Tuple
    staging_buf: Tuple[torch.Tensor, ...]
    t0: float


@dataclass
class EngineResult:
    client_id: int
    frame_id: int
    timestamp: int
    detections: List[Detection]
    infer_ms: float = 0.0
    queue_ms: float = 0.0
    recv_t: float = 0.0
    decode_ms: float = 0.0
    batch_n: int = 0
    serve_size: int = 0


def _pick_bucket(buckets: Sequence[Tuple[int, int]], h: int, w: int
                 ) -> Optional[Tuple[int, int]]:
    """Smallest configured bucket covering (h, w); None when none does."""
    for bh, bw in sorted(buckets, key=lambda b: b[0] * b[1]):
        if h <= bh and w <= bw:
            return (bh, bw)
    return None


def _gather(cache: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """The batch's slots out of the frame cache, into a new tensor."""
    return cache.index_select(0, slots)


def _row_inputs(frames: Sequence[torch.Tensor], packed: Sequence[torch.Tensor]
                ) -> List[Tuple[torch.Tensor, ...]]:
    """(frames, heights, widths) a data row of a serving mesh, from each
    row's frames and packed int32 rows (heights and widths the last two)."""
    return [(f, p[-2], p[-1]) for f, p in zip(frames, packed)]


class _Events:
    """The CUDA events of a batch stepped on a serving mesh, one a device:
    the batch is done when every one has passed."""

    def __init__(self, events: List[Any]) -> None:
        self.events = events

    def query(self) -> bool:
        return all(e.query() for e in self.events)

    def synchronize(self) -> None:
        for e in self.events:
            e.synchronize()


def _pick_batch(buckets: Sequence[int], n: int) -> int:
    for b in sorted(buckets):
        if n <= b:
            return b
    return max(buckets)


def group_by_bucket(frame_buckets: Sequence[Tuple[int, int]],
                    requests: Sequence[InferenceRequest]
                    ) -> Dict[Optional[Tuple[int, int]], List[InferenceRequest]]:
    """Group requests by the frame bucket that covers them (None = none
    does); dispatch() serves one bucket per call."""
    groups: Dict[Optional[Tuple[int, int]], List[InferenceRequest]] = {}
    for r in requests:
        groups.setdefault(_pick_bucket(frame_buckets, r.height, r.width),
                          []).append(r)
    return groups


@contextlib.contextmanager
def full_f32_precision():
    """Run cuDNN convs and matmuls in full f32, not TF32 (cuDNN's f32 convs
    are TF32 by default), and restore the caller's settings on exit. Uses the
    per-op precision settings where PyTorch has them (2.9 and later), which
    the older `allow_tf32` flags map onto there, else those flags. The
    settings are process-wide: another thread's convs in the meantime also
    run in full f32."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    if hasattr(cudnn, "conv") and hasattr(cudnn.conv, "fp32_precision"):
        knobs = [(cudnn.conv, "fp32_precision", "ieee"),
                 (matmul, "fp32_precision", "ieee")]
    else:
        knobs = [(cudnn, "allow_tf32", False), (matmul, "allow_tf32", False)]
    saved = [getattr(obj, name) for obj, name, _ in knobs]
    try:
        for obj, name, off in knobs:
            setattr(obj, name, off)
        yield
    finally:
        for (obj, name, _), value in zip(knobs, saved):
            setattr(obj, name, value)


def _unstretch(boxes: torch.Tensor, sy: torch.Tensor) -> torch.Tensor:
    """Boxes (B, A, 4+) of a stretched frame with y and h divided by the
    per-frame (B, 1) factor sy: the stretch's separate x and y scales in the
    (scale, pad) form postprocess undoes."""
    boxes = boxes.clone()
    boxes[..., 1] /= sy
    boxes[..., 3] /= sy
    return boxes


class InferenceEngine:
    """Synchronous batched compute wrapper; the caller owns queues/threads.

    Device work (dispatch, complete, warmup, applying a hot reload) happens
    on one thread at a time: in the server, warmup runs before the batcher
    starts and the batcher thread alone does the rest. Thresholds, SLO and
    reload requests may come from any thread; they only stage host state."""

    # SimulationEngine: random detections, no model load, no device state.
    _always_simulate = False
    # An upshift answered by a downshift within this window is a failed
    # probe (drives the exponential upshift holddown; see _maybe_adapt).
    _UPSHIFT_PROBE_S = 10.0

    def __init__(self, config: ServerConfig,
                 params: Optional[Dict[str, Any]] = None,
                 device: str = "cuda") -> None:
        self.config = config
        tpu = config.tpu
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("InferenceEngine(device='cuda'): no CUDA device "
                               "(pass device='cpu' to run the plain versions)")
        if config.detection.model_width != config.detection.model_height:
            raise ValueError("non-square model inputs not supported")
        self.spec: ModelSpec = get_spec(tpu.variant, tpu.num_classes)
        self.model_size = int(config.detection.model_width)
        self.dtype = torch.bfloat16 if tpu.dtype == "bfloat16" else torch.float32
        self.batch_buckets = tuple(int(b) for b in tpu.batch_buckets)
        self.frame_buckets = tuple(tuple(b) for b in tpu.frame_buckets)
        self.pre_nms_topk = int(tpu.pre_nms_topk)
        self.max_inflight = max(int(tpu.max_inflight), 1)
        # Serve-size ladder (adaptive resolution): the fully-convolutional
        # model serves any 32-multiple size from the same params; steps are
        # keyed by size and the current size is dispatch-thread state.
        ladder = {int(s) for s in tpu.serve_sizes or ()}
        too_big = {s for s in ladder if s > self.model_size}
        if too_big:
            # The policy only trades resolution down from the configured
            # size: a larger rung would let a healthy server upshift above
            # the operator's baseline.
            log.warning("tpu.serve_sizes rungs %s exceed model size %d — "
                        "dropped", sorted(too_big), self.model_size)
            ladder -= too_big
        self.serve_sizes = tuple(sorted(ladder | {self.model_size},
                                        reverse=True))
        self._serve_size = self.model_size
        self.adaptive_slo_ms = float(tpu.adaptive_slo_ms)
        # Policy state (dispatch thread only): a short window of its own, so
        # a size switch is judged on fresh samples.
        self._adapt_stats = RollingStats(window=256)
        self._adapt_next_check = 0.0
        self._adapt_hot = 0
        self._adapt_cool = 0
        self.size_downshifts = 0
        self.size_upshifts = 0
        # Upshift holddown: an upshift followed by a downshift within
        # _UPSHIFT_PROBE_S failed under the current load; each failed probe
        # doubles the wait before the next one, bounded.
        self._last_upshift_t = -1e9
        self._upshift_fail_streak = 0
        self._upshift_block_until = 0.0
        # A runtime SLO change (update_adaptive_slo) staged for the dispatch
        # thread; the lock makes stage and consume atomic, so a concurrent
        # update the client was acknowledged for is never lost.
        self._staged_slo: Optional[float] = None
        self._slo_lock = threading.Lock()
        # Rungs every (batch, bucket) step of which warmup ran: a runtime
        # SLO enable is refused while a rung is cold, so that a downshift
        # under pressure is never the first call of its shapes (cuDNN's
        # algorithm choice and the 1x1 kernel's plans are made there).
        self._warmed_sizes: Tuple[int, ...] = ()

        self.simulation = self._always_simulate
        self._model_hash: Optional[str] = None
        self._failed_hash: Optional[str] = None  # last unloadable file hash
        self._file_sig: Optional[Tuple[int, int]] = None  # (mtime_ns, size)
        if params is None and not self.simulation:
            params, self.spec, self.simulation = load_model(
                config.model_path, tpu.variant, tpu.num_classes)
            if not self.simulation:
                self._model_hash = file_sha256(config.model_path)
            else:
                log.warning("model %s not loadable — simulation mode active",
                            config.model_path)
        # The synthetic step (a measurement harness for everything around
        # the step): a fixed-duration fake device step, or one per batch
        # bucket (synthetic_step_profile) and per serve size
        # (synthetic_step_profiles), with times from the config. It forces
        # simulated detections and never touches the device.
        self.synthetic_step_ms = float(tpu.synthetic_step_ms)
        self.synthetic_profile = {
            int(k): float(v)
            for k, v in (tpu.synthetic_step_profile or {}).items()}
        self.synthetic_profiles = {
            int(size): {int(k): float(v) for k, v in prof.items()}
            for size, prof in (tpu.synthetic_step_profiles or {}).items()}
        if self.synthetic_profiles:
            if self.adaptive_slo_ms > 0:
                missing = set(self.serve_sizes) - set(self.synthetic_profiles)
                if missing:
                    raise ValueError(
                        f"tpu.synthetic_step_profiles missing ladders for "
                        f"serve sizes {sorted(missing)}")
            if not self.synthetic_profile:
                self.synthetic_profile = self.synthetic_profiles.get(
                    self.model_size) or next(
                        iter(self.synthetic_profiles.values()))
        if self.synthetic_profile and self.synthetic_step_ms <= 0:
            self.synthetic_step_ms = max(self.synthetic_profile.values())
        if self.synthetic_step_ms > 0:
            if not self.simulation:
                log.warning("synthetic_step_ms=%.2f: device compute DISABLED "
                            "(measurement harness)", self.synthetic_step_ms)
            self.simulation = True
        # When the previous fake step finishes: fake steps queue one after
        # another like the real device lane.
        self._synthetic_last_ready = 0.0
        # Serving mesh (tpu.mesh_data x tpu.mesh_model > 1): batch rows over
        # "data", conv output channels over "model". Not in simulation,
        # which never touches a device.
        self.mesh: Optional[mesh_mod.Mesh] = None
        md, mm = int(tpu.mesh_data), int(tpu.mesh_model)
        self.mesh_requested = (md, mm)
        if md * mm > 1 and not self.simulation:
            devices = mesh_mod.available_devices(self.device)
            if len(devices) >= md * mm:
                self.mesh = mesh_mod.make_mesh(md, mm, devices[:md * mm])
                self.device = self.mesh.leads[0]
                log.info("serving mesh active: data=%d model=%d (%s)", md, mm,
                         self.mesh.describe())
            else:
                log.warning("tpu.mesh %dx%d needs %d devices, have %d — "
                            "single-device serving on %s", md, mm, md * mm,
                            len(devices), self.device)
        if self.mesh is not None:
            # Batch buckets must divide evenly over the data axis.
            kept = tuple(b for b in self.batch_buckets if b % md == 0)
            if kept != self.batch_buckets:
                log.warning("batch buckets %s -> %s (multiples of data=%d)",
                            self.batch_buckets, kept or (md,), md)
            self.batch_buckets = kept or (md,)
        # Simulation never touches the device.
        self._params = None if self.simulation else self._device_params(
            self._host_params(params))
        self._set_class_weights()
        # A hot reload staged by maybe_reload (host tensors, and the file's
        # geometry when leaving simulation), applied by the dispatch thread.
        self._staged: Optional[Tuple[Any, Optional[ModelSpec]]] = None
        self._params_lock = threading.Lock()

        # Steps by (batch, serve size), and ("cached", batch, serve size).
        self._step_cache: Dict[Tuple, Any] = {}
        # Per-shape free-lists of host staging buffer pairs (see dispatch).
        self._staging: Dict[Tuple[int, int, int],
                            List[Tuple[torch.Tensor, torch.Tensor]]] = {}

        # Telemetry (reference stats fields, onnx_engine.h:261-273).
        self.inference_count = Counter()
        self.frames_dropped = Counter()
        # Subset of frames_dropped: oversized-frame sheds (client misconfig,
        # load-invariant; rate control leaves them out of its drop share).
        self.frames_oversized = Counter()
        self.error_count = Counter()
        self.latency = RollingStats()      # dispatch -> readback (pipeline)
        self.e2e_latency = RollingStats()  # submit -> result
        self.synthetic_host = RollingStats()  # e2e minus the fake step
        self.batch_sizes = RollingStats()
        self._rng = random.Random(1337)
        self.warmed = self.simulation

    def _set_class_weights(self) -> None:
        """The class weights on the device, and on each data row's lead
        device (`_row_class_weights`; the one device off a mesh)."""
        nc = self.spec.num_classes
        names = CS16_CLASS_NAMES if nc == len(CS16_CLASS_NAMES) else tuple(
            f"class_{i}" for i in range(nc))
        self._class_weights = torch.tensor(
            self.config.detection.class_weight_vector(names),
            dtype=torch.float32,
            device=None if self.simulation else self.device)
        self._row_class_weights = (
            [self._class_weights.to(d) for d in self.mesh.leads]
            if self.mesh is not None else [self._class_weights])

    def _c2f_form(self, batch: int, size: int) -> str:
        tpu = self.config.tpu
        return resolve_c2f(tpu.c2f, batch, variant=tpu.variant, size=size,
                           dtype=tpu.dtype)

    def _place_kw(self) -> Dict[str, bool]:
        """The layouts `place_params` adds: the split C2f's weight pieces
        when some (batch bucket, rung) runs that form, the space-to-depth
        stem kernel when tpu.stem="s2d"."""
        return dict(c2f_split=any(self._c2f_form(b, s) == "split"
                                  for b in self.batch_buckets
                                  for s in self.serve_sizes),
                    stem_s2d=self.config.tpu.stem == "s2d")

    def _place(self, params):
        """Device placement of device-form params: one placed tree, or on
        a serving mesh one tree a data row (`parallel/mesh.py`
        `shard_params` and `row_params`: the tensor-parallel layout)."""
        if self.mesh is None:
            return place_params(params, self.device, self.dtype,
                                **self._place_kw())
        trees = mesh_mod.shard_params(params, self.mesh, self.dtype,
                                      **self._place_kw())
        return [mesh_mod.row_params(self.mesh, trees, r)
                for r in range(self.mesh.data)]

    def _host_params(self, tree):
        """What a loaded NumPy tree is staged as (any thread, host work
        only): its device form, or with tpu.quantize_int8 the tree itself,
        which the dispatch thread quantizes and calibrates
        (_device_params), as the JAX engine does."""
        return tree if self.config.tpu.quantize_int8 else params_from_jax(tree)

    def _device_params(self, host):
        """Dispatch thread only: the placed params of a staged host form."""
        if self.config.tpu.quantize_int8:
            return self._quantize_and_calibrate(host)
        return self._place(host)

    def _quantize_and_calibrate(self, tree):
        """int8 backbone: per-channel weight quant, placed, then static
        activation scales calibrated on synthetic letterboxed samples (the
        JAX engine's sample: default_rng(0), one uniform frame and one
        letterbox-gray frame at the model size) in the engine's dtype. A
        calibration that fails leaves dynamic quant, as in the JAX engine,
        except where a kernel failed to build or launch, or the device
        faulted: that raises, since the step would fail too."""
        quantized = params_from_jax(quantize_params(tree))
        # Calibrated whole on the (first) device; on a mesh the scales are
        # then carried onto the sharded placement.
        placed = place_params(quantized, self.device, self.dtype,
                              **self._place_kw())
        rng = np.random.default_rng(0)
        sample = (rng.uniform(0.0, 1.0, (2, self.model_size, self.model_size, 3))
                  .astype(np.float32))
        sample[1] = 114.0 / 255.0  # letterbox-gray frame
        precision = (full_f32_precision if self.dtype == torch.float32
                     else contextlib.nullcontext)
        try:
            with precision():
                n = calibrate_activations(placed, self.spec, sample,
                                          dtype=self.dtype)
            log.info("int8 calibration: %d convs got static scales", n)
        except KernelError:
            raise
        except Exception:  # noqa: BLE001 — fall back to dynamic quant
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # a device fault raises
            log.exception("activation calibration failed; dynamic quant")
        if self.mesh is None:
            return placed
        scales = x_scales(placed)
        rows = self._place(quantized)
        for row in rows:
            if scales:
                set_x_scales(row, scales)
        return rows

    # ---------------------------------------------------------------- step
    def _build_step(self, batch: int, size: Optional[int] = None,
                    plain: bool = False):
        """The serving step of one (batch bucket, serve size):
        step(params, frames, heights, widths, class_w, conf, iou) -> packed
        (B, 1 + 6*MAX_DET) f32, the JAX engine's `_build_step`: resize by
        tpu.preprocess (or the space-to-depth letterbox with tpu.stem="s2d"),
        the model with the C2f form `resolve_c2f` picks for the batch, the
        decode, and the concat or per-level candidate selection (tpu.select).
        `plain=True` runs every kernel's plain PyTorch version instead (the
        reference a run checks the kernels against). An f32 step runs its
        convs and matmuls in full f32 whatever the caller's TF32 settings
        (`full_f32_precision`). On a serving mesh the step of the batch
        bucket runs on each data row's B / data rows and params, with
        `tp_conv` when the model axis shards channels."""
        size = int(size or self.model_size)
        spec, dtype, topk = self.spec, self.dtype, self.pre_nms_topk
        tpu = self.config.tpu
        mode, stem, select = tpu.preprocess, tpu.stem, tpu.select
        tensor_parallel = self.mesh is not None and self.mesh.model > 1
        model_kw = dict(dtype=dtype, plain=plain, stem=stem,
                        c2f=self._c2f_form(batch, size), dot1x1=tpu.dot1x1,
                        conv_fn=tp_conv if tensor_parallel else None)
        if stem == "s2d":
            if not mode.startswith("letterbox"):
                raise ValueError("stem='s2d' requires a letterbox preprocess")
            mode = "letterbox"  # for the scale/pad branch below

            def resize(f, hh, ww):
                return pre_ops.letterbox_batch_mxu_s2d(f, hh, ww, size, dtype)
        else:
            resize = {
                "letterbox": lambda f, hh, ww: pre_ops.letterbox_batch(
                    f, hh, ww, size),
                "letterbox_mxu": lambda f, hh, ww: pre_ops.letterbox_batch_mxu(
                    f, hh, ww, size, dtype),
                "stretch": lambda f, hh, ww: pre_ops.stretch_batch(
                    f, hh, ww, size),
            }[mode]
        precision = (full_f32_precision if dtype == torch.float32
                     else contextlib.nullcontext)

        @torch.inference_mode()
        def step(params, frames, heights, widths, class_w, conf, iou):
            with precision():
                x = resize(frames, heights, widths)
                hf = heights.to(torch.float32)
                wf = widths.to(torch.float32)
                if mode.startswith("letterbox"):
                    scale, pad_x, pad_y = letterbox_params(hf, wf, size)
                    pad = torch.stack([pad_x, pad_y], dim=-1)
                    sy = None
                else:
                    # Stretch: separate x and y scales, folded into the
                    # (scale, pad) form by giving postprocess the x scale
                    # and rescaling y and h.
                    scale = size / wf
                    pad = torch.zeros((frames.shape[0], 2),
                                      dtype=torch.float32, device=hf.device)
                    sy = ((size / hf) / scale)[:, None]
                src_wh = torch.stack([wf, hf], dim=-1)
                if select == "perlevel":
                    boxes_l, probs_l = forward_decoded_levels(
                        params, spec, x, **model_kw)
                    if sy is not None:
                        boxes_l = [_unstretch(b, sy) for b in boxes_l]
                    out = nms_ops.postprocess_batch_levels(
                        boxes_l, probs_l, class_w, conf, iou, scale, pad,
                        src_wh, topk, plain=plain)
                else:
                    pred = forward_decoded(params, spec, x, **model_kw)
                    if sy is not None:
                        pred = _unstretch(pred, sy)
                    out = nms_ops.postprocess_batch(
                        pred, class_w, conf, iou, scale, pad, src_wh, topk,
                        plain=plain)
                return nms_ops.pack_outputs(out)

        return step

    def get_step(self, batch: int, bucket: Tuple[int, int],
                 size: Optional[int] = None):
        """The step of a (batch, bucket) pair at serve size `size` (default:
        the current rung). PyTorch compiles nothing per shape, so the steps
        are cached by (batch, size) only."""
        size = int(size or self._serve_size)
        key = (batch, size)
        fn = self._step_cache.get(key)
        if fn is None:
            fn = self._step_cache[key] = self._build_step(batch, size)
        return fn

    def get_step_cached(self, batch: int, bucket: Tuple[int, int],
                        size: Optional[int] = None):
        """The cached step: step(params, cache, shw, class_w, conf, iou),
        shw a (3, B) int32 device tensor of rows [slots, heights, widths]:
        the gather of the batch's slots out of the device frame cache
        followed by the step (the JAX engine's fused program)."""
        size = int(size or self._serve_size)
        key = ("cached", batch, size)
        fn = self._step_cache.get(key)
        if fn is None:
            step = self.get_step(batch, bucket, size)

            def fn(params, cache, shw, class_w, conf, iou):
                return step(params, _gather(cache, shw[0]), shw[1], shw[2],
                            class_w, conf, iou)
            self._step_cache[key] = fn
        return fn

    def _step(self, size: int, params, frames: torch.Tensor, heights,
              widths, class_w, conf, iou) -> torch.Tensor:
        """Run the step of (len(frames), size) on a staged or gathered batch:
        every dispatch path off a mesh launches its step here."""
        return self.get_step(int(frames.shape[0]),
                             (int(frames.shape[1]), int(frames.shape[2])),
                             size)(params, frames, heights, widths, class_w,
                                   conf, iou)

    def _step_rows(self, size: int, batch: int, params,
                   rows: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]]) -> List[torch.Tensor]:
        """The step of (batch, size) on each data row of a serving mesh:
        rows[r] = (frames, heights, widths) of row r on its lead device,
        params[r] its placed tree; every dispatch path on a mesh launches
        its steps here. Returns each row's packed output."""
        f0 = rows[0][0]
        step = self.get_step(batch, (int(f0.shape[1]), int(f0.shape[2])),
                             size)
        conf, iou = self.config.confidence_threshold, self.config.nms_threshold
        return [step(params[r], f, h, w, self._row_class_weights[r], conf, iou)
                for r, (f, h, w) in enumerate(rows)]

    def _to_rows(self, frames: torch.Tensor, shw: torch.Tensor
                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """A batch's frames (B, H, W, 3) and packed (k, B) int32 rows split
        over the mesh's data rows: each row's frames copied `non_blocking`
        onto its lead device (from pinned memory, or from another device),
        the packed rows once onto each distinct lead. Returns (each row's
        frames, each row's (k, B / data) packed rows)."""
        packed = {d: shw.to(d, non_blocking=True)
                  for d in dict.fromkeys(self.mesh.leads)}
        spans = mesh_mod.batch_rows(self.mesh, int(frames.shape[0]))
        return ([frames[sl].to(lead, non_blocking=True)
                 for sl, lead in zip(spans, self.mesh.leads)],
                [packed[lead][:, sl]
                 for sl, lead in zip(spans, self.mesh.leads)])

    def warmup(self, batches: Optional[Sequence[int]] = None,
               buckets: Optional[Sequence[Tuple[int, int]]] = None,
               cache=None, inflight: int = 0) -> float:
        """Run every (batch, bucket) step once at every reachable rung (all
        of the ladder when the adaptive policy is on, else the current size);
        returns seconds spent. With `cache` (a DeviceFrameCache, or its
        device tensor) the cache's write path is run once too (`warm`), and
        the cached step once per batch bucket and rung under the cache's
        lock: a keyframe written meanwhile by a client is flushed first,
        never overwritten mid-step. PyTorch compiles nothing per shape, but
        a shape's first call pays for cuDNN's algorithm choice and the 1x1
        kernel's plan, which is what warming a rung buys. The rungs are
        certified for a runtime SLO enable (update_adaptive_slo) only when
        the full (batch, bucket) grid ran. `inflight` is the server's
        pipeline depth, for which PyTorch has nothing to compile."""
        t0 = time.perf_counter()
        warm_sizes = (self.serve_sizes if self.adaptive_slo_ms > 0
                      else (self._serve_size,))
        if not self.simulation:
            for b in (batches or self.batch_buckets):
                for bk in (buckets or self.frame_buckets):
                    frames = torch.zeros((b, bk[0], bk[1], 3), dtype=torch.uint8,
                                         device=self.device)
                    hw = torch.tensor([[bk[0]], [bk[1]]], dtype=torch.int32,
                                      device=self.device).repeat(1, b)
                    for sz in warm_sizes:
                        if self.mesh is not None:
                            for out in self._step_rows(
                                    sz, b, self._params,
                                    _row_inputs(*self._to_rows(frames, hw))):
                                out.cpu()
                            continue
                        self.get_step(b, bk, sz)(
                            self._params, frames, hw[0], hw[1],
                            self._class_weights,
                            self.config.confidence_threshold,
                            self.config.nms_threshold).cpu()
        if cache is not None:
            if hasattr(cache, "warm"):
                cache.warm()
            locked = (cache.run_locked if hasattr(cache, "run_locked")
                      else (lambda fn, _c=cache: fn(_c)))
            for b in ((batches or self.batch_buckets)
                      if not self.simulation else ()):
                held: List[GatheredBatch] = []

                def launch(arr, b=b, held=held):
                    bucket = (int(arr.shape[1]), int(arr.shape[2]))
                    if self.mesh is not None:
                        outs = []
                        for sz in warm_sizes:
                            g = self.gather_from_cache(
                                arr, np.zeros(b, np.int32),
                                np.full(b, bucket[0]), np.full(b, bucket[1]))
                            held.append(g)
                            outs += self._step_rows(
                                sz, b, self._params,
                                _row_inputs(g.frames, g.shw))
                        return outs
                    shw = torch.zeros((3, b), dtype=torch.int32)
                    shw[1], shw[2] = bucket
                    shw = shw.to(self.device)
                    return [self.get_step_cached(b, bucket, sz)(
                        self._params, arr, shw, self._class_weights,
                        self.config.confidence_threshold,
                        self.config.nms_threshold) for sz in warm_sizes]
                for out in locked(launch):
                    out.cpu()
                self.recycle_staging(held)
        self.warmed = True
        dt = time.perf_counter() - t0
        full_grid = (
            set(batches or self.batch_buckets) >= set(self.batch_buckets)
            and {tuple(bk) for bk in (buckets or self.frame_buckets)}
            >= set(self.frame_buckets))
        if full_grid:
            self._warmed_sizes = tuple(warm_sizes)
        log.info("engine warmup done in %.1fs%s", dt,
                 "" if full_grid else " (partial grid: rungs not certified "
                                     "for a runtime SLO enable)")
        return dt

    def update_adaptive_slo(self, slo_ms: float) -> bool:
        """Runtime SLO change (SET_CONFIG / CONFIG_UPDATE). Enabling needs a
        ladder whose rungs warmup ran over the full grid (the synthetic
        step, which has no device, needs no warmup); disabling (0) returns
        serving to the boot size. Validated here, on the caller's thread;
        the change is staged and applied by the dispatch thread
        (_apply_staged_slo), which owns the policy state."""
        slo_ms = float(slo_ms)
        if slo_ms > 0:
            if len(self.serve_sizes) < 2:
                log.warning("adaptive_slo_ms ignored: no tpu.serve_sizes "
                            "ladder configured")
                return False
            if (self.synthetic_step_ms <= 0
                    and not set(self.serve_sizes) <= set(self._warmed_sizes)):
                log.warning("adaptive_slo_ms ignored: serve-size rungs were "
                            "not warmed (boot with adaptive_slo_ms > 0)")
                return False
        with self._slo_lock:
            self._staged_slo = slo_ms
        return True

    def _apply_staged_slo(self) -> None:
        """Dispatch thread only (from _current_params and _maybe_adapt):
        apply a staged SLO change together with the policy state it
        governs."""
        with self._slo_lock:
            staged = self._staged_slo
            if staged is None:
                return
            self._staged_slo = None
        self.adaptive_slo_ms = staged
        self._adapt_hot = 0
        self._adapt_cool = 0
        # A new SLO is a new contract: the failed-probe history of the old
        # one does not hold upshifts back.
        self._last_upshift_t = -1e9
        self._upshift_fail_streak = 0
        self._upshift_block_until = 0.0
        # A fresh window: samples gathered before the change must not judge
        # the new SLO.
        self._adapt_stats = RollingStats(window=256)
        if staged <= 0:
            self._serve_size = self.model_size
        log.info("adaptive SLO now %.1f ms (serve size %d)",
                 self.adaptive_slo_ms, self._serve_size)

    def effective_serve_size(self, min_size: int = 0) -> int:
        """The rung for a request with accuracy floor `min_size`: the
        policy's current rung, raised to the smallest rung >= the floor (so
        a floored request always lands on a warmed rung)."""
        size = self._serve_size
        if min_size and min_size > size:
            size = min((s for s in self.serve_sizes if s >= min_size),
                       default=self.model_size)
        return size

    # ------------------------------------------------------------ hot swap
    def maybe_reload(self) -> bool:
        """Re-hash the model file; on change, stage the new params on the
        host. The dispatch thread places them on the device at its next
        batch (_current_params): this runs on the server's watcher thread,
        which must not touch the device. Reference onnx_engine.cpp:473-515."""
        path = self.config.model_path
        try:
            st = os.stat(path)
        except OSError:
            return False
        sig = (st.st_mtime_ns, st.st_size)
        if sig == self._file_sig:
            return False  # unchanged since the last check: skip the hash
        try:
            new_hash = file_sha256(path)
        except OSError:
            return False
        self._file_sig = sig
        if new_hash in (self._model_hash, self._failed_hash):
            return False
        params, spec, sim = load_model(path, self.config.tpu.variant,
                                       self.config.tpu.num_classes)
        if sim:
            self._failed_hash = new_hash  # do not re-parse it every tick
            return False
        if not self.simulation and (
                spec.num_classes != self.spec.num_classes
                or spec.backbone_channels != self.spec.backbone_channels
                or spec.depth != self.spec.depth
                or spec.reg_max != self.spec.reg_max):
            log.error("hot-swap rejected: %s is %s/nc=%d but the engine "
                      "serves %s/nc=%d — restart to change architecture",
                      path, spec.variant, spec.num_classes,
                      self.spec.variant, self.spec.num_classes)
            self._failed_hash = new_hash
            return False
        staged = self._host_params(params)
        with self._params_lock:
            # Leaving simulation adopts the file's geometry.
            self._staged = (staged, spec if self.simulation else None)
            self._model_hash = new_hash
        log.info("hot-reload staged: %s (sha256=%s)", path, new_hash[:12])
        return True

    def _current_params(self):
        """Dispatch thread only: apply a staged SLO change and a staged hot
        reload (the device copy happens here), then return the live
        params."""
        self._apply_staged_slo()
        with self._params_lock:
            staged, self._staged = self._staged, None
        if staged is not None:
            params, spec = staged
            self.simulation = False
            if spec is not None:
                self.spec = spec
                self._step_cache.clear()
            self._set_class_weights()
            self._params = self._device_params(params)
            log.info("hot-reload applied on the dispatch thread")
        return self._params

    def _simulating(self) -> bool:
        """Whether this dispatch serves simulated detections; a reload staged
        while simulating is applied here first (not under the synthetic
        step, which never serves the device)."""
        if (self.simulation and self._staged is not None
                and self.synthetic_step_ms <= 0):
            self._current_params()
        return self.simulation

    # --------------------------------------------------------------- infer
    def infer_batch(self, requests: List[InferenceRequest]) -> List[EngineResult]:
        """Convenience synchronous path. Requests are grouped by frame bucket
        and by their effective serve rung (accuracy floors), and chunked at
        the largest batch bucket (dispatch() serves one bucket of at most
        that many rows per call)."""
        groups: Dict[Tuple[Optional[Tuple[int, int]], int], List[int]] = {}
        for i, r in enumerate(requests):
            groups.setdefault(
                (_pick_bucket(self.frame_buckets, r.height, r.width),
                 self.effective_serve_size(r.min_size)),
                []).append(i)
        out: List[Optional[EngineResult]] = [None] * len(requests)
        cap = max(self.batch_buckets)
        for (_bucket, size), idxs in groups.items():
            for j in range(0, len(idxs), cap):
                part = idxs[j:j + cap]
                res = self.complete(self.dispatch(
                    [requests[i] for i in part], size=size))
                if len(res) == len(part):  # oversized group: res == [] (shed)
                    for i, e in zip(part, res):
                        out[i] = e
        return [e for e in out if e is not None]

    def dispatch(self, requests: List[InferenceRequest],
                 size: Optional[int] = None) -> PendingBatch:
        """Stage + launch one device step; returns without waiting for the
        device. Pair with complete(). `size` is the serve rung the caller
        grouped by (effective_serve_size); default the current rung."""
        if not requests:
            return PendingBatch(requests=[], out=None, t0=0.0, n=0)
        size = self._rung(size)
        if any(r.data is None for r in requests):
            raise ValueError("request without pixels: a frame in the device "
                             "frame cache is served by dispatch_from_cache")
        if self._simulating():
            return self._sim_pending(requests, size)
        t0 = time.perf_counter()
        # Shed frames larger than every configured bucket.
        oversized = [r for r in requests
                     if _pick_bucket(self.frame_buckets, r.height, r.width)
                     is None]
        if oversized:
            self.frames_dropped.inc(len(oversized))
            self.frames_oversized.inc(len(oversized))
            log.warning("shed %d oversized frame(s) (max bucket %s)",
                        len(oversized), max(self.frame_buckets))
            bad = {id(r) for r in oversized}
            requests = [r for r in requests if id(r) not in bad]
            if not requests:
                return PendingBatch(requests=[], out=None, t0=0.0, n=0)
        bucket = _pick_bucket(
            self.frame_buckets,
            max(r.height for r in requests), max(r.width for r in requests))
        if bucket is None:
            # Mixed orientations under non-nested buckets: keep the largest
            # same-bucket subset.
            total = len(requests)
            bucket, requests = max(
                group_by_bucket(self.frame_buckets, requests).items(),
                key=lambda kv: len(kv[1]))
            self.frames_dropped.inc(total - len(requests))
            log.warning("mixed-bucket dispatch: kept %d, dropped %d",
                        len(requests), total - len(requests))
        n = len(requests)
        batch = _pick_batch(self.batch_buckets, n)
        if n > batch:
            self.frames_dropped.inc(n - batch)
            log.warning("dispatch overflow: %d requests > max bucket %d; "
                        "shed %d (chunk at the caller)", n, batch, n - batch)
            requests = requests[:batch]
            n = batch
        key = (batch, bucket[0], bucket[1])
        # Staging buffers (the frames, and heights and widths packed as one
        # (2, B) int32 array like the JAX engine's `shw`) come from a
        # per-shape free-list: from pinned memory both H2D copies are
        # asynchronous, so dispatch does not wait for the device, and a pair
        # returns to the list only once its batch's results are read back
        # (_convert).
        free = self._staging.setdefault(key, [])
        pin = self.device.type == "cuda"
        frames, shw = free.pop() if free else (
            torch.zeros((batch, bucket[0], bucket[1], 3), dtype=torch.uint8,
                        pin_memory=pin),
            torch.empty((2, batch), dtype=torch.int32, pin_memory=pin))
        host, hw = frames.numpy(), shw.numpy()
        hw.fill(1)
        for i, r in enumerate(requests):
            host[i, :r.height, :r.width] = r.data
            hw[:, i] = (r.height, r.width)
        params = self._current_params()
        if self.mesh is not None:
            outs = self._step_rows(size, batch, params,
                                   _row_inputs(*self._to_rows(frames, shw)))
            return self._launched(requests, outs, t0, key, (frames, shw),
                                  size)
        frames_d = frames.to(self.device, non_blocking=True)
        shw_d = shw.to(self.device, non_blocking=True)
        out = self._step(size, params, frames_d, shw_d[0], shw_d[1],
                         self._class_weights, self.config.confidence_threshold,
                         self.config.nms_threshold)
        return self._launched(requests, out, t0, key, (frames, shw), size)

    def _rung(self, size: Optional[int]) -> int:
        """The serve rung of a dispatch: `size`, which must be a rung of the
        ladder, or the current rung."""
        if size is None:
            return self._serve_size
        if int(size) not in self.serve_sizes:
            raise ValueError(f"serve size {size}: not a rung of the ladder "
                             f"{self.serve_sizes}")
        return int(size)

    def _launched(self, requests: List[InferenceRequest], out,
                  t0: float, staging_key: Tuple,
                  staging_buf: Tuple[torch.Tensor, ...],
                  size: int) -> PendingBatch:
        """The PendingBatch of a step just launched; on CUDA its result's
        D2H copy is started and an event recorded behind it. On a serving
        mesh `out` is the list of the data rows' outputs: on CUDA each row
        is copied into its rows of one pinned output, at every depth, and
        one event recorded on each device behind its copies; on the CPU the
        rows are concatenated."""
        event = host = None
        if isinstance(out, list):
            if not out[0].is_cuda:
                out = torch.cat(out)
            else:
                host = torch.empty((sum(int(o.shape[0]) for o in out),)
                                   + tuple(out[0].shape[1:]),
                                   dtype=out[0].dtype, pin_memory=True)
                row = 0
                for o in out:
                    host[row:row + o.shape[0]].copy_(o, non_blocking=True)
                    row += int(o.shape[0])
                events = []
                for d in dict.fromkeys(o.device for o in out):
                    events.append(torch.cuda.Event())
                    events[-1].record(torch.cuda.current_stream(d))
                event = _Events(events)
        elif out.is_cuda:
            # Start the result's D2H copy now, so complete() finds it on the
            # host; only at depth <= 2, where complete() reads each batch
            # (deeper, complete_many reads several in one copy). The event
            # marks the end of the step and of the copy.
            if self.max_inflight <= 2:
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        return PendingBatch(requests=requests, out=out, t0=t0,
                            n=len(requests), staging_key=staging_key,
                            staging_buf=staging_buf, event=event, host=host,
                            serve_size=size)

    def _stage_shw(self, batch: int, rows: Sequence[np.ndarray]):
        """A pinned (3, B) int32 staging buffer from the free-list, its rows
        [slots, heights, widths] filled from `rows`, and its non_blocking
        device copy: (key, buffer, device tensor)."""
        key = ("shw", batch)
        free = self._staging.setdefault(key, [])
        buf = free.pop() if free else (torch.empty(
            (3, batch), dtype=torch.int32,
            pin_memory=self.device.type == "cuda"),)
        host = buf[0].numpy()
        for i, row in enumerate(rows):
            host[i] = row
        return key, buf, buf[0].to(self.device, non_blocking=True)

    def infer_batch_cached(self, requests: List[InferenceRequest],
                           frames: torch.Tensor, heights: np.ndarray,
                           widths: np.ndarray) -> List[EngineResult]:
        return self.complete(
            self.dispatch_cached(requests, frames, heights, widths))

    def dispatch_cached(self, requests: List[InferenceRequest],
                        frames: torch.Tensor, heights: np.ndarray,
                        widths: np.ndarray) -> PendingBatch:
        """Launch over device-resident frames (a DeviceFrameCache gather):
        no pixel staging, no H2D pixel copy. The frames' shape must be a
        configured (batch bucket, frame bucket) pair, as the JAX engine
        requires. Runs at the current rung."""
        if self._simulating():
            return self._sim_pending(requests)
        t0 = time.perf_counter()
        batch = int(frames.shape[0])
        bucket = (int(frames.shape[1]), int(frames.shape[2]))
        if batch not in self.batch_buckets or bucket not in self.frame_buckets:
            raise ValueError(
                f"dispatch_cached shape (batch={batch}, bucket={bucket}) is "
                f"not a configured (batch bucket, frame bucket) pair "
                f"{self.batch_buckets} x {self.frame_buckets} — gather to a "
                f"bucket first")
        key, buf, shw_d = self._stage_shw(
            batch, (0, np.asarray(heights, np.int32),
                    np.asarray(widths, np.int32)))
        if self.mesh is not None:
            rows, packed = self._to_rows(frames, shw_d)
            return self.dispatch_gathered(requests, GatheredBatch(
                frames=rows, shw=packed, staging_key=key, staging_buf=buf,
                t0=t0))
        return self.dispatch_gathered(requests, GatheredBatch(
            frames=frames, shw=shw_d, staging_key=key, staging_buf=buf,
            t0=t0))

    def gather_from_cache(self, cache: torch.Tensor, slots: np.ndarray,
                          heights: np.ndarray, widths: np.ndarray
                          ) -> Optional[GatheredBatch]:
        """The first half of dispatch_from_cache: the packed (3, B) upload
        and the gather of the slots out of `cache` (the DeviceFrameCache's
        tensor) into a new tensor; None in simulation mode. It launches two
        device operations and waits for neither; call it under the cache's
        lock (DeviceFrameCache.dispatch_with) and dispatch_gathered after.
        len(slots) must be a batch bucket (pad the slot list first)."""
        if self._simulating():
            return None
        t0 = time.perf_counter()
        batch = len(slots)
        if batch not in self.batch_buckets:
            raise ValueError(
                f"dispatch_from_cache batch={batch} is not a configured "
                f"batch bucket {self.batch_buckets} — pad the slot list "
                "to a bucket first")
        if self.mesh is not None:
            return self._gather_rows(cache, slots, heights, widths, t0)
        key, buf, shw_d = self._stage_shw(batch, (
            np.asarray(slots, np.int32), np.asarray(heights, np.int32),
            np.asarray(widths, np.int32)))
        return GatheredBatch(frames=_gather(cache, shw_d[0]), shw=shw_d,
                             staging_key=key, staging_buf=buf, t0=t0)

    def _gather_rows(self, cache, slots: np.ndarray, heights: np.ndarray,
                     widths: np.ndarray, t0: float) -> GatheredBatch:
        """gather_from_cache on a serving mesh. `cache` is a slot-sharded
        cache's `SlotShards` (`ops/roi.py`; shard i holds slots [i * per,
        (i + 1) * per) on its device) or one tensor (one shard). Each data
        row's frames are gathered onto its lead device from whichever shard
        holds each slot (the batcher places clients freely): one
        index_select a (row, shard) pair, copied to the lead, and with more
        than one shard in a row put in place by index_copy_. The packed (3,
        B) int32 rows and, in int64, the gather's [local slot, position in
        the row] pairs grouped by (row, shard) come from one pinned staging
        pair, uploaded once to each device that reads them."""
        shards = list(getattr(cache, "shards", [cache]))
        per = int(shards[0].shape[0])
        slots = np.asarray(slots, np.int64)
        batch = len(slots)
        key = ("gather_rows", batch)
        free = self._staging.setdefault(key, [])
        pin = self.device.type == "cuda"
        shw, idx = free.pop() if free else (
            torch.empty((3, batch), dtype=torch.int32, pin_memory=pin),
            torch.empty((2, batch), dtype=torch.int64, pin_memory=pin))
        hw, ix = shw.numpy(), idx.numpy()
        hw[0], hw[1], hw[2] = slots, heights, widths
        spans = mesh_mod.batch_rows(self.mesh, batch)
        groups: List[List[Tuple[int, int, int]]] = []  # per row: (shard, a, b)
        n = 0
        for sl in spans:
            pos = np.arange(sl.start, sl.stop)
            owner = slots[sl] // per
            groups.append([])
            for s in np.unique(owner):
                sel = pos[owner == s]
                ix[0, n:n + len(sel)] = slots[sel] - s * per
                ix[1, n:n + len(sel)] = sel - sl.start
                groups[-1].append((int(s), n, n + len(sel)))
                n += len(sel)
        leads = self.mesh.leads
        shw_on = {d: shw.to(d, non_blocking=True)
                  for d in dict.fromkeys(leads)}
        idx_on = {d: idx.to(d, non_blocking=True) for d in dict.fromkeys(
            leads + [t.device for t in shards])}
        frames_rows = []
        for sl, lead, mine in zip(spans, leads, groups):
            def part(s, a, b):
                src = shards[s]
                return src.index_select(0, idx_on[src.device][0, a:b]).to(
                    lead, non_blocking=True)
            if len(mine) == 1:
                frames_rows.append(part(*mine[0]))
                continue
            f = torch.empty((sl.stop - sl.start,) + tuple(shards[0].shape[1:]),
                            dtype=shards[0].dtype, device=lead)
            for s, a, b in mine:
                f.index_copy_(0, idx_on[lead][1, a:b], part(s, a, b))
            frames_rows.append(f)
        return GatheredBatch(frames=frames_rows,
                             shw=[shw_on[lead][:, sl]
                                  for sl, lead in zip(spans, leads)],
                             staging_key=key, staging_buf=(shw, idx), t0=t0)

    def dispatch_gathered(self, requests: List[InferenceRequest],
                          gathered: Optional[GatheredBatch],
                          size: Optional[int] = None) -> PendingBatch:
        """The second half of dispatch_from_cache: the step on a gathered
        batch (None: simulated) at rung `size` (default the current rung).
        Needs no lock: the gather is already queued on the stream ahead of
        any later cache write."""
        size = self._rung(size)
        if gathered is None or self._simulating():
            return self._sim_pending(requests, size)
        if self.mesh is not None:
            rows = _row_inputs(gathered.frames, gathered.shw)
            outs = self._step_rows(
                size, sum(int(f.shape[0]) for f, _, _ in rows),
                self._current_params(), rows)
            return self._launched(requests, outs, gathered.t0,
                                  gathered.staging_key, gathered.staging_buf,
                                  size)
        out = self._step(size, self._current_params(), gathered.frames,
                         gathered.shw[1], gathered.shw[2],
                         self._class_weights, self.config.confidence_threshold,
                         self.config.nms_threshold)
        return self._launched(requests, out, gathered.t0,
                              gathered.staging_key, gathered.staging_buf,
                              size)

    def dispatch_from_cache(self, requests: List[InferenceRequest],
                            cache: torch.Tensor, slots: np.ndarray,
                            heights: np.ndarray, widths: np.ndarray,
                            size: Optional[int] = None) -> PendingBatch:
        """Gather + step over the device frame cache in one call (the JAX
        engine's fused dispatch): one packed (3, B) upload of slots, heights
        and widths from pinned memory, the gather, the step on the cache's
        bucket; returns without waiting for the device. `size` is the serve
        rung (default the current rung)."""
        size = self._rung(size)
        return self.dispatch_gathered(
            requests, self.gather_from_cache(cache, slots, heights, widths),
            size)

    def _sim_pending(self, requests: List[InferenceRequest],
                     size: Optional[int] = None) -> PendingBatch:
        """Simulated dispatch. Under the synthetic step the batch also gets
        a ready_at stamp: back-to-back dispatches queue, one fake step
        each, like the one real device lane."""
        t0 = time.perf_counter()
        pb = PendingBatch(requests=requests, out=None, t0=t0, n=len(requests),
                          simulated=[self._simulate(r) for r in requests],
                          serve_size=int(size or self._serve_size))
        for er in pb.simulated:
            er.batch_n = len(requests)
            er.serve_size = pb.serve_size
        if self.synthetic_step_ms > 0:
            pb.step_ms = self._synthetic_step(len(requests), pb.serve_size)
            start = max(t0, self._synthetic_last_ready)
            self._synthetic_last_ready = start + pb.step_ms / 1e3
            pb.ready_at = self._synthetic_last_ready
            for er in pb.simulated:
                er.infer_ms = pb.step_ms
        return pb

    def _synthetic_step(self, n: int, size: Optional[int] = None) -> float:
        """The fake step's ms for an n-request batch: the configured ladder's
        entry for the padded batch bucket (the next listed bucket up when
        it is not listed), of the rung `size` when per-rung ladders are
        configured, else the flat synthetic_step_ms."""
        profile = (self.synthetic_profiles.get(int(size or self._serve_size))
                   or self.synthetic_profile)
        if not profile:
            return self.synthetic_step_ms
        bucket = _pick_batch(self.batch_buckets, n)
        for b in sorted(profile):
            if bucket <= b:
                return profile[b]
        return profile[max(profile)]

    def complete(self, pending: PendingBatch) -> List[EngineResult]:
        """Wait for the device step and convert its packed output."""
        if not pending.requests:
            return []
        if pending.simulated is not None:
            if pending.ready_at is not None:
                self._complete_synthetic(pending)
            return pending.simulated
        if pending.host is not None:  # the copy started at dispatch
            pending.event.synchronize()
            return self._convert(pending, pending.host.numpy())
        return self._convert(pending, pending.out.cpu().numpy())  # one D2H

    def complete_many(self, pendings: List[PendingBatch]
                      ) -> List[List[EngineResult]]:
        """Complete several in-flight batches. Those whose copy did not start
        at dispatch are read with ONE host readback (a device-side concat of
        their packed outputs)."""
        real = [p for p in pendings
                if p.requests and p.simulated is None and p.out is not None
                and p.host is None]
        host: Dict[int, np.ndarray] = {}
        if len(real) > 1:
            flat = torch.cat([p.out for p in real], dim=0).cpu().numpy()
            row = 0
            for p in real:
                rows = int(p.out.shape[0])
                host[id(p)] = flat[row:row + rows]
                row += rows
        return [self._convert(p, host[id(p)]) if id(p) in host
                else self.complete(p) for p in pendings]

    def _complete_synthetic(self, pending: PendingBatch) -> None:
        """Wait like a device readback until the fake step is done, and feed
        the statistics (and the adaptive policy) the real path feeds."""
        delay = pending.ready_at - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        now = time.perf_counter()
        self.latency.record((now - pending.t0) * 1e3)
        self.batch_sizes.record(pending.n)
        for r, er in zip(pending.requests, pending.simulated):
            e2e = (now - r.enqueue_t) * 1e3
            self.e2e_latency.record(e2e)
            if pending.serve_size == self._serve_size:
                self._adapt_stats.record(e2e)
            # Everything but the fake step: the host path's own time.
            self.synthetic_host.record(max(e2e - pending.step_ms, 0.0))
            er.queue_ms = max(e2e - pending.step_ms, 0.0)
        self._maybe_adapt()

    def recycle_staging(self, pendings: List[PendingBatch]) -> None:
        """Return the staging buffers of batches whose completion failed to
        the free-list (normal recycling happens in _convert). Batcher thread
        only, like _convert."""
        for p in pendings:
            if p.staging_buf is not None:
                self._staging.setdefault(p.staging_key, []).append(
                    p.staging_buf)
                p.staging_buf = None

    def _convert(self, pending: PendingBatch,
                 host_out: np.ndarray) -> List[EngineResult]:
        # Results are on host => the step ran => its H2D copies finished.
        self.recycle_staging([pending])
        out = nms_ops.unpack_outputs(host_out)
        boxes, scores = out["boxes"], out["scores"]
        classes, counts = out["classes"], out["count"]
        infer_ms = (time.perf_counter() - pending.t0) * 1e3
        self.latency.record(infer_ms)
        self.batch_sizes.record(pending.n)
        self.inference_count.inc(pending.n)
        results = []
        now = time.perf_counter()
        for i, r in enumerate(pending.requests):
            dets = [
                Detection(
                    x=float(boxes[i, j, 0]), y=float(boxes[i, j, 1]),
                    width=float(boxes[i, j, 2]), height=float(boxes[i, j, 3]),
                    confidence=float(scores[i, j]),
                    class_id=int(classes[i, j]), track_id=0,
                    timestamp=r.timestamp)
                for j in range(int(counts[i]))
            ]
            e2e_ms = (now - r.enqueue_t) * 1e3
            self.e2e_latency.record(e2e_ms)
            if pending.serve_size == self._serve_size:
                # Only samples of the current rung steer the policy: a
                # floored group serves above it by contract (its latency is
                # nothing a further downshift fixes), and a batch dispatched
                # at a previous rung must not judge the new one.
                self._adapt_stats.record(e2e_ms)
            results.append(EngineResult(
                client_id=r.client_id, frame_id=r.frame_id,
                timestamp=r.timestamp, detections=dets,
                infer_ms=infer_ms, queue_ms=max(e2e_ms - infer_ms, 0.0),
                recv_t=r.enqueue_t,
                decode_ms=max((r.decoded_t - r.enqueue_t) * 1e3, 0.0),
                batch_n=pending.n, serve_size=pending.serve_size))
        self._maybe_adapt()
        return results

    # ------------------------------------------------- adaptive resolution
    def _maybe_adapt(self) -> None:
        """The serve-size policy, dispatch thread only (called at
        completion): a sustained submit->result p99 over the SLO steps down
        the ladder, a sustained wide margin steps back up. The hysteresis is
        asymmetric (two hot checks down, eight cool checks up), checks are
        0.5 s apart on at least 32 fresh samples, the window resets on every
        switch, and an upshift that fails within _UPSHIFT_PROBE_S holds the
        next one off exponentially (30 s, 60 s, ... up to 600 s)."""
        self._apply_staged_slo()
        if self.adaptive_slo_ms <= 0 or len(self.serve_sizes) < 2:
            return
        if self.simulation and not self.synthetic_profiles:
            # Plain simulation has no size-dependent step to adapt to.
            return
        now = time.perf_counter()
        if now < self._adapt_next_check:
            return
        snap = self._adapt_stats.snapshot()
        if snap["count"] < 32:
            return
        self._adapt_next_check = now + 0.5
        i = self.serve_sizes.index(self._serve_size)
        if (self._last_upshift_t > 0
                and now - self._last_upshift_t >= self._UPSHIFT_PROBE_S):
            # The probed rung held for the window: the probe succeeded.
            self._upshift_fail_streak = 0
            self._last_upshift_t = -1e9
        if snap["p99_ms"] > self.adaptive_slo_ms:
            self._adapt_cool = 0
            self._adapt_hot += 1
            if self._adapt_hot >= 2 and i + 1 < len(self.serve_sizes):
                if now - self._last_upshift_t < self._UPSHIFT_PROBE_S:
                    # The rung just probed failed. The probe marker is
                    # consumed, so that on a longer ladder the downshifts
                    # that follow count as descent, not as more failures.
                    self._upshift_fail_streak += 1
                    self._upshift_block_until = now + min(
                        30.0 * (2 ** (self._upshift_fail_streak - 1)), 600.0)
                    self._last_upshift_t = -1e9
                self._switch_size(self.serve_sizes[i + 1], snap["p99_ms"])
                self.size_downshifts += 1
        elif snap["p99_ms"] < 0.6 * self.adaptive_slo_ms:
            self._adapt_hot = 0
            self._adapt_cool += 1
            if (self._adapt_cool >= 8 and i > 0
                    and now >= self._upshift_block_until):
                self._last_upshift_t = now
                self._switch_size(self.serve_sizes[i - 1], snap["p99_ms"])
                self.size_upshifts += 1
        else:
            self._adapt_hot = 0
            self._adapt_cool = 0

    def _switch_size(self, size: int, p99_ms: float) -> None:
        log.info("adaptive resolution: %d -> %d (p99 %.1f ms, SLO %.1f ms)",
                 self._serve_size, size, p99_ms, self.adaptive_slo_ms)
        self._serve_size = size
        self._adapt_stats = RollingStats(window=256)
        self._adapt_hot = 0
        self._adapt_cool = 0

    def _simulate(self, r: InferenceRequest) -> EngineResult:
        """Random plausible detections (reference onnx_engine.cpp:1133-1177)."""
        rng = self._rng
        dets = []
        for _ in range(rng.randint(0, 3)):
            w, h = rng.uniform(0.05, 0.2), rng.uniform(0.1, 0.3)
            dets.append(Detection(
                x=rng.uniform(0.2, 0.8), y=rng.uniform(0.2, 0.8),
                width=w, height=h, confidence=rng.uniform(0.5, 0.95),
                class_id=rng.randint(0, max(self.spec.num_classes - 1, 0)),
                track_id=0, timestamp=r.timestamp))
        self.inference_count.inc()
        return EngineResult(client_id=r.client_id, frame_id=r.frame_id,
                            timestamp=r.timestamp, detections=dets,
                            recv_t=r.enqueue_t,
                            decode_ms=max((r.decoded_t - r.enqueue_t) * 1e3,
                                          0.0),
                            batch_n=1, serve_size=self._serve_size)

    # -------------------------------------------------------- live config
    def update_thresholds(self, confidence: Optional[float] = None,
                          nms: Optional[float] = None) -> None:
        """Runtime threshold update, read by the next dispatch (thresholds
        are host floats passed into the step: no rebuild)."""
        if confidence is not None:
            self.config.confidence_threshold = float(confidence)
        if nms is not None:
            self.config.nms_threshold = float(nms)

    # -------------------------------------------------------------- status
    def status(self) -> Dict[str, str]:
        lat = self.latency.snapshot()
        e2e = self.e2e_latency.snapshot()
        host = (self.synthetic_host.snapshot()
                if self.synthetic_step_ms > 0 else None)
        return {
            "engine": "torch-cuda",
            "device": str(self.device),
            "model": self.spec.variant,
            "model_file": os.path.basename(self.config.model_path or ""),
            "model_sha": (self._model_hash or "")[:12],
            "model_size": str(self.model_size),
            # The current rung (the model size unless the adaptive policy
            # stepped down) and the switches so far.
            "serve_size": str(self._serve_size),
            "size_downshifts": str(self.size_downshifts),
            "size_upshifts": str(self.size_upshifts),
            "classes": str(self.spec.num_classes),
            # The serving mesh in use (1x1: one device), the one configured
            # (tpu.mesh_data x tpu.mesh_model), its devices and whether a
            # device repeats in it.
            "mesh": (f"{self.mesh.data}x{self.mesh.model}"
                     if self.mesh is not None else "1x1"),
            "mesh_requested": "x".join(map(str, self.mesh_requested)),
            "mesh_devices": ",".join(
                str(d) for d in (self.mesh.flat if self.mesh is not None
                                 else [self.device])),
            "mesh_virtual": str(self.mesh is not None
                                and self.mesh.virtual).lower(),
            "simulation": str(self.simulation).lower(),
            "inferences": str(self.inference_count.value),
            "dropped": str(self.frames_dropped.value),
            "oversized": str(self.frames_oversized.value),
            "errors": str(self.error_count.value),
            "pipeline_avg_ms": f"{lat['avg_ms']:.2f}",
            "pipeline_p99_ms": f"{lat['p99_ms']:.2f}",
            "e2e_avg_ms": f"{e2e['avg_ms']:.2f}",
            "e2e_p99_ms": f"{e2e['p99_ms']:.2f}",
            "avg_batch": f"{self.batch_sizes.snapshot()['avg_ms']:.1f}",
            "warmed": str(self.warmed).lower(),
            **({"synthetic_step_ms": f"{self.synthetic_step_ms:.2f}",
                "synthetic_host_avg_ms": f"{host['avg_ms']:.2f}",
                "synthetic_host_p99_ms": f"{host['p99_ms']:.2f}"}
               if host is not None else {}),
        }


class SimulationEngine(InferenceEngine):
    """Serves random detections whether or not a model file exists (the
    reference's simulation mode as a selectable engine,
    onnx_engine.cpp:1133-1177, inference_engine.h:45-103). Loads no model
    and places nothing on the device; for protocol and load tests."""

    _always_simulate = True

    def __init__(self, config: ServerConfig,
                 params: Optional[Dict[str, Any]] = None,
                 device: str = "cuda") -> None:
        cfg = dataclasses.replace(config)
        cfg.tpu = dataclasses.replace(config.tpu, quantize_int8=False)
        super().__init__(cfg, params=params, device=device)

    def maybe_reload(self) -> bool:  # a model appearing must not flip modes
        return False


# Engine registry under the JAX package's names (reference
# inference_engine.h:45-103): "onnx", the reference's default config value,
# and "jax" both select the real engine, so existing config files serve
# through the port's kernels unchanged.
ENGINE_REGISTRY: Dict[str, type] = {
    "jax": InferenceEngine,
    "onnx": InferenceEngine,
    "simulation": SimulationEngine,
}


def register_engine(name: str):
    """Class decorator registering a custom engine under `name`."""
    def deco(cls):
        ENGINE_REGISTRY[name] = cls
        return cls
    return deco


def create_engine(config: ServerConfig, **kwargs) -> InferenceEngine:
    """The engine `config.inference_engine` names; an unknown name falls
    back to the default engine with a warning (reference
    server/main.cpp:226-240). kwargs (e.g. device) go to the engine."""
    name = (config.inference_engine or "jax").strip().lower()
    cls = ENGINE_REGISTRY.get(name)
    if cls is None:
        log.warning("unknown inference_engine %r; using the default engine",
                    name)
        cls = InferenceEngine
    return cls(config, **kwargs)
