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

Not ported yet, and refused at construction rather than served differently:
serve-size ladders (so `effective_serve_size` is always the model size and
`update_adaptive_slo` refuses to enable), the synthetic step, int8, meshes,
and the layout experiments stem="s2d", select="perlevel", c2f="split". The
TPU kernel switches tpu.nms / tpu.act / tpu.conv1x1 have no effect here.

`create_engine` picks the engine from `config.inference_engine` under the
JAX package's registry names: "jax" and "onnx" select `InferenceEngine`,
"simulation" `SimulationEngine`.
"""

from __future__ import annotations

import contextlib
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
from ..models.yolov8 import ModelSpec, forward_decoded, get_spec
from ..ops import nms as nms_ops
from ..ops.preprocess import letterbox_batch_mxu, letterbox_params
from ..protocol import Detection
from ..utils.logging import get_logger
from ..utils.stats import Counter, RollingStats

log = get_logger("engine")


@dataclass
class InferenceRequest:
    client_id: int
    frame_id: int
    timestamp: int
    width: int
    height: int
    data: Optional[np.ndarray]  # (h, w, 3) uint8 RGB
    keyframe: bool = False
    # Accuracy floor (the client's min_serve_size). Without a serve-size
    # ladder every request is served at the model size.
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
    # batch is done without waiting for it.
    event: Optional[Any] = None
    host: Optional[torch.Tensor] = None
    # The JAX engine's synthetic-step finish time; the port has no synthetic
    # step, so it stays None.
    ready_at: Optional[float] = None
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
    heights and widths; and the pinned staging buffer that copy came from."""
    frames: torch.Tensor
    shw: torch.Tensor
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


def _check_supported(config: ServerConfig) -> None:
    """Refuse what the port does not implement yet, at construction."""
    tpu = config.tpu
    refused = {
        "tpu.stem='s2d'": tpu.stem != "conv",
        "tpu.select='perlevel'": tpu.select != "concat",
        "tpu.c2f='split'": tpu.c2f == "split",
        "tpu.quantize_int8": bool(tpu.quantize_int8),
        "tpu.mesh_data/mesh_model > 1": int(tpu.mesh_data) * int(tpu.mesh_model) > 1,
        "tpu.serve_sizes": bool(tpu.serve_sizes),
        f"tpu.preprocess={tpu.preprocess!r}": tpu.preprocess != "letterbox_mxu",
        "tpu.synthetic_step_ms / synthetic_step_profile(s)": bool(
            tpu.synthetic_step_ms > 0 or tpu.synthetic_step_profile
            or tpu.synthetic_step_profiles),
    }
    bad = [name for name, hit in refused.items() if hit]
    if bad:
        raise ValueError(f"not implemented in the PyTorch port: {', '.join(bad)}")


class InferenceEngine:
    """Synchronous batched compute wrapper; the caller owns queues/threads.

    Device work (dispatch, complete, warmup, applying a hot reload) happens
    on one thread at a time: in the server, warmup runs before the batcher
    starts and the batcher thread alone does the rest. Thresholds, SLO and
    reload requests may come from any thread; they only stage host state."""

    # SimulationEngine: random detections, no model load, no device state.
    _always_simulate = False

    def __init__(self, config: ServerConfig,
                 params: Optional[Dict[str, Any]] = None,
                 device: str = "cuda") -> None:
        _check_supported(config)
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
        # No serve-size ladder (tpu.serve_sizes is refused): one rung.
        self.serve_sizes = (self.model_size,)
        self._serve_size = self.model_size
        self.adaptive_slo_ms = 0.0

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
        # Simulation never touches the device.
        self._params = None if self.simulation else place_params(
            params_from_jax(params), self.device, self.dtype)
        self._class_weights = self._class_weight_tensor()
        # A hot reload staged by maybe_reload (host tensors, and the file's
        # geometry when leaving simulation), applied by the dispatch thread.
        self._staged: Optional[Tuple[Any, Optional[ModelSpec]]] = None
        self._params_lock = threading.Lock()

        self._step = self._build_step()
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
        self.batch_sizes = RollingStats()
        self._rng = random.Random(1337)
        self.warmed = self.simulation

    def _class_weight_tensor(self) -> torch.Tensor:
        nc = self.spec.num_classes
        names = CS16_CLASS_NAMES if nc == len(CS16_CLASS_NAMES) else tuple(
            f"class_{i}" for i in range(nc))
        return torch.tensor(
            self.config.detection.class_weight_vector(names),
            dtype=torch.float32,
            device=None if self.simulation else self.device)

    # ---------------------------------------------------------------- step
    def _build_step(self, plain: bool = False):
        """The serving step:
        step(params, frames, heights, widths, class_w, conf, iou) -> packed
        (B, 1 + 6*MAX_DET) f32. `plain=True` runs every kernel's plain
        PyTorch version instead (the reference a run checks the kernels
        against). An f32 step runs its convs and matmuls in full f32
        whatever the caller's TF32 settings (`full_f32_precision`)."""
        size, spec = self.model_size, self.spec
        dtype, topk = self.dtype, self.pre_nms_topk
        precision = (full_f32_precision if dtype == torch.float32
                     else contextlib.nullcontext)

        @torch.inference_mode()
        def step(params, frames, heights, widths, class_w, conf, iou):
            with precision():
                x = letterbox_batch_mxu(frames, heights, widths, size, dtype)
                hf = heights.to(torch.float32)
                wf = widths.to(torch.float32)
                scale, pad_x, pad_y = letterbox_params(hf, wf, size)
                pad = torch.stack([pad_x, pad_y], dim=-1)
                src_wh = torch.stack([wf, hf], dim=-1)
                pred = forward_decoded(params, spec, x, dtype=dtype,
                                       plain=plain)
                out = nms_ops.postprocess_batch(pred, class_w, conf, iou,
                                                scale, pad, src_wh, topk,
                                                plain=plain)
                return nms_ops.pack_outputs(out)

        return step

    def get_step(self, batch: int, bucket: Tuple[int, int]):
        """The step for a (batch, bucket) pair. PyTorch runs eagerly and
        compiles nothing per shape, so one step serves every pair."""
        return self._step

    def get_step_cached(self, batch: int, bucket: Tuple[int, int]):
        """The cached step: step(params, cache, shw, class_w, conf, iou),
        shw a (3, B) int32 device tensor of rows [slots, heights, widths]:
        the gather of the batch's slots out of the device frame cache
        followed by the step (the JAX engine's fused program)."""
        step = self.get_step(batch, bucket)

        def cached(params, cache, shw, class_w, conf, iou):
            return step(params, _gather(cache, shw[0]), shw[1], shw[2],
                        class_w, conf, iou)
        return cached

    def warmup(self, batches: Optional[Sequence[int]] = None,
               buckets: Optional[Sequence[Tuple[int, int]]] = None,
               cache=None, inflight: int = 0) -> float:
        """Run every (batch, bucket) step once; returns seconds spent. With
        `cache` (a DeviceFrameCache, or its device tensor) the cache's write
        path is run once too (`warm`), and the cached step once per batch
        bucket under the cache's lock: a keyframe written meanwhile by a
        client is flushed first, never overwritten mid-step. `inflight` is
        the server's pipeline depth, for which PyTorch has nothing to
        compile."""
        t0 = time.perf_counter()
        if not self.simulation:
            for b in (batches or self.batch_buckets):
                for bk in (buckets or self.frame_buckets):
                    frames = torch.zeros((b, bk[0], bk[1], 3), dtype=torch.uint8,
                                         device=self.device)
                    hs = torch.full((b,), bk[0], dtype=torch.int32,
                                    device=self.device)
                    ws = torch.full((b,), bk[1], dtype=torch.int32,
                                    device=self.device)
                    self.get_step(b, bk)(
                        self._params, frames, hs, ws, self._class_weights,
                        self.config.confidence_threshold,
                        self.config.nms_threshold).cpu()
        if cache is not None:
            if hasattr(cache, "warm"):
                cache.warm()
            locked = (cache.run_locked if hasattr(cache, "run_locked")
                      else (lambda fn, _c=cache: fn(_c)))
            for b in ((batches or self.batch_buckets)
                      if not self.simulation else ()):
                def launch(arr, b=b):
                    bucket = (int(arr.shape[1]), int(arr.shape[2]))
                    shw = torch.zeros((3, b), dtype=torch.int32)
                    shw[1], shw[2] = bucket
                    return self.get_step_cached(b, bucket)(
                        self._params, arr, shw.to(self.device),
                        self._class_weights, self.config.confidence_threshold,
                        self.config.nms_threshold)
                locked(launch).cpu()
        self.warmed = True
        dt = time.perf_counter() - t0
        log.info("engine warmup done in %.1fs", dt)
        return dt

    def update_adaptive_slo(self, slo_ms: float) -> bool:
        """Runtime SLO change (SET_CONFIG / CONFIG_UPDATE). Enabling needs a
        warmed serve-size ladder, which the port has not got: refused, as
        the JAX engine refuses it without one. Disabling (0) is a no-op."""
        if float(slo_ms) > 0:
            log.warning("adaptive_slo_ms ignored: no tpu.serve_sizes ladder "
                        "(not ported)")
            return False
        return True

    def effective_serve_size(self, min_size: int = 0) -> int:
        """Serve rung for a request with accuracy floor `min_size`: without
        a ladder, always the model size."""
        return self.model_size

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
        staged = params_from_jax(params)
        with self._params_lock:
            # Leaving simulation adopts the file's geometry.
            self._staged = (staged, spec if self.simulation else None)
            self._model_hash = new_hash
        log.info("hot-reload staged: %s (sha256=%s)", path, new_hash[:12])
        return True

    def _current_params(self):
        """Dispatch thread only: apply a staged hot reload (the device copy
        happens here), then return the live params."""
        with self._params_lock:
            staged, self._staged = self._staged, None
        if staged is not None:
            params, spec = staged
            self.simulation = False
            if spec is not None:
                self.spec = spec
                self._step = self._build_step()
            self._class_weights = self._class_weight_tensor()
            self._params = place_params(params, self.device, self.dtype)
            log.info("hot-reload applied on the dispatch thread")
        return self._params

    def _simulating(self) -> bool:
        """Whether this dispatch serves simulated detections; a reload staged
        while simulating is applied here first."""
        if self.simulation and self._staged is not None:
            self._current_params()
        return self.simulation

    # --------------------------------------------------------------- infer
    def infer_batch(self, requests: List[InferenceRequest]) -> List[EngineResult]:
        """Convenience synchronous path. Requests are grouped by frame bucket
        and chunked at the largest batch bucket (dispatch() serves one bucket
        of at most that many rows per call)."""
        groups: Dict[Optional[Tuple[int, int]], List[int]] = {}
        for i, r in enumerate(requests):
            groups.setdefault(
                _pick_bucket(self.frame_buckets, r.height, r.width),
                []).append(i)
        out: List[Optional[EngineResult]] = [None] * len(requests)
        cap = max(self.batch_buckets)
        for idxs in groups.values():
            for j in range(0, len(idxs), cap):
                part = idxs[j:j + cap]
                res = self.complete(self.dispatch([requests[i] for i in part]))
                if len(res) == len(part):  # oversized group: res == [] (shed)
                    for i, e in zip(part, res):
                        out[i] = e
        return [e for e in out if e is not None]

    def dispatch(self, requests: List[InferenceRequest],
                 size: Optional[int] = None) -> PendingBatch:
        """Stage + launch one device step; returns without waiting for the
        device. Pair with complete(). `size` is the serve rung the caller
        grouped by (effective_serve_size): only the model size exists."""
        if not requests:
            return PendingBatch(requests=[], out=None, t0=0.0, n=0)
        self._check_size(size)
        if any(r.data is None for r in requests):
            raise ValueError("request without pixels: a frame in the device "
                             "frame cache is served by dispatch_from_cache")
        if self._simulating():
            return self._sim_pending(requests)
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
        frames_d = frames.to(self.device, non_blocking=True)
        shw_d = shw.to(self.device, non_blocking=True)
        out = self.get_step(batch, bucket)(
            params, frames_d, shw_d[0], shw_d[1], self._class_weights,
            self.config.confidence_threshold, self.config.nms_threshold)
        return self._launched(requests, out, t0, key, (frames, shw))

    def _check_size(self, size: Optional[int]) -> None:
        if size is not None and int(size) != self.model_size:
            raise ValueError(f"serve size {size}: the engine serves only its "
                             f"model size {self.model_size} (no ladder)")

    def _launched(self, requests: List[InferenceRequest], out: torch.Tensor,
                  t0: float, staging_key: Tuple,
                  staging_buf: Tuple[torch.Tensor, ...]) -> PendingBatch:
        """The PendingBatch of a step just launched; on CUDA its result's
        D2H copy is started and an event recorded behind it."""
        event = host = None
        if out.is_cuda:
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
                            serve_size=self.model_size)

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
        requires."""
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
        key, buf, shw_d = self._stage_shw(batch, (
            np.asarray(slots, np.int32), np.asarray(heights, np.int32),
            np.asarray(widths, np.int32)))
        return GatheredBatch(frames=_gather(cache, shw_d[0]), shw=shw_d,
                             staging_key=key, staging_buf=buf, t0=t0)

    def dispatch_gathered(self, requests: List[InferenceRequest],
                          gathered: Optional[GatheredBatch],
                          size: Optional[int] = None) -> PendingBatch:
        """The second half of dispatch_from_cache: the step on a gathered
        batch (None: simulated). Needs no lock: the gather is already
        queued on the stream ahead of any later cache write."""
        self._check_size(size)
        if gathered is None or self._simulating():
            return self._sim_pending(requests)
        frames = gathered.frames
        out = self.get_step(int(frames.shape[0]),
                            (int(frames.shape[1]), int(frames.shape[2])))(
            self._current_params(), frames, gathered.shw[1], gathered.shw[2],
            self._class_weights, self.config.confidence_threshold,
            self.config.nms_threshold)
        return self._launched(requests, out, gathered.t0,
                              gathered.staging_key, gathered.staging_buf)

    def dispatch_from_cache(self, requests: List[InferenceRequest],
                            cache: torch.Tensor, slots: np.ndarray,
                            heights: np.ndarray, widths: np.ndarray,
                            size: Optional[int] = None) -> PendingBatch:
        """Gather + step over the device frame cache in one call (the JAX
        engine's fused dispatch): one packed (3, B) upload of slots, heights
        and widths from pinned memory, the gather, the step on the cache's
        bucket; returns without waiting for the device. `size` is the serve
        rung (only the model size exists)."""
        self._check_size(size)
        return self.dispatch_gathered(
            requests, self.gather_from_cache(cache, slots, heights, widths))

    def _sim_pending(self, requests: List[InferenceRequest]) -> PendingBatch:
        pb = PendingBatch(requests=requests, out=None, t0=time.perf_counter(),
                          n=len(requests),
                          simulated=[self._simulate(r) for r in requests],
                          serve_size=self.model_size)
        for er in pb.simulated:
            er.batch_n = len(requests)
        return pb

    def complete(self, pending: PendingBatch) -> List[EngineResult]:
        """Wait for the device step and convert its packed output."""
        if not pending.requests:
            return []
        if pending.simulated is not None:
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
            results.append(EngineResult(
                client_id=r.client_id, frame_id=r.frame_id,
                timestamp=r.timestamp, detections=dets,
                infer_ms=infer_ms, queue_ms=max(e2e_ms - infer_ms, 0.0),
                recv_t=r.enqueue_t,
                decode_ms=max((r.decoded_t - r.enqueue_t) * 1e3, 0.0),
                batch_n=pending.n, serve_size=pending.serve_size))
        return results

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
                            batch_n=1, serve_size=self.model_size)

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
        return {
            "engine": "torch-cuda",
            "device": str(self.device),
            "model": self.spec.variant,
            "model_file": os.path.basename(self.config.model_path or ""),
            "model_sha": (self._model_hash or "")[:12],
            "model_size": str(self.model_size),
            "serve_size": str(self.model_size),
            "classes": str(self.spec.num_classes),
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
        }


class SimulationEngine(InferenceEngine):
    """Serves random detections whether or not a model file exists (the
    reference's simulation mode as a selectable engine,
    onnx_engine.cpp:1133-1177, inference_engine.h:45-103). Loads no model
    and places nothing on the device; for protocol and load tests."""

    _always_simulate = True

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
