"""Inference engine on an NVIDIA GPU: one serving step per (batch, frame-bucket).

The PyTorch counterpart of the JAX package's `runtime/engine.py`
`InferenceEngine`. One step runs

    uint8 frames -> letterbox -> YOLOv8 -> DFL decode -> weighted NMS -> pack

on the device, so one H2D copy (the padded frame batch) and one small D2H copy
(the packed (B, 1 + 6*32) f32 result) happen per batch. The convs and the
suppression scan go through the port's CUDA kernels (see `models/yolov8.py`
and `ops/nms.py`).

Batches are padded up to a batch bucket and frames into a frame bucket; the
true per-frame (h, w) are runtime tensors. Simulation mode serves random
detections when the model file cannot be loaded, as the JAX engine does
(reference onnx_engine.cpp:70-75, :1133-1177).

Not ported yet, and refused at construction rather than served differently:
the device frame cache, hot reload, serve-size ladders, the synthetic step,
int8, meshes, and the layout experiments stem="s2d", select="perlevel",
c2f="split". The TPU kernel switches tpu.nms / tpu.act / tpu.conv1x1 have no
effect here.
"""

from __future__ import annotations

import contextlib
import os
import random
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
    data: np.ndarray  # (h, w, 3) uint8 RGB
    enqueue_t: float = field(default_factory=time.perf_counter)
    decoded_t: float = field(default_factory=time.perf_counter)


@dataclass
class PendingBatch:
    """A dispatched-but-unread device step (see InferenceEngine.dispatch)."""
    requests: List[InferenceRequest]
    out: Optional[torch.Tensor]
    t0: float
    n: int
    simulated: Optional[List["EngineResult"]] = None
    # Pinned host staging buffers (frames, packed heights and widths): held
    # until the batch's results are read back (which proves their H2D copies
    # finished), then recycled.
    staging_key: Optional[Tuple[int, int, int]] = None
    staging_buf: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


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


def _pick_batch(buckets: Sequence[int], n: int) -> int:
    for b in sorted(buckets):
        if n <= b:
            return b
    return max(buckets)


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
    """Synchronous batched compute wrapper; the caller owns queues/threads."""

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

        self.simulation = False
        self._model_hash: Optional[str] = None
        if params is None:
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

        nc = self.spec.num_classes
        names = CS16_CLASS_NAMES if nc == len(CS16_CLASS_NAMES) else tuple(
            f"class_{i}" for i in range(nc))
        self._class_weights = torch.tensor(
            config.detection.class_weight_vector(names), dtype=torch.float32,
            device=None if self.simulation else self.device)

        self._step = self._build_step()
        # Per-shape free-lists of host staging buffer pairs (see dispatch).
        self._staging: Dict[Tuple[int, int, int],
                            List[Tuple[torch.Tensor, torch.Tensor]]] = {}

        # Telemetry (reference stats fields, onnx_engine.h:261-273).
        self.inference_count = Counter()
        self.frames_dropped = Counter()
        self.latency = RollingStats()      # dispatch -> readback (pipeline)
        self.e2e_latency = RollingStats()  # submit -> result
        self.batch_sizes = RollingStats()
        self._rng = random.Random(1337)
        self.warmed = self.simulation

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

    def warmup(self, batches: Optional[Sequence[int]] = None,
               buckets: Optional[Sequence[Tuple[int, int]]] = None) -> float:
        """Run every (batch, bucket) step once; returns seconds spent."""
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
        self.warmed = True
        dt = time.perf_counter() - t0
        log.info("engine warmup done in %.1fs", dt)
        return dt

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

    def dispatch(self, requests: List[InferenceRequest]) -> PendingBatch:
        """Stage + launch one device step; returns without waiting for the
        device. Pair with complete()."""
        if not requests:
            return PendingBatch(requests=[], out=None, t0=0.0, n=0)
        if self.simulation:
            return self._sim_pending(requests)
        t0 = time.perf_counter()
        # Shed frames larger than every configured bucket.
        oversized = [r for r in requests
                     if _pick_bucket(self.frame_buckets, r.height, r.width)
                     is None]
        if oversized:
            self.frames_dropped.inc(len(oversized))
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
            groups: Dict[Tuple[int, int], List[InferenceRequest]] = {}
            for r in requests:
                groups.setdefault(
                    _pick_bucket(self.frame_buckets, r.height, r.width),
                    []).append(r)
            total = len(requests)
            bucket, requests = max(groups.items(), key=lambda kv: len(kv[1]))
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
        frames_d = frames.to(self.device, non_blocking=True)
        shw_d = shw.to(self.device, non_blocking=True)
        out = self.get_step(batch, bucket)(
            self._params, frames_d, shw_d[0], shw_d[1], self._class_weights,
            self.config.confidence_threshold, self.config.nms_threshold)
        return PendingBatch(requests=requests, out=out, t0=t0, n=n,
                            staging_key=key, staging_buf=(frames, shw))

    def _sim_pending(self, requests: List[InferenceRequest]) -> PendingBatch:
        pb = PendingBatch(requests=requests, out=None, t0=time.perf_counter(),
                          n=len(requests),
                          simulated=[self._simulate(r) for r in requests])
        for er in pb.simulated:
            er.batch_n = len(requests)
        return pb

    def complete(self, pending: PendingBatch) -> List[EngineResult]:
        """Wait for the device step and convert its packed output."""
        if not pending.requests:
            return []
        if pending.simulated is not None:
            return pending.simulated
        return self._convert(pending, pending.out.cpu().numpy())  # one D2H

    def complete_many(self, pendings: List[PendingBatch]
                      ) -> List[List[EngineResult]]:
        """Complete several in-flight batches with ONE host readback (a
        device-side concat of their packed outputs)."""
        real = [p for p in pendings
                if p.requests and p.simulated is None and p.out is not None]
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

    def _convert(self, pending: PendingBatch,
                 host_out: np.ndarray) -> List[EngineResult]:
        if pending.staging_buf is not None:
            # Results are on host => the step ran => its H2D copies finished.
            self._staging.setdefault(pending.staging_key, []).append(
                pending.staging_buf)
            pending.staging_buf = None
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
                batch_n=pending.n, serve_size=self.model_size))
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
            "pipeline_avg_ms": f"{lat['avg_ms']:.2f}",
            "pipeline_p99_ms": f"{lat['p99_ms']:.2f}",
            "e2e_avg_ms": f"{e2e['avg_ms']:.2f}",
            "e2e_p99_ms": f"{e2e['p99_ms']:.2f}",
            "avg_batch": f"{self.batch_sizes.snapshot()['avg_ms']:.1f}",
            "warmed": str(self.warmed).lower(),
        }
