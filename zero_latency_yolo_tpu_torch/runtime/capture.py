"""Production dataset capture: sampled served keyframes + their detections
written as a YOLO-convention directory (train/data.py's input format).

The reference has no retraining story at all — its deployment flow is
"train with ultralytics elsewhere, drop the export into models/"
(reference start.sh:113-149). This module closes the loop the other way:
the server itself records what it serves, in exactly the layout the native
fine-tune pipeline consumes, so an operator's path is

    serve with capture on -> fine-tune (train CLI --data <capture_dir>,
    optionally --distill-from the serving artifact) -> canary/hot-swap.

Scope and honesty: labels are the MODEL'S OWN detections (pre-adapter,
confidence-gated) — self-training data, useful for distillation into a
cheaper variant or domain statistics, not ground truth. Frames with zero
detections above the gate are still written (empty label file): background
negatives are training signal in the YOLO convention.

Threading: `offer_keyframe` runs on the decode workers, `on_result` on the
event loop, file IO on one dedicated daemon writer — nothing here ever
touches the device lane or blocks the dispatch thread. Both hot hooks are
a dict op under a small lock; JPEG encode happens on the writer.

Bounds: a pending-frame dict capped by count (PENDING_CAP) AND bytes
(PENDING_BYTES_CAP — wire geometry is client-chosen, so count alone is not
a memory bound; frames whose results never arrive age out by insertion
order), a bounded write queue that SHEDS under disk pressure (counter,
never backpressure), and `max_images` as the disk bound, resumable across
restarts (existing images are counted at init).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.logging import get_logger

log = get_logger("capture")

# Frames stashed awaiting their detection result: bounded by COUNT and by
# BYTES (wire w/h are u16, so a single sub-64KB JPEG datagram can decode to
# a multi-MB frame — a count bound alone is not a memory bound). Oldest
# entries age out first; evictions are counted, never fatal.
PENDING_CAP = 64
PENDING_BYTES_CAP = 96 * 1024 * 1024
WRITE_QUEUE_CAP = 16


class DatasetCapture:
    """Sampled (keyframe, detections) recorder in YOLO-dir layout."""

    def __init__(self, directory: str, sample_every: int = 30,
                 max_images: int = 1000, min_confidence: float = 0.25,
                 jpeg_quality: int = 92) -> None:
        self.directory = directory
        self.sample_every = max(1, int(sample_every))
        self.max_images = max(1, int(max_images))
        self.min_confidence = float(min_confidence)
        self.jpeg_quality = int(jpeg_quality)
        self._images_dir = os.path.join(directory, "images")
        self._labels_dir = os.path.join(directory, "labels")
        os.makedirs(self._images_dir, exist_ok=True)
        os.makedirs(self._labels_dir, exist_ok=True)
        # Resume-aware disk bound: a restarted server keeps honoring the
        # operator's max_images for the directory, not per-process.
        self.written = sum(
            1 for n in os.listdir(self._images_dir)
            if n.lower().endswith((".jpg", ".jpeg", ".png")))
        # Run id carries the pid too: a crash-looping server restarting
        # within the same wall-clock second (or a clock step back) would
        # otherwise reuse the run id, and — with client/frame ids also
        # restarting — silently os.rename over the previous run's pairs
        # while `written` drifts above the real file count (review r5).
        self._run_id = f"{int(time.time())}p{os.getpid()}"
        self._lock = threading.Lock()
        self._pending: "OrderedDict[Tuple[int, int], np.ndarray]" = OrderedDict()
        self._pending_bytes = 0
        self._per_client_seen: Dict[int, int] = {}
        self._queue: "queue.Queue[Optional[Tuple[int, int, np.ndarray, np.ndarray]]]" = (
            queue.Queue(maxsize=WRITE_QUEUE_CAP))
        self.pending_evicted = 0
        self.write_drops = 0
        self.write_errors = 0
        self._full_logged = False
        self._writer = threading.Thread(target=self._write_loop,
                                        name="zlt-capture", daemon=True)
        self._writer.start()

    # ---------------------------------------------------------- hot hooks
    def offer_keyframe(self, client_id: int, frame_id: int,
                       pixels: np.ndarray) -> None:
        """Decode-worker hook: stash every Nth full frame per client.

        `pixels` may be a read-only view over the datagram payload — held
        as-is (bytes are immutable); the writer copies via JPEG encode.
        """
        if self.written >= self.max_images:
            return
        with self._lock:
            seen = self._per_client_seen.get(client_id, 0)
            self._per_client_seen[client_id] = seen + 1
            if seen % self.sample_every:
                return
            old = self._pending.pop((client_id, frame_id), None)
            if old is not None:
                self._pending_bytes -= old.nbytes
            self._pending[(client_id, frame_id)] = pixels
            self._pending_bytes += pixels.nbytes
            while self._pending and (len(self._pending) > PENDING_CAP
                                     or self._pending_bytes
                                     > PENDING_BYTES_CAP):
                _, dropped = self._pending.popitem(last=False)
                self._pending_bytes -= dropped.nbytes
                self.pending_evicted += 1

    def on_result(self, client_id: int, frame_id: int, detections) -> None:
        """Event-loop hook: pair a result with its stashed frame.

        Takes the PRE-adapter detections — the model's output, before
        domain shaping (head shrink) rewrites boxes for the wire.
        """
        with self._lock:
            pixels = self._pending.pop((client_id, frame_id), None)
            if pixels is not None:
                self._pending_bytes -= pixels.nbytes
        if pixels is None:
            return
        rows = [(int(d.class_id), float(d.x), float(d.y),
                 float(d.width), float(d.height)) for d in detections
                if d.confidence >= self.min_confidence]
        labels = np.asarray(rows, np.float32).reshape(len(rows), 5)
        try:
            self._queue.put_nowait((client_id, frame_id, pixels, labels))
        except queue.Full:
            self.write_drops += 1

    def evict_client(self, client_id: int) -> None:
        with self._lock:
            self._per_client_seen.pop(client_id, None)
            for key in [k for k in self._pending if k[0] == client_id]:
                self._pending_bytes -= self._pending.pop(key).nbytes

    # -------------------------------------------------------------- writer
    def _write_loop(self) -> None:
        from .frames import encode_jpeg  # deferred: cv2 import cost
        while True:
            item = self._queue.get()
            if item is None:
                return
            if self.written >= self.max_images:
                if not self._full_logged:
                    self._full_logged = True
                    log.info("capture dir %s reached max_images=%d; "
                             "capture stopped", self.directory,
                             self.max_images)
                continue
            client_id, frame_id, pixels, labels = item
            stem = f"zl{self._run_id}_c{client_id}_f{frame_id}"
            try:
                jpg = encode_jpeg(np.ascontiguousarray(pixels),
                                  quality=self.jpeg_quality)
                tmp = os.path.join(self._images_dir, stem + ".jpg.tmp")
                with open(tmp, "wb") as f:
                    f.write(jpg)
                lines: List[str] = []
                for cls, cx, cy, w, h in labels:
                    # Clamp into [0,1]: train/data.py validates ranges and
                    # a box nudged outside by bf16 rounding must not poison
                    # a later fine-tune load.
                    cx, cy = min(max(cx, 0.0), 1.0), min(max(cy, 0.0), 1.0)
                    w, h = min(max(w, 0.0), 1.0), min(max(h, 0.0), 1.0)
                    if w <= 0.0 or h <= 0.0:
                        continue
                    lines.append(f"{int(cls)} {cx:.6f} {cy:.6f} "
                                 f"{w:.6f} {h:.6f}")
                with open(os.path.join(self._labels_dir, stem + ".txt"),
                          "w") as f:
                    f.write("\n".join(lines) + ("\n" if lines else ""))
                # Image lands LAST and atomically: a pair is visible to a
                # fine-tune scan only once both halves are complete.
                os.rename(tmp, os.path.join(self._images_dir, stem + ".jpg"))
                self.written += 1
            except Exception:  # noqa: BLE001 - capture must never kill serving
                self.write_errors += 1
                log.exception("capture write failed (%s)", stem)

    # ---------------------------------------------------------------- mgmt
    def status(self) -> Dict[str, object]:
        with self._lock:
            pending = len(self._pending)
            pending_bytes = self._pending_bytes
        return {
            "dir": self.directory,
            "written": self.written,
            "max_images": self.max_images,
            "full": self.written >= self.max_images,
            "pending": pending,
            "pending_bytes": pending_bytes,
            "pending_evicted": self.pending_evicted,
            "write_drops": self.write_drops,
            "write_errors": self.write_errors,
        }

    def stop(self, timeout: float = 5.0) -> None:
        sentinel_sent = True
        try:
            self._queue.put(None, timeout=timeout)
        except queue.Full:
            sentinel_sent = False
        self._writer.join(timeout=timeout)
        if self._writer.is_alive():
            # Loud, not silent (review r5): a writer that outlives stop()
            # — slow disk kept the queue full past the timeout, or a write
            # is wedged — would race a successor capture on the same
            # directory and double-count `written`.
            log.warning(
                "capture writer still running after stop(%ss)%s — a new "
                "capture on this directory would race it", timeout,
                "" if sentinel_sent else " (shutdown sentinel dropped on a "
                                         "full queue)")
