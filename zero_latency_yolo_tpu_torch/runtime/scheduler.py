"""Continuous-batching scheduler: per-client queues -> micro-batched device steps.

A copy of the JAX package's `runtime/scheduler.py` over the PyTorch engine.
Two differences: a batch is ready when the CUDA event its dispatch recorded
behind the step and the result's D2H copy has completed
(`PendingBatch.event`); and a batch served from the device frame cache
(requests without pixels) holds the cache's lock only while it flushes the
queued writes and gathers its slots, not while the step runs (see
`_dispatch`).

This replaces the reference's incoherent two-pool scheme (1 inference thread
racing N worker threads on one queue, batching stubbed — SURVEY §2.3/§3.4)
with a single coherent batcher:

- per-client bounded queues with drop-oldest overflow, enforcing
  `max_queue_size` for real (the reference parsed but never enforced it,
  SURVEY §2.9 item 10; semantics from concurrent_queue.h push_force);
- micro-batch collection: close a batch at `max_batch` frames or
  `batch_window_ms`, whichever first — the intended behavior of the
  reference's stub (onnx_engine.cpp:320-344: ≤4 frames / 5 ms);
- round-robin draining across clients for fairness at 64 streams;
- at most one frame per client per batch (a newer frame supersedes, matching
  the drop-oldest stream semantics);
- the batcher thread is the ONLY thread touching the device: completion
  runs inline after the NEXT dispatch (pipelining via async D2H copies); a
  single device lane keeps the engine's host state (staging free-lists,
  hot-reload swap) single-threaded;
- every engine call of the batcher (dispatch, readiness query, completion)
  holds `device_gate`, so that a profiler capture (`utils/profiling.py`,
  the server's /profilez) starts and stops only between them: stopping
  torch.profiler while a thread is inside an operator can crash the
  process;
- while a profiler runs, each dispatched group is a recorded step of the
  span recorder (`utils/profiling.SPANS`): its root span `batcher.step`
  and each request's wait from `enqueue_t` to the step.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional

from ..utils.logging import get_logger
from ..utils.profiling import SPANS, armed
from .engine import (
    EngineResult, InferenceEngine, InferenceRequest, _pick_batch,
    group_by_bucket,
)

log = get_logger("scheduler")


class ContinuousBatcher:
    def __init__(self, engine: InferenceEngine,
                 on_result: Callable[[List[EngineResult]], None],
                 max_batch: int = 64,
                 batch_window_ms: float = 3.0,
                 max_queue_per_client: int = 8,
                 device_cache=None,
                 max_inflight: int = 2) -> None:
        self.engine = engine
        self.on_result = on_result
        # Held around every engine call of the batcher thread; a profiler
        # start or stop takes it (utils/profiling.capture).
        self.device_gate = threading.RLock()
        # Clamp to the engine's OWN batch buckets: the engine may have
        # filtered the configured buckets (e.g. to multiples of the serving
        # mesh's data axis), and collecting more requests than the largest
        # real bucket would overrun the staging batch / mint per-count
        # cached programs.
        engine_max = max(engine.batch_buckets) if engine.batch_buckets else max_batch
        self.max_batch = min(max_batch, engine_max)
        if self.max_batch != max_batch:
            log.warning("max_batch clamped %d -> %d (engine batch buckets %s)",
                        max_batch, self.max_batch, engine.batch_buckets)
        self.batch_window_ms = batch_window_ms
        # Clamp like max_inflight: max_queue <= 0 would make submit()'s
        # drop-oldest loop popleft an EMPTY deque on every frame.
        self.max_queue = max(int(max_queue_per_client), 1)
        if self.max_queue != max_queue_per_client:
            log.warning("max_queue_size clamped %r -> %d",
                        max_queue_per_client, self.max_queue)
        self.device_cache = device_cache
        self.max_inflight = max(int(max_inflight), 1)
        self._queues: "OrderedDict[int, deque]" = OrderedDict()
        self._cv = threading.Condition()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._pending = 0
        # Dispatched-but-unread batches (depth 2: one batch computing on
        # device while the previous one's results convert on host).
        self._inflight: deque = deque()
        # Stall visibility: perf_counter stamps set while the lane is inside
        # a REAL device readback (complete_many) or a dispatch (H2D/compile/
        # cache flush can block on a wedged transport too). A device that
        # stops answering blocks this single lane with no exception — the
        # monitor loop surfaces the stall via device_stall_s() instead of
        # serving silence.
        self._completing_since: Optional[float] = None
        self._dispatching_since: Optional[float] = None

    # ---------------------------------------------------------------- submit
    def submit(self, request: InferenceRequest) -> bool:
        """Enqueue a frame; drop-oldest when the client's queue is full.
        Returns False if a frame was dropped to make room."""
        dropped = False
        with self._cv:
            q = self._queues.get(request.client_id)
            if q is None:
                q = deque()
                self._queues[request.client_id] = q
            while len(q) >= self.max_queue:
                q.popleft()
                self._pending -= 1
                dropped = True
            q.append(request)
            self._pending += 1
            self._cv.notify()
        if dropped:
            self.engine.frames_dropped.inc()
        return not dropped

    def remove_client(self, client_id: int) -> int:
        """Forget a client's queued frames; returns how many there were."""
        with self._cv:
            q = self._queues.pop(client_id, None)
            if q:
                self._pending -= len(q)
            return len(q) if q else 0

    def discard_pending(self) -> int:
        """Forget every queued frame (the server is stopping); returns how
        many there were."""
        with self._cv:
            n, self._pending = self._pending, 0
            self._queues.clear()
            return n

    def queue_depth(self) -> int:
        with self._cv:
            return self._pending

    def device_stall_s(self) -> float:
        """Seconds the device lane has gone without completing a REAL batch
        that should have finished: the age of a blocked readback, or of the
        oldest in-flight device batch. ~0 in healthy serving (a step is
        milliseconds); sustained growth means the device stopped answering
        (a hung kernel or a lost device) while ingest sheds normally.
        Read from other threads (monitor loop / statusz) — attribute reads
        are atomic and the worst case is one stale sample."""
        t = self._completing_since
        if t is None:
            t = self._dispatching_since
        if t is not None:
            return max(time.perf_counter() - t, 0.0)
        try:
            p = self._inflight[0]
        except IndexError:
            return 0.0
        if not p.is_real_device:
            return 0.0  # synthetic/simulated lanes cannot wedge
        return max(time.perf_counter() - p.t0, 0.0)

    # --------------------------------------------------------------- control
    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, name="zlt-batcher",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        with self._cv:
            self._running = False
            self._cv.notify_all()
        if self._thread:
            self._thread.join(timeout=5.0)
            self._thread = None

    # ------------------------------------------------------------------ loop
    def _collect(self) -> List[InferenceRequest]:
        """Round-robin drain: newest frame per client (older ones in the same
        batch window are superseded and counted as drops)."""
        batch: List[InferenceRequest] = []
        with self._cv:
            clients = list(self._queues.keys())
            # Keyframe priority (reference onnx_engine.cpp:241-244): when the
            # batch can't admit every stream, clients whose newest pending
            # frame is a keyframe go first — with the device frame cache a
            # keyframe re-anchors the client's slot, so serving it late
            # stalls every later ROI delta of the stream.
            if self._pending > self.max_batch:
                clients.sort(key=lambda c: not (
                    self._queues[c] and self._queues[c][-1].keyframe))
            for cid in clients:
                q = self._queues[cid]
                if not q:
                    continue
                while len(q) > 1:  # supersede stale frames
                    q.popleft()
                    self._pending -= 1
                    self.engine.frames_dropped.inc()
                batch.append(q.popleft())
                self._pending -= 1
                # Rotate for fairness.
                self._queues.move_to_end(cid)
                if len(batch) >= self.max_batch:
                    break
        return batch

    def _loop(self) -> None:
        window_s = self.batch_window_ms / 1000.0
        while True:
            with self._cv:
                while self._running and self._pending == 0 and not self._inflight:
                    self._cv.wait(timeout=0.1)
                stopping = not self._running
                if not stopping:
                    if self._pending == 0:
                        # Idle with batches in flight: complete them now.
                        pass
                    oldest = min(
                        (q[0].enqueue_t for q in self._queues.values() if q),
                        default=time.perf_counter())
            if stopping:
                # Drain OUTSIDE the condition lock: completion is a real
                # device readback that can block for as long as the device
                # hangs, and holding self._cv through it would hang every
                # submit()/remove_client()/queue_depth() caller for the
                # whole teardown.
                self._drain_inflight()
                return
            if self._pending == 0 and self._inflight:
                if self._inflight[0].ready_at is None:
                    # Idle: nothing to dispatch — drain everything in flight
                    # now (tail results land sooner than popping them one
                    # per loop turn).
                    self._complete_n(len(self._inflight))
                else:
                    # Synthetic lane: ready times are exact — complete only
                    # the finished prefix and sleep until the next step ends
                    # or a submit arrives. Blocking on the NEWEST batch here
                    # (the policy above) would hold arrivals hostage
                    # for a whole step and inflate the measured host path.
                    n_ready = 0
                    for p in self._inflight:
                        if self._ready_gated(p):
                            n_ready += 1
                        else:
                            break
                    if n_ready:
                        self._complete_n(n_ready)
                    else:
                        delay = max(
                            self._inflight[0].ready_at - time.perf_counter(),
                            0.0)
                        with self._cv:
                            if self._running and self._pending == 0:
                                self._cv.wait(
                                    timeout=min(delay + 0.0002, 0.1))
                continue
            deadline = oldest + window_s
            # Batch-forming window: wait on the condition variable (woken by
            # submits) until the batch fills or the deadline passes. In-flight
            # batches whose async D2H has landed complete immediately (2 ms
            # readiness polling), so the single lane adds no window of
            # completion latency.
            while True:
                if self._inflight and self._ready_gated(self._inflight[0]):
                    self._complete_oldest()
                remaining = deadline - time.perf_counter()
                # Completion readiness granularity: 2 ms polling for real
                # device handles; EXACT for synthetic batches (ready time
                # known) so completion adds no poll quantization to the
                # measured host path.
                poll = 0.002
                if self._inflight and self._inflight[0].ready_at is not None:
                    poll = max(self._inflight[0].ready_at
                               - time.perf_counter(), 0.0) + 0.0002
                with self._cv:
                    if self._pending >= self.max_batch or remaining <= 0:
                        break
                    self._cv.wait(timeout=(remaining if not self._inflight
                                           else min(remaining, poll)))
            batch = self._collect()
            if batch:
                # Stamp the dispatch too: H2D/compile/cache-flush inside it
                # can block on a wedged transport with _inflight still empty
                # (first batch after an idle drain) — without this the
                # watchdog is blind to dispatch-side wedges.
                self._dispatching_since = time.perf_counter()
                try:
                    with self.device_gate:
                        self._inflight.extend(self._dispatch(batch))
                except Exception:  # noqa: BLE001
                    self.engine.error_count.inc()
                    log.exception("batch dispatch failed (batch=%d)", len(batch))
                finally:
                    self._dispatching_since = None
            # Single device lane, pipelined: the newest dispatch computes on
            # device while we convert the older ones' (async-copied) results
            # on host. When the window fills, drain to depth 1 in one call
            # (complete_many reads batches whose copy did not start at
            # dispatch in ONE readback). At the default depth 2 this is
            # exactly complete-the-previous-batch.
            # max_inflight=1 means NO pipelining (debugging a wedged
            # device): drain to zero, not one, or the configured
            # discipline silently runs at depth 2.
            if len(self._inflight) >= self.max_inflight:
                keep = 1 if self.max_inflight > 1 else 0
                self._complete_n(len(self._inflight) - keep)

    def _ready_gated(self, pending) -> bool:
        with self.device_gate:
            return self._ready(pending)

    @staticmethod
    def _ready(pending) -> bool:
        if pending.ready_at is not None:  # synthetic fake device step
            return time.perf_counter() >= pending.ready_at
        if pending.simulated is not None or pending.out is None:
            return True
        if pending.event is not None:  # CUDA: step and D2H copy done?
            return bool(pending.event.query())
        return not pending.out.is_cuda  # a CPU step ran inside dispatch

    def _complete_oldest(self) -> None:
        self._complete_n(1)

    def _complete_n(self, k: int) -> None:
        batch = [self._inflight.popleft() for _ in range(min(k, len(self._inflight)))]
        if not batch:
            return
        if any(p.is_real_device for p in batch):
            # Real device readback ahead: stamp it so a wedged device shows
            # up as device_stall_s growth instead of silent blocking.
            self._completing_since = time.perf_counter()
        try:
            with self.device_gate:
                all_results = self.engine.complete_many(batch)
        except Exception:  # noqa: BLE001
            self.engine.error_count.inc()
            # The dropped batches' staging buffers never reached _convert;
            # recycle them here or every failed completion leaks one
            # full-size host buffer (unbounded under a hung device).
            with self.device_gate:
                self.engine.recycle_staging(batch)
            log.exception("batch completion failed")
            return
        finally:
            self._completing_since = None
        for results in all_results:
            try:
                self.on_result(results)
            except Exception:  # noqa: BLE001
                log.exception("result callback failed")

    def _drain_inflight(self) -> None:
        self._complete_n(len(self._inflight))

    def _dispatch(self, batch: List[InferenceRequest]):
        cache = self.device_cache
        cached = [r for r in batch if r.data is None]
        hosted = [r for r in batch if r.data is not None]
        out = []
        # Per-client accuracy floors (min_serve_size): requests whose floor
        # sits above the fleet-wide adaptive rung must be served at their
        # own (higher) rung — the batch splits by effective size, one
        # dispatch per distinct rung. With no floors set this is exactly one
        # group (the common case costs nothing); floors only differ from
        # the fleet rung while the SLO policy is downshifted, and every
        # rung is warmed at every batch bucket when the SLO is armed.
        eff = self.engine.effective_serve_size

        def launch(group, fn, rows=0):
            # Per-group isolation: a batch can split into several device
            # dispatches (cached + hosted, frame buckets, accuracy-floor
            # rungs). One group's failure (a CUDA error, a refused
            # request) must not abandon groups ALREADY LAUNCHED —
            # an exception out of _dispatch would drop their
            # PendingBatches on the floor: results never completed,
            # frames not counted, staging buffers leaked past the
            # free-list. Failed groups are counted as drops here.
            token = (SPANS.step_begin(
                rows or _pick_batch(self.engine.batch_buckets, len(group)),
                group, self.engine.device) if armed() else None)
            try:
                out.append(fn(group))
            except Exception:  # noqa: BLE001
                self.engine.error_count.inc()
                self.engine.frames_dropped.inc(len(group))
                log.exception("group dispatch failed (n=%d); group dropped",
                              len(group))
            finally:
                if token is not None:
                    SPANS.step_end(token)

        if cached:
            if cache is None:
                raise RuntimeError("cached requests but no device cache configured")
            # Device-resident path: frames were written to the cache at
            # packet-decode time; pad the slot list to the batch bucket.
            # The cache's lock is held for the resolve, the flush of the
            # queued writes and the gather of the slots into a new tensor
            # (gather_from_cache), not for the step: the eager step spends
            # milliseconds of host time launching its kernels, and a lock
            # held that long would stall every decode worker's write_roi /
            # write_keyframe. Nothing is donated in PyTorch and only this
            # thread issues device work, so a write flushed later is queued
            # on the stream behind this gather and cannot change its frames.
            by_size: Dict[int, List[InferenceRequest]] = {}
            for r in cached:
                by_size.setdefault(eff(r.min_size), []).append(r)
            for size, group in by_size.items():
                n = len(group)
                b = _pick_batch(self.engine.batch_buckets, n)
                cids = [r.client_id for r in group]
                cids += [cids[0]] * (b - n)
                launch(group,
                       lambda g, sz=size, ids=cids: self.engine.dispatch_gathered(
                           g, cache.dispatch_with(
                               self.engine.gather_from_cache, ids), size=sz),
                       b)
        if hosted:
            # Group by frame bucket first: with non-nested buckets (e.g.
            # mixed portrait/landscape) no single bucket may cover the whole
            # batch, and one dispatch would fail for everyone.
            for rs in group_by_bucket(self.engine.frame_buckets,
                                      hosted).values():
                by_size = {}
                for r in rs:
                    by_size.setdefault(eff(r.min_size), []).append(r)
                for size, group in by_size.items():
                    launch(group,
                           lambda g, sz=size: self.engine.dispatch(g, size=sz))
        return out
