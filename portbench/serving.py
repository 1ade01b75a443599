"""The serving core under test, assembled as the server assembles it, and
one run of a cell over it.

The run's process holds the program's `DeviceFrameCache` (one slot a
stream), `InferenceEngine` and `ContinuousBatcher`, built from the
configuration file as `runtime/server.py` builds them. A generator thread
plays the server's decode workers: at each due time of the open-loop
schedule it queues the frame's keyframe or region write in the cache,
stamps the request's `enqueue_t` with the due time and submits it.
Results come back through the batcher's `on_result`.

Spans come from thin wrappers installed on the objects (never inside the
program): the cache's `dispatch_with` (lock held through the flush and
the gather), the engine's `gather_from_cache`, `dispatch_gathered` and
`complete_many`, and the batcher's `_collect` (which frames left the
queues). Every frame offered in the window is accounted for: served,
superseded in its client's queue, shed or refused by the cache, dropped by
the engine, or unanswered at the end.

The cache holds each client's newest frame: a step serves whatever writes
were queued when its flush ran, which may include frames the generator
sent after the requested one (newest wins, by the cache's design). A
wrapper around the cache's flush notes, for each client, the newest write
it applies; each served frame is judged against the content the step
actually gathered, rebuilt by the reference from the pool.
"""

from __future__ import annotations

import copy
import gc
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from zero_latency_yolo_tpu_torch.config import ServerConfig
from zero_latency_yolo_tpu_torch.ops.roi import DeviceFrameCache
from zero_latency_yolo_tpu_torch.runtime.engine import (InferenceEngine,
                                                        InferenceRequest)
from zero_latency_yolo_tpu_torch.runtime.scheduler import ContinuousBatcher
from zero_latency_yolo_tpu_torch.utils import gcstats

from .traffic import Traffic

DRAIN_S = 60.0  # a frame due in the window may answer this long after it
TRACE_S = 2.0   # the traced window, at the end of the measured one


def server_config(cfg: Dict, streams: int, root: Path,
                  control: Optional[str] = None) -> ServerConfig:
    """The program's configuration of a cell: the configuration file's
    server block, one cache slot a stream, and for the control run the
    program's own lower-precision path."""
    d = copy.deepcopy(cfg["server"])
    d["max_clients"] = int(streams)
    d["model_path"] = str(root.parent / cfg["weights"])
    if control == "int8":
        d["tpu"]["quantize_int8"] = True
    elif control is not None:
        raise ValueError(f"unknown control {control!r}")
    return ServerConfig.from_dict(d)


def build_engine(config: ServerConfig, device: str) -> InferenceEngine:
    engine = InferenceEngine(config, device=device)
    if engine.simulation:
        raise RuntimeError(f"{config.model_path}: the engine fell back to "
                           "simulation (weights not loadable)")
    return engine


class Recorder:
    """What the wrappers and the callback saw, by host clock."""

    def __init__(self) -> None:
        self.spans: Dict[str, List[Tuple[float, float]]] = {
            "cache_lock": [], "gather": [], "launch": [], "complete": []}
        # (dispatch start, launch end, bucket rows, frames, serve size)
        self.steps: List[Tuple[float, float, int, int, int]] = []
        self.dispatch_t: Dict[Tuple[int, int], float] = {}
        self.collected: set = set()
        self.failed: set = set()
        self.results: Dict[Tuple[int, int], Tuple[float, list]] = {}
        self.last_collect: List[Tuple[int, int]] = []
        # id of a written array -> (client, frame, the array, kept alive)
        self.write_of: Dict[int, Tuple[int, int, object]] = {}
        # client -> frame of the newest write the cache has applied
        self.held: Dict[int, int] = {}
        self.snapshot: Dict[int, Optional[int]] = {}
        # (client, frame) -> frame whose content the step gathered
        self.served_as: Dict[Tuple[int, int], Optional[int]] = {}


def install(engine, cache, batcher, rec: Recorder) -> None:
    """Wrap the calls the batcher makes, on these instances only."""
    pc = time.perf_counter
    start = [0.0]

    def unwrapped(obj, name):
        # The class's method: a second install replaces the first one's.
        return getattr(type(obj), name).__get__(obj, type(obj))

    def wrap(obj, name, span, on_error=None, orig=None):
        orig = orig or unwrapped(obj, name)

        def call(*args, **kw):
            t0 = pc()
            if span == "cache_lock":
                start[0] = t0
            try:
                return orig(*args, **kw)
            except Exception:
                if on_error is not None:
                    on_error(*args, **kw)
                raise
            finally:
                rec.spans[span].append((t0, pc()))
        setattr(obj, name, call)

    def lock_failed(fn, ids):
        cids = set(ids)
        rec.failed.update(k for k in rec.last_collect if k[0] in cids)

    def launch_failed(requests, gathered, size=None):
        rec.failed.update((r.client_id, r.frame_id) for r in requests)

    def complete_failed(pendings):
        for p in pendings:
            rec.failed.update((r.client_id, r.frame_id) for r in p.requests)

    orig_flush = unwrapped(cache, "_flush_locked")

    def flush():
        # Under the cache's lock: what this flush applies, in order.
        for frame in list(cache._pending_kf.values()):
            w = rec.write_of.get(id(frame))
            if w:
                rec.held[w[0]] = w[1]
        for p in cache._pending:
            w = rec.write_of.get(id(p[5]))
            if w:
                rec.held[w[0]] = w[1]
        return orig_flush()
    cache._flush_locked = flush
    orig_lock = unwrapped(cache, "dispatch_with")

    def dispatch_with(fn, ids):
        def gather(*args):
            rec.snapshot = {c: rec.held.get(c) for c in set(ids)}
            return fn(*args)
        return orig_lock(gather, ids)
    wrap(cache, "dispatch_with", "cache_lock", lock_failed, dispatch_with)
    wrap(engine, "gather_from_cache", "gather")
    wrap(engine, "complete_many", "complete", complete_failed)
    orig_launch = unwrapped(engine, "dispatch_gathered")

    def dispatch_gathered(requests, gathered, size=None):
        t0 = pc()
        try:
            return orig_launch(requests, gathered, size=size)
        except Exception:
            launch_failed(requests, gathered)
            raise
        finally:
            t1 = pc()
            rec.spans["launch"].append((t0, t1))
            rows = (int(gathered.frames.shape[0]) if gathered is not None
                    else len(requests))
            rec.steps.append((start[0], t1, rows, len(requests),
                              int(size or 0)))
            for r in requests:
                rec.dispatch_t[(r.client_id, r.frame_id)] = start[0]
                rec.served_as[(r.client_id, r.frame_id)] = rec.snapshot.get(
                    r.client_id)
    engine.dispatch_gathered = dispatch_gathered
    orig_collect = unwrapped(batcher, "_collect")

    def collect():
        batch = orig_collect()
        rec.last_collect = [(r.client_id, r.frame_id) for r in batch]
        rec.collected.update(rec.last_collect)
        return batch
    batcher._collect = collect


class Generator(threading.Thread):
    """The decode workers' part: writes and submits on the schedule."""

    def __init__(self, traffic: Traffic, cache, batcher, rec: Recorder,
                 t0: float, t_stop: float) -> None:
        super().__init__(name="portbench-generator", daemon=True)
        self.traffic, self.cache, self.batcher = traffic, cache, batcher
        self.rec = rec
        self.t0, self.t_stop = t0, t_stop
        self.offered: Dict[Tuple[int, int], float] = {}
        self.refused: set = set()
        self.late: List[Tuple[float, float]] = []
        # client -> [(first frame, frame after the last)] served stale after
        # the cache shed its writes
        self.shed: Dict[int, List[Tuple[int, float]]] = {}
        self._frozen_from: Dict[int, int] = {}
        self.error: Optional[BaseException] = None

    def run(self) -> None:
        try:
            self._run()
        except BaseException as e:  # noqa: BLE001 — reported by the run
            self.error = e

    def _run(self) -> None:
        tr, cache = self.traffic, self.cache
        h, w = tr.mix["frame"]
        last_k: Dict[int, int] = {}
        event = 0
        while True:
            s, k, off = tr.due(event)
            event += 1
            due = self.t0 + off
            if due >= self.t_stop:
                return
            now = time.perf_counter()
            if due > now:
                time.sleep(due - now)
            self.late.append((due, time.perf_counter() - due))
            cid = s + 1
            key = (cid, k)
            self.offered[key] = due
            last_k[cid] = k
            kind, payload = tr.write(s, k)
            # A view of its own, so the flush's wrapper knows the write.
            view = (payload if kind == "key" else payload[2]).view()
            self.rec.write_of[id(view)] = (cid, k, view)
            if kind == "key":
                ok = cache.write_keyframe(cid, view)
                if ok and cid in self._frozen_from:
                    self.shed.setdefault(cid, []).append(
                        (self._frozen_from.pop(cid), k))
            else:
                x, y, _ = payload
                shed = cache.writes_shed
                ok = cache.write_roi(cid, view, x, y)
                if cache.writes_shed != shed:
                    for c in cache.frozen_clients():
                        if c not in self._frozen_from:
                            kc = last_k.get(c, 0)
                            self._frozen_from[c] = kc - kc % tr.interval
            if not ok:
                self.refused.add(key)
                continue
            req = InferenceRequest(client_id=cid, frame_id=k, timestamp=k,
                                   width=w, height=h, data=None,
                                   keyframe=kind == "key")
            req.enqueue_t = due
            self.batcher.submit(req)

    def stale(self, key: Tuple[int, int]) -> bool:
        spans = self.shed.get(key[0], []) + (
            [(self._frozen_from[key[0]], float("inf"))]
            if key[0] in self._frozen_from else [])
        return any(a <= key[1] < b for a, b in spans)


class Core:
    """Engine (built once; the knee sweep reuses it) and, per run, a cache
    and a batcher over it."""

    def __init__(self, cfg: Dict, root: Path, streams: int, device: str,
                 control: Optional[str] = None) -> None:
        self.cfg = cfg
        self.config = server_config(cfg, streams, root, control)
        self.device = device
        self.engine = build_engine(self.config, device)
        self.bucket = (max(b[0] for b in self.config.tpu.frame_buckets),
                       max(b[1] for b in self.config.tpu.frame_buckets))
        self._warm_engine = True

    def open(self, streams: int, rec: Recorder):
        cfg = self.config
        cache = DeviceFrameCache(streams, self.bucket[0], self.bucket[1],
                                 device=str(self.engine.device))
        batcher = ContinuousBatcher(
            self.engine, lambda results: self._on_results(rec, results),
            max_batch=max(cfg.tpu.batch_buckets),
            batch_window_ms=cfg.tpu.batch_window_ms,
            max_queue_per_client=cfg.max_queue_size,
            device_cache=cache, max_inflight=cfg.tpu.max_inflight)
        if self._warm_engine:
            # The cell's shapes only: every batch bucket, at the cache's
            # bucket and the pinned serve size.
            self.engine.warmup(None, [self.bucket], cache)
            self._warm_engine = False
            gcstats.tune_for_latency()
        else:
            cache.warm()
        install(self.engine, cache, batcher, rec)
        return cache, batcher

    @staticmethod
    def _on_results(rec: Recorder, results) -> None:
        t = time.perf_counter()
        for r in results:
            rec.results[(r.client_id, r.frame_id)] = (t, r.detections)

    def close(self) -> None:
        self.engine = None
        gc.collect()
        if self.device.startswith("cuda"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def drain(batcher, rec: Recorder, deadline: float) -> None:
    """Wait until every frame left in the queues and every batch in
    flight has answered, or the deadline passes."""
    while time.perf_counter() < deadline:
        if batcher.queue_depth() == 0 and all(
                k in rec.results or k in rec.failed
                for k in list(rec.collected)):
            return
        time.sleep(0.005)


def drive(traffic: Traffic, cache, batcher, rec: Recorder, ramp_s: float,
          seconds: float, prof=None) -> Tuple["Generator", float, float]:
    """Start the batcher and the schedule, trace the end of the window when
    `prof` is given, stop sending at the window's close, wait for the
    answers and stop the batcher. Returns (generator, window start, end).

    The profiler's stop holds the batcher for most of a second; it comes
    after the last frame is sent, so that hold delays the frames still
    queued and sheds and supersedes none."""
    batcher.start()
    t0 = time.perf_counter() + 0.01
    w0 = t0 + ramp_s
    w1 = w0 + seconds
    gen = Generator(traffic, cache, batcher, rec, t0, w1)
    gen.start()
    try:
        if prof is not None:
            span = min(TRACE_S, seconds / 3)
            time.sleep(max(w1 - span - prof.arm_s - time.perf_counter(), 0))
            prof.start()
        time.sleep(max(w1 - time.perf_counter(), 0))
        gen.join()
        if prof is not None:
            prof.stop()
        if gen.error is not None:
            raise gen.error
        drain(batcher, rec, w1 + DRAIN_S)
    finally:
        batcher.stop()
    return gen, w0, w1


def account(gen: Generator, batcher, rec: Recorder, w0: float,
            w1: float) -> Dict[str, object]:
    """Every frame due in [w0, w1) into exactly one outcome."""
    queued = {(r.client_id, r.frame_id)
              for q in list(batcher._queues.values()) for r in list(q)}
    kinds = {k: [] for k in ("served", "superseded", "cache_shed",
                             "cache_refused", "engine_dropped",
                             "unanswered")}
    for key, due in gen.offered.items():
        if not w0 <= due < w1:
            continue
        if key in gen.refused:
            kinds["cache_refused"].append(key)
        elif gen.stale(key):
            kinds["cache_shed"].append(key)
        elif key in rec.results:
            kinds["served"].append(key)
        elif key in queued or (key in rec.collected
                               and key not in rec.failed):
            kinds["unanswered"].append(key)
        elif key in rec.collected:
            kinds["engine_dropped"].append(key)
        else:
            kinds["superseded"].append(key)
    offered = sum(1 for due in gen.offered.values() if w0 <= due < w1)
    if sum(len(v) for v in kinds.values()) != offered:
        raise RuntimeError("a frame offered in the window is unaccounted for")
    return kinds


def failed(kinds: Dict[str, list]) -> List[Tuple[int, int]]:
    """The offered frames the system failed: shed or refused by the cache,
    dropped by the engine, never answered, and superseded ones that no
    newer frame of their stream answered. A frame superseded in its
    client's queue by a newer one is answered by that frame's result (the
    queue is newest-wins by design); it lowers `served_fps` and waits in
    the answer latency, and is not failed."""
    newest: Dict[int, int] = {}
    for c, k in kinds["served"]:
        newest[c] = max(newest.get(c, -1), k)
    never = [key for key in kinds["superseded"]
             if newest.get(key[0], -1) < key[1]]
    return (kinds["cache_shed"] + kinds["cache_refused"]
            + kinds["engine_dropped"] + kinds["unanswered"] + never)


def answer_ms(kinds: Dict[str, list], rec: Recorder,
              gen: Generator) -> np.ndarray:
    """For every frame offered in the window, ms from its due time to the
    first result its stream received for it or for a newer frame: a frame
    superseded in its queue is answered only by a later frame's result,
    and one that no served frame covers (inf) never is."""
    offered = sorted(k for ks in kinds.values() for k in ks)
    served = set(kinds["served"])
    out = np.full(len(offered), np.inf)
    first = np.inf
    for i in range(len(offered) - 1, -1, -1):
        key = offered[i]
        if i + 1 == len(offered) or offered[i + 1][0] != key[0]:
            first = np.inf
        if key in served:
            first = min(first, rec.results[key][0])
        out[i] = (first - gen.offered[key]) * 1e3
    return out


class Window:
    """The measured window's times and what the run saw in it."""

    def __init__(self, traffic: Traffic, core: Core, rec: Recorder,
                 gen: Generator, kinds: Dict[str, list], w0: float,
                 w1: float, trace: Optional[Dict],
                 span_end: Optional[float] = None) -> None:
        self.traffic, self.core, self.rec, self.gen = traffic, core, rec, gen
        self.kinds, self.w0, self.w1 = kinds, w0, w1
        self.seconds = w1 - w0
        self.trace = trace
        self.cfg = core.cfg
        self.served = kinds["served"]
        self.latency_ms = np.array(
            [(rec.results[k][0] - gen.offered[k]) * 1e3 for k in self.served])
        self.answer_ms = answer_ms(kinds, rec, gen)
        self.results_in_window = sum(1 for t, _ in rec.results.values()
                                     if w0 <= t < w1)
        # Spans, steps and queue waits are read up to `span_end`: in a
        # traced run the profiler's stop holds the interpreter for a while,
        # and what follows it is not the system's own behaviour.
        self.span_end = span_end or w1
        self.queue_wait_ms = np.array(
            [(rec.dispatch_t[k] - gen.offered[k]) * 1e3 for k in self.served
             if k in rec.dispatch_t and gen.offered[k] < self.span_end])
        self.steps = [s for s in rec.steps if w0 <= s[0] < self.span_end]
        self.results_to_span_end = sum(1 for t, _ in rec.results.values()
                                       if w0 <= t < self.span_end)

    def spans_ms(self, name: str) -> np.ndarray:
        return np.array([(b - a) * 1e3 for a, b in self.rec.spans[name]
                         if self.w0 <= a < self.span_end])
