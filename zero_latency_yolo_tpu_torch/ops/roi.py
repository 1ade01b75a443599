"""Device-resident per-client frame cache with ROI/diff updates.

The PyTorch counterpart of the JAX package's `ops/roi.py` `DeviceFrameCache`.
The reference protocol sends full JPEG keyframes and ROIIMG-headed JPEG
region updates (src/client/screen_capture.cpp:356-538); the reference server
never implemented the decode path (SURVEY §2.9 item 8).

The authoritative copy of every client's latest frame lives on the device as
a fixed-slot uint8 tensor (slots, H, W, 3):

- keyframes overwrite a slot: only the frame's own (h, w) bytes are
  uploaded, and the rest of the slot is zeroed on the device (the JAX cache
  uploads the frame zero-padded to the whole slot, because XLA needs static
  shapes; the slot's content is the same);
- ROI updates upload only the decoded region bytes and paste them into the
  slot in place, in submission order;
- inference gathers (slot -> batch) directly on the device; frame pixels
  never come back to the host.

Writers (the server's decode workers) only queue writes on the host; the
thread that gathers (the batcher) applies them at its next flush, so one
thread issues all device work. A flush uploads each write batch from a
pinned host buffer with one `non_blocking` copy and reuses a buffer only
after a CUDA event recorded behind its copy has passed: a flush never waits
for the device. The host logic (bucket ladders, slot management, validation
at enqueue, the shed and freeze policy and its counters, flush order) is
copied one for one from the JAX cache, so the same writes leave the same
bytes in both. The writes are plain PyTorch tensor operations (two
launches for a flush's keyframes of one shape, one slice copy an ROI): the
JAX package computes them in XLA, not in a Pallas kernel.

On a serving mesh (`parallel/mesh.py`) the cache shards its slots over the
mesh's data rows, as the JAX cache shards over the data axis of its
sharding: `num_slots` rounds up to a multiple of `data`, slot s lives on
the lead device of data row s // (num_slots / data), and every write goes
to the shard that owns its slot. The engine's gather copies each batch
row's frame from whichever shard holds it (`runtime/engine.py`
`_gather_rows`).

JPEG entropy decode itself stays on the host (runtime/frames.py, cv2).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.profiling import LIVE, Span


def _bucket(n: int, rungs: Tuple[int, ...], cap: int,
            cap_exclusive: bool = False) -> int:
    """Smallest ladder rung >= n that fits under the cap, else the cap —
    the ONE ladder-pick rule behind every padded write shape here (three
    hand-rolled copies of it had already drifted on cap semantics)."""
    for b in rungs:
        if n <= b and (b < cap if cap_exclusive else b <= cap):
            return b
    return cap


def _roi_bucket(n: int, full: int) -> int:
    """Coarse ROI edge buckets: 16, 32, 128, clamped at the cache extent.
    They decide how a flush groups its ROI writes (one write batch per
    class), as in the JAX cache."""
    return _bucket(n, (16, 32, 128), full)


def _count_bucket(n: int, cap: int) -> int:
    """Write-batch count buckets: 16, 64, or the cap (cap-exclusive: a
    64-slot cache's cap IS the chunk, rung 64 would duplicate it)."""
    return _bucket(n, (16, 64), cap, cap_exclusive=True)


# Keyframe flush chunk: bounds one write batch (and its upload) to 16
# whole frames; a connect storm flushes in ceil(n/16) batches.
_KF_CHUNK = 16


def _kf_bucket(n: int, cap: int) -> int:
    """Keyframe-batch count buckets: 1, 4, 16 (= the flush chunk), or the
    slot cap when smaller (the JAX cache pads each keyframe batch to one of
    these; kept for the same ladder and counters)."""
    return _bucket(n, (1, 4, _KF_CHUNK), cap)


def _paste_full_many(cache: torch.Tensor, frames: torch.Tensor,
                     slots: torch.Tensor) -> None:
    """Keyframe writes of K frames of one shape: frames (K, h, w, 3) into
    the top-left corner of their K distinct slots (an int64 tensor on the
    cache's device), the rest of each slot zeroed (what the JAX cache's
    whole-slot write of the zero-padded frame leaves). Two launches for the
    K frames, whatever K."""
    h, w = frames.shape[1:3]
    cache.index_fill_(0, slots, 0)
    cache[:, :h, :w].index_copy_(0, slots, frames)


def _paste_many(cache: torch.Tensor, regions: Sequence[torch.Tensor],
                meta: Sequence[Tuple[int, int, int, int, int]]) -> None:
    """Apply K region pastes in submission order, one slice copy each, so
    overlapping writes to one slot land last-wins (as the JAX cache's
    sequential `fori_loop`; an `index_put_` with duplicate indices would give
    no order). meta rows are (slot, y, x, rh, rw); region i is (rh, rw, 3).

    The JAX masked paste keeps a write inside the rect [y, y + rh) x
    [x, x + rw) clipped to the slot, so a negative origin pastes the
    region's lower-right part; the clipping here is the same."""
    ch, cw = cache.shape[1], cache.shape[2]
    for (slot, y, x, rh, rw), region in zip(meta, regions):
        y0, y1 = max(y, 0), min(y + rh, ch)
        x0, x1 = max(x, 0), min(x + rw, cw)
        if y0 < y1 and x0 < x1:
            cache[slot, y0:y1, x0:x1].copy_(
                region[y0 - y:y1 - y, x0 - x:x1 - x])


class _Uploads:
    """Pinned host buffers for the cache's uploads, each reused only once
    the CUDA event recorded behind its last copy has passed, so filling one
    never races a copy in flight and never waits for the device. On a CPU
    cache the buffers are plain memory and the "upload" is the buffer
    itself (the copy to a CPU tensor is a no-op)."""

    # Buffers kept; an older one is dropped (PyTorch's pinned allocator
    # holds its memory until the copies recorded on it have finished).
    KEEP = 8

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.cuda = device.type == "cuda"
        self._bufs: List[list] = []  # [pinned uint8 tensor, event or None]

    def upload(self, parts: Sequence[np.ndarray]) -> torch.Tensor:
        """Copy the uint8 arrays, one after the other, into one buffer and
        upload it with one copy; returns the flat uint8 device tensor.

        Few calls on purpose: under a loaded server every call into
        PyTorch may wait for the interpreter lock, and this runs under the
        cache's lock."""
        total = sum(int(p.size) for p in parts)
        entry = self._idle(total)
        np.concatenate([p.reshape(-1) for p in parts],
                       out=entry[0].numpy()[:total])
        dev = entry[0][:total].to(self.device, non_blocking=True)
        if self.cuda:
            # On the stream of the copy: the target device's, which on a
            # mesh need not be the current device.
            entry[1] = torch.cuda.Event()
            entry[1].record(torch.cuda.current_stream(self.device))
        return dev

    def _idle(self, nbytes: int) -> list:
        for entry in self._bufs:
            if entry[0].numel() >= nbytes and (entry[1] is None
                                               or entry[1].query()):
                return entry
        size = 1 << max(int(nbytes - 1).bit_length(), 16)
        entry = [torch.empty(size, dtype=torch.uint8, pin_memory=self.cuda),
                 None]
        self._bufs.append(entry)
        if len(self._bufs) > self.KEEP:
            self._bufs.pop(0)
        return entry


class SlotShards:
    """The frames of a slot-sharded DeviceFrameCache: `shards[i]`, on data
    row i's lead device, holds slots [i * per, (i + 1) * per)."""

    def __init__(self, shards: Sequence[torch.Tensor]) -> None:
        self.shards = list(shards)
        self.per = int(self.shards[0].shape[0])

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.per * len(self.shards),) + tuple(self.shards[0].shape[1:])


class DeviceFrameCache:
    """Fixed-slot device frame store for up to `num_slots` client streams,
    on `device` ("cuda" unless the caller asks for "cpu"), or with `mesh`
    (a `parallel.mesh.Mesh`) sharded slot-wise over its data rows' lead
    devices (num_slots rounds up to a multiple of the data axis)."""

    def __init__(self, num_slots: int, height: int, width: int,
                 device: str = "cuda", mesh=None) -> None:
        devices = [torch.device(device)] if mesh is None else mesh.leads
        if any(d.type == "cuda" for d in devices) \
                and not torch.cuda.is_available():
            raise RuntimeError("DeviceFrameCache(device='cuda'): no CUDA "
                               "device (pass device='cpu' to keep it on the "
                               "CPU)")
        if mesh is not None:
            num_slots = -(-num_slots // mesh.data) * mesh.data
        self.num_slots = num_slots
        self.height = height
        self.width = width
        self._per = num_slots // len(devices)
        self._shards = [torch.zeros((self._per, height, width, 3),
                                    dtype=torch.uint8, device=d)
                        for d in devices]
        # The devices as the tensors report them ("cuda" names its index).
        self.device = self._shards[0].device
        # What the engine gathers from: the one tensor, or the shards.
        self._cache = (self._shards[0] if len(self._shards) == 1
                       else SlotShards(self._shards))
        self._uploads = {t.device: _Uploads(t.device) for t in self._shards}
        # Set when a flush failed midway: the cache may hold part of the
        # flush's writes, so the next device touch re-zeroes it and freezes
        # every active slot for keyframe re-anchor (the JAX cache, whose
        # write donates the buffer, re-allocates it at the same point).
        self._cache_dead = False
        self._free = list(range(num_slots))
        self._slot_of: Dict[int, int] = {}
        self._dims: Dict[int, Tuple[int, int]] = {}
        self._lock = threading.Lock()
        # Deferred ROI writes: (slot, y, x, rh, rw, region) applied in
        # submission order at the next flush (gather/dispatch/run_locked).
        self._pending: list = []
        # slot -> latest full keyframe (applied before the ROI deltas: a
        # slot's queued ROIs always postdate its queued keyframe because
        # the keyframe drops everything older for that slot).
        self._pending_kf: Dict[int, np.ndarray] = {}
        # Flush chunk size of the ROI write batches.
        self._chunk = max(2 * num_slots, 64)
        # Shed threshold: writers may queue several chunks ahead of the
        # batcher's flush cadence before the overflow policy kicks in.
        self._max_pending = 4 * self._chunk
        self._pending_bytes = 0
        self._max_pending_bytes = 64 * 1024 * 1024
        # Slots whose pending writes were shed under overflow: their cached
        # frame is the last *flushed* consistent state; further ROI deltas
        # are refused until the client's next keyframe re-anchors the slot
        # (applying deltas over a frame with holes would corrupt it
        # patchwork-style). See _shed_locked.
        self._needs_kf: set = set()
        # Slots frozen since the last drain_frozen() call: the server turns
        # these into COMMAND(REQUEST_KEYFRAME) sends so the client
        # re-anchors in one RTT instead of one keyframe period.
        self._newly_frozen: list = []
        self.flushes = 0
        self.writes_flushed = 0
        self.bytes_flushed = 0  # bytes the flushes uploaded
        self.writes_shed = 0

    # ------------------------------------------------------------ slot mgmt
    def acquire(self, client_id: int) -> Optional[int]:
        with self._lock:
            return self._acquire_locked(client_id)

    def _acquire_locked(self, client_id: int) -> Optional[int]:
        if client_id in self._slot_of:
            return self._slot_of[client_id]
        if not self._free:
            return None
        slot = self._free.pop()
        self._slot_of[client_id] = slot
        self._dims[client_id] = (0, 0)
        return slot

    def release(self, client_id: int) -> None:
        with self._lock:
            slot = self._slot_of.pop(client_id, None)
            self._dims.pop(client_id, None)
            if slot is not None:
                self._drop_slot_writes_locked(slot)
                self._pending_kf.pop(slot, None)
                self._free.append(slot)

    def _drop_slot_writes_locked(self, slot: int) -> int:
        """Remove all pending ROI writes for `slot` (and its shed-freeze
        mark), keeping the byte count in sync. Returns how many were
        dropped."""
        kept = [p for p in self._pending if p[0] != slot]
        dropped = len(self._pending) - len(kept)
        self._pending = kept
        self._pending_bytes = sum(p[5].nbytes for p in kept)
        self._needs_kf.discard(slot)
        return dropped

    def slot(self, client_id: int) -> Optional[int]:
        with self._lock:
            return self._slot_of.get(client_id)

    def dims(self, client_id: int) -> Tuple[int, int]:
        with self._lock:
            return self._dims.get(client_id, (0, 0))

    def has_frame(self, client_id: int) -> bool:
        return self.dims(client_id) != (0, 0)

    # -------------------------------------------------------------- updates
    def write_keyframe(self, client_id: int, frame: np.ndarray) -> bool:
        """Queue a full (h, w, 3) uint8 frame for the client's slot.

        Deferred like ROI writes: the decode worker never touches the
        device. A keyframe supersedes everything queued for its slot."""
        if frame.ndim != 3 or frame.shape[2] != 3 or frame.dtype != np.uint8:
            # Reject malformed arrays at ENQUEUE: an error inside the
            # batched flush is indistinguishable from a device failure
            # there, and that recovery path costs every co-resident stream
            # its frame for one caller's host bug.
            return False
        h, w = frame.shape[:2]
        if h <= 0 or w <= 0 or h > self.height or w > self.width:
            # Zero-area frames would defeat the (0, 0) no-frame sentinel.
            return False
        with self._lock:
            # Slot resolution and mutation under ONE lock hold: resolving
            # first and re-locking would let an eviction + reconnect reuse
            # the slot in between (cross-client leakage).
            slot = self._acquire_locked(client_id)
            if slot is None:
                return False
            # Pre-keyframe deltas (and older keyframes) are superseded; a
            # keyframe also re-anchors a shed-frozen slot.
            self._drop_slot_writes_locked(slot)
            self._pending_kf[slot] = frame
            self._dims[client_id] = (h, w)
        return True

    def write_roi(self, client_id: int, region: np.ndarray, x: int, y: int) -> bool:
        """Queue a decoded (rh, rw, 3) region paste at (x, y) for the
        client's cached frame, applied in order at the next flush."""
        if (region.ndim != 3 or region.shape[2] != 3
                or region.dtype != np.uint8):
            return False  # see write_keyframe: validate at enqueue
        rh, rw = region.shape[:2]
        if rh <= 0 or rw <= 0:
            return False
        with self._lock:
            slot = self._slot_of.get(client_id)
            h, w = self._dims.get(client_id, (0, 0))
            if slot is None or (h, w) == (0, 0):
                return False  # need a keyframe first
            if y + rh > h or x + rw > w:
                return False
            if slot in self._needs_kf:
                # Frozen since a shed: the delta is discarded, but the slot
                # still serves its last consistent frame (stale detections
                # until the next keyframe).
                self.writes_shed += 1
                return True
            self._pending.append((slot, y, x, rh, rw, region))
            self._pending_bytes += region.nbytes
            # Bound host memory under a writer outpacing the batch cadence:
            # SHED a slot's writes rather than flushing from this thread —
            # only the batcher thread issues device work.
            while (len(self._pending) > self._max_pending
                   or self._pending_bytes > self._max_pending_bytes):
                self._shed_locked()
        return True

    def _shed_locked(self) -> None:
        """Overflow policy: drop ALL pending ROI writes for the slot holding
        the most queued bytes and freeze it until its next keyframe."""
        if not self._pending:
            return
        by_slot: Dict[int, int] = {}
        for p in self._pending:
            by_slot[p[0]] = by_slot.get(p[0], 0) + p[5].nbytes
        victim = max(by_slot, key=lambda s: by_slot[s])
        self.writes_shed += self._drop_slot_writes_locked(victim)
        self._needs_kf.add(victim)
        self._newly_frozen.append(victim)

    def _flush_locked(self) -> None:
        """Apply all pending writes (keyframes first, then ROI deltas in
        per-slot submission order). Caller holds self._lock.

        An exception mid-flush consumes the queued writes it was applying;
        silently continuing would later paste deltas over a frame with
        holes. The except path freezes every slot that had anything pending
        — each refuses deltas until its client re-anchors with a keyframe
        (REQUEST_KEYFRAME goes out via drain_frozen) — then re-raises."""
        self._revive_cache_locked()
        if not self._pending_kf and not self._pending:
            return
        touched = set(self._pending_kf) | {p[0] for p in self._pending}
        marks = LIVE.marks  # the recorded step's (utils/profiling), or None
        if marks is not None:
            marks.append((Span.FLUSH, time.perf_counter()))
            counts = (self.writes_flushed, self.bytes_flushed)
        try:
            self._flush_writes_locked()
        except Exception:
            self._freeze_slots_locked(touched)
            self._pending = []
            self._pending_kf = {}
            self._pending_bytes = 0
            # Part of the flush may have landed: re-zero lazily at the next
            # device touch.
            self._cache_dead = True
            raise
        if marks is not None:
            marks.append((~Span.FLUSH, time.perf_counter(),
                          self.writes_flushed - counts[0],
                          self.bytes_flushed - counts[1]))

    def _freeze_slots_locked(self, slots) -> None:
        active = set(self._slot_of.values())
        for s in set(slots) & active:
            if s not in self._needs_kf:
                self._needs_kf.add(s)
                self._newly_frozen.append(s)

    def _revive_cache_locked(self) -> None:
        """Re-zero the cache after a failed flush (see _cache_dead). Every
        active slot's content is zeros now — freeze them all so clients
        re-anchor with keyframes."""
        if not self._cache_dead:
            return
        for shard in self._shards:
            shard.zero_()
        self._freeze_slots_locked(set(self._slot_of.values()))
        self._cache_dead = False

    def _flush_writes_locked(self) -> None:
        if self._pending_kf:
            kf = self._pending_kf
            self._pending_kf = {}
            items = sorted(kf.items())
            chunk = min(_KF_CHUNK, self.num_slots)
            while items:
                part, items = items[:chunk], items[chunk:]
                # One upload and two launches per frame shape in the chunk
                # (slots distinct, so the order within it is immaterial).
                by_shape: Dict[Tuple[int, int], list] = {}
                for slot, frame in part:
                    by_shape.setdefault(frame.shape[:2], []).append(
                        (slot, frame))
                for (h, w), group in by_shape.items():
                    for shard, local in self._by_shard(group):
                        k = len(local)
                        slots = np.array([s for s, _ in local], np.int64)
                        dev = self._uploads[shard.device].upload(
                            [slots.view(np.uint8)] + [f for _, f in local])
                        _paste_full_many(shard, dev[8 * k:].view(k, h, w, 3),
                                         dev[:8 * k].view(torch.int64))
                        self.bytes_flushed += 8 * k + k * h * w * 3
                self.flushes += 1
                self.writes_flushed += len(part)
        # Group pending writes by ROI bucket class BEFORE chunking, as the
        # JAX cache does (its counters and batches are kept): writes to
        # different slots commute, and per-slot ordering is preserved by
        # splitting a slot's writes into RUNS at class-transition
        # boundaries and flushing groups in (phase, class) order.
        groups: Dict[Tuple[int, Tuple[int, int]], list] = {}
        slot_phase: Dict[int, int] = {}
        slot_last: Dict[int, Tuple[int, int]] = {}
        for p in self._pending:
            c = (_roi_bucket(p[3], self.height),
                 _roi_bucket(p[4], self.width))
            if slot_last.get(p[0]) != c:
                slot_phase[p[0]] = slot_phase.get(p[0], -1) + 1
                slot_last[p[0]] = c
            groups.setdefault((slot_phase[p[0]], c), []).append(p)
        self._pending = []
        for (_phase, (bh, bw)), pending in sorted(groups.items()):
            # Full-extent regions chunk at the keyframe stride.
            full = (bh, bw) == (self.height, self.width)
            chunk = min(_KF_CHUNK, self._chunk) if full else self._chunk
            while pending:
                pend, pending = pending[:chunk], pending[chunk:]
                # A slot's writes all go to its own shard, in order.
                for shard, local in self._by_shard(
                        [(p[0], p) for p in pend]):
                    dev = self._uploads[shard.device].upload(
                        [p[5] for _, p in local])
                    regions, off = [], 0
                    for _, p in local:
                        regions.append(dev[off:off + p[5].size].view(
                            p[5].shape))
                        off += p[5].size
                    _paste_many(shard, regions,
                                [(s,) + p[1:5] for s, p in local])
                    self.bytes_flushed += off
                self.flushes += 1
                self.writes_flushed += len(pend)
        self._pending_bytes = 0

    def _by_shard(self, items):
        """(shard tensor, [(local slot, item), ...]) for each shard that
        items [(slot, item), ...] touch, the items' order kept."""
        groups: Dict[int, list] = {}
        for slot, item in items:
            groups.setdefault(slot // self._per, []).append(
                (slot % self._per, item))
        return [(self._shards[i], local)
                for i, local in sorted(groups.items())]

    def _clients_for_slots_locked(self, slots) -> list:
        rev = {s: c for c, s in self._slot_of.items()}
        return [rev[s] for s in slots if s in rev]

    def drain_frozen(self) -> list:
        """One-shot: client ids whose slots froze (shed) since the last
        drain. The server sends each a REQUEST_KEYFRAME command. Slots
        released in the meantime resolve to nothing."""
        if not self._newly_frozen:
            return []  # hot path: called per ROI packet; freezes are rare
        with self._lock:
            slots, self._newly_frozen = self._newly_frozen, []
            slots = [s for s in dict.fromkeys(slots) if s in self._needs_kf]
            if not slots:
                return []
            return self._clients_for_slots_locked(slots)

    def frozen_clients(self) -> list:
        """Client ids currently serving a frozen (shed, pre-keyframe) slot —
        the management loop re-requests keyframes for these in case the
        first command was lost."""
        with self._lock:
            return self._clients_for_slots_locked(list(self._needs_kf))

    def apply_diff(self, client_id: int, diff_region: np.ndarray, x: int, y: int) -> bool:
        """Difference-frame update: the region is the new content for that
        rect (the reference client encodes changed-region *pixels*, not
        deltas — screen_capture.cpp:470-538), so it pastes like a ROI."""
        return self.write_roi(client_id, diff_region, x, y)

    # -------------------------------------------------------------- readout
    def _resolve_locked(self, client_ids):
        """Slot/dims for a batch. A client evicted between the batcher's
        collect and this dispatch resolves to slot 0 with 1x1 dims instead
        of raising — one stale client must not cost every co-batched client
        its result."""
        slots, hs, ws = [], [], []
        for cid in client_ids:
            slot = self._slot_of.get(cid)
            if slot is None:
                slots.append(0)
                hs.append(1)
                ws.append(1)
                continue
            h, w = self._dims.get(cid, (0, 0))
            slots.append(slot)
            hs.append(max(h, 1))
            ws.append(max(w, 1))
        return (np.asarray(slots, np.int32), np.asarray(hs, np.int32),
                np.asarray(ws, np.int32))

    def gather(self, client_ids) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
        """Batch device gather: returns (frames (B,H,W,3) on the (first)
        device, a new tensor; heights; widths)."""
        with self._lock:
            slots, hs, ws = self._resolve_locked(client_ids)
            self._flush_locked()
            if len(self._shards) == 1:
                idx = self._uploads[self.device].upload([slots.view(np.uint8)])
                return (self._cache.index_select(0, idx.view(torch.int32)),
                        hs, ws)
            frames = torch.empty((len(slots), self.height, self.width, 3),
                                 dtype=torch.uint8, device=self.device)
            for shard, local in self._by_shard(
                    (int(s), i) for i, s in enumerate(slots)):
                local_slots, pos = np.array(local, np.int64).T.copy()
                idx = self._uploads[shard.device].upload(
                    [local_slots.view(np.uint8)]).view(torch.int64)
                # Read before the next upload: off the card an upload
                # reuses its buffer at once.
                part = shard.index_select(0, idx).to(self.device,
                                                     non_blocking=True)
                frames.index_copy_(0, self._uploads[self.device].upload(
                    [pos.view(np.uint8)]).view(torch.int64), part)
        return frames, hs, ws

    def dispatch_with(self, fn, client_ids):
        """Run fn(cache, slots, heights, widths) under the cache lock, after
        the flush (cache: the tensor, or a sharded cache's SlotShards). fn
        should only launch device work, not wait for it: a caller that
        gathers out of the cache inside fn (a new tensor) can run the step
        on it after the lock is released — later writes are queued behind
        that gather on the same stream. In a recorded step
        (utils/profiling) the wait to acquire the lock is a span."""
        marks = LIVE.marks
        if marks is not None:
            marks.append((Span.LOCK_WAIT, time.perf_counter()))
        with self._lock:
            if marks is not None:
                marks.append((~Span.LOCK_WAIT, time.perf_counter()))
            slots, hs, ws = self._resolve_locked(client_ids)
            self._flush_locked()
            return fn(self._cache, slots, hs, ws)

    def warm(self) -> None:
        """Run the write path's device operations once (the JAX cache
        compiles its write programs here): zero a free slot, as the JAX
        warm's keyframe scatter of zeros does, and size the first upload
        buffer. Content of the slots in use is untouched."""
        with self._lock:
            self._revive_cache_locked()
            if self._free:
                slot = self._free[0]
                self._shards[slot // self._per][slot % self._per].zero_()
            for uploads in self._uploads.values():
                uploads.upload([np.zeros((self.height, self.width, 3),
                                         np.uint8)])
            self.flushes = 0
            self.writes_flushed = 0
            self.bytes_flushed = 0

    def run_locked(self, fn):
        """Run fn(cache) under the cache lock, after the flush (the tensor,
        or a sharded cache's SlotShards; e.g.
        warmup running the cached step while clients already send
        keyframes). fn should launch device work, not block on results."""
        with self._lock:
            self._flush_locked()
            return fn(self._cache)
