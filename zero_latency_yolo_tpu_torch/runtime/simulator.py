"""Loopback UDP client simulator — replaces the reference's Windows client for
tests and benchmarks (SURVEY §4 implication b).

Speaks the exact ZLTY protocol: CLIENT_INFO handshake (client/network.cpp:58-131),
FRAME_DATA uploads (raw RGB / JPEG keyframes / ROIIMG region updates, matching
src/client/screen_capture.cpp encodings), heartbeats, ACKs, and
DETECTION_RESULT reception. Includes a fault injector (packet loss / duplication /
corruption) for reliability tests.
"""

from __future__ import annotations

import json
import random
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..protocol import (
    AckPacket, ClientInfo, ClientInfoPacket, CommandPacket, CommandType,
    ConfigUpdatePacket, DetectionResultPacket, ErrorCode, FrameDataPacket,
    HeartbeatPacket, PacketType, ProtocolError, ServerInfoPacket,
    build_roi_header, parse_packet,
)
from ..protocol import native
from ..utils.netstats import (ANC_BUFSIZE, enable_rxq_ovfl, granted_buffers,
                              rxq_ovfl)
from .frames import encode_jpeg


@dataclass
class FaultInjector:
    """Probabilistic packet mangling for transport tests."""
    drop: float = 0.0
    duplicate: float = 0.0
    corrupt: float = 0.0
    rng: random.Random = field(default_factory=lambda: random.Random(42))

    def apply(self, data: bytes) -> List[bytes]:
        r = self.rng.random()
        if r < self.drop:
            return []
        out = [data]
        if self.rng.random() < self.duplicate:
            out.append(data)
        if self.rng.random() < self.corrupt:
            b = bytearray(data)
            b[self.rng.randrange(len(b))] ^= 0xFF
            out[0] = bytes(b)
        return out


class SimClient:
    """Synchronous loopback client; run one per simulated stream."""

    def __init__(self, server_addr: Tuple[str, int],
                 screen_width: int = 800, screen_height: int = 600,
                 game_id: int = 1, faults: Optional[FaultInjector] = None,
                 timeout: float = 5.0) -> None:
        self.server_addr = server_addr
        self.screen_width = screen_width
        self.screen_height = screen_height
        self.game_id = game_id
        self.faults = faults
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        # Loopback-bind for local servers (test hygiene: nothing off-host
        # can spoof results into an assertion); wildcard otherwise so the
        # client works against remote servers (scripts/stream_client.py).
        bind_host = ("127.0.0.1"
                     if server_addr[0] in ("127.0.0.1", "localhost")
                     else "0.0.0.0")
        self.sock.bind((bind_host, 0))
        self.sock.settimeout(timeout)
        # The receive socket's own drop count (SO_RXQ_OVFL, carried on each
        # datagram received after a drop): results the kernel refused at
        # this client's full receive buffer. None where the kernel does not
        # give it.
        self.rx_overflows: Optional[int] = (0 if enable_rxq_ovfl(self.sock)
                                            else None)
        self.server_info = None
        self.results: List[DetectionResultPacket] = []
        # Lifetime count, immune to callers draining/clearing `results`
        # (scripts/stream_client.py drains to stay bounded over long runs).
        self.results_total = 0
        # Server-originated COMMAND packets seen by the receiver (bounded).
        self.commands: List[CommandPacket] = []
        self.result_latencies_ms: List[float] = []
        # Long-running callers set this to bound the latency-sample list
        # (percentiles then cover the most recent window); None = keep all
        # samples (loadtest/soak runs are time-bounded and want every one).
        self.max_latency_samples: Optional[int] = None
        # Server-initiated stream control (REQUEST_KEYFRAME after a shed
        # froze our cache slot): the next capture must be a keyframe.
        self.keyframe_requested = False
        self.keyframe_requests_seen = 0
        self.errors_seen = 0  # ERROR packets observed by the rx loop
        self.errors: List = []  # recent ERROR packets (bounded at 64)
        # Server-pushed runtime settings (CONFIG_UPDATE broadcasts — rate
        # control): latest values win; read under _lock or via a plain
        # .get() (GIL-atomic) for pacing decisions.
        self.server_settings: Dict = {}
        self.config_updates_seen = 0
        # Server-initiated COMMAND(DISCONNECT): graceful shutdown/drain
        # notice — the session is already gone server-side.
        self.server_disconnected = False
        self._reconnect_pending = False
        # The accuracy floor (min_serve_size) this client last asked for in
        # a SET_CONFIG: per-session state that a new session starts without,
        # so reconnect() asks for it again, alone. The thresholds and the
        # SLO are the server's global state, shared by every client, and
        # are not replayed.
        self.sent_floor: Optional[int] = None
        self._handshake_event = threading.Event()
        self._sent_at: Dict[int, float] = {}
        self._frame_id = 0
        self._rx_thread: Optional[threading.Thread] = None
        self._running = False
        self._lock = threading.Lock()
        self._result_event = threading.Event()

    # ------------------------------------------------------------------ io
    def _recv(self) -> bytes:
        """One datagram; notes the drop count it carries."""
        data, anc, _, _ = self.sock.recvmsg(65536, ANC_BUFSIZE)
        if self.rx_overflows is not None:
            n = rxq_ovfl(anc)
            if n is not None and n > self.rx_overflows:
                self.rx_overflows = n
        return data

    def socket_stats(self) -> Dict[str, Optional[int]]:
        """The receive socket's granted buffers (None once closed) and its
        overflow count."""
        try:
            rcv, snd = granted_buffers(self.sock)
        except OSError:
            rcv = snd = None
        return {"rcvbuf": rcv, "sndbuf": snd,
                "rx_overflows": self.rx_overflows}

    def _send(self, data: bytes) -> None:
        datas = self.faults.apply(data) if self.faults else [data]
        for d in datas:
            self.sock.sendto(d, self.server_addr)

    def connect(self) -> ServerInfoPacket:
        """CLIENT_INFO -> wait for SERVER_INFO (reference blocks 3s)."""
        info = ClientInfo(client_id=0, screen_width=self.screen_width,
                          screen_height=self.screen_height, game_id=self.game_id)
        self._send(ClientInfoPacket(info=info).serialize())
        deadline = time.monotonic() + 3.0
        prev_timeout = self.sock.gettimeout()
        try:
            while time.monotonic() < deadline:
                # Cap each blocking recv at the REMAINING handshake window:
                # the constructor's socket timeout (default 5 s, caller-set
                # up to anything) would otherwise overrule the documented
                # 3 s deadline in a single receive.
                self.sock.settimeout(max(deadline - time.monotonic(), 0.01))
                try:
                    data = self._recv()
                except socket.timeout:
                    break
                try:
                    pkt = parse_packet(data)
                except ProtocolError:
                    continue
                if isinstance(pkt, ServerInfoPacket):
                    self.server_info = pkt.info
                    self._send(
                        AckPacket(acked_sequence=pkt.sequence).serialize())
                    return pkt
                if pkt.TYPE == PacketType.ERROR:
                    raise ConnectionRefusedError(
                        f"server error {pkt.error_code}: {pkt.message}")
        finally:
            self.sock.settimeout(prev_timeout)
        raise TimeoutError("no SERVER_INFO from server")

    def start_receiver(self) -> None:
        self._running = True
        self._rx_thread = threading.Thread(target=self._rx_loop, daemon=True)
        self._rx_thread.start()

    def _rx_loop(self) -> None:
        self.sock.settimeout(0.2)
        while self._running:
            try:
                data = self._recv()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                pkt = parse_packet(data)
            except ProtocolError:
                continue
            if isinstance(pkt, DetectionResultPacket):
                now = time.perf_counter()
                with self._lock:
                    self.results.append(pkt)
                    self.results_total += 1
                    t0 = self._sent_at.pop(pkt.frame_id, None)
                    if t0 is not None:
                        self.result_latencies_ms.append((now - t0) * 1e3)
                        cap = self.max_latency_samples
                        if cap and len(self.result_latencies_ms) > cap:
                            del self.result_latencies_ms[:-cap // 2]
                self._result_event.set()
            elif pkt.TYPE == PacketType.ERROR:
                self.errors_seen += 1
                with self._lock:
                    # Retain recent ERRORs (bounded) so drivers/tests can
                    # read refusal REASONS (e.g. a rejected CONFIG_UPDATE),
                    # not just a count.
                    self.errors.append(pkt)
                    del self.errors[:-64]
                if pkt.error_code == ErrorCode.TIMEOUT:
                    # Unknown-sender NAK: our session is gone server-side
                    # (shard crash rebalanced us, or we were evicted) and we
                    # kept streaming — re-handshake instead of waiting out
                    # our own liveness timeout. Only TIMEOUT means session
                    # loss: the server answers INVALID_REQUEST to live
                    # sessions too (bad SET_CONFIG), and re-handshaking on
                    # those would silently clear a deliberate PAUSE.
                    self.server_disconnected = True
            elif isinstance(pkt, ServerInfoPacket):
                # A re-handshake's SERVER_INFO (reconnect() with the
                # receiver running — connect()'s direct socket read would
                # race this loop, which consumes every inbound datagram).
                self.server_info = pkt.info
                try:
                    self._send(AckPacket(
                        acked_sequence=pkt.sequence).serialize())
                except OSError:
                    pass
                # Clear the disconnect flag only while a reconnect is in
                # flight: a stale/retransmitted SERVER_INFO from the old
                # shard must not cancel a genuine disconnect notice.
                if self._reconnect_pending:
                    self.server_disconnected = False
                self._handshake_event.set()
            elif pkt.TYPE == PacketType.COMMAND:
                # Server commands arrive reliable: ACK so retransmits stop.
                try:
                    self._send(AckPacket(
                        acked_sequence=pkt.sequence).serialize())
                except OSError:
                    pass
                if pkt.command_type == CommandType.REQUEST_KEYFRAME:
                    self.keyframe_requested = True
                    self.keyframe_requests_seen += 1
                elif pkt.command_type == CommandType.DISCONNECT:
                    # Server-initiated graceful drain (shutdown/rebalance):
                    # the session is gone server-side — a real client
                    # re-handshakes now instead of waiting out its timeout.
                    self.server_disconnected = True
                with self._lock:
                    # Surface server commands (GET_CONFIG echoes, keyframe
                    # requests) to drivers/tests; bounded so an idle client
                    # can't accumulate unboundedly.
                    self.commands.append(pkt)
                    del self.commands[:-64]
            elif isinstance(pkt, ConfigUpdatePacket):
                # Server-pushed runtime settings (rate control): sent
                # unreliable and re-broadcast each monitor tick, so no ACK.
                with self._lock:
                    self.server_settings.update(pkt.settings)
                self.config_updates_seen += 1

    def reconnect(self, timeout: float = 2.0) -> bool:
        """Re-handshake on the SAME socket after a server drain notice
        (COMMAND DISCONNECT on shutdown/rebalance). Same source port =
        same 4-tuple: if the old shard is gone, the kernel's reuseport
        hash lands the flow on a surviving shard, which sees a fresh
        CLIENT_INFO and opens a new session. Requires the receiver thread
        (it consumes every inbound datagram, including the SERVER_INFO)."""
        if not self._running:
            raise RuntimeError("reconnect() needs start_receiver() running; "
                               "use connect() before the receiver starts")
        self._handshake_event.clear()
        # server_disconnected stays set until the handshake actually
        # completes (the rx thread clears it on SERVER_INFO while
        # _reconnect_pending): a lost CLIENT_INFO/SERVER_INFO must leave
        # the flag up so the next push() retries immediately instead of
        # streaming sessionless until another (1/s rate-limited) NAK.
        self._reconnect_pending = True
        try:
            info = ClientInfo(client_id=0, screen_width=self.screen_width,
                              screen_height=self.screen_height,
                              game_id=self.game_id)
            try:
                self._send(ClientInfoPacket(info=info).serialize())
            except OSError:
                return False
            if not self._handshake_event.wait(timeout):
                return False
        finally:
            self._reconnect_pending = False
        if self.sent_floor is not None:
            # The new session's floor is the config's until the client asks
            # again; in a command of its own, so that a global key the new
            # server refuses cannot take the floor down with it.
            self.set_config(min_serve_size=self.sent_floor)
        return True

    def reset_latency_stats(self) -> None:
        """Drop accumulated e2e latency samples and in-flight send stamps —
        used by load harnesses to start a timed window clean after a warmup/
        prime phase whose results carry cold-compile latencies."""
        with self._lock:
            self.result_latencies_ms.clear()
            self._sent_at.clear()

    def disconnect(self) -> None:
        """Send a DISCONNECT command so the server frees the session."""
        self.send_command(CommandType.DISCONNECT)

    def set_config(self, **settings) -> None:
        """SET_CONFIG with these runtime settings (confidence_threshold,
        nms_threshold, adaptive_slo_ms, min_serve_size); a min_serve_size
        is recorded so that a re-handshake asks for it again."""
        self.send_command(CommandType.SET_CONFIG,
                          json.dumps(settings).encode())

    def send_command(self, command_type: int, data: bytes = b"") -> None:
        if command_type == CommandType.SET_CONFIG:
            try:
                settings = json.loads(data.decode())
            except (UnicodeDecodeError, ValueError):
                settings = None
            if (isinstance(settings, dict)
                    and settings.get("min_serve_size") is not None):
                self.sent_floor = settings["min_serve_size"]
        try:
            self._send(CommandPacket(command_type=command_type,
                                     command_data=data).serialize())
        except OSError:
            pass

    # Stream control (COMMAND types the reference declared but never
    # handled, types.h:94-103 — the rebuild's server implements them).
    def pause_stream(self) -> None:
        self.send_command(CommandType.PAUSE_STREAM)

    def resume_stream(self) -> None:
        self.send_command(CommandType.RESUME_STREAM)

    def start_stream(self) -> None:
        self.send_command(CommandType.START_STREAM)

    def stop_stream(self) -> None:
        self.send_command(CommandType.STOP_STREAM)

    def stop(self) -> None:
        if self.server_info is not None:
            self.disconnect()
        self._running = False
        if self._rx_thread:
            self._rx_thread.join(timeout=1.0)
        self.sock.close()

    # -------------------------------------------------------------- frames
    def send_raw_frame(self, pixels: np.ndarray, timestamp: Optional[int] = None) -> int:
        h, w = pixels.shape[:2]
        self._frame_geom = (w, h)
        return self._send_frame(pixels.tobytes(), w, h, keyframe=True,
                                timestamp=timestamp)

    def send_jpeg_keyframe(self, pixels: np.ndarray, quality: int = 85) -> int:
        h, w = pixels.shape[:2]
        self._frame_geom = (w, h)
        return self._send_frame(encode_jpeg(pixels, quality), w, h, keyframe=True)

    def send_roi_update(self, region: np.ndarray, x: int, y: int,
                        full_width: Optional[int] = None, quality: int = 85) -> int:
        # ROI packets must carry the STREAMED frame geometry (the last
        # keyframe's), not the registered screen dims: the server's
        # letterbox scales by the header w/h, and a stale 800x600 header
        # on a 1280x720 stream skews every ROI-driven inference (and
        # splits one stream across frame buckets) — review r5.
        gw, gh = getattr(self, "_frame_geom", None) or (self.screen_width,
                                                        self.screen_height)
        rh, rw = region.shape[:2]
        payload = build_roi_header(x, y, rw, rh, full_width or gw)
        payload += encode_jpeg(region, quality)
        return self._send_frame(payload, gw, gh, keyframe=False)

    def _send_frame(self, payload: bytes, w: int, h: int, keyframe: bool,
                    timestamp: Optional[int] = None) -> int:
        self._frame_id += 1
        fid = self._frame_id
        ts = int(time.time() * 1000) if timestamp is None else timestamp
        # Native frame builder when available: the pure-Python CRC over
        # every payload dominates client CPU at 60 FPS (the reference
        # client computed its CRC in C++ too, protocol.h:441-466).
        if native.HAVE_FRAME_BUILDER:
            from ..protocol.packets import next_sequence, now_ms
            raw = native.build_frame_data(fid, ts, w, h, keyframe, payload,
                                          next_sequence(), now_ms())
        else:
            raw = FrameDataPacket(
                frame_id=fid, frame_timestamp=ts, width=w, height=h,
                keyframe=keyframe, data=payload).serialize()
        with self._lock:
            self._sent_at[fid] = time.perf_counter()
            # Frames whose results never arrive (shed batches, eviction)
            # would otherwise accumulate forever on a long-running client.
            # Insertion order IS time order, so pop stale entries from the
            # FRONT until the first fresh one — O(stale), not a full scan
            # per send (a shed-heavy loadtest grows this dict to ~fps*60).
            if len(self._sent_at) > 8192:
                cutoff = time.perf_counter() - 60.0
                stale = []
                for k, t0 in self._sent_at.items():  # insertion = time order
                    if t0 >= cutoff:
                        break
                    stale.append(k)
                for k in stale:
                    del self._sent_at[k]
        self._send(raw)
        return fid

    def heartbeat(self, ping: int = 0) -> None:
        self._send(HeartbeatPacket(ping=ping).serialize())

    def start_heartbeat(self, interval_s: float = 1.0) -> None:
        """Periodic heartbeat thread (reference client sends every 1s,
        client/network.cpp:252-266)."""
        def loop():
            while self._running:
                try:
                    self.heartbeat()
                except OSError:
                    return
                time.sleep(interval_s)
        self._hb_thread = threading.Thread(target=loop, daemon=True)
        self._running = True
        self._hb_thread.start()

    # -------------------------------------------------------------- results
    def drain_results(self):
        """Atomically take (and clear) the buffered DETECTION_RESULT
        packets. The public API for long-running drivers that bound their
        memory by draining every tick (scripts/stream_client.py) —
        `results_total` keeps the lifetime count."""
        with self._lock:
            out = self.results[:]
            self.results.clear()
        return out

    def wait_results(self, n: int, timeout: float = 10.0) -> List[DetectionResultPacket]:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if len(self.results) >= n:
                    return list(self.results)
            self._result_event.wait(timeout=0.05)
            self._result_event.clear()
        with self._lock:
            return list(self.results)


def compute_diff_region(current: np.ndarray, previous: np.ndarray,
                        threshold: int = 10, sample_step: int = 4,
                        padding: int = 20, align: int = 8):
    """Changed-region bounding box between two RGB frames.

    Mirrors the reference client's grid-sampled diff detection
    (src/client/screen_capture.cpp:391-468): sample every `sample_step`
    pixels, any channel delta > threshold marks change; pad and align the
    box. Returns (x, y, w, h) or None when nothing changed.
    """
    h, w = current.shape[:2]
    cur = current[::sample_step, ::sample_step].astype(np.int16)
    prev = previous[::sample_step, ::sample_step].astype(np.int16)
    changed = (np.abs(cur - prev) > threshold).any(axis=-1)
    ys, xs = np.nonzero(changed)
    if len(ys) == 0:
        return None
    x0 = max(0, int(xs.min()) * sample_step - padding)
    y0 = max(0, int(ys.min()) * sample_step - padding)
    x1 = min(w - 1, int(xs.max()) * sample_step + padding)
    y1 = min(h - 1, int(ys.max()) * sample_step + padding)
    x0 = (x0 // align) * align
    y0 = (y0 // align) * align
    rw = min(w - x0, ((x1 - x0 + 1 + align - 1) // align) * align)
    rh = min(h - y0, ((y1 - y0 + 1 + align - 1) // align) * align)
    return (x0, y0, rw, rh)


class StreamDriver:
    """Reference-client-style capture loop: keyframe every
    `keyframe_interval` frames, diff-detected ROI updates in between
    (the capture/encode pipeline of src/client/main.cpp:211-241 +
    screen_capture.cpp, minus the Windows capture source)."""

    def __init__(self, client: SimClient, quality: int = 75,
                 keyframe_interval: int = 30, roi_padding: int = 20) -> None:
        self.client = client
        self.quality = quality
        self.keyframe_interval = keyframe_interval
        self.roi_padding = roi_padding
        self._prev: Optional[np.ndarray] = None
        self._count = 0
        self.keyframes_sent = 0
        self.roi_sent = 0
        self.skipped = 0
        self.rehandshakes = 0

    def push(self, frame: np.ndarray) -> Optional[int]:
        """Encode + send one captured frame; returns the frame id or None
        when the frame was skipped (no change). A server REQUEST_KEYFRAME
        (shed-frozen cache slot) forces the next push to re-anchor
        immediately instead of waiting out the keyframe cadence."""
        if getattr(self.client, "server_disconnected", False):
            # Drain notice (shutdown/rebalance): re-handshake on the same
            # socket — the reuseport hash lands us on a surviving shard —
            # and re-anchor with a keyframe (the new session has no cache
            # slot). On failure, skip this tick and retry next push.
            if not self.client.reconnect():
                self.skipped += 1
                return None
            self.rehandshakes += 1
            self._prev = None
        forced = getattr(self.client, "keyframe_requested", False)
        if forced:
            self.client.keyframe_requested = False
        if (self._prev is not None
                and frame.shape != self._prev.shape):
            # Capture source renegotiated resolution mid-stream: a diff
            # against the old geometry is a numpy broadcast crash (review
            # r5) — re-anchor with a keyframe, exactly like a fresh start.
            self._prev = None
        is_key = (forced or self._count % self.keyframe_interval == 0
                  or self._prev is None)
        self._count += 1
        fid: Optional[int]
        if is_key:
            fid = self.client.send_jpeg_keyframe(frame, self.quality)
            self.keyframes_sent += 1
        else:
            region = compute_diff_region(frame, self._prev,
                                         padding=self.roi_padding)
            if region is None:
                # Keep _prev at the last SENT frame: advancing it here let
                # slow sub-threshold changes accumulate invisibly, drifting
                # the server's cached frame until the next keyframe.
                self.skipped += 1
                return None
            x, y, rw, rh = region
            # full_width from the PUSHED frame: a client registered at the
            # constructor-default 800x600 but streaming other geometry must
            # not stamp ROI headers with the stale registration dims.
            fid = self.client.send_roi_update(
                frame[y:y + rh, x:x + rw], x, y,
                full_width=frame.shape[1], quality=self.quality)
            self.roi_sent += 1
            # _prev tracks what the SERVER has: the old frame with only the
            # sent region replaced. Adopting the whole captured frame would
            # hide sub-threshold residue outside the region from future
            # diffs, drifting the server cache until the next keyframe.
            prev = self._prev.copy()
            prev[y:y + rh, x:x + rw] = frame[y:y + rh, x:x + rw]
            self._prev = prev
            return fid
        # COPY: callers may reuse their capture buffer (cv2 cap.read(buf));
        # holding a reference would make every later diff compare the
        # buffer against itself and silently drop all inter-keyframe motion.
        self._prev = frame.copy()
        return fid


def synthetic_frame(width: int, height: int, seed: int = 0,
                    t: float = 0.0) -> np.ndarray:
    """Deterministic synthetic game frame: gradient background + moving blobs."""
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
