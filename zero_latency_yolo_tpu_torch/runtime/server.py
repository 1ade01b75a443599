"""Asyncio UDP detection server speaking the ZLTY wire protocol.

Rebuilds the reference transport + session dispatch
(src/network/reliable_udp.{h,cpp}, src/network/network_server.cpp) minus its
bugs (SURVEY §2.9: phantom aggregation, mismatched reliable sequence numbers),
on a single asyncio loop instead of recv/management threads:

- CLIENT_INFO handshake: cap check, addr dedupe, id assignment, SERVER_INFO
  reply (reliable) — reference reliable_udp.cpp:376-425, network_server.cpp:152-182
- HEARTBEAT echo with client liveness (network_server.cpp:129-150)
- ACK every valid non-ACK packet from a known peer (reliable_udp.cpp:602-605)
- reliable sends: per-client pending map, RFC6298 RTT/RTO, bounded retries
  then drop (reliable_udp.cpp:627-658, :718-777)
- client timeout eviction (reliable_udp.cpp:690-715)
- port auto-increment once if busy (reliable_udp.cpp:98-129)
- socket-level fatal errors re-create the endpoint in place (:492-509)

FRAME_DATA payloads (raw RGB / JPEG keyframe / ROIIMG region) are decoded
on the host and written to the device frame cache (ops/roi.py, on the
engine's device); the continuous batcher closes device micro-batches on the
PyTorch engine (its CUDA kernels on the card), gathering each batch's
frames out of the cache; DETECTION_RESULT goes back unreliable (a fresh
result always supersedes a stale one — matching the reference's
default-unreliable send, network_server.cpp:227-243). With
`use_device_cache=False` keyframes are served from host memory and ROI
updates are dropped, as the JAX server does without its cache.

A copy of the JAX package's `runtime/server.py`. JPEG payloads need `cv2`
(runtime/frames.py). POST /profilez captures a torch.profiler trace of the
live process into logs/torch-trace/ (utils/profiling.py), starting and
stopping the profiler between the batcher's engine calls
(`ContinuousBatcher.device_gate`).

A minimal /statusz HTTP endpoint on web_port replaces the reference
dashboard's log-file scraping (web/server.js:198-248).
"""

from __future__ import annotations

import asyncio
import json
import os
import socket
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..config import ServerConfig
from ..protocol import (
    AckPacket, ClientInfoPacket, CommandPacket, CommandType,
    ConfigUpdatePacket, DetectionResultPacket, ErrorCode,
    ErrorPacket, FrameDataPacket, HeartbeatPacket, PacketType, ProtocolError,
    ServerInfo, ServerInfoPacket, parse_header, parse_packet,
)
from .ratecontrol import RateController
from ..utils.events import (
    CLIENT_CONNECTED, CLIENT_DISCONNECTED, CLIENT_TIMEOUT, EVENT_BUS,
    INFERENCE_COMPLETED, MODEL_UPDATED, SERVER_STARTED, SERVER_STOPPING,
)
from ..protocol import native
from ..protocol.packets import next_sequence, now_ms
from ..ops.launches import launch_counts
from ..ops.roi import DeviceFrameCache
from ..utils.logging import get_logger
from ..utils.netstats import SystemUdpDrops, request_buffers, socket_drops
from ..utils.stats import Counter, RollingStats
from .adapters import GameAdapter, get_adapter
from .capture import DatasetCapture
from .engine import (EngineResult, InferenceEngine, InferenceRequest,
                     create_engine)
from .frames import FrameDecodeError, decode_frame_payload
from .scheduler import ContinuousBatcher

log = get_logger("server")

# Monitor-loop warning threshold for a device lane that stopped completing
# batches (see ContinuousBatcher.device_stall_s).
DEVICE_STALL_WARN_S = 5.0
# The longest stop() waits for its UDP socket to be read empty before it
# closes it (a client that never got the drain notice keeps it busy).
SOCKET_DRAIN_S = 5.0

Addr = Tuple[str, int]


def udp_kernel_drops(port: Optional[int]) -> Optional[int]:
    """Datagrams the kernel dropped for the UDP sockets bound to `port`
    (their receive buffer was full), from /proc/net/udp and udp6 (Linux;
    None elsewhere). The server never sees these frames, so without this
    count they vanish from its accounting."""
    total, found = 0, False
    for path in ("/proc/net/udp", "/proc/net/udp6"):
        try:
            with open(path) as f:
                lines = f.read().splitlines()[1:]
        except OSError:
            continue
        for line in lines:
            fields = line.split()
            if (port and len(fields) >= 13
                    and int(fields[1].rsplit(":", 1)[1], 16) == port):
                total += int(fields[12])
                found = True
    return total if found else None


def _is_frame(item) -> bool:
    """Whether a decode-queue item is a frame (not a worker's stop sentinel
    or a cleanup / release marker)."""
    return item is not None and not isinstance(item[0], str)


@dataclass
class PendingPacket:
    data: bytes
    addr: Addr
    sent_at: float
    retries: int = 0


# Reliable-send in-flight window (AIMD). The reference computed a TCP-style
# congestion window per client but never gated sends with it
# (reference reliable_udp.h:130-151 — declared-but-dead); here it is live:
# at most int(cwnd) un-ACKed reliable packets may be outstanding per client,
# sends past the cap are SHED (never queued — every reliable consumer has a
# retry path: REQUEST_KEYFRAME re-requests while the slot stays frozen, a
# handshake client re-sends CLIENT_INFO). Growth: +1/cwnd per clean ACK
# (congestion avoidance); decrease: halve on a loss event (retransmit or
# retry-exhausted drop), at most once per RTO so one burst isn't multiply
# punished.
REL_WND_INIT = 8.0
REL_WND_MAX = 32.0


@dataclass
class ClientSession:
    client_id: int
    addr: Addr
    screen_width: int = 800
    screen_height: int = 600
    game_id: int = 1
    last_active: float = field(default_factory=time.monotonic)
    # RFC6298 state (reference reliable_udp.h:105-127).
    srtt: Optional[float] = None
    rttvar: float = 0.0
    rto: float = 0.2
    pending: Dict[int, PendingPacket] = field(default_factory=dict)
    # Reliable-send AIMD window state (see REL_WND_* above).
    cwnd: float = REL_WND_INIT
    last_backoff: float = 0.0
    frames_received: int = 0
    results_sent: int = 0
    # Last REQUEST_KEYFRAME command time (rate limit: the freeze event and
    # the periodic re-request must not double-send within the same window).
    last_kf_request: float = 0.0
    # Stream control (COMMAND PAUSE/STOP_STREAM): frames from a paused
    # session are shed at ingest before any decode/device work; the session
    # itself stays registered and heartbeats keep it alive.
    paused: bool = False
    # Accuracy-SLA floor: this client is never served below this rung while
    # the adaptive policy downshifts the fleet (0 = follow the fleet rung).
    # Seeded from detection.min_serve_size; raisable per client over
    # SET_CONFIG/CONFIG_UPDATE when network.allow_client_config permits.
    min_serve_size: int = 0

    def observe_rtt(self, rtt: float) -> None:
        if self.srtt is None:
            self.srtt = rtt
            self.rttvar = rtt / 2
        else:
            self.rttvar = 0.75 * self.rttvar + 0.25 * abs(self.srtt - rtt)
            self.srtt = 0.875 * self.srtt + 0.125 * rtt
        self.rto = min(max(self.srtt + 4 * self.rttvar, 0.05), 2.0)

    def ack_pending(self, sequence: int) -> None:
        """Clear an ACKed reliable packet: Karn-gated RTT sample + additive
        window growth (both ACK paths — fast and object-codec — share this
        so the AIMD state cannot drift between them)."""
        pending = self.pending.pop(sequence, None)
        if pending is None:
            return
        if pending.retries == 0:
            # Karn: an ACK for a retransmitted packet is ambiguous
            # (original or copy?) — sampling it can collapse the RTO.
            self.observe_rtt(time.monotonic() - pending.sent_at)
        self.cwnd = min(self.cwnd + 1.0 / max(self.cwnd, 1.0), REL_WND_MAX)

    def backoff_window(self, now: float) -> None:
        """Multiplicative decrease on a loss event, at most once per RTO."""
        if now - self.last_backoff >= self.rto:
            self.cwnd = max(self.cwnd / 2.0, 1.0)
            self.last_backoff = now


class _Protocol(asyncio.DatagramProtocol):
    def __init__(self, server: "DetectionServer") -> None:
        self.server = server

    def connection_made(self, transport) -> None:
        self.server._transport = transport

    def datagram_received(self, data: bytes, addr: Addr) -> None:
        self.server._on_datagram(data, addr)

    def error_received(self, exc) -> None:
        log.warning("socket error: %s", exc)
        self.server._schedule_socket_recovery()


class DetectionServer:
    """The full server: transport + sessions + batcher + engine + adapter."""

    def __init__(self, config: ServerConfig,
                 engine: Optional[InferenceEngine] = None,
                 device: str = "cuda",
                 use_device_cache: bool = True) -> None:
        import torch
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"DetectionServer(device={device!r}): no CUDA "
                               "device (pass device='cpu' to serve on the "
                               "CPU)")
        self.config = config
        # config.inference_engine selects from the engine registry
        # (reference inference_engine.h:45-103 factory semantics).
        self.engine = engine or create_engine(config, device=device)
        game_name = next(
            (name for name, g in config.game_adapters.items() if g.enabled),
            "cs16")
        self.adapter: GameAdapter = get_adapter(
            game_name, config.game_adapters.get(game_name) or
            next(iter(config.game_adapters.values())),
            enable_tracking=config.detection.enable_tracking,
            max_tracking_age_ms=config.detection.max_tracking_age_ms)

        max_h = max(b[0] for b in config.tpu.frame_buckets)
        max_w = max(b[1] for b in config.tpu.frame_buckets)
        self.device_cache = (
            DeviceFrameCache(config.max_clients, max_h, max_w,
                             device=str(self.engine.device),
                             mesh=getattr(self.engine, "mesh", None))
            if use_device_cache else None)

        self.batcher = ContinuousBatcher(
            self.engine, self._on_results_threadsafe,
            max_batch=max(config.tpu.batch_buckets),
            batch_window_ms=config.tpu.batch_window_ms,
            max_queue_per_client=config.max_queue_size,
            device_cache=self.device_cache,
            max_inflight=config.tpu.max_inflight)

        import os as _os
        from .web import ManagementApi
        # Rolling 5s snapshots from the monitor loop (~10 min at maxlen):
        # the p99/fps/serve-size trend is queryable (/historyz) instead of
        # reconstructed from log scraping like the reference's web plane
        # (web/server.js:198-248).
        self._status_history: deque = deque(maxlen=120)
        from ..utils import profiling as _profiling
        _trace_dir = _os.path.join(
            _os.path.dirname(config.logging.log_file) or "logs", "torch-trace")
        gate = self.batcher.device_gate
        self.management = ManagementApi(
            status_fn=self.status,
            history_fn=lambda: list(self._status_history),
            traces_fn=lambda: list(self._traces),
            models_dir=_os.path.dirname(config.model_path) or "models",
            logs_dir=_os.path.dirname(config.logging.log_file) or "logs",
            active_model=_os.path.basename(config.model_path),
            # On-demand capture of the live process (POST /profilez): the
            # capture sleeps on the management worker thread while the
            # batcher keeps serving; the profiler starts and stops between
            # the batcher's engine calls (the gate every one of them holds).
            profile_fn=lambda s: _profiling.capture(s, _trace_dir, gate=gate),
            profile_status_fn=_profiling.capture_status,
            auth_token=config.network.web_auth_token)
        # Frame decode offload (config worker_threads, reference
        # server/config.h:316): JPEG/ROI decode runs off the packet thread.
        # N workers shard by client id (cid % N -> one FIFO queue each):
        # per-client frame ordering — and the eviction-cleanup-behind-
        # frames invariant — hold per worker, while independent clients'
        # decodes parallelize on multicore hosts. Cache writes are
        # host-side deferred appends (lock-protected); no worker ever
        # touches the device.
        import queue as _queue
        n_workers = max(int(config.worker_threads), 0)
        self._decode_queues = [_queue.Queue(maxsize=256)
                               for _ in range(n_workers)]
        self._decode_threads: List = []

        self._sessions: Dict[int, ClientSession] = {}
        self._by_addr: Dict[Addr, int] = {}
        self._next_client_id = 1
        self._transport = None
        # The asyncio socket's granted (SO_RCVBUF, SO_SNDBUF), and the
        # machine's UDP drop counters from the bind on (status()).
        self._socket_buffers: Optional[Tuple[int, int]] = None
        self._system_udp: Optional[SystemUdpDrops] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._mgmt_task: Optional[asyncio.Task] = None
        self._watch_task: Optional[asyncio.Task] = None
        self._http_server = None
        self._running = False
        self.port: Optional[int] = None

        # Always-on GC pause observability: cyclic-GC collections pause every
        # serving thread; their size/frequency must be visible where the p99
        # is read (/statusz host.gc), not inferred. INSTALLED in start(),
        # not here: gc.callbacks is process-global, and a constructed-but-
        # never-started server (failed boot, tests) would otherwise leak a
        # dead observer onto every future collection (review r5).
        from ..utils.gcstats import GcPauseTracker
        self._gc_tracker = GcPauseTracker()

        # Transport counters (reference reliable_udp.h:269-275).
        self.packets_received = Counter()
        self.packets_sent = Counter()
        self.bytes_received = Counter()
        self.bytes_sent = Counter()
        self.retransmits = Counter()
        self.send_drops = Counter()
        self.reliable_shed = Counter()  # reliable sends shed at a full cwnd
        self.bad_packets = Counter()
        self.results_sent = Counter()  # rate => live served fps
        self.keyframe_requests = Counter()  # REQUEST_KEYFRAME commands sent
        self.cache_rejects = Counter()  # keyframes the device cache refused
        self._cache_reject_log_at = 0.0  # rate limit for the warning
        self.frames_paused = Counter()  # frames shed at ingest while paused
        self.unknown_sender_naks = Counter()  # ERRORs to sessionless senders
        # FRAME_DATA from senders with no session, refused (the NAK that
        # answers them is rate-limited, so this counts every such frame).
        self.frames_unknown_sender = Counter()
        self._unknown_nak: Dict[Addr, float] = {}  # per-addr NAK rate limit
        self._nak_prune_at = 0.0  # full-table prune throttle (flood posture)
        self._draining = False  # stop() in progress: refuse new handshakes
        self._recovering = False  # single-flight socket recovery guard
        # Socket recovery exhausted its retries: the server cannot receive
        # (surfaced in /statusz so a deaf shard is visible, not "healthy").
        self.transport_dead = False
        self.detect_latency = RollingStats()  # frame recv -> result sent
        self.frames_received = Counter()  # FRAME_DATA ingest (offered rate)
        self.rate_updates_sent = Counter()  # CONFIG_UPDATE broadcasts
        rc_slo = float(config.tpu.rate_control_slo_ms)
        # AIMD server->client rate control (runtime/ratecontrol.py): ticked
        # only by the monitor loop, broadcast over CONFIG_UPDATE.
        self._rate_ctl: Optional[RateController] = (
            RateController(rc_slo, config.tpu.rate_control_min_fps,
                           config.target_fps) if rc_slo > 0 else None)
        # Per-frame lifecycle trace sampling (GET /debugz): every Nth served
        # frame lands in the ring with its stage spans. Written only by the
        # result path, read by the management plane (GIL-atomic deque ops).
        self._trace_every = int(config.tpu.trace_sample_every)
        self._trace_seen = 0
        self._traces: deque = deque(maxlen=256)
        # Dataset capture (runtime/capture.py): sampled served keyframes +
        # detections recorded in the YOLO-dir layout train/data.py reads —
        # the serve -> fine-tune -> hot-swap flywheel. Host-side only:
        # decode-worker stash, event-loop pairing, dedicated writer thread.
        self._capture: Optional[DatasetCapture] = None
        if config.analytics.capture_dir:
            self._capture = DatasetCapture(
                config.analytics.capture_dir,
                sample_every=config.analytics.capture_sample_every,
                max_images=config.analytics.capture_max_images,
                min_confidence=config.analytics.capture_min_confidence)

    # ================================================================ lifecycle
    async def start(self, warmup: bool = False) -> None:
        """Bring up transports + management plane; optionally warm every
        (batch, frame bucket) step BEFORE the batcher thread starts — the
        warmup thread and the batcher must never both touch the device
        (single device lane). Frames arriving during warmup queue host-side
        (drop-oldest)."""
        self._loop = asyncio.get_running_loop()
        port = self.config.network.port
        use_native = self.config.network.use_native_transport
        if use_native:
            from .transport import HAVE_NATIVE_UDP, NativeUdpTransport
            if not HAVE_NATIVE_UDP:
                log.warning("native transport requested but unavailable; "
                            "falling back to asyncio")
                use_native = False
        reuse = self.config.network.reuse_port
        if reuse and use_native:
            from .transport import HAVE_NATIVE_UDP_REUSEPORT
            if not HAVE_NATIVE_UDP_REUSEPORT:
                log.warning("native .so lacks zl_udp_open2; reuse_port "
                            "sharding falls back to the asyncio endpoint")
                use_native = False
        # reuse_port shards must all sit on the SAME port — the port+1
        # fallback would silently strand a shard where no client looks.
        candidates = (port,) if reuse else (port, port + 1)
        for attempt, p in enumerate(candidates):
            try:
                if use_native:
                    self._transport = NativeUdpTransport(
                        p, self.config.network.recv_buffer_size,
                        self.config.network.send_buffer_size,
                        self._on_native_batch, reuse_port=reuse,
                        bind_address=self.config.network.bind_address)
                else:
                    # reuse_port=True sets SO_REUSEPORT before bind (the
                    # fleet shard group); a plain bind holding the port
                    # still raises EADDRINUSE either way.
                    await self._loop.create_datagram_endpoint(
                        lambda: _Protocol(self),
                        local_addr=(self.config.network.bind_address
                                    or "0.0.0.0", p),
                        reuse_port=reuse or None)
                    self._size_socket_buffers()
                self.port = p
                self._system_udp = SystemUdpDrops()
                break
            except OSError:
                if attempt == len(candidates) - 1:
                    raise
                log.warning("port %d busy, trying %d", p, p + 1)
        if use_native:
            log.info("native recvmmsg transport active on udp/%d", self.port)
        if self._decode_queues:
            import threading as _threading
            for i, q in enumerate(self._decode_queues):
                t = _threading.Thread(target=self._decode_loop, args=(q,),
                                      name=f"zlt-decode-{i}", daemon=True)
                t.start()
                self._decode_threads.append(t)
        if self.config.network.web_port:
            try:
                self._http_server = await asyncio.start_server(
                    self._handle_http,
                    self.config.network.web_bind_address or "0.0.0.0",
                    self.config.network.web_port)
            except OSError:
                log.warning("statusz port %d busy; endpoint disabled",
                            self.config.network.web_port)
        def gated(fn, *args):
            # The device work of warmup holds the batcher's gate too: the
            # management plane is up, so a /profilez capture may start now.
            with self.batcher.device_gate:
                return fn(*args)
        if warmup and not self.engine.simulation:
            await asyncio.to_thread(gated, self.engine.warmup,
                                    None, None, self.device_cache,
                                    self.config.tpu.max_inflight)
        elif warmup and self.device_cache is not None:
            # Simulation mode skips engine warmup, but the cache's writes
            # are real device work regardless of engine mode.
            await asyncio.to_thread(gated, self.device_cache.warm)
        applied = {}
        if self.config.tpu.gc_tune:
            # Post-warmup: every compiled program / pool / session table
            # alive now is process-lifetime tenure — freeze it out of the
            # cyclic GC's scan set before the first frame arrives
            # (utils/gcstats.py; measured host-tail effect in BENCH_NOTES).
            from ..utils import gcstats
            applied.update(gcstats.tune_for_latency())
        if self.config.tpu.gil_switch_interval_ms > 0:
            import sys as _sys
            _sys.setswitchinterval(self.config.tpu.gil_switch_interval_ms / 1e3)
            applied["switch_interval_ms"] = self.config.tpu.gil_switch_interval_ms
        if applied:
            log.info("host latency tuning applied: %s", applied)
        self.batcher.start()
        self._mgmt_task = asyncio.create_task(self._management_loop())
        self._watch_task = asyncio.create_task(self._model_watch_loop())
        self._monitor_task = asyncio.create_task(self._monitor_loop())
        self._running = True
        # In-process restart support (review r5): stop() set _draining to
        # refuse handshakes during teardown and uninstalled the gc hook —
        # a restarted instance must accept clients and observe GC again.
        self._draining = False
        self.transport_dead = False
        self._gc_tracker.install()
        EVENT_BUS.publish(SERVER_STARTED, {"port": self.port})
        log.info("detection server listening on udp/%d (statusz on %s)",
                 self.port, self.config.network.web_port)

    async def stop(self) -> None:
        self._running = False
        # Teardown takes seconds (task cancels, batcher drain, thread
        # joins) with the socket still open — and while it is open, the
        # kernel's reuseport hash keeps landing this shard's 4-tuples
        # here. Refuse handshakes for the whole window or a drained
        # client's instant re-handshake would get a fresh session on a
        # shard whose batcher is already stopped (it would stream into
        # silence until the socket finally closes).
        self._draining = True
        EVENT_BUS.publish(SERVER_STOPPING, None)
        # Graceful-drain notice: tell every live session the server is going
        # away (COMMAND DISCONNECT, server-initiated — the reference declared
        # the type, types.h:94-103, but only ever sent it client->server).
        # Clients re-handshake immediately (onto a surviving fleet shard
        # after a rebalance) instead of waiting out network.timeout_ms.
        # Best-effort fire-and-forget: the retransmit machinery is being
        # torn down, and the liveness timeout remains the fallback.
        bye = CommandPacket(command_type=CommandType.DISCONNECT).serialize()
        for session in list(self._sessions.values()):
            try:
                self._send_raw(bye, session.addr)
            except OSError:
                pass
        for task in (self._mgmt_task, self._watch_task,
                     getattr(self, "_monitor_task", None)):
            if task:
                task.cancel()
                try:
                    await task
                except (asyncio.CancelledError, Exception):  # noqa: BLE001
                    pass
        self.batcher.stop()
        # The batches it drained handed their results to this loop: send
        # them while the transport is open.
        await asyncio.sleep(0)
        import queue as _queue
        if self._decode_threads:
            for q in self._decode_queues:
                # Never block the event loop on a full decode queue (a
                # worker can be slow and the drain thread keeps refilling):
                # make room by dropping queued frames — the server is
                # stopping, their results are already moot.
                while True:
                    try:
                        q.put_nowait(None)
                        break
                    except _queue.Full:
                        try:
                            if _is_frame(q.get_nowait()):
                                self.engine.frames_dropped.inc()
                        except _queue.Empty:
                            pass
            for t in self._decode_threads:
                t.join(timeout=2.0)
            self._decode_threads = []
        if self._http_server:
            self._http_server.close()
            await self._http_server.wait_closed()
        # Read the socket empty before closing it: a datagram still queued
        # there at the close is freed without any count. The clients have
        # the drain notice, so their frames stop; what was queued is read
        # now and, with the batcher and the decode workers stopped, counted
        # as dropped below.
        deadline = time.monotonic() + SOCKET_DRAIN_S
        while self._rx_pending() and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        rx_overflows = self.socket_stats()["rx_overflows"]
        if self._transport:
            self._transport.close()
            self._transport = None
        # Frames still held (queued for a decode worker that has exited, or
        # for the stopped batcher) will never be served: count them as drops,
        # so that every frame this process took in is accounted for.
        left = self.batcher.discard_pending()
        for q in self._decode_queues:
            items = []
            while True:
                try:
                    items.append(q.get_nowait())
                except _queue.Empty:
                    break
            left += sum(map(_is_frame, items))
            if None in items:  # a worker still running keeps its sentinel
                q.put_nowait(None)
        self.engine.frames_dropped.inc(left)
        log.info("server stopped: %s", json.dumps(
            {**self.frame_counts(), "rx_overflows": rx_overflows}))
        if self._capture is not None:
            self._capture.stop()
        # gc.callbacks is process-global: leaving the hook installed across
        # many server lifetimes (tests, rolling restarts in-process) would
        # stack dead observers on every collection.
        self._gc_tracker.uninstall()

    # ============================================================== rx path
    def _on_native_batch(self, batch) -> None:
        """Called on the native drain thread. v2 batches carry pre-validated
        headers (CRC checked in C++) and an already-ACKed flag (the ACK left
        via sendmmsg on the drain thread); v1 batches carry hdr=None and
        take the validating loop path.

        FRAME_DATA from a known, already-ACKed session is handed to its
        sharded decode worker DIRECTLY from this thread: at 64x60 the event
        loop was the host bottleneck, and the dominant packet type needs
        nothing from it (counters are lock-backed, the queue is
        thread-safe, last_active is a benign monotonic float store, and
        the decode worker re-checks session identity before any cache
        write). Control packets and not-yet-registered peers still hop to
        the loop. Transition window: a client's frames land on the loop
        path until set_peers installs it, so one early keyframe can be
        overtaken by a drain-path ROI — which the decode path heals by
        requesting a fresh keyframe (see _decode_frame)."""
        if self._loop is None:
            return
        rest = batch
        if self._decode_queues:
            rest = []
            # Counters accumulate across the recvmmsg batch and commit as
            # ONE lock acquisition each: recv is blocked while this runs,
            # so per-packet inc()s directly delay the next drain.
            fast_n = 0
            fast_bytes = 0
            fast_frames = 0
            for item in batch:
                data, addr, hdr, pre_acked = item
                try:
                    if (hdr is not None and pre_acked
                            and hdr[0] == PacketType.FRAME_DATA):
                        session = self._session_by_addr(addr)
                        if session is not None:
                            fast_n += 1
                            fast_bytes += len(data)
                            session.last_active = time.monotonic()
                            parsed = native.parse_frame_header(data)
                            if parsed is None:
                                self.bad_packets.inc()
                                continue
                            fid, fts, w, h, keyframe, off = parsed
                            fast_frames += 1
                            self._handle_frame_fast(session, fid, fts, w, h,
                                                    keyframe, data[off:],
                                                    count_offered=False)
                            continue
                except Exception:  # noqa: BLE001
                    self.bad_packets.inc()
                    log.exception("drain-path frame failed (%s)", addr)
                    continue
                rest.append(item)
            if fast_n:
                self.packets_received.inc(fast_n)
                self.bytes_received.inc(fast_bytes)
                self.packets_sent.inc(fast_n)   # the C-side 26B ACKs
                self.bytes_sent.inc(26 * fast_n)
            if fast_frames:
                self.frames_received.inc(fast_frames)
            if not rest:
                return
        def deliver(batch=rest):
            for data, addr, hdr, pre_acked in batch:
                # Per-datagram isolation: one handler fault must not shed
                # the rest of the recvmmsg batch (other clients' frames and
                # ACKs share it).
                try:
                    if hdr is None:
                        self._on_datagram(data, addr)
                        continue
                    self.packets_received.inc()
                    self.bytes_received.inc(len(data))
                    if pre_acked:  # the drain thread already sent a 26B ACK
                        self.packets_sent.inc()
                        self.bytes_sent.inc(26)
                    ntype, sequence, _ts = hdr
                    self._handle_validated(data, addr,
                                           self._session_by_addr(addr),
                                           ntype, sequence, pre_acked)
                except Exception:  # noqa: BLE001
                    self.bad_packets.inc()
                    log.exception("datagram handler failed (%s)", addr)
        self._loop.call_soon_threadsafe(deliver)

    def _on_datagram(self, data: bytes, addr: Addr) -> None:
        self.packets_received.inc()
        self.bytes_received.inc(len(data))
        session = self._session_by_addr(addr)

        # Fast path (native codec): one C call validates
        # magic/version/length/CRC and yields the header; the dominant
        # packet types (FRAME_DATA, ACK, HEARTBEAT) are then handled without
        # constructing Python packet objects at all.
        if native.HAVE_NATIVE:
            hdr = native.validate_packet(data)
            if hdr is None:
                self.bad_packets.inc()
                log.debug("bad packet from %s (native reject)", addr)
                return
            ntype, _length, sequence, _ts = hdr
            self._handle_validated(data, addr, session, ntype, sequence,
                                   pre_acked=False)
            return

        try:
            pkt = parse_packet(data)
        except ProtocolError as e:
            self.bad_packets.inc()
            log.debug("bad packet from %s: %s", addr, e)
            return

        if session is not None:
            session.last_active = time.monotonic()

        ptype = pkt.TYPE
        if ptype == PacketType.ACK:
            self._handle_ack(pkt, session)
            return
        # ACK every valid non-ACK packet from a known peer. (The native
        # codec path returned above, so this is always the pure-Python
        # fallback here.)
        if session is not None:
            self._send_raw(AckPacket(acked_sequence=pkt.sequence).serialize(),
                           addr)

        if ptype == PacketType.HEARTBEAT:
            if session is not None:
                reply = HeartbeatPacket(ping=pkt.ping)
                self._send_raw(reply.serialize(), addr)
            else:
                # An idle (heartbeat-only) client of a crashed shard must
                # also learn its session is gone — frames aren't the only
                # liveness signal.
                self._nak_unknown_sender(addr)
        elif ptype == PacketType.FRAME_DATA:
            if session is None:
                self.frames_unknown_sender.inc()
                self._nak_unknown_sender(addr)
                return
            self._handle_frame(pkt, session)
        else:
            self._handle_control(pkt, addr, session)

    def _handle_validated(self, data: bytes, addr: Addr,
                          session: Optional[ClientSession], ntype: int,
                          sequence: int, pre_acked: bool) -> None:
        """Dispatch a header-validated datagram. The dominant packet types
        (FRAME_DATA, ACK, HEARTBEAT) never construct Python packet objects;
        rare control packets fall through to the object codec."""
        if session is not None:
            session.last_active = time.monotonic()
        if ntype == PacketType.ACK:
            if session is not None and len(data) >= 26:
                acked = int.from_bytes(data[22:26], "little")
                session.ack_pending(acked)
            return
        if session is not None and not pre_acked:
            self._send_raw(
                native.build_ack(sequence, next_sequence(), now_ms()), addr)
        if ntype == PacketType.FRAME_DATA:
            if session is None:
                self.frames_unknown_sender.inc()
                self._nak_unknown_sender(addr)
                return
            parsed = native.parse_frame_header(data)
            if parsed is None:
                self.bad_packets.inc()
                return
            fid, fts, w, h, keyframe, off = parsed
            self._handle_frame_fast(session, fid, fts, w, h, keyframe,
                                    data[off:])
            return
        if ntype == PacketType.HEARTBEAT:
            if session is not None and len(data) >= 26:
                ping = int.from_bytes(data[22:26], "little")
                self._send_raw(native.build_heartbeat(
                    ping, next_sequence(), now_ms()), addr)
            elif session is None:
                # Idle client of a crashed shard: see the object-path twin.
                self._nak_unknown_sender(addr)
            return
        # Rare control packets: full object parse.
        try:
            pkt = parse_packet(data)
        except ProtocolError as e:
            self.bad_packets.inc()
            log.debug("bad packet from %s: %s", addr, e)
            return
        self._handle_control(pkt, addr, session)

    def _nak_unknown_sender(self, addr: Addr) -> None:
        """FRAME_DATA from an address with no session is usually a client
        whose shard CRASHED (no drain notice) and whose flow the kernel
        re-hashed onto this shard mid-stream: answer ERROR(TIMEOUT) so it
        re-handshakes in one RTT instead of streaming into the void until
        its own liveness timeout. TIMEOUT (not INVALID_REQUEST) because the
        server also sends INVALID_REQUEST to LIVE sessions for malformed
        SET_CONFIG bodies — the session-loss NAK must be unambiguous or a
        bad config request would trigger a spurious re-handshake (which
        clears PAUSE state). Abuse posture: the reply is far smaller than
        the frame that elicited it (attenuation, not amplification),
        rate-limited to 1/s per address, and the tracking table is
        hard-capped so a spoofed-source flood cannot grow state."""
        now = time.monotonic()
        if now - self._unknown_nak.get(addr, 0.0) < 1.0:
            return
        if len(self._unknown_nak) >= 512:
            # Table pinned full by a spoofed-source flood: prune at most
            # once a second — per-packet dict rebuilds would hand the
            # attacker an event-loop CPU amplifier.
            if now < self._nak_prune_at:
                return
            self._nak_prune_at = now + 1.0
            self._unknown_nak = {a: t for a, t in self._unknown_nak.items()
                                 if now - t < 2.0}
            if len(self._unknown_nak) >= 512:
                return  # under flood: stay silent, frames are dropped anyway
        self._unknown_nak[addr] = now
        log.debug("frame data from unknown client %s; sent re-handshake NAK",
                  addr)
        self.unknown_sender_naks.inc()
        self._send_raw(ErrorPacket(
            error_code=ErrorCode.TIMEOUT,
            message="no session for sender; re-handshake").serialize(), addr)

    def _handle_control(self, pkt, addr: Addr,
                        session: Optional[ClientSession]) -> None:
        """Rare control packets — shared by the validated fast path and the
        pure-Python codec path so dispatch/accounting can't diverge."""
        ptype = pkt.TYPE
        if ptype == PacketType.CLIENT_INFO:
            self._handle_client_info(pkt, addr)
        elif ptype == PacketType.COMMAND:
            self._handle_command(pkt, session)
        elif ptype == PacketType.CONFIG_UPDATE:
            self._handle_config_update(pkt, session)
        elif ptype == PacketType.ERROR:
            log.debug("received error packet")
        else:
            log.debug("unhandled packet type %d", ptype)

    def _handle_config_update(self, pkt, session: Optional[ClientSession]) -> None:
        """CONFIG_UPDATE: apply recognized runtime settings live. The
        reference declared type 7 but never defined a body or handler
        (types.h:81); here thresholds are traced scalars, so the update
        takes effect on the next batch with zero recompiles. Registered
        sessions only."""
        if session is None:
            log.debug("config update from unknown peer; ignored")
            return
        if not self.config.network.allow_client_config:
            # Same tenant-isolation gate as SET_CONFIG: the wire format is
            # public, so a crafted type-7 datagram must not reach the GLOBAL
            # thresholds when the operator locked client writes.
            self._send_raw(ErrorPacket(
                error_code=ErrorCode.INVALID_REQUEST,
                message="CONFIG_UPDATE disabled "
                        "(network.allow_client_config)").serialize(),
                session.addr)
            return
        reason = self._apply_runtime_settings(
            getattr(pkt, "settings", {}) or {}, session)
        if reason is not None:
            # Same refusal contract as SET_CONFIG (review r5): the client
            # must learn its settings were NOT applied — a silently-refused
            # CONFIG_UPDATE is exactly the "silent success with nothing
            # applied" the shared validator's all-or-nothing rule exists
            # to prevent.
            self._send_raw(ErrorPacket(
                error_code=ErrorCode.INVALID_REQUEST,
                message=reason).serialize(), session.addr)

    def _apply_runtime_settings(self, s: Dict,
                                session: ClientSession) -> Optional[str]:
        """Validate-then-apply runtime thresholds (shared by SET_CONFIG and
        CONFIG_UPDATE). Both values parse BEFORE either applies — one
        malformed field must not leave a partial state change. Returns
        None on success, else the refusal REASON — both wire entry points
        echo it so a rejected floor/SLO is diagnosable from the client
        instead of a catch-all "non-numeric" (review r5)."""
        conf = s.get("confidence_threshold")
        nms = s.get("nms_threshold")
        slo = s.get("adaptive_slo_ms")
        floor = s.get("min_serve_size")
        try:
            conf_f = float(conf) if conf is not None else None
            nms_f = float(nms) if nms is not None else None
            slo_f = float(slo) if slo is not None else None
            floor_i = int(floor) if floor is not None else None
        except (TypeError, ValueError):
            log.debug("non-numeric threshold update from client #%d ignored",
                      session.client_id)
            return "non-numeric runtime setting"
        import math
        # Range gate, not just parseability: json.loads accepts NaN/Infinity
        # tokens, and a NaN confidence makes every NMS comparison False —
        # one client could silently blank detections for everyone.
        for v in (conf_f, nms_f):
            if v is not None and not (math.isfinite(v) and 0.0 <= v <= 1.0):
                log.debug("out-of-range threshold update from client #%d "
                          "ignored", session.client_id)
                return "threshold out of range [0, 1]"
        if slo_f is not None and not (math.isfinite(slo_f)
                                      and 0.0 <= slo_f <= 10000.0):
            log.debug("out-of-range adaptive_slo_ms from client #%d ignored",
                      session.client_id)
            return "adaptive_slo_ms out of range [0, 10000]"
        # Accuracy-SLA floor: PER-CLIENT state (unlike the global
        # thresholds) — bounded below by the OPERATOR's configured default
        # (clients may only raise their own floor; a lower value would
        # silently void the documented accuracy SLA) and above by the
        # model size (a floor the ladder cannot honor is refused, not
        # silently clamped).
        if floor_i is not None and not (
                int(self.config.detection.min_serve_size)
                <= floor_i <= self.engine.model_size):
            log.debug("out-of-range min_serve_size=%r from client #%d "
                      "ignored (allowed [%d, %d])", floor,
                      session.client_id,
                      int(self.config.detection.min_serve_size),
                      self.engine.model_size)
            return ("min_serve_size out of range "
                    f"[{int(self.config.detection.min_serve_size)}, "
                    f"{self.engine.model_size}] (floors are raise-only)")
        # The SLO stages (or refuses) BEFORE the thresholds apply, keeping
        # the all-or-nothing contract: a refused SLO (no ladder / cold
        # rungs) fails the whole update so the client gets an ERROR rather
        # than silent success with nothing applied.
        if slo_f is not None and not self.engine.update_adaptive_slo(slo_f):
            log.debug("adaptive_slo_ms update from client #%d refused by "
                      "the engine (no warmed serve-size ladder)",
                      session.client_id)
            return "adaptive_slo_ms refused: no warmed serve-size ladder"
        self.engine.update_thresholds(confidence=conf_f, nms=nms_f)
        if floor_i is not None:
            session.min_serve_size = floor_i
        applied = {k: v for k, v in (("confidence_threshold", conf_f),
                                     ("nms_threshold", nms_f),
                                     ("adaptive_slo_ms", slo_f),
                                     ("min_serve_size", floor_i))
                   if v is not None}
        if applied:
            ignored = sorted(set(s) - set(applied))
            log.info("client #%d applied runtime settings: %s%s",
                     session.client_id, applied,
                     f" (ignored: {ignored})" if ignored else "")
        return None

    def _handle_ack(self, pkt: AckPacket, session: Optional[ClientSession]) -> None:
        if session is None:
            return
        session.ack_pending(pkt.acked_sequence)

    def _handle_client_info(self, pkt: ClientInfoPacket, addr: Addr) -> None:
        if self._draining:
            # Shutdown/rebalance in progress: answer with the same drain
            # notice stop() broadcasts so the client keeps its
            # disconnected state and retries — once this socket closes,
            # the kernel re-hashes its flow onto a surviving shard.
            try:
                self._send_raw(CommandPacket(
                    command_type=CommandType.DISCONNECT).serialize(), addr)
            except OSError:
                pass
            return
        info = pkt.info
        existing = self._by_addr.get(addr)
        if existing is not None:
            session = self._sessions[existing]
            changed = ((info.screen_width or session.screen_width,
                        info.screen_height or session.screen_height,
                        info.game_id)
                       != (session.screen_width, session.screen_height,
                           session.game_id))
            session.screen_width = info.screen_width or session.screen_width
            session.screen_height = info.screen_height or session.screen_height
            session.game_id = info.game_id
            # A re-handshake means the client (re)started and will stream:
            # clear any PAUSE/STOP_STREAM shed state, or a restarted client
            # reusing the addr:port would be ACKed but never served.
            session.paused = False
            client_id = existing
            if changed:
                # Refresh the adapter registration: best_target ranks by
                # pixel distance from the session's screen dims, so a
                # restart at a new resolution (or game) must reach adapter
                # state. Unchanged retries (lost SERVER_INFO) keep their
                # live tracker instead of churning it.
                self.adapter.register_client(client_id, session.screen_width,
                                             session.screen_height,
                                             info.game_id)
        elif len(self._sessions) >= self.config.max_clients:
            self._send_raw(ErrorPacket(
                error_code=ErrorCode.SERVER_FULL,
                message="server full").serialize(), addr)
            return
        else:
            client_id = self._next_client_id
            self._next_client_id += 1
            session = ClientSession(
                client_id=client_id, addr=addr,
                screen_width=info.screen_width or 800,
                screen_height=info.screen_height or 600,
                game_id=info.game_id,
                min_serve_size=int(
                    self.config.detection.min_serve_size))
            self._sessions[client_id] = session
            self._by_addr[addr] = client_id
            self.adapter.register_client(client_id, session.screen_width,
                                         session.screen_height, info.game_id)
            self._sync_peers()
            EVENT_BUS.publish(CLIENT_CONNECTED, client_id)
            log.info("client #%d connected from %s (game %d)", client_id, addr,
                     info.game_id)
        reply = ServerInfoPacket(info=ServerInfo(
            server_id=1, model_version=1.0,
            max_clients=self.config.max_clients,
            max_fps=self.config.target_fps, status=0))
        self._send_reliable(reply.serialize(), session)

    def _handle_command(self, pkt, session: Optional[ClientSession]) -> None:
        """COMMAND handling. The reference declared CommandType but ignored all
        commands (network_server.cpp:102-105); DISCONNECT and PING are useful
        and implemented here."""
        from ..protocol import CommandType
        if session is None:
            return
        if pkt.command_type == CommandType.DISCONNECT:
            self._evict(session.client_id, "disconnect")
        elif pkt.command_type == CommandType.PING:
            self._send_raw(HeartbeatPacket(ping=0).serialize(), session.addr)
        elif pkt.command_type == CommandType.SET_CONFIG:
            # Runtime-tunable subset; thresholds are traced scalars so the
            # update costs no recompiles.
            if not self.config.network.allow_client_config:
                # The thresholds are GLOBAL: one tenant raising confidence
                # to 0.99 blanks detections for every other stream. Multi-
                # tenant operators disable client writes and tune over the
                # authenticated management plane instead.
                self._send_raw(ErrorPacket(
                    error_code=ErrorCode.INVALID_REQUEST,
                    message="SET_CONFIG disabled "
                            "(network.allow_client_config)").serialize(),
                    session.addr)
                return
            try:
                payload = json.loads(pkt.command_data.decode("utf-8"))
                if not isinstance(payload, dict):
                    raise ValueError("not an object")
            except (ValueError, UnicodeDecodeError):
                self._send_raw(ErrorPacket(
                    error_code=ErrorCode.INVALID_REQUEST,
                    message="SET_CONFIG expects JSON").serialize(), session.addr)
                return
            reason = self._apply_runtime_settings(payload, session)
            if reason is not None:
                self._send_raw(ErrorPacket(
                    error_code=ErrorCode.INVALID_REQUEST,
                    message=reason).serialize(), session.addr)
        elif pkt.command_type == CommandType.PAUSE_STREAM:
            # Shed this client's frames at ingest; its device-cache slot and
            # tracker state stay warm for a cheap resume. (The reference
            # declared these stream-control commands, types.h:94-103, but
            # never handled any of them.)
            session.paused = True
            log.info("client #%d stream paused", session.client_id)
        elif pkt.command_type == CommandType.STOP_STREAM:
            # Stronger than pause: release the client's device-cache slot
            # (device memory is the contended serving resource) and its
            # tracker state. Ordered through the client's decode FIFO so
            # frames already queued decode before the slot goes away.
            session.paused = True
            if self._decode_queues:
                self._enqueue_sentinel("__release__", session.client_id)
            else:
                self._release_stream(session.client_id)
            log.info("client #%d stream stopped (slot released)",
                     session.client_id)
        elif pkt.command_type in (CommandType.START_STREAM,
                                  CommandType.RESUME_STREAM):
            was_paused = session.paused
            session.paused = False
            if was_paused:
                # Content continuity broke while frames were shed (and STOP
                # released the keyframe slot) — re-anchor in one RTT instead
                # of waiting out the client's keyframe cadence.
                session.last_kf_request = 0.0
                self._send_keyframe_requests([session.client_id])
                log.info("client #%d stream resumed", session.client_id)
        elif pkt.command_type == CommandType.GET_CONFIG:
                # Read the ENGINE's config — the object update_thresholds
            # actually mutates (the simulation engine works on a copy of
            # the server config).
            body = json.dumps({
                "confidence_threshold": self.engine.config.confidence_threshold,
                "nms_threshold": self.engine.config.nms_threshold,
                "target_fps": self.config.target_fps,
                "adaptive_slo_ms": getattr(self.engine, "adaptive_slo_ms",
                                           0.0),
                "serve_size": int(getattr(self.engine, "_serve_size", 0)
                                  or self.config.detection.model_width),
                # THIS client's accuracy floor (per-session state).
                "min_serve_size": int(session.min_serve_size),
            }).encode()
            self._send_raw(CommandPacket(
                command_type=CommandType.GET_CONFIG,
                command_data=body).serialize(), session.addr)

    def _handle_frame(self, pkt: FrameDataPacket, session: ClientSession) -> None:
        self._handle_frame_fast(session, pkt.frame_id, pkt.frame_timestamp,
                                pkt.width, pkt.height, pkt.keyframe, pkt.data)

    def _handle_frame_fast(self, session: ClientSession, frame_id: int,
                           frame_ts: int, width: int, height: int,
                           keyframe: bool, payload: bytes,
                           count_offered: bool = True) -> None:
        # Offered-rate feed for rate control. The drain thread batches this
        # counter across the recvmmsg batch (count_offered=False there) —
        # a per-packet lock here would undo _on_native_batch's one-inc-per-
        # batch discipline on the thread that gates the next drain.
        if count_offered:
            self.frames_received.inc()
        if session.paused:
            # PAUSE/STOP_STREAM: shed before decode/device work. All three
            # FRAME_DATA ingest paths (drain-thread fast path, validated
            # loop path, Python codec fallback) converge here, so this one
            # gate covers them; a bool read is drain-thread-safe.
            self.frames_paused.inc()
            return
        # detect_latency starts HERE, at datagram arrival — decode-queue wait
        # + JPEG/ROI decode time must show up in the reported p99, not be
        # silently excluded by stamping after decode.
        recv_t = time.perf_counter()
        if self._decode_queues:
            # Offload JPEG/ROI decode + cache writes off the packet thread
            # (the client's sharded worker preserves its keyframe->ROI
            # ordering).
            try:
                self._queue_for(session.client_id).put_nowait(
                    (session, frame_id, frame_ts, width, height, keyframe,
                     payload, recv_t))
            except Exception:  # noqa: BLE001 — queue full: shed the frame
                self.engine.frames_dropped.inc()
            return
        self._decode_frame(session, frame_id, frame_ts, width, height,
                           keyframe, payload, recv_t)

    def _cleanup_client(self, client_id: int) -> None:
        self.engine.frames_dropped.inc(self.batcher.remove_client(client_id))
        if self.device_cache is not None:
            self.device_cache.release(client_id)
        if self._capture is not None:
            self._capture.evict_client(client_id)

    def _release_stream(self, client_id: int) -> None:
        """STOP_STREAM: free the serving resources (queued frames, device
        cache slot, tracker state) while KEEPING the session registered —
        unlike _cleanup_client this runs for a live client that will
        START/RESUME later. A drain-path frame that raced the pause flag
        can re-acquire a slot right after this; that is benign (the client
        is live and the slot frees normally on eviction)."""
        session = self._sessions.get(client_id)
        if session is None or not session.paused:
            # Evicted (cleanup owns teardown), or START/RESUME already
            # revived the stream — a delayed release (queue-full retry via
            # call_later breaks FIFO ordering) must not free the resumed
            # stream's fresh keyframe slot or reset its tracker.
            return
        self.engine.frames_dropped.inc(self.batcher.remove_client(client_id))
        if self.device_cache is not None:
            self.device_cache.release(client_id)
        self.adapter.reset_client(client_id)

    def _queue_for(self, client_id: int):
        qs = self._decode_queues
        return qs[client_id % len(qs)]

    def _decode_loop(self, q) -> None:
        while True:
            item = q.get()
            if item is None:
                return
            try:
                if item[0] == "__cleanup__":
                    self._cleanup_client(item[1])
                elif item[0] == "__release__":
                    self._release_stream(item[1])
                else:
                    self._decode_frame(*item)
            except Exception:  # noqa: BLE001
                log.exception("frame decode worker failed")

    def _decode_frame(self, session: ClientSession, frame_id: int,
                      frame_ts: int, width: int, height: int,
                      keyframe: bool, payload: bytes,
                      recv_t: Optional[float] = None) -> None:
        if self._sessions.get(session.client_id) is not session:
            # Evicted while queued: don't waste the decode.
            self.engine.frames_dropped.inc()
            return
        # Oversized-frame shed BEFORE decode, not at dispatch: the header's
        # u16 dims license the JPEG decoder's allocation (frames.py SOF
        # guard), so a 30000x30000 claim must be rejected while it is
        # still 4 bytes of header — a multi-GB imdecode on the decode
        # worker is a remote OOM (review r5). Engine-side dispatch keeps
        # its own shed for the hosted path.
        if not any(height <= bh and width <= bw
                   for bh, bw in self.engine.frame_buckets):
            self.engine.frames_dropped.inc()
            self.engine.frames_oversized.inc()
            log.debug("oversized frame header %dx%d (client %d); shed "
                      "before decode", width, height, session.client_id)
            return
        try:
            decoded = decode_frame_payload(payload, width, height)
        except FrameDecodeError as e:
            self.bad_packets.inc()
            log.debug("frame decode failed (client %d): %s", session.client_id, e)
            return
        session.frames_received += 1
        request = InferenceRequest(
            client_id=session.client_id, frame_id=frame_id,
            timestamp=frame_ts, width=width, height=height,
            data=None, keyframe=keyframe,
            min_size=session.min_serve_size)
        cache = self.device_cache
        if cache is not None:
            if decoded.roi is not None:
                ok = cache.write_roi(session.client_id, decoded.pixels,
                                     decoded.roi.x, decoded.roi.y)
                self._notify_frozen()
                if not ok:
                    # No anchoring keyframe (lost in transit, or overtaken
                    # during the drain-path transition window): ask for one
                    # now instead of serving nothing until the client's own
                    # cadence — rate-limited like the shed path.
                    log.debug("ROI before keyframe (client %d); dropped",
                              session.client_id)
                    self.engine.frames_dropped.inc()
                    if self._loop is not None:
                        self._loop.call_soon_threadsafe(
                            self._send_keyframe_requests,
                            [session.client_id])
                    return
            else:
                if not cache.write_keyframe(session.client_id, decoded.pixels):
                    # Counted (visible to /statusz and operators) and
                    # rate-limited: a misconfigured client streaming
                    # oversized keyframes at 60 fps must not emit 60
                    # warnings/s of formatting work on the decode worker.
                    self.cache_rejects.inc()
                    now = time.monotonic()
                    if now - self._cache_reject_log_at > 5.0:
                        self._cache_reject_log_at = now
                        log.warning(
                            "frame cache refused keyframe (client %d, "
                            "%dx%d): no free slot or frame exceeds the "
                            "slot bucket (%d rejects total)",
                            session.client_id, width, height,
                            self.cache_rejects.value)
                    return
        else:
            if decoded.roi is not None:
                log.debug("ROI update without device cache; dropped")
                self.engine.frames_dropped.inc()
                return
            request.data = decoded.pixels
        if self._capture is not None and decoded.roi is None:
            # Full frames only: ROI-reconstructed frames live on the device
            # and a readback here would ride the device lane; keyframes are
            # the natural sample anyway (one per cadence, complete pixels).
            self._capture.offer_keyframe(session.client_id, frame_id,
                                         decoded.pixels)
        request.enqueue_t = (recv_t if recv_t is not None
                             else time.perf_counter())
        self.batcher.submit(request)

    def _size_socket_buffers(self) -> None:
        """Give the asyncio socket the kernel buffers network.recv_buffer_size
        and send_buffer_size ask for (the native transport sizes its own).
        The kernel caps a request at its rmem_max / wmem_max (on some
        kernels far below what a load needs: 8 MiB of the 64 MiB asked on
        the H100's machine); a privileged process asks again past the cap
        (`utils/netstats.py` `request_buffers`). At the system default a
        receive buffer holds a few raw frames, and a stall of the event
        loop (a profiler's stop holds the GIL for up to 223 ms) drops the
        rest in the kernel. status() reports what was granted."""
        self._socket_buffers = request_buffers(
            self._transport.get_extra_info("socket"),
            self.config.network.recv_buffer_size,
            self.config.network.send_buffer_size)
        log.info("udp socket buffers granted: rcvbuf %d B, sndbuf %d B "
                 "(asked %d, %d)", *self._socket_buffers,
                 self.config.network.recv_buffer_size,
                 self.config.network.send_buffer_size)

    def socket_stats(self) -> Dict[str, object]:
        """The server socket's granted buffers and its own receive-buffer
        drops (the native transport's SO_RXQ_OVFL count, the asyncio
        socket's SO_MEMINFO count; None where the kernel gives neither),
        and the machine's UDP drop counters since the bind, labelled
        system-wide (every UDP socket of the machine counts there, the
        clients' too)."""
        t = self._transport
        if hasattr(t, "buffer_sizes"):
            buffers, overflows = t.buffer_sizes(), t.rx_overflows
            source = "SO_RXQ_OVFL" if overflows is not None else None
        else:
            buffers = self._socket_buffers
            sock = t.get_extra_info("socket") if t is not None else None
            overflows = socket_drops(sock) if sock is not None else None
            source = "SO_MEMINFO" if overflows is not None else None
        return {
            "rcvbuf": buffers[0] if buffers else None,
            "sndbuf": buffers[1] if buffers else None,
            "rx_overflows": overflows,
            "rx_overflows_source": source,
            "system_udp": (self._system_udp.since_start()
                           if self._system_udp is not None else None),
        }

    def _sync_peers(self) -> None:
        """Install the live client set into the native transport's inline-ACK
        filter (no-op on the asyncio transport)."""
        t = self._transport
        if t is not None and hasattr(t, "set_peers"):
            t.set_peers(list(self._by_addr.keys()))

    # ============================================================== tx path
    def _send_raw(self, data: bytes, addr: Addr) -> None:
        if self._transport is None:
            return
        rc = self._transport.sendto(data, addr)
        if rc is not None and rc < 0:
            # Native transport surfaces -errno (ENOBUFS/EAGAIN bursts):
            # count the drop honestly instead of reporting healthy tx
            # while packets die at the socket.
            self.send_drops.inc()
            return
        self.packets_sent.inc()
        self.bytes_sent.inc(len(data))

    def _send_reliable(self, data: bytes, session: ClientSession) -> bool:
        """Returns False when the send was shed at a full in-flight window
        — callers with their own rate limits/counters must not mark a shed
        packet as sent (the keyframe-request path re-arms on it)."""
        if len(session.pending) >= int(session.cwnd):
            # In-flight window full: the peer is not ACKing. Shed — never
            # queue unboundedly (design invariant; every reliable consumer
            # has its own retry path, see REL_WND_* above).
            self.reliable_shed.inc()
            return False
        hdr = parse_header(data)
        session.pending[hdr.sequence] = PendingPacket(
            data=data, addr=session.addr, sent_at=time.monotonic())
        self._send_raw(data, session.addr)
        return True

    def _on_results_threadsafe(self, results: List[EngineResult]) -> None:
        """Called from the batcher thread; hop onto the loop for sending."""
        if self._loop is None:
            return
        self._loop.call_soon_threadsafe(self._send_results, results)

    def _send_results(self, results: List[EngineResult]) -> None:
        import numpy as np
        burst: List[Tuple[bytes, Addr]] = []
        recvs: List[Optional[float]] = []
        fallback_lat: List[float] = []
        sampled: List = []  # (EngineResult, n_dets) picked for /debugz
        gone = 0  # results of clients evicted meanwhile: their frames drop
        for res in results:
            session = self._sessions.get(res.client_id)
            if session is None:
                gone += 1
                continue
            if self._capture is not None:
                # Pre-adapter: the model's own boxes, before domain shaping
                # (head shrink) rewrites them for the wire.
                self._capture.on_result(res.client_id, res.frame_id,
                                        res.detections)
            dets = self.adapter.process_detections(res.client_id, res.detections)
            dets = dets[:32]
            if native.HAVE_NATIVE:
                arr = np.array(
                    [[d.x, d.y, d.width, d.height, d.confidence, d.class_id]
                     for d in dets], np.float32).reshape(len(dets), 6)
                tids = np.array([d.track_id for d in dets], np.uint32)
                det_ts = dets[0].timestamp if dets else res.timestamp
                raw = native.build_detection_result(
                    res.frame_id, res.timestamp, arr, tids, det_ts,
                    next_sequence(), now_ms())
            else:
                raw = DetectionResultPacket(
                    frame_id=res.frame_id, frame_timestamp=res.timestamp,
                    detections=dets).serialize()
            burst.append((raw, session.addr))
            recvs.append(res.recv_t)
            fallback_lat.append(res.infer_ms + res.queue_ms)
            if self._trace_every > 0:
                self._trace_seen += 1
                if self._trace_seen % self._trace_every == 0:
                    sampled.append((res, len(dets)))
            session.results_sent += 1
            EVENT_BUS.publish(INFERENCE_COMPLETED, res.client_id)
        if gone:
            self.engine.frames_dropped.inc(gone)
        if not burst:
            return
        self.results_sent.inc(len(burst))
        # One sendmmsg for the whole engine batch on the native transport;
        # per-packet sendto otherwise.
        t = self._transport
        if t is not None and hasattr(t, "send_many"):
            sent, sent_bytes = t.send_many(burst)
            self.packets_sent.inc(sent)
            if sent < len(burst):
                self.send_drops.inc(len(burst) - sent)
            self.bytes_sent.inc(sent_bytes)
        else:
            for data, addr in burst:
                self._send_raw(data, addr)
        # True datagram-arrival -> result-sent latency (includes decode
        # queueing, batch window, device step, and the send hop).
        sent_t = time.perf_counter()
        for recv_t, fb in zip(recvs, fallback_lat):
            if recv_t:
                self.detect_latency.record((sent_t - recv_t) * 1e3)
            else:
                self.detect_latency.record(fb)
        for res, ndet in sampled:
            # One served frame's lifecycle, stage by stage:
            #   decode_ms   arrival -> payload decoded & queued
            #   queue_ms    arrival -> device dispatch (decode + client
            #               queue + batch window; decode_ms is its prefix)
            #   pipeline_ms dispatch -> results on host (device step +
            #               inflight wait, so not the step time alone)
            #   send_ms     results on host -> datagram sent (adapter,
            #               tracking, serialize, send burst)
            #   detect_ms   arrival -> sent (the SLO metric)
            total = ((sent_t - res.recv_t) * 1e3 if res.recv_t
                     else res.infer_ms + res.queue_ms)
            self._traces.append({
                "t": round(time.time(), 3),
                "client_id": res.client_id,
                "frame_id": res.frame_id,
                "detections": ndet,
                "batch": res.batch_n,
                # Serve rung the frame was letterboxed to (adaptive ladder
                # + per-client accuracy floors; 0 = flat-simulated).
                "serve_size": res.serve_size,
                "decode_ms": round(res.decode_ms, 3),
                "queue_ms": round(res.queue_ms, 3),
                "pipeline_ms": round(res.infer_ms, 3),
                "send_ms": round(
                    max(total - res.queue_ms - res.infer_ms, 0.0), 3),
                "detect_ms": round(total, 3),
            })

    def _notify_frozen(self) -> None:
        """Called on the decode worker after a cache write: any slot the
        overflow policy froze gets a server-initiated REQUEST_KEYFRAME so
        the stream re-anchors in one RTT instead of waiting out the
        client's own keyframe cadence (ops/roi.py _shed_locked; the
        reference declared the command, types.h:94-103, but never sent it)."""
        cache = self.device_cache
        if cache is None or self._loop is None:
            return
        cids = cache.drain_frozen()
        if cids:
            self._loop.call_soon_threadsafe(self._send_keyframe_requests, cids)

    def _send_keyframe_requests(self, cids: List[int]) -> None:
        now = time.monotonic()
        for cid in cids:
            session = self._sessions.get(cid)
            if session is None or now - session.last_kf_request < 0.5:
                continue
            if not self._send_reliable(CommandPacket(
                    command_type=CommandType.REQUEST_KEYFRAME).serialize(),
                    session):
                # Shed at a full reliable window: do NOT stamp the rate
                # limit or the counter — the management loop's ~1s frozen
                # re-request must retry a command that never hit the wire.
                continue
            session.last_kf_request = now
            self.keyframe_requests.inc()
            log.debug("REQUEST_KEYFRAME -> client #%d (slot frozen)", cid)

    # ========================================================== maintenance
    async def _management_loop(self) -> None:
        timeout_s = self.config.network.timeout_ms / 1000.0
        max_retries = self.config.network.max_retries
        tick = 0
        while True:
            await asyncio.sleep(0.1)
            tick += 1
            if tick % 10 == 0 and self.device_cache is not None:
                # Re-request keyframes for slots still frozen ~1s later
                # (first command lost, or the client ignored it) — the
                # per-session rate limit dedupes against the event path.
                frozen = self.device_cache.frozen_clients()
                if frozen:
                    self._send_keyframe_requests(frozen)
            now = time.monotonic()
            for client_id in list(self._sessions.keys()):
                session = self._sessions[client_id]
                if now - session.last_active > timeout_s:
                    self._evict(client_id, "timeout")
                    continue
                for seq in list(session.pending.keys()):
                    p = session.pending.get(seq)
                    # RFC6298 5.5: exponential RTO backoff per retry (capped
                    # at the same 2 s ceiling as the base RTO) — a fixed
                    # interval re-burns retries while the real ACK is still
                    # in flight on high-latency paths.
                    if p is None or (now - p.sent_at
                                     < min(session.rto * (1 << p.retries),
                                           2.0)):
                        continue
                    if p.retries >= max_retries:
                        del session.pending[seq]
                        self.send_drops.inc()
                        session.backoff_window(now)
                        continue
                    p.retries += 1
                    p.sent_at = now
                    self._send_raw(p.data, p.addr)
                    self.retransmits.inc()
                    session.backoff_window(now)

    def _evict(self, client_id: int, reason: str) -> None:
        session = self._sessions.pop(client_id, None)
        if session is None:
            return
        self._by_addr.pop(session.addr, None)
        self._sync_peers()
        self.adapter.unregister_client(client_id)
        if self._decode_queues:
            # Order the queue/slot cleanup BEHIND any frames already queued
            # for this client: a frame decoded after release() would
            # re-acquire a cache slot under the dead id (client ids are
            # never reused, so that slot would leak until the free list
            # drained and the server stopped admitting ANY client). The
            # client's sharded FIFO worker orders sentinel-after-frames;
            # the drain-thread fast path CAN still enqueue a frame after
            # this point (it read the session ref pre-pop), so the LOAD-
            # BEARING guard is _decode_frame's session-identity re-check —
            # do not remove it.
            self._enqueue_cleanup(client_id)
        else:
            self._cleanup_client(client_id)
        EVENT_BUS.publish(
            CLIENT_TIMEOUT if reason == "timeout" else CLIENT_DISCONNECTED,
            client_id)
        log.info("client #%d evicted (%s)", client_id, reason)

    def _enqueue_cleanup(self, client_id: int) -> None:
        """Enqueue a cleanup sentinel WITHOUT blocking the event-loop thread.

        The decode queue is bounded and a worker can stall mid-item. A
        blocking put here would freeze the loop (no datagrams, heartbeats,
        ACKs, result sends) for the whole stall and cascade more timeout
        evictions into it — so on Full we retry shortly via call_later
        instead. FIFO ordering
        vs already-queued frames still holds: the sentinel only ever lands
        behind them, and no new frame can enqueue for a dead session."""
        self._enqueue_sentinel("__cleanup__", client_id)

    def _enqueue_sentinel(self, tag: str, client_id: int) -> None:
        try:
            self._queue_for(client_id).put_nowait((tag, client_id))
        except Exception:  # noqa: BLE001 — queue.Full
            if self._loop is not None and self._running:
                self._loop.call_later(0.05, self._enqueue_sentinel, tag,
                                      client_id)
            else:
                # Shutdown path: the loop may not run again — fall back to
                # direct cleanup (worker is stopping; ordering moot).
                if tag == "__release__":
                    self._release_stream(client_id)
                else:
                    self._cleanup_client(client_id)

    async def _monitor_loop(self) -> None:
        """Periodic status block (reference server/main.cpp:84-136, every 5s)
        + analytics stats-to-file (config.analytics — parsed but never used
        by the reference, SURVEY §5.5)."""
        analytics = self.config.analytics
        last_stats = 0.0
        while True:
            await asyncio.sleep(5.0)
            # Per-iteration isolation (like _model_watch_loop): one malformed
            # status() — e.g. an engine swapped in mid-flight missing a stats
            # key — must not silently kill monitoring + analytics for the
            # process lifetime.
            try:
                st = self.status()
                log.info(
                    "status: clients=%s queue=%s rx_pps=%s detect_p99=%.2fms "
                    "engine_p99=%sms drops=%s",
                    st["clients"], st["queue_depth"],
                    st["transport"]["rx_pps"],
                    st["detect_latency"]["p99_ms"],
                    st["engine"].get("pipeline_p99_ms"),
                    st["engine"].get("dropped"))
                self._status_history.append({
                    "t": round(time.time(), 1),
                    "clients": st["clients"],
                    "served_fps": st["served_fps"],
                    "detect_p99_ms": st["detect_latency"].get("p99_ms"),
                    "queue_depth": st["queue_depth"],
                    "dropped": st["engine"].get("dropped"),
                    "serve_size": st["engine"].get("serve_size"),
                    "device_stall_s": st.get("device_stall_s"),
                    "rate_hint_fps": (self._rate_ctl.hint
                                      if self._rate_ctl else None),
                })
                if self._rate_ctl is not None:
                    prev = self._rate_ctl.hint
                    # Paused sessions' frames are shed at ingest and can
                    # never produce a drop OR a latency sample — leaving
                    # them in `offered` dilutes drop_frac (and the per-
                    # client rate below) until real overload hides behind
                    # paused traffic.
                    offered = max(self.frames_received.rate(5.0)
                                  - self.frames_paused.rate(5.0), 0.0)
                    # Shed frames never produce a latency sample, so the
                    # drop fraction is the only overload signal in the
                    # steady-shedding mode this controller exists for.
                    # Oversized sheds are excluded: they are client
                    # misconfig, invariant under rate cuts — counting them
                    # would pin every well-behaved client at the floor.
                    load_drops = max(
                        self.engine.frames_dropped.rate(5.0)
                        - self.engine.frames_oversized.rate(5.0), 0.0)
                    drop_frac = (load_drops / offered) if offered > 0 else 0.0
                    active = sum(1 for sess in self._sessions.values()
                                 if not sess.paused)
                    fps = self._rate_ctl.tick(
                        st["detect_latency"].get("p99_ms"),
                        # Per-ACTIVE-client rate: offered already excludes
                        # paused frames, so dividing by all sessions would
                        # underestimate active clients and overshoot the
                        # seeded first cut.
                        offered / max(active, 1),
                        drop_frac=drop_frac)
                    if fps is not None and self._sessions:
                        blob = ConfigUpdatePacket(
                            settings={"target_fps": fps}).serialize()
                        for s in list(self._sessions.values()):
                            self._send_raw(blob, s.addr)
                        self.rate_updates_sent.inc(len(self._sessions))
                        if self._rate_ctl.hint != prev:
                            log.info(
                                "rate control: detect p99 %.2fms vs slo "
                                "%.2fms, drop_frac %.2f -> clients told "
                                "target_fps=%d%s",
                                st["detect_latency"].get("p99_ms") or 0.0,
                                self._rate_ctl.slo_ms, drop_frac, fps,
                                "" if self._rate_ctl.hint is not None
                                else " (restored)")
                if st["transport"].get("rx_dead"):
                    log.error("native transport is RX-DEAD (recv thread "
                              "exited on a permanent error): clients will "
                              "time out — restart this server/shard")
                stall = float(st.get("device_stall_s") or 0.0)
                if stall > DEVICE_STALL_WARN_S:
                    # The device lane stopped completing (a hung kernel or
                    # a lost device): ingest keeps shedding per-client,
                    # heartbeats and /statusz stay live — say WHY results
                    # stopped. Far above any step and below liveness
                    # eviction timeouts.
                    log.warning(
                        "device lane stalled for %.1fs (no batch completion;"
                        " hung kernel or lost device?)", stall)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001
                log.exception("status block failed")
                continue
            now = time.monotonic()
            if (analytics.enable_analytics and analytics.save_stats_to_file
                    and now - last_stats >= analytics.stats_interval_sec):
                last_stats = now

                def _write_stats(path=analytics.stats_file, snapshot=st):
                    import os as _os
                    d = _os.path.dirname(path)
                    if d:
                        _os.makedirs(d, exist_ok=True)
                    with open(path, "w") as f:
                        json.dump(snapshot, f, indent=1)

                try:
                    # Worker thread, never the event loop (review r5): a
                    # contended disk write here would stall datagram
                    # dispatch/ACKs/result sends and land straight in the
                    # detect p99 (same discipline as the model watcher
                    # below).
                    await asyncio.to_thread(_write_stats)
                except OSError:
                    log.exception("failed writing analytics stats")

    async def _model_watch_loop(self) -> None:
        """SHA-256 model watcher: hot-swap on change (reference
        onnx_engine.cpp:473-515), every 10s."""
        while True:
            await asyncio.sleep(10.0)
            try:
                if await asyncio.to_thread(self.engine.maybe_reload):
                    EVENT_BUS.publish(MODEL_UPDATED, self.config.model_path)
            except Exception:  # noqa: BLE001
                log.exception("model watcher failed")

    def _schedule_socket_recovery(self) -> None:
        # Single-flight: a burst of error_received callbacks must not stack
        # recovery tasks — each extra task would re-bind after the first one
        # succeeded (leaking reuseport group members, or raising EADDRINUSE).
        if self._loop and self._running and not self._recovering:
            self._recovering = True
            self._loop.create_task(self._recover_socket())

    async def _recover_socket(self) -> None:
        """Close and re-create the datagram endpoint in place
        (reference reliable_udp.cpp:492-509). Retries with backoff: a
        one-shot attempt that lost the 50 ms race (another process
        grabbed the port, transient ENOBUFS) used to leave the server
        PERMANENTLY deaf — _transport stayed None, no further
        error_received could re-trigger recovery, and /statusz read
        healthy while every client timed out (review r5). The failure is
        also surfaced (transport_dead) so operators see a deaf server."""
        try:
            if self._transport:
                self._transport.close()
                self._transport = None
            delay = 0.05
            for attempt in range(6):
                await asyncio.sleep(delay)
                if not self._running:
                    # stop() ran while we slept: re-binding now would hold
                    # the port past shutdown (EADDRINUSE for next boot).
                    return
                try:
                    # reuse_port: rejoin the reuseport group, not a plain
                    # bind — a plain bind would EADDRINUSE against
                    # surviving shards.
                    await self._loop.create_datagram_endpoint(
                        lambda: _Protocol(self),
                        local_addr=(self.config.network.bind_address
                                    or "0.0.0.0", self.port),
                        reuse_port=self.config.network.reuse_port or None)
                    self._size_socket_buffers()
                    self.transport_dead = False
                    log.warning("socket recovered on udp/%d (attempt %d)",
                                self.port, attempt + 1)
                    return
                except OSError:
                    log.exception("socket recovery attempt %d failed",
                                  attempt + 1)
                    delay = min(delay * 2, 2.0)
            self.transport_dead = True
            log.error("socket recovery EXHAUSTED on udp/%d — transport is "
                      "DEAD (restart the server/shard)", self.port)
        finally:
            self._recovering = False

    # =============================================================== status
    def _rx_pending(self) -> Optional[int]:
        """The size of the next datagram waiting in the UDP socket (FIONREAD:
        0 when it is empty); None where it cannot be read."""
        t = self._transport
        fd = getattr(t, "fd", None)
        if fd is None and t is not None:
            sock = t.get_extra_info("socket")
            fd = sock.fileno() if sock is not None else None
        if fd is None or fd < 0:
            return None
        try:
            import fcntl
            import struct
            import termios
            return struct.unpack("i", fcntl.ioctl(fd, termios.FIONREAD,
                                                  b"\0" * 4))[0]
        except (ImportError, OSError):
            return None

    def frame_counts(self) -> Dict[str, int]:
        """This process's frame totals: the frames taken in from sessions,
        the results sent, the drops, the other ends of a frame taken in
        (paused, refused by the cache, undecodable), and the frames refused
        for want of a session. `stop()` logs them as its last count."""
        return {"pid": os.getpid(),
                "frames_received": self.frames_received.value,
                "results_sent": self.results_sent.value,
                "dropped": self.engine.frames_dropped.value,
                "frames_paused": self.frames_paused.value,
                "cache_rejects": self.cache_rejects.value,
                "bad_packets": self.bad_packets.value,
                "frames_unknown_sender": self.frames_unknown_sender.value}

    def status(self) -> Dict[str, object]:
        lat = self.detect_latency.snapshot()
        return {
            "server": "zero_latency_yolo_tpu_torch",
            "pid": os.getpid(),
            "port": self.port,
            "clients": len(self._sessions),
            "max_clients": self.config.max_clients,
            # Accuracy-SLA floors in force: how many clients the adaptive
            # policy must serve above the fleet rung, and the highest floor
            # (operators see at a glance why two rungs dispatch per cycle).
            "clients_floored": sum(
                1 for s in self._sessions.values() if s.min_serve_size > 0),
            "max_client_floor": max(
                (s.min_serve_size for s in self._sessions.values()),
                default=0),
            "queue_depth": self.batcher.queue_depth(),
            "device_stall_s": round(self.batcher.device_stall_s(), 3),
            "device_stall_warn_s": DEVICE_STALL_WARN_S,
            "transport": {
                "packets_received": self.packets_received.value,
                "packets_sent": self.packets_sent.value,
                "bytes_received": self.bytes_received.value,
                "bytes_sent": self.bytes_sent.value,
                "retransmits": self.retransmits.value,
                "reliable_shed": self.reliable_shed.value,
                # Native drain thread gave up on a permanent recv failure:
                # tx works, nothing is ever read — restart the shard.
                "rx_dead": bool(getattr(self._transport, "rx_dead", False)),
                # Asyncio socket recovery exhausted its retries: the
                # server cannot receive OR send — restart the shard.
                "transport_dead": self.transport_dead,
                "send_drops": self.send_drops.value,
                "bad_packets": self.bad_packets.value,
                # Datagrams the kernel dropped at a full receive buffer.
                "kernel_drops": udp_kernel_drops(self.port),
                # Granted buffers, the socket's own overflow count, and the
                # machine's UDP drops since the bind (system-wide).
                **self.socket_stats(),
                "unknown_sender_naks": self.unknown_sender_naks.value,
                "frames_unknown_sender": self.frames_unknown_sender.value,
                "rx_pps": round(self.packets_received.rate(), 1),
            },
            "served_fps": round(self.results_sent.rate(), 1),
            "results_sent": self.results_sent.value,
            "frames_received": self.frames_received.value,
            "frames_paused": self.frames_paused.value,
            "detect_latency": lat,
            "rate_control": ({
                "slo_ms": self._rate_ctl.slo_ms,
                "min_fps": self._rate_ctl.min_fps,
                # The full-rate value restores broadcast — consumers
                # classify a received hint as throttled iff below this.
                "target_fps": self._rate_ctl.target_fps,
                "hint_fps": self._rate_ctl.hint,
                "updates_sent": self.rate_updates_sent.value,
            } if self._rate_ctl is not None else None),
            "frame_cache": ({
                "slots_used": (self.device_cache.num_slots
                               - len(self.device_cache._free)),
                "slots_total": self.device_cache.num_slots,
                "flushes": self.device_cache.flushes,
                "writes_flushed": self.device_cache.writes_flushed,
                "writes_shed": self.device_cache.writes_shed,
                "frozen_slots": len(self.device_cache.frozen_clients()),
                "keyframe_requests": self.keyframe_requests.value,
                # Keyframes the cache refused (oversized/slot-exhausted).
                "cache_rejects": self.cache_rejects.value,
            } if self.device_cache is not None else None),
            "keyframe_requests": self.keyframe_requests.value,
            "engine": self.engine.status(),
            # The kernels this process launched (ops/launches.py), read by
            # processes that drive the server from outside (loadtest.py).
            "kernel_launches": launch_counts(),
            "adapter": self.adapter.status(),
            # Host GC pauses stop ALL serving threads — surfaced next to the
            # latency they inflate (utils/gcstats.py; tpu.gc_tune posture).
            "host_gc": self._gc_tracker.status(),
            "capture": (self._capture.status()
                        if self._capture is not None else None),
            "sessions": {
                str(cid): {
                    "addr": f"{s.addr[0]}:{s.addr[1]}",
                    "frames": s.frames_received,
                    "results": s.results_sent,
                    "srtt_ms": round((s.srtt or 0) * 1e3, 2),
                    "paused": s.paused,
                } for cid, s in self._sessions.items()
            },
        }

    async def _handle_http(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            request_line = await asyncio.wait_for(reader.readline(), timeout=5.0)
            parts = request_line.split(b" ")
            if len(parts) < 2:
                return
            method = parts[0].decode("ascii", "replace").upper()
            path = parts[1].decode("utf-8", "replace")
            content_length = 0
            auth = ""
            # Header cap: each readline gets a fresh 5 s timeout, so without
            # a line bound a client trickling one garbage header every ~4 s
            # holds the fd/coroutine forever (slowloris on the mgmt port).
            for _ in range(64):
                line = await asyncio.wait_for(reader.readline(), timeout=5.0)
                if line in (b"\r\n", b"\n", b""):
                    break
                if line.lower().startswith(b"content-length:"):
                    try:
                        content_length = int(
                            line.split(b":", 1)[1].strip() or 0)
                    except ValueError:
                        return  # unparseable framing: no safe body read
                elif line.lower().startswith(b"authorization:"):
                    # "Bearer <token>" (scheme case-insensitive per RFC
                    # 7235); a bare token is also accepted for curl
                    # convenience. Decoded as UTF-8 to match the config.
                    val = line.split(b":", 1)[1].strip()
                    if val[:7].lower() == b"bearer ":
                        val = val[7:].strip()
                    auth = val.decode("utf-8", "replace")
            else:
                return  # >64 header lines: not a legitimate client
            from .web import MAX_UPLOAD
            body = b""
            if (method == "POST" and 0 < content_length <= MAX_UPLOAD
                    and self.management.auth_ok(auth)):
                # Auth gates the BODY READ, not just the route: without the
                # pre-check an unauthenticated client could make the server
                # buffer 256 MB per connection before its 401 (memory DoS
                # on the management port). With a bad token the body is
                # never read; handle() re-checks and answers 401.
                body = await asyncio.wait_for(
                    reader.readexactly(content_length), timeout=60.0)
            code, payload = await self.management.handle(method, path, body,
                                                         auth=auth)
            if isinstance(payload, dict) and "__html__" in payload:
                data = payload["__html__"].encode()
                ctype = "text/html; charset=utf-8"
            elif isinstance(payload, dict) and "__text__" in payload:
                # Prometheus /metricsz (and any future plain-text route).
                data = payload["__text__"].encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            else:
                data = json.dumps(payload, indent=1).encode()
                ctype = "application/json"
            reason = {200: "OK", 400: "Bad Request", 401: "Unauthorized",
                      404: "Not Found", 409: "Conflict",
                      500: "Internal Server Error"}.get(code, "OK")
            writer.write(f"HTTP/1.1 {code} {reason}\r\n"
                         f"Content-Type: {ctype}\r\n"
                         f"Content-Length: {len(data)}\r\n"
                         f"Connection: close\r\n\r\n".encode() + data)
            await writer.drain()
        except Exception:  # noqa: BLE001
            pass
        finally:
            writer.close()

    # ============================================================== helpers
    def _session_by_addr(self, addr: Addr) -> Optional[ClientSession]:
        cid = self._by_addr.get(addr)
        return self._sessions.get(cid) if cid is not None else None

    def client_count(self) -> int:
        return len(self._sessions)


async def serve(config: Optional[ServerConfig] = None,
                warmup: bool = True, device: str = "cuda") -> DetectionServer:
    """Convenience entry: build, warm up, start. Warmup runs every step once
    before the batcher runs (main() does the same), so the first live
    batches do not pay the kernels' build and cuDNN's first-call setup;
    pass warmup=False to skip (tests, simulation mode)."""
    config = config or ServerConfig.load()
    server = DetectionServer(config, device=device)
    await server.start(warmup=warmup)
    return server


def main(argv: Optional[List[str]] = None) -> None:  # pragma: no cover
    """Process entry point (reference src/server/main.cpp lifecycle).
    Serves on the CUDA device unless `--device cpu`; exits with an error
    when asked for CUDA without a CUDA device."""
    import argparse
    import os
    import signal

    import faulthandler
    faulthandler.enable()
    if hasattr(signal, "SIGUSR1"):  # kill -USR1 <pid> => all-thread dump
        faulthandler.register(signal.SIGUSR1, all_threads=True)

    ap = argparse.ArgumentParser(
        description="zero-latency-yolo detection server (PyTorch / CUDA)")
    ap.add_argument("--config", default="configs/server.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; cpu runs "
                         "every kernel's plain PyTorch version)")
    args = ap.parse_args(argv)
    import torch
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device (pass "
                         "--device cpu to serve on the CPU)")

    cfg = ServerConfig.load(args.config)
    from ..utils.logging import init_logging
    init_logging(cfg.logging.log_level,
                 cfg.logging.log_file if cfg.logging.enable_logging else None,
                 cfg.logging.max_log_size_mb, cfg.logging.max_log_files)
    for d in ("logs", "models", "configs"):
        os.makedirs(d, exist_ok=True)

    # CPU affinity / priority (reference server/main.cpp:35-60, :208-220).
    # These pin the *host* loop; device work is unaffected.
    if cfg.use_cpu_affinity and hasattr(os, "sched_setaffinity"):
        try:
            os.sched_setaffinity(0, {cfg.cpu_core_id})
        except OSError as e:
            # Loud, not fatal: a silent failure here means an operator who
            # asked for per-shard core pinning (serve_fleet) gets a process
            # floating across all cores and no signal why.
            log.warning("cpu affinity to core %d failed (%s); process "
                        "runs unpinned", cfg.cpu_core_id, e)
    if cfg.use_high_priority:
        try:
            os.nice(-10)
        except OSError:
            pass

    async def run():
        server = DetectionServer(cfg, device=args.device)
        loop = asyncio.get_running_loop()
        stop = asyncio.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await server.start(warmup=True)
        await stop.wait()
        await server.stop()

    asyncio.run(run())


if __name__ == "__main__":  # pragma: no cover
    main()
