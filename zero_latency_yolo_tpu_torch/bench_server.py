#!/usr/bin/env python3
"""Loopback load on the port's UDP server on one NVIDIA GPU: the deployed
config (`configs/examples/server-cs16-416.json`: yolov8n, 416 px, bf16,
real weights), or another of `configs/examples/` (`--config`), served by
`DetectionServer` in this process, with its device frame cache (the
default) or without it, and clients streaming raw frames to it over
loopback UDP, from threads of this process or from one child process.

    python3 zero_latency_yolo_tpu_torch/bench_server.py \\
        [--config configs/examples/server-64stream-adaptive.json] \\
        [--clients-in threads|process] [--clients 8] [--fps 60] \\
        [--seconds 4] [--native-transport] [--cache | --no-cache] [--label L]

The frames are `synthetic_frame`s of 160x120 (raw RGB, 57,600 B, one
datagram): they land in the 608x800 frame bucket, so every step runs the
full model. With `--clients-in threads` the clients share this process, and
its GIL, with the server; with `process` they run in a child process.
`--native-transport` serves through the native recvmmsg transport instead
of the asyncio endpoint. With the cache each frame is written to the
server's device frame cache as a keyframe and every batch is gathered out
of it, at the cache's shape (the largest frame bucket, 1080x1920); with
`--no-cache` it is staged from host memory into its own bucket (608x800).
`chip_smoke.py`'s server phase runs `run_load` with the clients in
threads.

Prints one JSON line (`load`): frames sent, results received, the drops the
server counted (engine and kernel receive-buffer drops), the server's own
detect latency p50 and p99 (datagram arrival to result sent, over
[0.5, 3.0) s of the load), results a second over that window, batch sizes,
the host time of each batch's step launch (`engine.dispatch`, or
`engine.dispatch_gathered` with the cache; median and p90, ms), with the
cache the time the batcher holds the cache's lock for a batch (the flush of
the queued writes and the gather: `lock_ms_p50` / `lock_ms_p90`), the
device's busy time and idle share over the last second of the load
(torch.profiler), the server socket's granted buffers, its own overflow
count and the machine's UDP drops since the bind (`socket`, from
/statusz), each client's receive-socket overflows
(`client_overflows`), the machine's IP and UDP drop counters over the load
with the loopback MTU (`net`), and the results by the serve
size they were served at (`serve_sizes`) with the engine's size switches
(`size_downshifts`, `size_upshifts`; a config with a tpu.serve_sizes ladder
and tpu.adaptive_slo_ms steps down under load).
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import contextlib
import json
import socket
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CONFIG = ROOT / "configs" / "examples" / "server-cs16-416.json"
FRAME = (160, 120)  # w, h


def free_port(kind=socket.SOCK_DGRAM) -> int:
    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ServerThread:
    """A DetectionServer on an asyncio loop of its own thread."""

    def __init__(self, server) -> None:
        self.server = server
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)

    def run(self, coro, timeout: float = 120.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def start(self, warmup: bool) -> "ServerThread":
        self.thread.start()
        self.run(self.server.start(warmup=warmup), timeout=600.0)
        return self

    def stop(self) -> None:
        try:
            self.run(self.server.stop())
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(timeout=10)


def http_get(port: int, path: str, method: str = "GET") -> tuple:
    """(status code, body) of GET (or `method`, with no body) path on
    127.0.0.1:port."""
    with socket.create_connection(("127.0.0.1", port), timeout=30) as sock:
        sock.sendall(f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
                     "Content-Length: 0\r\n\r\n".encode())
        data = b""
        while True:
            chunk = sock.recv(65536)
            if not chunk:
                break
            data += chunk
    head, _, body = data.partition(b"\r\n\r\n")
    return int(head.split()[1]), body


# The server socket's receive buffer for the load: 64 MiB holds about 2 s
# of it (480 frames/s of 57,600 B). With the batcher's eager step holding
# the GIL, the event loop that drains the socket can stall for a few
# hundred ms, and a smaller buffer loses frames in the kernel, which some
# kernels count per socket nowhere (PERF.md section 7). The kernel caps the
# request (8 MiB on the H100's machine); the server asks past the cap when
# it may and reports what it got (/statusz `transport.rcvbuf`).
RECV_BUFFER_BYTES = 64 << 20


def deployed_config(tracking: bool = True, native_transport: bool = False,
                    config: Path = CONFIG):
    """A config file (default the deployed one) on free loopback ports,
    tracking on or off, the asyncio or the native recvmmsg transport."""
    from zero_latency_yolo_tpu_torch.config import ServerConfig
    d = json.loads(Path(config).read_text())
    d["model_path"] = str(ROOT / d["model_path"])
    d["port"] = free_port()
    d["web_port"] = free_port(socket.SOCK_STREAM)
    d["network"] = {"bind_address": "127.0.0.1",
                    "web_bind_address": "127.0.0.1",
                    "recv_buffer_size": RECV_BUFFER_BYTES,
                    "use_native_transport": native_transport}
    d["detection"] = {**d["detection"], "enable_tracking": tracking}
    d["logging"] = {"enable_logging": False}
    return ServerConfig.from_dict(d)


def client_frames(i: int) -> list:
    from zero_latency_yolo_tpu_torch.runtime.simulator import synthetic_frame
    return [synthetic_frame(*FRAME, seed=100 + 8 * i + k, t=0.2 * k)
            for k in range(8)]


def _stream(client, frames, n: int, fps: float, t0: float, sent: list) -> None:
    """Send n frames at fps from t0 (perf_counter; cycling `frames`)."""
    for i in range(n):
        delay = t0 + i / fps - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        client.send_raw_frame(frames[i % len(frames)])
        sent[0] += 1


class Clients:
    """n SimClients connected to 127.0.0.1:port, each streaming from a
    thread of its own; their starts spread evenly over one frame interval."""

    def __init__(self, port: int, n: int) -> None:
        from zero_latency_yolo_tpu_torch.runtime.simulator import SimClient
        self.clients = []
        for _ in range(n):
            c = SimClient(("127.0.0.1", port), screen_width=FRAME[0],
                          screen_height=FRAME[1])
            c.connect()
            c.start_receiver()
            self.clients.append(c)
        self.frames = [client_frames(i) for i in range(n)]
        self.sent = [[0] for _ in range(n)]
        self.threads = []

    def start(self, fps: float, seconds: float, t0: float) -> None:
        n, k = int(fps * seconds), len(self.clients)
        self.threads = [threading.Thread(
            target=_stream, args=(c, self.frames[i], n, fps,
                                  t0 + i / (fps * k), self.sent[i]),
            daemon=True) for i, c in enumerate(self.clients)]
        for t in self.threads:
            t.start()

    def join(self) -> None:
        for t in self.threads:
            t.join()

    def results(self) -> list:
        return [len(c.wait_results(0, timeout=0)) for c in self.clients]

    def overflows(self) -> list:
        """Each client's receive-socket drops (SO_RXQ_OVFL; None where the
        kernel does not count them): results lost at the client."""
        return [c.rx_overflows for c in self.clients]

    def stop(self) -> None:
        for c in self.clients:
            c.stop()


def _child(port: int, n: int, fps: float, seconds: float) -> None:
    """The client side of `--clients-in process`: connect, say "ready",
    read the start time (perf_counter, shared by the processes of one
    machine) from stdin, stream, wait until no result arrives for 0.5 s,
    print {"sent", "results"}."""
    clients = Clients(port, n)
    try:
        print("ready", flush=True)
        t0 = float(sys.stdin.readline())
        clients.start(fps, seconds, t0)
        clients.join()
        last, still = None, time.perf_counter()
        while time.perf_counter() - still < 0.5:
            time.sleep(0.05)
            now = clients.results()
            if now != last:
                last, still = now, time.perf_counter()
        print(json.dumps({"sent": [s[0] for s in clients.sent],
                          "results": clients.results(),
                          "client_overflows": clients.overflows()}),
              flush=True)
    finally:
        clients.stop()


def net_counters() -> dict:
    """The machine's IP and UDP counters that can hide a lost datagram
    (/proc/net/snmp; empty off Linux) and the loopback MTU: a datagram
    larger than the MTU travels in fragments, and a failed reassembly
    drops it before any socket sees it."""
    from zero_latency_yolo_tpu_torch.utils.netstats import snmp_counters
    keys = ("Ip.ReasmFails", "Ip.InDiscards", "Udp.InErrors",
            "Udp.RcvbufErrors", "Udp.NoPorts")
    out = {k: v for k, v in snmp_counters().items() if k in keys}
    try:
        out["lo_mtu"] = int(Path("/sys/class/net/lo/mtu").read_text())
    except (OSError, ValueError):
        pass
    return out


def warm_profiler(torch) -> None:
    """One short profile of a matmul: the first profile of a process can
    miss the device's kernels. Call before the server's batcher starts (it
    touches the device from this thread)."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(64, 64, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        (x @ x).sum().item()


def device_idle_share(torch, seconds: float, gate=None) -> tuple:
    """(busy ms, wall ms, idle share or None) of the device over `seconds`
    of whatever runs meanwhile: torch.profiler's kernel and copy time.
    `gate`, a lock every engine call of the load holds, is held while the
    profiler starts and stops: stopping it while the batcher thread was
    inside an operator crashed the process (a segmentation fault in the
    profiler's stop, in 3 of 20 loads of the yolov8s config on an
    H100)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    gate = gate or contextlib.nullcontext()
    prof = profile(activities=[ProfilerActivity.CUDA])
    with gate:
        prof.start()
    t0 = time.perf_counter()
    time.sleep(seconds)
    wall = (time.perf_counter() - t0) * 1e3
    with gate:
        prof.stop()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    return busy, wall, (max(0.0, 1.0 - busy / wall) if busy > 0 else None)


def run_load(torch, server, clients_in: str = "threads", n: int = 8,
             fps: float = 60.0, seconds: float = 4.0, during=None) -> dict:
    """Drive a started server with n clients for `seconds` (see the module
    docstring) and return what was sent, received and measured. The load
    needs at least 3.5 s: the latency window ends at 3.0 s and the idle
    share is read over the last second. `during`, if given, is called at
    3.0 s, while every client is connected; its result is returned under
    "during"."""
    engine, cache = server.engine, server.device_cache
    batch_sizes, served_at = collections.Counter(), collections.Counter()
    dispatch_ms, lock_ms = [], []
    dispatch, dispatch_gathered = engine.dispatch, engine.dispatch_gathered
    complete_many = engine.complete_many
    dispatch_with = cache.dispatch_with if cache is not None else None

    def counted(pendings):
        out = complete_many(pendings)
        for results in out:
            served_at.update(r.serve_size for r in results)
        return out

    def timing(fn, out, count):
        def timed(first, *args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(first, *args, **kwargs)
            finally:
                out.append((time.perf_counter() - t) * 1e3)
                if count:  # first: the batch's requests
                    batch_sizes[len(first)] += 1
        return timed

    child = clients = None
    try:
        if clients_in == "process":
            child = subprocess.Popen(
                [sys.executable, "-m", "zero_latency_yolo_tpu_torch.bench_server",
                 "--child", str(server.port), str(n), str(fps), str(seconds)],
                cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                text=True)
            if child.stdout.readline().strip() != "ready":
                raise RuntimeError("client process did not start")
        else:
            clients = Clients(server.port, n)
        engine.dispatch = timing(dispatch, dispatch_ms, True)
        engine.dispatch_gathered = timing(dispatch_gathered, dispatch_ms, True)
        engine.complete_many = counted
        if cache is not None:
            cache.dispatch_with = timing(dispatch_with, lock_ms, False)
        net0 = net_counters()
        # The engine may have served before (a server reusing it).
        drops0 = engine.frames_dropped.value
        t0 = time.perf_counter() + 0.05
        if child is not None:
            child.stdin.write(f"{t0!r}\n")
            child.stdin.flush()
        else:
            clients.start(fps, seconds, t0)
        # Rate and latency over [0.5, 3.0) s of the load; the device's
        # idle share over its last second (the profiler's own cost stays
        # out of the latency numbers).
        time.sleep(max(t0 + 0.5 - time.perf_counter(), 0))
        r0 = server.results_sent.value
        time.sleep(max(t0 + 3.0 - time.perf_counter(), 0))
        r1 = server.results_sent.value
        lat = server.detect_latency.snapshot()
        seen = during() if during is not None else None
        time.sleep(max(t0 + seconds - 0.95 - time.perf_counter(), 0))
        # Every engine call of the batcher holds its device_gate, so the
        # profiler starts and stops between them.
        busy, wall, idle = device_idle_share(torch, 0.9,
                                             server.batcher.device_gate)
        if child is not None:
            out = json.loads(child.stdout.readline())
            child.wait(timeout=60)
            sent, results = out["sent"], out["results"]
            client_overflows = out["client_overflows"]
        else:
            clients.join()
            last, still = None, time.perf_counter()
            while time.perf_counter() - still < 0.5:
                time.sleep(0.05)
                now = (clients.results(), server.batcher.queue_depth())
                if now != last:
                    last, still = now, time.perf_counter()
                if time.perf_counter() - t0 > 60:
                    raise RuntimeError("server did not drain")
            sent = [s[0] for s in clients.sent]
            results = clients.results()
            client_overflows = clients.overflows()
    finally:
        engine.dispatch, engine.dispatch_gathered = dispatch, dispatch_gathered
        engine.complete_many = complete_many
        if cache is not None:
            cache.dispatch_with = dispatch_with
        if clients is not None:
            clients.stop()
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()
    net1 = net_counters()
    st = server.status()

    def p50_p90(xs):
        if not xs:
            return 0.0, 0.0
        q = statistics.quantiles(xs, n=10) if len(xs) > 1 else [xs[0]] * 9
        return statistics.median(xs), q[8]
    (d50, d90), (l50, l90) = p50_p90(dispatch_ms), p50_p90(lock_ms)
    return dict(
        clients_in=clients_in, clients=n, fps=fps, seconds=seconds,
        cache=st["frame_cache"], during=seen,
        sent=sent, results=results,
        engine_drops=int(st["engine"]["dropped"]) - drops0,
        kernel_drops=st["transport"]["kernel_drops"] or 0,
        # The server socket's granted buffers and own overflow count, the
        # machine's UDP drops since the server's bind (system-wide), and
        # each client's receive-socket overflows (results lost there).
        socket={k: st["transport"][k] for k in (
            "rcvbuf", "sndbuf", "rx_overflows", "rx_overflows_source",
            "system_udp")},
        client_overflows=client_overflows,
        bad_packets=st["transport"]["bad_packets"],
        frames_received=st["frames_received"],
        p50_ms=lat["p50_ms"], p99_ms=lat["p99_ms"],
        latency_samples=min(lat["count"], 1000),
        results_per_s=(r1 - r0) / 2.5,
        batch_sizes=dict(sorted(batch_sizes.items())),
        dispatch_ms_p50=d50, dispatch_ms_p90=d90,
        lock_ms_p50=l50, lock_ms_p90=l90,
        busy_ms=busy, wall_ms=wall, idle_share=idle,
        serve_sizes=dict(sorted(served_at.items())),
        size_downshifts=int(st["engine"]["size_downshifts"]),
        size_upshifts=int(st["engine"]["size_upshifts"]),
        net={k: v - net0.get(k, 0) if k != "lo_mtu" else v
             for k, v in net1.items()})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clients-in", choices=("threads", "process"),
                    default="threads")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--fps", type=float, default=60.0)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--native-transport", action="store_true",
                    help="network.use_native_transport (recvmmsg intake)")
    ap.add_argument("--cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve with the device frame cache (the server's "
                         "use_device_cache; default on)")
    ap.add_argument("--config", default=str(CONFIG),
                    help="a config file (default: the deployed one)")
    ap.add_argument("--label", default="")
    ap.add_argument("--child", nargs=4, metavar=("PORT", "N", "FPS", "SECONDS"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    if args.child:
        port, n, fps, seconds = args.child
        _child(int(port), int(n), float(fps), float(seconds))
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_server: no CUDA device")
    from zero_latency_yolo_tpu_torch.runtime.server import DetectionServer
    from zero_latency_yolo_tpu_torch.utils.bench_util import device_label
    smi_line = device_label("cuda")
    warm_profiler(torch)
    cfg = deployed_config(native_transport=args.native_transport,
                          config=Path(args.config))
    srv = ServerThread(DetectionServer(
        cfg, device="cuda", use_device_cache=args.cache)).start(warmup=True)
    try:
        load = run_load(torch, srv.server, args.clients_in, args.clients,
                        args.fps, args.seconds)
    finally:
        srv.stop()
    print(json.dumps({"label": args.label,
                      "device": smi_line,
                      "native_transport": args.native_transport,
                      "cache": args.cache,
                      "config": Path(args.config).name,
                      "load": load}), flush=True)


if __name__ == "__main__":
    main()
