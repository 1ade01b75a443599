#!/usr/bin/env python3
"""Loopback load on the port's UDP server on one NVIDIA GPU: the deployed
config (`configs/examples/server-cs16-416.json`: yolov8n, 416 px, bf16,
real weights; no device frame cache) served by `DetectionServer` in this
process, and clients streaming raw frames to it over loopback UDP, from
threads of this process or from one child process.

    python3 zero_latency_yolo_tpu_torch/bench_server.py \\
        [--clients-in threads|process] [--clients 8] [--fps 60] \\
        [--seconds 4] [--native-transport] [--label L]

The frames are `synthetic_frame`s of 160x120 (raw RGB, 57,600 B, one
datagram): they land in the 608x800 frame bucket, so every step runs the
full model. With `--clients-in threads` the clients share this process, and
its GIL, with the server; with `process` they run in a child process.
`--native-transport` serves through the native recvmmsg transport instead
of the asyncio endpoint.
`chip_smoke.py`'s server phase runs `run_load` with the clients in
threads.

Prints one JSON line (`load`): frames sent, results received, the drops the
server counted (engine and kernel receive-buffer drops), the server's own
detect latency p50 and p99 (datagram arrival to result sent, over
[0.5, 3.0) s of the load), results a second over that window, batch sizes,
the host time of each `engine.dispatch` call (median and p90, ms), the
device's busy time and idle share over the last second of the load
(torch.profiler), the server socket's granted receive buffer (`rcvbuf`;
None on the native transport), and the machine's IP and UDP drop counters
over the load with the loopback MTU (`net`).
"""

from __future__ import annotations

import argparse
import asyncio
import collections
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


def http_get(port: int, path: str) -> tuple:
    """(status code, body) of GET path on 127.0.0.1:port."""
    with socket.create_connection(("127.0.0.1", port), timeout=30) as sock:
        sock.sendall(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
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
# kernels do not count per socket in /proc/net/udp (PERF.md section 7).
RECV_BUFFER_BYTES = 64 << 20


def deployed_config(tracking: bool = True, native_transport: bool = False):
    """The deployed config on free loopback ports, tracking on or off, the
    asyncio or the native recvmmsg transport."""
    from zero_latency_yolo_tpu_torch.config import ServerConfig
    d = json.loads(CONFIG.read_text())
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
                          "results": clients.results()}), flush=True)
    finally:
        clients.stop()


def net_counters() -> dict:
    """The machine's IP and UDP counters that can hide a lost datagram
    (/proc/net/snmp; empty off Linux) and the loopback MTU: a datagram
    larger than the MTU travels in fragments, and a failed reassembly
    drops it before any socket sees it."""
    out = {}
    try:
        lines = Path("/proc/net/snmp").read_text().splitlines()
        for head, vals in zip(lines[::2], lines[1::2]):
            name, keys = head.split(":")
            for k, v in zip(keys.split(), vals.split(":")[1].split()):
                if (name, k) in (("Ip", "ReasmFails"), ("Ip", "InDiscards"),
                                 ("Udp", "InErrors"), ("Udp", "RcvbufErrors"),
                                 ("Udp", "NoPorts")):
                    out[f"{name}.{k}"] = int(v)
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


def device_idle_share(torch, seconds: float) -> tuple:
    """(busy ms, wall ms, idle share or None) of the device over `seconds`
    of whatever runs meanwhile: torch.profiler's kernel and copy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        time.sleep(seconds)
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    return busy, wall, (max(0.0, 1.0 - busy / wall) if busy > 0 else None)


def run_load(torch, server, clients_in: str = "threads", n: int = 8,
             fps: float = 60.0, seconds: float = 4.0) -> dict:
    """Drive a started server with n clients for `seconds` (see the module
    docstring) and return what was sent, received and measured. The load
    needs at least 3.5 s: the latency window ends at 3.0 s and the idle
    share is read over the last second."""
    engine = server.engine
    batch_sizes = collections.Counter()
    dispatch_ms = []
    dispatch = engine.dispatch

    def timed(requests, size=None):
        t = time.perf_counter()
        try:
            return dispatch(requests, size=size)
        finally:
            dispatch_ms.append((time.perf_counter() - t) * 1e3)
            batch_sizes[len(requests)] += 1

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
        engine.dispatch = timed
        transport = server._transport
        sock = (transport.get_extra_info("socket")
                if hasattr(transport, "get_extra_info") else None)
        rcvbuf = (sock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)
                  if sock is not None else None)
        net0 = net_counters()
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
        time.sleep(max(t0 + seconds - 0.95 - time.perf_counter(), 0))
        busy, wall, idle = device_idle_share(torch, 0.9)
        if child is not None:
            out = json.loads(child.stdout.readline())
            child.wait(timeout=60)
            sent, results = out["sent"], out["results"]
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
    finally:
        engine.dispatch = dispatch
        if clients is not None:
            clients.stop()
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()
    net1 = net_counters()
    st = server.status()
    q = statistics.quantiles(dispatch_ms, n=10) if len(dispatch_ms) > 1 else [0.0] * 9
    return dict(
        clients_in=clients_in, clients=n, fps=fps, seconds=seconds,
        sent=sent, results=results,
        engine_drops=int(st["engine"]["dropped"]),
        kernel_drops=st["transport"]["kernel_drops"] or 0,
        bad_packets=st["transport"]["bad_packets"],
        frames_received=st["frames_received"],
        p50_ms=lat["p50_ms"], p99_ms=lat["p99_ms"],
        latency_samples=min(lat["count"], 1000),
        results_per_s=(r1 - r0) / 2.5,
        batch_sizes=dict(sorted(batch_sizes.items())),
        dispatch_ms_p50=statistics.median(dispatch_ms) if dispatch_ms else 0.0,
        dispatch_ms_p90=q[8],
        busy_ms=busy, wall_ms=wall, idle_share=idle, rcvbuf=rcvbuf,
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    warm_profiler(torch)
    cfg = deployed_config(native_transport=args.native_transport)
    srv = ServerThread(DetectionServer(cfg, device="cuda")).start(warmup=True)
    try:
        load = run_load(torch, srv.server, args.clients_in, args.clients,
                        args.fps, args.seconds)
    finally:
        srv.stop()
    print(json.dumps({"label": args.label,
                      "device": smi.stdout.strip().splitlines()[0],
                      "native_transport": args.native_transport,
                      "load": load}), flush=True)


if __name__ == "__main__":
    main()
