"""Live-load p99 measurement of the PyTorch port: N SimClient streams at a
paced FPS against a real server process, reporting the server's OWN latency
counters (the reference instrumented a rolling p99 on the live path,
src/inference/onnx_engine.cpp:428-449; this measures the port's equivalent
under offered load).

    python -m zero_latency_yolo_tpu_torch.loadtest --streams 8 --fps 60 \
        --duration 4 --variant yolov8n --size 416 --dtype bfloat16
    python -m zero_latency_yolo_tpu_torch.loadtest --streams 2 --fps 10 \
        --duration 2 --variant yolov8p --size 64 --device cpu   # CPU smoke

The port's copy of the JAX package's `scripts/loadtest.py`, with the same
arguments, JSON line and exit code, except:

- `--device` (default `cuda`) takes the place of `--platform`. The server is
  `python -m zero_latency_yolo_tpu_torch.runtime.server --config <tmp>
  --device DEVICE`, run from the repository root with this process's
  environment (this process has checked that the device is visible, so the
  server sees it too). Without a CUDA device and without `--device cpu` the
  tool exits with an error.
- The model file is the port's `init_params` (seed 0, folded) written by
  its `save_params`.
- `frames_dropped` counts the drops of the timed window, as
  `results_received` counts its results (the JAX script reports the
  server's drops since it started).
- The JSON line adds `server_device` (the engine's device in `/statusz`),
  `server_socket` (the server socket's own receive overflows, the kernel's
  drops at its socket and the machine's `Udp.RcvbufErrors` over the timed
  window, each null where the host gives no such count) and
  `kernel_launches` (each kernel's launches in the server process over the
  timed window, from `/statusz` `kernel_launches`).

Every `/statusz` field read here has the same name in the port's server as
in the JAX server.

The clients run in this process, apart from the server: clients in the
server's process share its GIL and slow its batcher. The client process is
deliberately lean: ROI payload bytes are encoded once and resent (packet
headers rebuilt per send so frame ids/CRC stay valid); JPEG encode never runs
on the paced path. `--synthetic-step-ms`, `--synthetic-profile` and
`--adaptive-profiles` serve from the engine's fake device step (no model).
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

from .utils.device import require_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_config(args, model_path: str) -> dict:
    return {
        "model_path": model_path,
        "port": args.port,
        "web_port": args.web_port,
        "max_clients": args.streams,
        "target_fps": args.fps,
        "max_queue_size": 8,
        "worker_threads": 1,
        "confidence_threshold": 0.5,
        "nms_threshold": 0.45,
        # Liveness timeout far above a cold start (process, CUDA context,
        # the kernels' load, warmup): an eviction during the prime purges
        # the client's queue and cache slot and zeroes the measurement
        # (clients don't heartbeat during the wait).
        # Native recvmmsg/sendmmsg transport: the production tier for
        # 64-stream rates (CRC+ACK in C++, one sendmmsg per result batch).
        "network": {"timeout_ms": 600000, "use_native_transport": True},
        "detection": {"model_width": args.size, "model_height": args.size},
        "tpu": {
            "variant": args.variant,
            "num_classes": 4,
            "dtype": args.dtype,
            "batch_buckets": sorted({max(1, args.streams // 2), args.streams}),
            "frame_buckets": [[args.bucket_h, args.bucket_w]],
            "batch_window_ms": args.window_ms,
            "preprocess": "letterbox_mxu",
            "max_inflight": args.max_inflight,
            # > 0: fixed-duration fake device step — measures the ENTIRE
            # host path under load without the device.
            "synthetic_step_ms": args.synthetic_step_ms,
            # Measured per-bucket step ladder.
            "synthetic_step_profile": json.loads(args.synthetic_profile)
            if args.synthetic_profile else {},
            # Per-size ladders + the REAL adaptive policy:
            # {"416": {...}, "320": {...}} with an SLO.
            # (args.adaptive_profiles is parsed once in main.)
            "synthetic_step_profiles": args.adaptive_profiles or {},
            "serve_sizes": ([int(s) for s in args.adaptive_profiles]
                            if args.adaptive_profiles else []),
            "adaptive_slo_ms": (args.adaptive_slo
                                if args.adaptive_profiles else 0.0),
            # > 0: server->client AIMD rate control over CONFIG_UPDATE —
            # the Stream pacing loop honors the broadcast hints.
            "rate_control_slo_ms": args.rate_control_slo,
            "rate_control_min_fps": args.rate_control_min_fps,
            # Host-tail A/B knobs (utils/gcstats.py): library default unless
            # explicitly forced on/off from the CLI.
            **({"gc_tune": args.gc_tune == "on"}
               if args.gc_tune != "default" else {}),
            "gil_switch_interval_ms": args.switch_interval_ms,
        },
    }


def make_model(args, path: str) -> None:
    from .models.weights import save_params
    from .models.yolov8 import get_spec, init_params
    spec = get_spec(args.variant, 4)
    save_params(init_params(0, spec, folded=True), path)


def wait_statusz(url: str, timeout: float) -> dict:
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(url, timeout=5) as r:
                return json.loads(r.read())
        except Exception as e:  # noqa: BLE001
            last = e
            time.sleep(1.0)
    raise TimeoutError(f"statusz not up: {last}")


def wait_warm(url: str, timeout: float) -> None:
    """Block until the engine finished warmup (every step of its buckets run
    once: the kernels' build or load, cuDNN's first calls)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = wait_statusz(url, 30)
        if st["engine"].get("warmed") == "true":
            return
        time.sleep(2.0)
    raise TimeoutError("engine warmup did not finish")


class Stream:
    """One paced client stream resending a pre-encoded ROI payload."""

    def __init__(self, idx, args, payload, keyframe_px):
        from .runtime.simulator import SimClient
        self.idx = idx
        self.args = args
        self.payload = payload
        self.keyframe_px = keyframe_px
        self.client = SimClient((getattr(args, "host", "127.0.0.1"),
                                 args.port),
                                screen_width=args.width,
                                screen_height=args.height)
        self.sent = 0
        self.errors = 0
        self.rate_hint = None  # last server rate-control hint honored

    def connect_and_prime(self):
        self.client.connect()
        self.client.start_receiver()
        self.client.send_jpeg_keyframe(self.keyframe_px, quality=80)

    def run(self, start_t, end_t):
        c = self.client
        period = 1.0 / self.args.fps
        # Desynchronize stream phases so sends spread across the window.
        next_t = start_t + (self.idx % 16) * (period / 16.0)
        while True:
            now = time.perf_counter()
            if now >= end_t:
                return
            if next_t > now:
                time.sleep(next_t - now)
            try:
                c._send_frame(self.payload, self.args.width, self.args.height,
                              keyframe=False)
                self.sent += 1
            except OSError:
                self.errors += 1
            # Honor server rate control (CONFIG_UPDATE target_fps): capped
            # by our own configured fps, floored at 1 (dict .get is
            # GIL-atomic against the rx thread's update).
            hint = c.server_settings.get("target_fps")
            if hint:
                period = 1.0 / max(min(self.args.fps, float(hint)), 1.0)
                self.rate_hint = float(hint)
            next_t += period
            if next_t < time.perf_counter() - 0.5:
                next_t = time.perf_counter()  # don't spiral after a stall


def _transport_counts(st: dict) -> dict:
    """The server socket's drop counters in a /statusz body (None where the
    host gives no such count)."""
    tr = st.get("transport") or {}
    udp = tr.get("system_udp") or {}
    return {"rx_overflows": tr.get("rx_overflows"),
            "kernel_drops": tr.get("kernel_drops"),
            "system_udp_rcvbuf_errors": udp.get("RcvbufErrors")}


def _delta(after: dict, before: dict) -> dict:
    return {k: (after[k] - before[k] if isinstance(after.get(k), int)
                and isinstance(before.get(k), int) else None)
            for k in after}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--fps", type=float, default=60.0)
    ap.add_argument("--duration", type=float, default=15.0)
    ap.add_argument("--variant", default="yolov8n")
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--bucket-h", type=int, default=608)
    ap.add_argument("--bucket-w", type=int, default=800)
    ap.add_argument("--roi", type=int, default=16,
                    help="square ROI update edge (px)")
    ap.add_argument("--window-ms", type=float, default=1.0)
    ap.add_argument("--port", type=int, default=47788)
    ap.add_argument("--web-port", type=int, default=43000)
    ap.add_argument("--device", default="cuda",
                    help="the server's torch device (default cuda; cpu runs "
                         "every kernel's plain PyTorch version)")
    ap.add_argument("--external", default="",
                    help="host:port of an already-running server (skip spawn)")
    ap.add_argument("--warmup-timeout", type=float, default=900.0)
    ap.add_argument("--max-inflight", type=int, default=4)
    ap.add_argument("--synthetic-step-ms", type=float, default=0.0,
                    help="replace device compute with a fixed fake step of "
                         "this duration: isolates the host path (use the "
                         "measured step of the card)")
    ap.add_argument("--synthetic-profile", default="",
                    help='measured per-bucket step ladder as JSON, e.g. '
                         '\'{"8": 3.1, "32": 6.44}\'; implies synthetic mode')
    ap.add_argument("--adaptive-profiles", default="",
                    help='per-serve-size measured ladders as JSON, e.g. '
                         '\'{"416": {"32": 6.4}, "320": {"32": 4.0}}\' — '
                         'runs the REAL adaptive-resolution policy over '
                         'them (implies synthetic mode)')
    ap.add_argument("--adaptive-slo", type=float, default=8.0,
                    help="adaptive policy SLO ms (with --adaptive-profiles)")
    ap.add_argument("--rate-control-slo", type=float, default=0.0,
                    help="> 0: server->client AIMD rate control SLO (ms); "
                         "streams honor the CONFIG_UPDATE fps hints")
    ap.add_argument("--rate-control-min-fps", type=int, default=15)
    ap.add_argument("--gc-tune", choices=("default", "on", "off"),
                    default="default",
                    help="force the server's tpu.gc_tune posture (A/B)")
    ap.add_argument("--switch-interval-ms", type=float, default=0.0,
                    help="server tpu.gil_switch_interval_ms (0 = interpreter"
                         " default 5 ms)")
    ap.add_argument("--client-nice", type=int, default=10,
                    help="niceness ADDED to this (client) process so the "
                         "server wins the CPU on small co-located hosts; "
                         "the spawned server re-nices itself -10 on top "
                         "(0 disables)")
    args = ap.parse_args(argv)
    require_device(args.device, "loadtest")
    if args.synthetic_profile and args.synthetic_step_ms <= 0:
        args.synthetic_step_ms = max(
            float(v) for v in json.loads(args.synthetic_profile).values())
    args.adaptive_profiles = (json.loads(args.adaptive_profiles)
                              if args.adaptive_profiles else {})
    if args.adaptive_profiles and args.synthetic_step_ms <= 0:
        args.synthetic_step_ms = max(
            float(v) for prof in args.adaptive_profiles.values()
            for v in prof.values())

    tmp = tempfile.mkdtemp(prefix="zlt-loadtest-")
    proc = None
    if not args.external:
        model_path = os.path.join(tmp, "model.npz")
        if args.synthetic_step_ms > 0:
            model_path = os.path.join(tmp, "no-model-synthetic.npz")
        else:
            make_model(args, model_path)
        cfg_path = os.path.join(tmp, "server.json")
        with open(cfg_path, "w") as f:
            json.dump(build_config(args, model_path), f)
        env = dict(os.environ)
        cmd = [sys.executable, "-u", "-m",
               "zero_latency_yolo_tpu_torch.runtime.server", "--config",
               cfg_path, "--device", args.device]
        proc = subprocess.Popen(
            cmd, cwd=REPO,
            stdout=open(os.path.join(tmp, "server.log"), "w"),
            stderr=subprocess.STDOUT, env=env)
        print(f"# server pid={proc.pid} log={tmp}/server.log", file=sys.stderr)
    else:
        host, port = args.external.rsplit(":", 1)
        args.port = int(port)
        args.host = host or "127.0.0.1"
    if args.client_nice > 0:
        # The pacing/receiver threads otherwise steal scheduler slots from
        # the server under test on a small host — the measurement should
        # show the SERVER's path, not contention from its own harness.
        # AFTER the spawn: the server child must not inherit this niceness
        # (an unprivileged server can't re-nice itself back down).
        try:
            os.nice(args.client_nice)
        except OSError:
            pass

    statusz = (f"http://{getattr(args, 'host', '127.0.0.1')}:"
               f"{args.web_port}/statusz")
    try:
        wait_statusz(statusz, 120)
        wait_warm(statusz, args.warmup_timeout)
        print("# engine warm", file=sys.stderr)

        from .protocol import build_roi_header
        from .runtime.frames import encode_jpeg
        from .runtime.simulator import synthetic_frame

        frame_px = synthetic_frame(args.width, args.height)
        region = frame_px[:args.roi, :args.roi]
        payload = (build_roi_header(8, 8, args.roi, args.roi, args.width)
                   + encode_jpeg(region, 80))

        streams = [Stream(i, args, payload, frame_px)
                   for i in range(args.streams)]
        for s in streams:
            s.connect_and_prime()
        # Drain the prime phase BEFORE timing: every keyframe must be
        # uploaded to the device cache and served. Measuring from here
        # isolates steady-state ROI serving.
        deadline = time.monotonic() + 300.0
        base_results = 0
        stable_since = None
        while time.monotonic() < deadline:
            base = wait_statusz(statusz, 30)
            n = sum(int(v["results"]) for v in base["sessions"].values())
            if n >= args.streams:
                base_results = n
                break
            # Fleet mode: one SO_REUSEPORT shard's statusz only
            # ever sees ITS share of the streams, so the absolute threshold
            # never fires — treat a count that stopped growing for 10 s as
            # drained instead of burning the whole 300 s deadline per rung.
            if n == base_results and n > 0:
                if stable_since is None:
                    stable_since = time.monotonic()
                elif time.monotonic() - stable_since >= 10.0:
                    break
            else:
                stable_since = None
            base_results = n
            time.sleep(2.0)
        print(f"# prime drained: {base_results} keyframe results",
              file=sys.stderr)
        # Client-side latency samples recorded so far belong to the prime
        # phase (keyframe results that waited through the cold first
        # steps); the timed window must start clean or they dominate
        # client_e2e_p99.
        for s in streams:
            s.client.reset_latency_stats()
        st0 = wait_statusz(statusz, 30)

        start_t = time.perf_counter() + 0.5
        end_t = start_t + args.duration
        threads = [threading.Thread(target=s.run, args=(start_t, end_t),
                                    daemon=True) for s in streams]
        from .utils.stats import cpu_times, steal_pct
        steal0 = cpu_times()
        t_wall0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        time.sleep(1.0)  # drain tail results
        wall = time.perf_counter() - t_wall0 - 0.5 - 1.0
        steal_now = steal_pct(steal0, cpu_times())

        st = wait_statusz(statusz, 30)
        total_sent = sum(s.sent for s in streams)
        total_results = sum(int(v["results"])
                            for v in st["sessions"].values()) - base_results
        lat = np.concatenate([
            np.asarray(s.client.result_latencies_ms, np.float64)
            for s in streams if s.client.result_latencies_ms
        ]) if any(s.client.result_latencies_ms for s in streams) else np.array([])
        for s in streams:
            s.client.stop()

        report = {
            "metric": ("host_path_p99" if args.synthetic_step_ms > 0
                       else "live_load_p99"),
            "synthetic_step_ms": args.synthetic_step_ms or None,
            "streams": args.streams,
            "fps_per_stream": args.fps,
            "duration_s": round(wall, 2),
            "variant": args.variant,
            "model_size": args.size,
            "frames_sent": total_sent,
            "offered_fps": round(total_sent / wall, 1),
            "results_received": int(total_results),
            "served_fps": round(total_results / wall, 1),
            "server_detect_avg_ms": st["detect_latency"].get("avg_ms"),
            "server_detect_p99_ms": st["detect_latency"].get("p99_ms"),
            # Hypervisor CPU steal over the timed window: steal inflates the
            # p99 on a shared VM — without this field, inflated rows look
            # like regressions.
            "cpu_steal_pct": steal_now,
            "engine_pipeline_p99_ms": float(st["engine"]["pipeline_p99_ms"]),
            "engine_e2e_p99_ms": float(st["engine"]["e2e_p99_ms"]),
            "engine_avg_batch": float(st["engine"]["avg_batch"]),
            # The timed window's drops (st0: read just before it), so that
            # frames_sent >= results_received + frames_dropped holds against
            # a server that ran before (--external).
            "frames_dropped": (int(st["engine"]["dropped"])
                               - int(st0["engine"]["dropped"])),
            "rate_control": (st.get("rate_control") and {
                "hint_fps": st["rate_control"].get("hint_fps"),
                "updates_sent": st["rate_control"].get("updates_sent"),
                # Throttled = last hint below the SERVER's full rate (the
                # value restores broadcast): against an external server,
                # target_fps may differ from our --fps, so compare with the
                # server's own number, not the harness's.
                "clients_honoring": sum(
                    1 for s in streams
                    if s.rate_hint is not None and s.rate_hint < float(
                        st["rate_control"].get("target_fps") or args.fps)),
            }),
            "client_e2e_p50_ms": round(float(np.percentile(lat, 50)), 2)
            if lat.size else None,
            "client_e2e_p99_ms": round(float(np.percentile(lat, 99)), 2)
            if lat.size else None,
            "client_samples": int(lat.size),
            "server_device": st["engine"].get("device"),
            "server_socket": _delta(_transport_counts(st),
                                    _transport_counts(st0)),
            "kernel_launches": ({
                k: int(v) - int(st0["kernel_launches"].get(k, 0))
                for k, v in st["kernel_launches"].items()}
                if st.get("kernel_launches") else None),
        }
        if args.synthetic_step_ms > 0:
            # Everything the HOST adds around each batch's (fake) step:
            # decode wait + batch window + lane queueing + completion —
            # measured per-request by the engine (e2e minus that batch's
            # own step; correct under a per-bucket step profile too).
            eng = st["engine"]
            report["host_overhead_avg_ms"] = float(
                eng.get("synthetic_host_avg_ms", "nan"))
            report["host_overhead_p99_ms"] = float(
                eng.get("synthetic_host_p99_ms", "nan"))
        if st.get("host_gc"):
            # GC pause pressure during the run (utils/gcstats.py): the
            # host-tail A/B's explanatory variable next to the p99 it moves.
            report["gc_pause_p99_ms"] = st["host_gc"].get("pause_p99_ms")
            report["gc_pause_max_ms"] = st["host_gc"].get("pause_max_ms")
            report["gc_pause_total_ms"] = st["host_gc"].get("pause_total_ms")
            report["gc_collections"] = (
                int(st["host_gc"].get("collections_g0", 0))
                + int(st["host_gc"].get("collections_g1", 0))
                + int(st["host_gc"].get("collections_g2", 0)))
        if args.adaptive_profiles:
            eng = st["engine"]
            report["serve_size"] = int(eng.get("serve_size", 0))
            report["size_downshifts"] = int(eng.get("size_downshifts", 0))
            report["size_upshifts"] = int(eng.get("size_upshifts", 0))
            report["adaptive_slo_ms"] = args.adaptive_slo
        print(json.dumps(report))
    finally:
        if proc is not None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()


if __name__ == "__main__":
    main()
