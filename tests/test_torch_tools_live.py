"""The PyTorch port's loopback tools on the CPU: `stream_client`, `loadtest`
and `soak` (`python -m zero_latency_yolo_tpu_torch.<tool> --device cpu`)
against the port's server, with the JAX package's scripts run against the
same server beside them (the wire protocol is the same), so that each
port tool's JSON line carries the JAX script's keys. Short runs, small
frames, simulation mode or yolov8p at 64 px; every port is picked free at
run time, so no two tests share a fixed one."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from torch_fixtures import cpu_threads  # caps torch's threads on import

cv2 = pytest.importorskip("cv2")
pytest.importorskip("torch")

from zero_latency_yolo_tpu_torch.bench_server import ServerThread  # noqa: E402
from zero_latency_yolo_tpu_torch.config import ServerConfig  # noqa: E402
from zero_latency_yolo_tpu_torch.runtime.server import (  # noqa: E402
    DetectionServer)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port(kind=socket.SOCK_DGRAM) -> int:
    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(cmd, timeout=120):
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                       timeout=timeout,
                       env={**os.environ, "PYTHONPATH": REPO,
                            "JAX_PLATFORMS": "cpu",
                            # The tools' processes (and a spawned server)
                            # keep the thread cap of this file's workers.
                            "OMP_NUM_THREADS": str(cpu_threads.THREADS)})
    lines = [json.loads(line) for line in r.stdout.splitlines()
             if line.startswith("{")]
    return r, lines


def _port_tool(tool, *args):
    return [sys.executable, "-m", f"zero_latency_yolo_tpu_torch.{tool}",
            "--device", "cpu", *args]


def _jax_script(name, *args):
    return [sys.executable, os.path.join(REPO, "scripts", f"{name}.py"),
            *args]


@pytest.fixture(scope="module")
def server():
    """The port's server in simulation mode on free loopback ports. Its
    liveness timeout (5 s) outlasts the load test's prime, whose clients
    send nothing while it polls /statusz every 2 s, and frees a session
    whose DISCONNECT the soak's faults ate within the soak's settle."""
    cfg = ServerConfig.from_dict({
        "model_path": "/nonexistent/model.npz",  # simulation mode
        "port": _free_port(), "web_port": _free_port(socket.SOCK_STREAM),
        "max_clients": 8,
        "network": {"timeout_ms": 5000},
        "tpu": {"batch_window_ms": 1.0, "frame_buckets": [[240, 320]],
                "batch_buckets": [1, 2, 4]},
    })
    srv = ServerThread(DetectionServer(cfg, device="cpu")).start(warmup=False)
    yield srv.server
    srv.stop()


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """An 8-frame MJPG clip (64x96) with a moving patch, so the stream
    sends ROI updates between keyframes."""
    path = tmp_path_factory.mktemp("media") / "clip.avi"
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"),
                         10, (96, 64))
    assert vw.isOpened()
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    for i in range(8):
        frame = base.copy()
        frame[10:26, 8 * i:8 * i + 16] = 255
        vw.write(frame)
    vw.release()
    return str(path)


def test_stream_client_matches_jax_client(server, clip):
    """The port's stream client streams the clip (keyframes and ROI
    updates) to the port's server: rc 0, detection lines before a stats
    line with the JAX client's keys, every pushed frame answered or counted
    dropped by the server (the newest frame of a client wins) but the last,
    which may be in flight, and the session gone after its DISCONNECT."""
    args = [clip, "--server", f"127.0.0.1:{server.port}", "--fps", "60",
            "--loop", "--duration", "2", "--print-dets",
            "--keyframe-interval", "4"]
    stats, drops = {}, {}
    for name, cmd in (("port", _port_tool("stream_client", *args)),
                      ("jax", _jax_script("stream_client", *args))):
        before = server.engine.frames_dropped.value
        r, lines = _run(cmd)
        assert r.returncode == 0, r.stderr[-2000:]
        drops[name] = server.engine.frames_dropped.value - before
        stats[name] = lines[-1]
        dets = [d for d in lines[:-1] if "frame_id" in d]
        assert dets and all(set(d) == {"frame_id", "detections"}
                            for d in dets)
        assert server.client_count() == 0
    got = stats["port"]
    assert set(got) == set(stats["jax"])
    assert got["frames_pushed"] > 0 and got["keyframes"] >= 1
    assert got["roi_updates"] >= 1
    assert got["results"] > 0
    assert got["results"] + drops["port"] >= got["frames_pushed"] - 1, (
        got, drops)
    assert got["e2e_p99_ms"] > 0


def test_soak_verdict_matches_jax(server):
    """A short fault-injected soak (2 streams, 5% loss/dup/corrupt) of the
    port's server: the verdict is clean (rc 0) with the JAX soak's keys,
    and the JAX soak against the same server agrees."""
    args = ["--port", str(server.port), "--web-port",
            str(server.config.network.web_port), "--streams", "2",
            "--fps", "20", "--fault", "0.05", "--width", "160",
            "--height", "120"]
    verdicts = {}
    # The JAX soak's streams import their client (and with it JAX) when
    # they start, after the clock started: give them the import's seconds,
    # which run past 7 s on a machine busy with the rest of the suite.
    for name, cmd in (("port", _port_tool("soak", *args, "--duration", "3")),
                      ("jax", _jax_script("soak", *args, "--duration",
                                          "15"))):
        r, lines = _run(cmd)
        assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
        verdicts[name] = lines[-1]
    got = verdicts["port"]
    assert set(got) == set(verdicts["jax"])
    assert set(got["server"]) == set(verdicts["jax"]["server"])
    assert got["clean"] is True and got["streams"] == 2
    assert got["server"]["results_sent_delta"] > 0
    assert got["server"]["clients_left"] == 0


def test_soak_aggregates_a_list_of_web_ports(server):
    """--web-port takes a comma-separated list (a fleet's shards); the
    same shard twice counts its results twice."""
    web = server.config.network.web_port
    r, lines = _run(_port_tool(
        "soak", "--port", str(server.port), "--web-port", f"{web},{web}",
        "--streams", "1", "--duration", "1.5", "--fps", "20", "--fault", "0",
        "--width", "160", "--height", "120"))
    assert r.returncode == 0, r.stderr[-2000:]
    v = lines[-1]
    assert v["clean"] and v["server"]["results_sent_delta"] % 2 == 0


LOAD_ARGS = ["--streams", "2", "--fps", "10", "--duration", "2",
             "--width", "160", "--height", "120", "--bucket-h", "128",
             "--bucket-w", "160", "--client-nice", "0"]


def _load_gates(rep, streams=2):
    assert rep["streams"] == streams and rep["frames_sent"] > 0
    assert rep["results_received"] > 0
    assert rep["frames_sent"] >= (rep["results_received"]
                                  + rep["frames_dropped"]), rep
    assert rep["server_device"] == "cpu"
    # On the CPU every kernel runs its plain version: no launch.
    assert rep["kernel_launches"] and not any(rep["kernel_launches"].values())


@pytest.fixture(scope="module")
def jax_load_keys(server):
    """The keys of the JAX load test's JSON line, run against the port's
    server (`--external`)."""
    r, lines = _run(_jax_script(
        "loadtest", "--external", f"127.0.0.1:{server.port}", "--web-port",
        str(server.config.network.web_port), *LOAD_ARGS))
    assert r.returncode == 0, r.stderr[-2000:]
    return set(lines[-1])


def test_loadtest_spawns_the_port_server(jax_load_keys):
    """The port's load test spawns `python -m
    zero_latency_yolo_tpu_torch.runtime.server --device cpu` on a yolov8p
    model it writes, drives it from its own process and prints the JAX
    script's JSON line (plus the port's fields); every frame sent is a
    result or a counted drop, up to the frames still in flight."""
    r, lines = _run(_port_tool(
        "loadtest", "--variant", "yolov8p", "--size", "64", "--dtype",
        "float32", "--port", str(_free_port()), "--web-port",
        str(_free_port(socket.SOCK_STREAM)), *LOAD_ARGS))
    assert r.returncode == 0, r.stderr[-3000:]
    rep = lines[-1]
    assert jax_load_keys <= set(rep), jax_load_keys - set(rep)
    assert {"server_device", "server_socket", "kernel_launches"} <= set(rep)
    assert rep["metric"] == "live_load_p99" and rep["variant"] == "yolov8p"
    _load_gates(rep)
    assert "server pid=" in r.stderr


def test_loadtest_synthetic_step_against_external_server(server,
                                                         jax_load_keys):
    """--external drives a running server (here the port's, simulation
    mode); --synthetic-step-ms spawns one serving a fake step, and the
    line adds the host-overhead fields."""
    r, lines = _run(_port_tool(
        "loadtest", "--external", f"127.0.0.1:{server.port}", "--web-port",
        str(server.config.network.web_port), *LOAD_ARGS))
    assert r.returncode == 0, r.stderr[-2000:]
    assert set(lines[-1]) == jax_load_keys | {
        "server_device", "server_socket", "kernel_launches"}
    _load_gates(lines[-1])
    r, lines = _run(_port_tool(
        "loadtest", "--synthetic-step-ms", "2", "--port",
        str(_free_port()), "--web-port", str(_free_port(socket.SOCK_STREAM)),
        *LOAD_ARGS))
    assert r.returncode == 0, r.stderr[-3000:]
    rep = lines[-1]
    assert rep["metric"] == "host_path_p99" and rep["synthetic_step_ms"] == 2
    assert rep["host_overhead_p99_ms"] >= 0
    _load_gates(rep)
