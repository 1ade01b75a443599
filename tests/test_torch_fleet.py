"""The port's SO_REUSEPORT fleet manager (`python -m
zero_latency_yolo_tpu_torch.serve_fleet`), on the CPU: the cheap cases of
tests/test_fleet.py against the port's copy of scripts/serve_fleet.py
(config derivation and its defaults, the canary derivation and CLI
checks, the restart budget, the core-pin wrap, the rolling restart with
stub shards and its aborts, the /proc health check), then real managers
with port shards on `--device cpu`: two shards serving on one port, one
zero-downtime SIGHUP roll under streaming clients, and a SIGHUP that
re-reads the config. Ports are picked free at run time."""

import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

pytest.importorskip("torch")

from zero_latency_yolo_tpu_torch import serve_fleet as fleet  # noqa: E402
from zero_latency_yolo_tpu_torch.config import ServerConfig  # noqa: E402
from zero_latency_yolo_tpu_torch.runtime.simulator import (  # noqa: E402
    SimClient, StreamDriver, synthetic_frame)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port(kind=socket.SOCK_DGRAM) -> int:
    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_fleet_shard_config_derivation():
    """Derivation on the NORMALIZED config: every shard on the fleet port
    with reuse_port, web_port + shard, per-shard log and stats files,
    cpu_core_id + shard; a disabled dashboard stays disabled; the base dict
    is not mutated."""
    base = {
        "port": 7788,
        "web_port": 8080,
        "use_cpu_affinity": True,
        "cpu_core_id": 2,
        "logging": {"log_file": "logs/server.log"},
        "analytics": {"stats_file": "logs/stats.json"},
    }
    l0 = ServerConfig.from_dict(fleet.derive_shard_config(base, 0, ncpu=8))
    l1 = ServerConfig.from_dict(fleet.derive_shard_config(base, 1, ncpu=8))
    for cfg in (l0, l1):
        assert cfg.network.reuse_port is True
        assert cfg.network.port == 7788
    assert (l0.network.web_port, l1.network.web_port) == (8080, 8081)
    assert l0.logging.log_file == "logs/server-0.log"
    assert l1.logging.log_file == "logs/server-1.log"
    assert l1.analytics.stats_file == "logs/stats-1.json"
    assert (l0.cpu_core_id, l1.cpu_core_id) == (2, 3)
    assert ServerConfig.from_dict(fleet.derive_shard_config(
        {"web_port": 0}, 1, ncpu=8)).network.web_port == 0
    assert base["logging"]["log_file"] == "logs/server.log"


def test_fleet_defaults_shard_cleanly():
    """An empty base config (all server defaults) derives shards that do
    not collide: cores, stats files, log files and web ports differ, from
    the default web port up."""
    l0 = ServerConfig.from_dict(fleet.derive_shard_config({}, 0, ncpu=8))
    l1 = ServerConfig.from_dict(fleet.derive_shard_config({}, 1, ncpu=8))
    assert l0.cpu_core_id != l1.cpu_core_id
    assert l0.analytics.stats_file != l1.analytics.stats_file
    assert l0.logging.log_file != l1.logging.log_file
    assert l0.network.web_port != l1.network.web_port
    assert l0.network.web_port == ServerConfig().network.web_port


def test_fleet_core_pin_wraps_within_host_cpus(capsys):
    base = {"use_cpu_affinity": True, "cpu_core_id": 1}
    cores = [ServerConfig.from_dict(fleet.derive_shard_config(
        base, s, ncpu=2)).cpu_core_id for s in range(3)]
    assert cores == [1, 0, 1]
    assert "wrapping" in capsys.readouterr().err


def test_restart_budget_rolling_window():
    clock = {"t": 0.0}
    b = fleet.RestartBudget(max_restarts=3, window_s=300.0,
                            now=lambda: clock["t"])
    assert all(b.allow(0) for _ in range(3))
    assert not b.allow(0)
    assert b.allow(1)               # per-shard budgets
    clock["t"] = 301.0
    assert b.allow(0)               # the window rolled
    clock["t"] = 302.0
    assert b.allow(0) and b.allow(0)
    assert not b.allow(0)


def test_fleet_canary_model_derivation():
    base = {"model_path": "models/base.npz", "web_port": 8080}
    l0 = ServerConfig.from_dict(fleet.derive_shard_config(base, 0, ncpu=8))
    l1 = ServerConfig.from_dict(fleet.derive_shard_config(
        base, 1, ncpu=8, model_path="models/candidate.npz"))
    assert l0.model_path == "models/base.npz"
    assert l1.model_path == "models/candidate.npz"
    assert l1.network.web_port == 8081
    assert base["model_path"] == "models/base.npz"


def _run_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "zero_latency_yolo_tpu_torch.serve_fleet",
         *args], cwd=REPO, capture_output=True, text=True, timeout=120)


def test_fleet_canary_and_device_env_cli_validation(tmp_path):
    """Misconfigurations fail before any shard spawns: no baseline shard
    left, a missing canary artifact, a --device-env without '='."""
    model = tmp_path / "cand.npz"
    model.write_bytes(b"x")
    r = _run_cli("--shards", "2", "--canary-shards", "2",
                 "--canary-model", str(model))
    assert r.returncode == 2 and "baseline" in r.stderr
    r = _run_cli("--shards", "2", "--canary-model", str(tmp_path / "no.npz"))
    assert r.returncode == 2 and "does not exist" in r.stderr
    r = _run_cli("--device-env", "CUDA_VISIBLE_DEVICES")
    assert r.returncode == 2 and "NAME=VALUE" in r.stderr


class _FakeFleet:
    """Stub shards (alive and healthy flags) and a manual clock."""

    def __init__(self, n):
        self.t = 0.0
        self.shards = [{"alive": True, "healthy": True, "gen": 0}
                       for _ in range(n)]
        self.log_lines = []
        self.kills = []

    def roller(self, **kw):
        return fleet.RollingRestarter(
            len(self.shards),
            stop_shard=lambda i: self.shards[i].update(stopping=True),
            kill_shard=lambda i: (self.kills.append(i),
                                  self.shards[i].update(alive=False)),
            respawn=lambda i: self.shards[i].update(
                alive=True, healthy=False, stopping=False,
                gen=self.shards[i]["gen"] + 1),
            is_alive=lambda i: self.shards[i]["alive"],
            healthy=lambda i: self.shards[i]["healthy"],
            log=self.log_lines.append,
            now=lambda: self.t, **kw)


def test_rolling_restart_one_shard_at_a_time():
    f = _FakeFleet(3)
    r = f.roller()
    r.request()
    assert r.active
    r.tick()
    assert f.shards[0].get("stopping") and not f.shards[1].get("stopping")
    assert r.expects_exit(0) and not r.expects_exit(1)
    f.shards[0]["alive"] = False
    r.tick()                                  # respawn 0
    assert f.shards[0]["gen"] == 1 and f.shards[0]["alive"]
    r.tick()                                  # warming
    assert not f.shards[1].get("stopping")
    f.shards[0]["healthy"] = True
    r.tick()
    r.tick()                                  # drains shard 1
    assert f.shards[1].get("stopping")
    for i in (1, 2):
        f.shards[i]["alive"] = False
        r.tick()
        f.shards[i]["healthy"] = True
        r.tick()
        r.tick()
    assert [s["gen"] for s in f.shards] == [1, 1, 1]
    assert not r.active
    assert any("complete" in m for m in f.log_lines)
    r.request()
    r.tick()
    r.request()
    assert any("ignored" in m for m in f.log_lines)


def test_rolling_restart_kills_shard_that_ignores_sigterm():
    f = _FakeFleet(2)
    r = f.roller(drain_grace_s=10.0)
    r.request()
    r.tick()
    f.t = 11.0
    r.tick()
    assert f.kills == [0]
    r.tick()
    assert f.shards[0]["gen"] == 1


def test_rolling_restart_aborts_on_unhealthy_replacement():
    """A replacement that never turns healthy is killed and aborts the
    roll; the other shards keep their old generation."""
    f = _FakeFleet(3)
    r = f.roller(warm_grace_s=30.0)
    r.request()
    r.tick()
    f.shards[0]["alive"] = False
    r.tick()
    f.t = 31.0
    r.tick()
    assert not r.active and f.kills == [0]
    assert f.shards[1]["gen"] == 0 and f.shards[2]["gen"] == 0
    assert any("ABORTED" in m for m in f.log_lines)


def test_rolling_restart_aborts_when_replacement_dies():
    f = _FakeFleet(2)
    r = f.roller()
    r.request()
    r.tick()
    f.shards[0]["alive"] = False
    r.tick()
    f.shards[0]["alive"] = False              # the replacement crashes
    r.tick()
    assert not r.active and not r.expects_exit(0)
    assert f.shards[1]["gen"] == 0


def test_rolling_restart_abort_mid_roll_clears_active():
    for phase in ("queued", "stopping", "warming"):
        f = _FakeFleet(3)
        r = f.roller()
        r.request()
        if phase in ("stopping", "warming"):
            r.tick()
        if phase == "warming":
            f.shards[0]["alive"] = False
            r.tick()
        assert r.active
        r.abort()
        assert not r.active and not r.expects_exit(0), phase


def test_pid_bound_to_udp_port_sees_real_sockets():
    if not os.path.isdir(f"/proc/{os.getpid()}/fd"):
        pytest.skip("no /proc on this platform")
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        assert fleet.pid_bound_to_udp_port(os.getpid(), port)
        assert not fleet.pid_bound_to_udp_port(os.getpid(), 1)
    finally:
        s.close()
    assert not fleet.pid_bound_to_udp_port(os.getpid(), port)


# ------------------------------------------------ real managers, CPU shards

def _write_cfg(path, port, web, model="/nonexistent/model.npz", **extra):
    d = os.path.dirname(path)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({
            "model_path": model, "port": port, "web_port": web,
            "max_clients": 8, "use_cpu_affinity": False,
            "logging": {"log_file": os.path.join(d, "server.log")},
            "analytics": {"stats_file": os.path.join(d, "stats.json")},
            "network": {"timeout_ms": 4000},
            "tpu": {"batch_window_ms": 1.0, "frame_buckets": [[128, 128]],
                    "batch_buckets": [1, 2, 4]},
            **extra}, f)


class _Manager:
    """A serve_fleet manager process on --device cpu, its output in a log."""

    def __init__(self, tmp_path, cfg_path, *args):
        self.log_path = str(tmp_path / "fleet.log")
        with open(self.log_path, "w", encoding="utf-8") as logf:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "zero_latency_yolo_tpu_torch.serve_fleet",
                 "--config", cfg_path, "--device", "cpu",
                 "--status-interval", "0", *args],
                cwd=REPO, stdout=logf, stderr=subprocess.STDOUT)

    def text(self):
        with open(self.log_path, encoding="utf-8", errors="replace") as f:
            return f.read()

    def pids(self):
        return [int(m) for m in re.findall(r"shard \d+: pid=(\d+)",
                                           self.text())]

    def stop(self):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout=40.0)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=10)
            raise AssertionError("fleet manager ignored SIGTERM")


def _statusz(web):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{web}/statusz",
                                    timeout=2) as r:
            return json.loads(r.read())
    except (OSError, ValueError):
        return None


def _connect_clients(port, n, deadline_s=90.0):
    clients = []
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline and len(clients) < n:
        c = SimClient(("127.0.0.1", port), screen_width=96, screen_height=64)
        try:
            c.connect()
        except Exception:  # noqa: BLE001 — a shard still booting
            c.sock.close()
            time.sleep(0.5)
            continue
        c.start_receiver()
        clients.append(c)
    return clients


def test_two_port_shards_share_one_port_and_serve_on_cpu(tmp_path):
    """A manager with two port shards on --device cpu: both shards answer
    /statusz (web_port + shard) with their engine on the CPU, hold the one
    UDP port, and every client is served; the clients' sessions split
    over the shards and account for all of them; SIGTERM stops the fleet
    with rc 0 and no shard left behind."""
    port, web = _free_port(), _free_port(socket.SOCK_STREAM)
    while web + 1 == port:
        web = _free_port(socket.SOCK_STREAM)
    cfg = str(tmp_path / "server.json")
    _write_cfg(cfg, port, web)
    mgr = _Manager(tmp_path, cfg, "--shards", "2")
    clients = []
    try:
        deadline = time.monotonic() + 90.0
        st = [None, None]
        while time.monotonic() < deadline and not all(st):
            st = [_statusz(web), _statusz(web + 1)]
            time.sleep(0.5)
        assert all(st), f"shards never answered: {mgr.text()[-2000:]}"
        for s in st:
            assert s["port"] == port and s["engine"]["device"] == "cpu"
        clients = _connect_clients(port, 6)
        assert len(clients) == 6, mgr.text()[-2000:]
        for i, c in enumerate(clients):
            fid = c.send_raw_frame(synthetic_frame(96, 64, seed=i))
            got = c.wait_results(1, timeout=20.0)
            assert got and got[0].frame_id == fid, f"client {i} not served"
        per = [_statusz(web)["clients"], _statusz(web + 1)["clients"]]
        assert sum(per) == len(clients), per
    finally:
        for c in clients:
            c.stop()
        rc = mgr.stop()
    assert rc == 0, mgr.text()[-2000:]
    for pid in mgr.pids():
        assert not os.path.isdir(f"/proc/{pid}"), f"orphan shard {pid}"


def test_rolling_restart_e2e_zero_downtime(tmp_path):
    """SIGHUP on a real manager with two port shards (simulation, CPU):
    both shards respawn one at a time onto new pids while four streams
    keep pushing; every stream re-handshakes at least once and keeps
    getting results after the roll; SIGTERM exits rc 0 with no orphan."""
    pytest.importorskip("cv2")
    port = _free_port()
    cfg = str(tmp_path / "server.json")
    _write_cfg(cfg, port, 0)
    mgr = _Manager(tmp_path, cfg, "--shards", "2", "--roll-warm-grace", "90",
                   "--roll-drain-grace", "10")
    clients = []
    try:
        clients = _connect_clients(port, 4)
        assert len(clients) == 4, f"fleet never served: {mgr.text()[-2000:]}"
        drivers = [StreamDriver(c, keyframe_interval=8) for c in clients]
        deadline, t = time.monotonic() + 30.0, 0
        while time.monotonic() < deadline and not all(c.results
                                                      for c in clients):
            for d in drivers:
                d.push(synthetic_frame(96, 64, seed=2, t=t * 0.3))
            t += 1
            time.sleep(0.3)
        assert all(c.results for c in clients), "no results before the roll"
        boot = mgr.pids()
        assert len(boot) == 2
        mgr.proc.send_signal(signal.SIGHUP)
        deadline = time.monotonic() + 150.0
        while time.monotonic() < deadline:
            for d in drivers:
                d.push(synthetic_frame(96, 64, seed=2, t=time.monotonic()))
            if "rolling restart complete" in mgr.text():
                break
            time.sleep(0.1)
        else:
            raise AssertionError(f"roll never completed: {mgr.text()[-2000:]}")
        pids = mgr.pids()
        assert len(pids) == 4 and set(pids[2:]).isdisjoint(boot)
        before = [len(c.results) for c in clients]
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            for d in drivers:
                d.push(synthetic_frame(96, 64, seed=2, t=time.monotonic()))
            if all(len(c.results) > b + 2 for c, b in zip(clients, before)):
                break
            time.sleep(0.1)
        assert all(len(c.results) > b for c, b in zip(clients, before)), (
            "a stream starved after the roll")
        assert all(d.rehandshakes >= 1 for d in drivers)
    finally:
        for c in clients:
            try:
                c.stop()
            except OSError:
                pass
        rc = mgr.stop()
    assert rc == 0, mgr.text()[-2000:]
    for pid in mgr.pids():
        assert not os.path.isdir(f"/proc/{pid}"), f"orphan shard {pid}"


def test_sighup_rereads_config_before_the_roll(tmp_path):
    """SIGHUP re-reads --config: the respawned shard serves the model the
    edited config names (simulation files, told apart by name in
    /statusz)."""
    port, web = _free_port(), _free_port(socket.SOCK_STREAM)
    cfg = str(tmp_path / "server.json")
    _write_cfg(cfg, port, web, model=str(tmp_path / "a.npz"))
    mgr = _Manager(tmp_path, cfg, "--shards", "1", "--roll-warm-grace", "90",
                   "--roll-drain-grace", "10")
    try:
        deadline, st = time.monotonic() + 90.0, None
        while time.monotonic() < deadline and not st:
            st = _statusz(web)
            time.sleep(0.5)
        assert st, f"shard never answered: {mgr.text()[-2000:]}"
        assert st["engine"]["model_file"] == "a.npz"
        _write_cfg(cfg, port, web, model=str(tmp_path / "b.npz"))
        mgr.proc.send_signal(signal.SIGHUP)
        deadline = time.monotonic() + 120.0
        while (time.monotonic() < deadline
               and "rolling restart complete" not in mgr.text()):
            time.sleep(0.5)
        assert "rolling restart complete" in mgr.text(), mgr.text()[-2000:]
        assert "config reloaded" in mgr.text()
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            st = _statusz(web)
            if st and st["engine"]["model_file"] == "b.npz":
                break
            time.sleep(0.5)
        assert st and st["engine"]["model_file"] == "b.npz", st
    finally:
        assert mgr.stop() == 0, mgr.text()[-2000:]
