"""Launch N detection-server shards of the PyTorch port on ONE UDP port
(an SO_REUSEPORT fleet).

    python -m zero_latency_yolo_tpu_torch.serve_fleet --config FILE \
        [--shards 2] [--device cpu] \
        [--device-env 'CUDA_VISIBLE_DEVICES={shard}'] \
        [--canary-model models/candidate.npz [--canary-shards 1]]

The port's copy of the JAX package's `scripts/serve_fleet.py`, with the same
derivation, canary, restart budget, signal forwarding and SIGHUP rolls. Each
shard is `python -m zero_latency_yolo_tpu_torch.runtime.server --config
<derived> [--device DEVICE]` (`--device` takes the place of the JAX
script's `--platform`), run from the repository root.

The kernel flow-hashes clients across the shard group (sticky per
4-tuple), so every client keeps talking to one shard for its whole session:
sessions, trackers and the device frame cache stay process-local with no
cross-shard coordination. Each shard is its own process (its own GIL,
decode workers and event loop); `--device-env 'CUDA_VISIBLE_DEVICES={shard}'`
gives each shard its own card, and without it the shards share the visible
cards (each shard its own CUDA context).

Derived per shard from the base config (after normalizing it through
ServerConfig, so defaults apply): network.reuse_port=true (and no port+1
fallback), web_port+shard (0 stays 0), log_file-<shard>,
stats_file-<shard>, cpu_core_id+shard (when use_cpu_affinity, wrapped
within the host's cores).

Canary rollout: --canary-model makes the LAST K shards serve a candidate
artifact while the rest keep the base model; flow hashing is sticky per
client socket, so about K/N of clients ride the candidate for their whole
session. Compare cohorts on each shard's own /statusz (web_port+shard).

Signals: SIGTERM/SIGINT stop the fleet (graceful drain). SIGHUP performs a
zero-downtime rolling restart, one shard at a time: drain, respawn, wait
healthy (its /statusz answers with its engine warmed, or without a
dashboard port it holds the fleet's UDP port), next; a replacement that
dies or never turns healthy aborts the roll. SIGHUP also re-reads --config
before rolling; a reload that fails to validate or moves network.port is
refused and the roll proceeds on the boot-time derivation. A shard's cold
boot (process start, CUDA context, kernel library load or build, weights,
warmup) counts against --roll-warm-grace; shards that start together may both build the
kernels (`ops/_build.py` installs the library atomically).
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import urllib.request

from .config import ServerConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def derive_shard_config(base: dict, shard: int, ncpu: int = None,
                        model_path: str = None) -> dict:
    """Per-shard config from the base JSON, derived AFTER normalizing
    through ServerConfig — the server applies dataclass defaults for absent
    keys (web_port=3000, use_cpu_affinity=True, analytics stats file...),
    and deriving from the raw dict would miss every one of them: shards
    would fight over core 0, clobber one stats file, and an explicit
    `"web_port": 0` disable would silently re-enable the default port."""
    cfg = ServerConfig.from_dict(base).to_dict()  # validated + defaults
    if model_path:
        # Canary shard: serve a different artifact than the base fleet.
        # Each shard's hot-swap watcher follows its OWN file, so promoting
        # the canary is: copy it over the base model (survivors hot-swap)
        # or re-point the config and SIGHUP-roll.
        cfg["model_path"] = model_path
    net = cfg["network"]
    net["reuse_port"] = True
    web = int(net.get("web_port", 0) or 0)
    if web:
        net["web_port"] = web + shard
    # to_dict mirrors network.web_port as a top-level alias; keep the two
    # consistent (from_dict applies the alias first, then network wins).
    cfg["web_port"] = net.get("web_port", 0)
    root, ext = os.path.splitext(cfg["logging"]["log_file"])
    cfg["logging"]["log_file"] = f"{root}-{shard}{ext}"
    stats = cfg["analytics"].get("stats_file")
    if stats:
        root, ext = os.path.splitext(stats)
        cfg["analytics"]["stats_file"] = f"{root}-{shard}{ext}"
    if cfg["use_cpu_affinity"]:
        # Wrap within the host's cores: base_core+shard past the end would
        # make sched_setaffinity fail — the shard would float unpinned
        # (the server now also warns, but the operator asked for pinning).
        # Wrapping double-pins two shards in oversubscribed fleets, so say
        # so loudly.
        if ncpu is None:
            ncpu = os.cpu_count() or 1
        core = int(cfg["cpu_core_id"]) + shard
        if core >= ncpu:
            print(f"[fleet] shard {shard}: core {core} exceeds host cpus "
                  f"({ncpu}); wrapping to {core % ncpu} (shared pin)",
                  file=sys.stderr)
            core %= ncpu
        cfg["cpu_core_id"] = core
    return cfg


class RestartBudget:
    """Rolling-window restart limiter for --on-shard-exit restart: a
    crash-looping shard (bad config, poisoned model file) must not flap
    forever — restart storms hide real breakage behind apparent uptime."""

    def __init__(self, max_restarts: int = 5, window_s: float = 300.0,
                 now=time.monotonic) -> None:
        self.max_restarts = max_restarts
        self.window_s = window_s
        self._now = now
        self._events: dict = {}

    def allow(self, shard: int) -> bool:
        t = self._now()
        ev = [e for e in self._events.get(shard, ())
              if t - e < self.window_s]
        if len(ev) >= self.max_restarts:
            self._events[shard] = ev
            return False
        ev.append(t)
        self._events[shard] = ev
        return True


class RollingRestarter:
    """Zero-downtime rolling restart of the shard group (sent via SIGHUP).

    One shard at a time: SIGTERM it (graceful stop sends the drain notice,
    so its clients re-handshake onto survivors within one RTT), respawn it,
    wait until it reports healthy, then move to the next. This is the
    fleet's answer to the one model swap the in-process watcher REJECTS by
    design: an architecture-changing update (the engine's hot-swap guard
    refuses another geometry) — roll the fleet and every
    shard boots on the new file while the group keeps the port served.

    Deliberately conservative: a replacement shard that never turns healthy
    ABORTS the roll (survivors keep serving the old model) instead of
    marching on and degrading capacity shard by shard.
    """

    def __init__(self, n_shards, *, stop_shard, kill_shard, respawn,
                 is_alive, healthy, log=print, now=time.monotonic,
                 drain_grace_s=15.0, warm_grace_s=120.0):
        self.n = n_shards
        self._stop = stop_shard
        self._kill = kill_shard
        self._respawn = respawn
        self._alive = is_alive
        self._healthy = healthy
        self._log = log
        self._now = now
        self.drain_grace_s = drain_grace_s
        self.warm_grace_s = warm_grace_s
        self._queue = []          # shard indexes still to roll
        self._state = None        # None | ("stopping"|"warming", shard, t0)

    @property
    def active(self) -> bool:
        return self._state is not None or bool(self._queue)

    def expects_exit(self, shard: int) -> bool:
        """True while `shard`'s exit is intentional (manager must not treat
        it as a crash)."""
        return (self._state is not None and self._state[0] == "stopping"
                and self._state[1] == shard)

    def request(self) -> None:
        if self.active:
            self._log("rolling restart already in progress; ignored")
            return
        self._queue = list(range(self.n))
        self._log(f"rolling restart: {self.n} shard(s), one at a time")

    def abort(self) -> None:
        if self.active:
            self._queue = []
            self._state = None

    def tick(self) -> None:
        if self._state is None:
            if not self._queue:
                return
            shard = self._queue.pop(0)
            self._log(f"rolling restart: draining shard {shard}")
            self._stop(shard)
            self._state = ("stopping", shard, self._now())
            return
        phase, shard, t0 = self._state
        if phase == "stopping":
            if not self._alive(shard):
                self._respawn(shard)
                self._log(f"rolling restart: shard {shard} respawned; "
                          "waiting for health")
                self._state = ("warming", shard, self._now())
            elif self._now() - t0 > self.drain_grace_s:
                self._log(f"rolling restart: shard {shard} ignored SIGTERM "
                          f"for {self.drain_grace_s:.0f}s; killing")
                self._kill(shard)
                self._state = ("stopping", shard, self._now())
        elif phase == "warming":
            if not self._alive(shard):
                # The replacement died during warmup (bad model/config):
                # abort the roll — the remaining shards keep the OLD model;
                # the dead shard falls to the --on-shard-exit policy.
                self._log(f"rolling restart ABORTED: replacement shard "
                          f"{shard} exited during warmup")
                self.abort()
            elif self._healthy(shard):
                self._log(f"rolling restart: shard {shard} healthy")
                self._state = None  # next tick picks the next shard
                if not self._queue:
                    self._log("rolling restart complete")
            elif self._now() - t0 > self.warm_grace_s:
                self._log(f"rolling restart ABORTED: shard {shard} not "
                          f"healthy after {self.warm_grace_s:.0f}s "
                          "(survivors keep serving)")
                # KILL the wedged replacement: alive, it holds
                # a slot in the SO_REUSEPORT group and the kernel keeps
                # hashing ~1/N of clients onto a shard that never answers
                # — and poll() is None so neither the exit policy nor
                # fleet-stop would ever touch it. SIGKILL, not SIGTERM: a
                # shard wedged in warmup (a hung device call) may never
                # process a graceful stop. Dead, it falls to the
                # --on-shard-exit policy like any crashed shard.
                self._kill(shard)
                self.abort()


def pid_bound_to_udp_port(pid: int, port: int) -> bool:
    """True if process `pid` holds a UDP socket bound to `port` (Linux
    /proc walk: fd -> socket inodes, matched against /proc/net/udp*).

    This is the dashboardless health check for the rolling restart. The
    kernel's reuseport hash cannot target a specific shard through the
    shared port, so an external ZLTY probe can't tell the replacement from
    a survivor — but "bound" is exactly the zero-downtime condition: the
    server binds before warmup and queues frames host-side, so once the
    replacement holds the port it is safe to drain the next shard. A
    time-based grace is NOT (a shard spends seconds in imports before it
    binds; draining the next shard in that window leaves the port with no
    listener)."""
    try:
        inodes = set()
        fd_dir = f"/proc/{pid}/fd"
        for fd in os.listdir(fd_dir):
            try:
                tgt = os.readlink(os.path.join(fd_dir, fd))
            except OSError:
                continue
            if tgt.startswith("socket:["):
                inodes.add(tgt[8:-1])
    except OSError:
        return False
    if not inodes:
        return False
    for path in ("/proc/net/udp", "/proc/net/udp6"):
        try:
            with open(path, encoding="ascii") as f:
                next(f, None)  # header
                for line in f:
                    cols = line.split()
                    if len(cols) < 10:
                        continue
                    try:
                        lport = int(cols[1].rsplit(":", 1)[1], 16)
                    except (ValueError, IndexError):
                        continue
                    if lport == port and cols[9] in inodes:
                        return True
        except OSError:
            continue
    return False


def shard_status(cfg: dict) -> dict:
    web = int(cfg.get("network", {}).get("web_port", 0) or 0)
    if not web:
        return {}
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{web}/statusz", timeout=2) as r:
            return json.loads(r.read())
    except Exception:  # noqa: BLE001 — shard booting or busy
        return {}


def main() -> int:
    ap = argparse.ArgumentParser(
        description="SO_REUSEPORT fleet of detection-server shards")
    ap.add_argument("--config", default="configs/server.json")
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--device", default="",
                    help="forwarded to every shard's --device (e.g. cpu; "
                         "default the server's: cuda)")
    ap.add_argument("--device-env", default="",
                    help="per-shard env assignment with {shard} substituted, "
                         "e.g. 'CUDA_VISIBLE_DEVICES={shard}' to give each "
                         "shard its own card")
    ap.add_argument("--status-interval", type=float, default=10.0,
                    help="seconds between aggregated status lines (0=off)")
    ap.add_argument("--canary-model", default="",
                    help="model artifact served by the LAST --canary-shards "
                         "shards instead of the base config's model — a "
                         "canary rollout: SO_REUSEPORT flow-hashing is "
                         "sticky per client socket, so ~K/N of clients ride "
                         "the candidate for their whole session. Compare "
                         "the cohorts on each shard's own statusz/metricsz "
                         "(web_port+shard); promote by copying the file "
                         "over the base model (survivors hot-swap) or "
                         "re-pointing the config + SIGHUP roll")
    ap.add_argument("--canary-shards", type=int, default=1,
                    help="how many trailing shards serve --canary-model "
                         "(must leave at least one baseline shard)")
    ap.add_argument("--on-shard-exit", choices=("stop", "restart"),
                    default="stop",
                    help="stop: tear the fleet down loudly when a shard "
                         "dies (default, dev). restart: respawn it — the "
                         "drain/rebalance loop keeps its clients served by "
                         "survivors meanwhile; budget-limited "
                         "(--max-restarts per shard per 5 min), exhausted "
                         "budget stops the fleet")
    ap.add_argument("--max-restarts", type=int, default=5,
                    help="per-shard restart budget in a rolling 5-minute "
                         "window (with --on-shard-exit restart)")
    ap.add_argument("--roll-warm-grace", type=float, default=300.0,
                    help="SIGHUP rolling restart: seconds to wait for a "
                         "replacement shard to report healthy before "
                         "aborting the roll (cold boot = process start + "
                         "device init + kernel build + warmup; size for "
                         "the slow case — an abort leaves survivors on "
                         "the old model)")
    ap.add_argument("--roll-drain-grace", type=float, default=15.0,
                    help="SIGHUP rolling restart: seconds a drained shard "
                         "may ignore SIGTERM before it is killed")
    args = ap.parse_args()
    if args.shards < 1:
        ap.error("--shards must be >= 1")

    if args.device_env and "=" not in args.device_env:
        # A missing '=' would export the whole string as VAR='': an empty
        # visible-devices list hides every card, silently.
        ap.error("--device-env must look like NAME=VALUE "
                 "(e.g. 'CUDA_VISIBLE_DEVICES={shard}')")

    if args.canary_model:
        if not (1 <= args.canary_shards <= args.shards - 1):
            ap.error("--canary-shards must leave at least one baseline "
                     f"shard (got {args.canary_shards} of {args.shards})")
        if not os.path.isfile(args.canary_model):
            # Fail fast: a typo'd path would boot the canary cohort in
            # SIMULATION mode — random detections presented as a candidate
            # model's results.
            ap.error(f"--canary-model {args.canary_model!r} does not exist")

    with open(args.config, "r", encoding="utf-8") as f:
        base = json.load(f)

    tmp = tempfile.mkdtemp(prefix="zlt-fleet-")
    procs = []
    shard_cfgs = []
    stopping = False

    def _forward(signum, _frame):
        nonlocal stopping
        stopping = True
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    # Install BEFORE spawning: a Ctrl+C mid-spawn must tear down the shards
    # already launched instead of orphaning them on the port group.
    signal.signal(signal.SIGINT, _forward)
    signal.signal(signal.SIGTERM, _forward)

    def spawn(shard: int, cfg: dict) -> subprocess.Popen:
        path = os.path.join(tmp, f"shard-{shard}.json")
        # Always (re)write: a SIGHUP roll may have reloaded the base config,
        # and the respawned shard must boot the reloaded derivation.
        with open(path, "w", encoding="utf-8") as f:
            json.dump(cfg, f, indent=2)
        env = dict(os.environ)
        if args.device_env:
            key, _, val = args.device_env.partition("=")
            # Literal replace, not str.format: a value with other braces
            # (JSON) must pass through untouched.
            env[key] = val.replace("{shard}", str(shard))
        cmd = [sys.executable, "-m", "zero_latency_yolo_tpu_torch.runtime.server",
               "--config", path]
        if args.device:
            cmd += ["--device", args.device]
        p = subprocess.Popen(cmd, cwd=REPO, env=env)
        print(f"shard {shard}: pid={p.pid} config={path} "
              f"web_port={cfg.get('network', {}).get('web_port', 0)}",
              flush=True)
        return p

    first_canary = (args.shards - args.canary_shards
                    if args.canary_model else args.shards)
    for shard in range(args.shards):
        canary = shard >= first_canary
        cfg = derive_shard_config(
            base, shard, model_path=args.canary_model if canary else None)
        shard_cfgs.append(cfg)
        if canary:
            print(f"shard {shard}: CANARY model={args.canary_model}",
                  flush=True)
        procs.append(spawn(shard, cfg))
        if stopping:
            break
    if stopping:
        # Re-forward: a shard spawned in the same loop iteration the signal
        # landed in missed the first pass.
        _forward(signal.SIGTERM, None)

    # Rolling restart on SIGHUP: the operational path for the ONE model
    # update the in-process hot-swap watcher rejects by design — an
    # architecture change (the engine refuses another geometry). Drop the
    # new model file in place, `kill -HUP <manager>`, and each shard
    # restarts in turn onto the new file while the group keeps serving.
    roll_requested = False

    def _on_hup(_signum, _frame):
        nonlocal roll_requested
        roll_requested = True

    if hasattr(signal, "SIGHUP"):
        signal.signal(signal.SIGHUP, _on_hup)

    boot_t = {i: time.time() for i in range(len(procs))}

    def _shard_healthy(i: int) -> bool:
        # With a dashboard port: statusz answering with the engine warmed
        # is health (the port's server answers while it warms, and a roll
        # that moved on then would drain the next shard onto a replacement
        # that serves nothing until its warmup ends). Without one:
        # the shard must actually HOLD the fleet port (a time grace would
        # let the roll drain the next shard while the replacement is still
        # importing — a no-listener window on the port). Non-Linux (no
        # /proc) falls back to alive + grace.
        if int(shard_cfgs[i].get("network", {}).get("web_port", 0) or 0):
            st = shard_status(shard_cfgs[i])
            return bool(st) and str(st.get("engine", {}).get(
                "warmed", "true")).lower() != "false"
        p = procs[i]
        if p.poll() is not None:
            return False
        if os.path.isdir(f"/proc/{p.pid}/fd"):
            return pid_bound_to_udp_port(
                p.pid, int(shard_cfgs[i]["network"]["port"]))
        return time.time() - boot_t.get(i, 0.0) >= 5.0

    def _respawn_rolled(i: int) -> None:
        procs[i] = spawn(i, shard_cfgs[i])
        boot_t[i] = time.time()

    def _reload_base_config() -> None:
        """Re-read --config at SIGHUP so a roll can change more than model
        FILE CONTENTS: model_path (canary promotion by re-pointing),
        variant, buckets — anything the boot spec traces. Canary overrides
        re-apply on top. A reload that fails to parse/validate, or that
        moves network.port (the fleet's bind — moving it needs a restart,
        not a roll), is refused loudly and the roll proceeds on the
        boot-time derivation."""
        try:
            with open(args.config, "r", encoding="utf-8") as f:
                new_base = json.load(f)
            fresh = [derive_shard_config(
                new_base, i,
                model_path=(args.canary_model if i >= first_canary
                            else None))
                for i in range(args.shards)]
        except Exception as e:  # noqa: BLE001 — operator typo must not kill
            print(f"fleet: config reload failed ({e}); rolling on the "
                  "boot-time config", file=sys.stderr, flush=True)
            return
        if (int(fresh[0]["network"]["port"])
                != int(shard_cfgs[0]["network"]["port"])):
            print("fleet: reloaded config moves network.port; reload "
                  "refused (restart the fleet to change ports)",
                  file=sys.stderr, flush=True)
            return
        if fresh != shard_cfgs:
            print("fleet: config reloaded; the roll respawns shards on the "
                  "new derivation", file=sys.stderr, flush=True)
        shard_cfgs[:] = fresh

    roller = RollingRestarter(
        len(procs),
        stop_shard=lambda i: (procs[i].poll() is None
                              and procs[i].send_signal(signal.SIGTERM)),
        kill_shard=lambda i: (procs[i].poll() is None and procs[i].kill()),
        respawn=_respawn_rolled,
        is_alive=lambda i: procs[i].poll() is None,
        healthy=_shard_healthy,
        log=lambda m: print(f"fleet: {m}", file=sys.stderr, flush=True),
        drain_grace_s=args.roll_drain_grace,
        warm_grace_s=args.roll_warm_grace)

    last_status = time.time()
    term_deadline = None
    exit_code = 0
    budget = RestartBudget(max_restarts=args.max_restarts)
    while True:
        alive = [p for p in procs if p.poll() is None]
        if stopping and roller.active:
            # A fleet-stop signal mid-roll supersedes the roll. Without
            # this, tick() is never called again (the `not stopping` gate
            # below), roller.active stays true forever, and the exit
            # condition under it never fires: every shard dead, manager
            # spinning. The drained shard already got SIGTERM; _forward
            # covered the rest.
            roller.abort()
        if not alive and not roller.active:
            # roller.active guard: a 1-shard fleet mid-roll has ZERO live
            # shards between drain and respawn — that window is not "fleet
            # done".
            break
        if stopping and term_deadline is None:
            term_deadline = time.time() + 15.0
        if term_deadline is not None and time.time() > term_deadline:
            # A shard wedged past SIGTERM grace (e.g. stuck in a device
            # readback inside a C extension) must not hang the manager.
            for p in alive:
                print(f"shard pid={p.pid} ignored SIGTERM; killing",
                      file=sys.stderr)
                p.kill()
            term_deadline = time.time() + 15.0  # re-arm for the kill wait
        if not stopping:
            if roll_requested:
                roll_requested = False
                _reload_base_config()
                roller.request()
            roller.tick()
        dead_unexpected = [i for i, p in enumerate(procs)
                           if p.poll() is not None
                           and not roller.expects_exit(i)]
        if not stopping and dead_unexpected:
            # A shard died: the surviving group keeps the port and picks up
            # the dead shard's flows (drain notice + client re-handshake,
            # or liveness timeout on a crash).
            dead = dead_unexpected
            if args.on_shard_exit == "restart":
                for i in dead:
                    if budget.allow(i):
                        print(f"shard {i} exited (rc={procs[i].returncode});"
                              " restarting", file=sys.stderr)
                        procs[i] = spawn(i, shard_cfgs[i])
                        boot_t[i] = time.time()
                    else:
                        # Crash loop: stop loudly rather than flap forever.
                        print(f"shard {i} exhausted its restart budget "
                              f"({args.max_restarts}/5min); stopping fleet",
                              file=sys.stderr)
                        exit_code = 1
                        _forward(signal.SIGTERM, None)
                        break
            else:
                # Default: shut the fleet down loudly rather than limp with
                # silent capacity loss.
                print(f"shard(s) {dead} exited; stopping fleet",
                      file=sys.stderr)
                exit_code = 1
                _forward(signal.SIGTERM, None)
        if (args.status_interval and not stopping
                and not roller.active
                # Skip status collection mid-roll: sequential
                # 2 s-timeout urlopens against a draining shard block this
                # single supervisory loop and skew the roll's drain/warm
                # grace timing by seconds.
                and time.time() - last_status >= args.status_interval):
            stats = [shard_status(c) for c in shard_cfgs]
            clients = sum(int(s.get("clients", 0)) for s in stats)
            served = sum(float(s.get("served_fps", 0) or 0) for s in stats)
            per = "/".join(str(s.get("clients", "?")) for s in stats)
            line = f"fleet: clients={clients} ({per}) served_fps={served:.0f}"
            if first_canary < len(stats):
                c_stats = stats[first_canary:]
                line += (" canary: clients="
                         f"{sum(int(s.get('clients', 0)) for s in c_stats)}"
                         " detect_p99_ms="
                         + "/".join(str((s.get("detect_latency") or {})
                                        .get("p99_ms", "?"))
                                    for s in c_stats))
            print(line, flush=True)
            last_status = time.time()
        time.sleep(0.5)
    # Shard configs live in a mkdtemp'd dir the shards only read at boot:
    # clean it up on manager exit (every fleet run would otherwise
    # leak a /tmp dir carrying model paths + port layout).
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    return exit_code


if __name__ == "__main__":
    sys.exit(main())
