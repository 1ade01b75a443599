"""Management-plane HTTP API (replaces the reference's Node dashboard backend).

A copy of the JAX package's `runtime/web.py`. The PyTorch server wires no
profiler yet (`profile_fn=None`), so `/profilez` answers 404 "profiling not
wired".

The reference serves a separate Express app (src/web/server.js) whose status
endpoint scrapes the C++ server's *log files* by regex (server.js:198-248).
Here the management API lives in-process with direct access to live state:

    GET  /statusz, /api/server/status   live status JSON (engine, transport,
                                        sessions, latency percentiles)
    GET  /api/models                    list model files (server.js:318-330)
    POST /api/models/upload?name=...    upload .onnx/.npz/.pt; the SHA-256
                                        watcher hot-swaps it (server.js:340-362)
    GET  /api/logs                      list log files (server.js:266-280)
    GET  /api/logs/<name>               view one log, path-traversal guarded
                                        (server.js:283-315)
    POST /api/logs/upload?name=...      client log upload (server.js:182-195)
    GET  /api/client/version            client version info (server.js:251-263)
    GET  /debugz                        sampled per-frame lifecycle traces
                                        (tpu.trace_sample_every; the
                                        reference's per-frame DEBUG timing,
                                        onnx_engine.cpp:615-618)
    GET  /profilez                      capture status + last capture summary
    POST /profilez?seconds=N            on-demand profiler capture of the
                                        LIVE serving process (bounded,
                                        single-flight), when a profiler is
                                        wired (profile_fn)

Implemented on asyncio streams — no web framework dependency. The dashboard
HTML itself is optional and not rebuilt; every consumer of the reference's
JSON API finds the same routes here.

Auth: when `network.web_auth_token` is set, every POST route requires
`Authorization: Bearer <token>` (constant-time compare; 401 otherwise).
GET routes stay open — they are read-only telemetry; scope them with
`network.web_bind_address`. The reference's web plane had no auth at all.
"""

from __future__ import annotations

import json
import os
import re
import urllib.parse
from typing import Callable, Dict, Optional, Tuple

from ..utils.logging import get_logger

log = get_logger("web")

# fullmatch (not match-with-$): $ matches BEFORE a trailing newline, so a
# %0A-suffixed upload name would pass the gate and write a file with an
# embedded newline (review r5).
_SAFE_NAME = re.compile(r"[A-Za-z0-9._-]+")
MAX_UPLOAD = 256 * 1024 * 1024
ALLOWED_MODEL_EXT = (".onnx", ".npz", ".pt", ".pth")

CLIENT_VERSION = {"version": "1.0.0", "min_supported": "1.0.0"}

# Self-contained live dashboard (replaces the reference's Express-served
# public/index.html + script.js polling loop, web/server.js).
DASHBOARD_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>zero-latency-yolo</title>
<style>
body{font-family:system-ui,sans-serif;background:#111;color:#ddd;margin:2rem}
h1{font-size:1.2rem} .grid{display:grid;grid-template-columns:repeat(auto-fill,minmax(220px,1fr));gap:12px}
.card{background:#1c1c1c;border:1px solid #333;border-radius:8px;padding:12px}
.k{color:#888;font-size:.75rem;text-transform:uppercase}.v{font-size:1.4rem;margin-top:4px}
table{width:100%;border-collapse:collapse;margin-top:1rem;font-size:.85rem}
td,th{border-bottom:1px solid #2a2a2a;padding:4px 8px;text-align:left}
.trend{grid-column:span 2;min-width:0}
.trend svg{display:block;width:100%;height:56px;margin-top:6px}
.hovv{color:#c3c2b7;font-size:.75rem;min-height:1em;margin-top:2px}
</style></head><body>
<h1>zero-latency-yolo &mdash; live status</h1>
<div class="grid" id="cards"></div>
<div class="grid" id="trends" style="margin-top:12px"></div>
<table id="sessions"><thead><tr><th>client</th><th>addr</th><th>frames</th>
<th>results</th><th>srtt ms</th></tr></thead><tbody></tbody></table>
<script>
async function tick(){
  try{
    const s = await (await fetch('/statusz')).json();
    const cards = [
      ['clients', s.clients + ' / ' + s.max_clients],
      ['queue depth', s.queue_depth],
      ['rx pps', s.transport.rx_pps],
      ['served fps', s.served_fps],
      ['detect p99 ms', s.detect_latency.p99_ms.toFixed ? s.detect_latency.p99_ms.toFixed(2) : s.detect_latency.p99_ms],
      ['pipeline p99 ms', s.engine.pipeline_p99_ms],
      ['inferences', s.engine.inferences],
      ['dropped', s.engine.dropped],
      ['bad packets', s.transport.bad_packets],
      ['retransmits', s.transport.retransmits],
      ['model', s.engine.model + '@' + s.engine.model_size +
        (s.engine.serve_size !== s.engine.model_size
          ? ' → ' + s.engine.serve_size : '') +
        (s.engine.simulation === 'true' ? ' (SIM)' : '')],
      // WHICH artifact (canary fleets, hot-swap visibility).
      ['artifact', s.engine.model_file +
        (s.engine.model_sha ? ' #' + s.engine.model_sha : '')],
    ];
    if (s.device_stall_s > (s.device_stall_warn_s || 5.0))
      cards.push(['DEVICE STALLED (s)', s.device_stall_s.toFixed(1)]);
    if (s.host_gc && s.host_gc.pause_max_ms > 20)
      cards.push(['gc pause max ms', s.host_gc.pause_max_ms.toFixed(1)]);
    document.getElementById('cards').innerHTML = cards.map(
      c => `<div class="card"><div class="k">${c[0]}</div><div class="v">${c[1]}</div></div>`).join('');
    const rows = Object.entries(s.sessions || {}).map(([id, x]) =>
      `<tr><td>#${id}</td><td>${x.addr}</td><td>${x.frames}</td><td>${x.results}</td><td>${x.srtt_ms}</td></tr>`);
    document.querySelector('#sessions tbody').innerHTML = rows.join('');
  }catch(e){}
}
tick(); setInterval(tick, 2000);

// Trend sparklines from /historyz (5s monitor snapshots, ~10 min window).
// One series per chart (no dual axes); line colors are pre-validated
// dark-surface categorical steps; values/labels stay in text tokens.
function spark(el, hist, key, color, fmt){
  const pts = hist.map(h => +h[key]).filter(v => isFinite(v));
  const hv = el.querySelector('.hovv');
  const svg = el.querySelector('svg');
  if (pts.length < 2) { svg.innerHTML=''; hv.textContent='collecting…'; return; }
  const W = svg.clientWidth || 300, H = 56, P = 3;
  const lo = Math.min(...pts), hi = Math.max(...pts), span = (hi-lo) || 1;
  const x = i => P + i*(W-2*P)/(pts.length-1);
  const y = v => H-P - (v-lo)*(H-2*P)/span;
  const line = pts.map((v,i) => `${x(i).toFixed(1)},${y(v).toFixed(1)}`).join(' ');
  svg.setAttribute('viewBox', `0 0 ${W} ${H}`);
  svg.innerHTML =
    `<line x1="${P}" y1="${y(lo)}" x2="${W-P}" y2="${y(lo)}" stroke="#2a2a2a" stroke-width="1"/>` +
    `<polyline points="${line}" fill="none" stroke="${color}" stroke-width="2" stroke-linejoin="round"/>` +
    `<circle id="dot" r="3" fill="${color}" opacity="0"/>`;
  hv.textContent = `now ${fmt(pts[pts.length-1])} · min ${fmt(lo)} · max ${fmt(hi)}`;
  svg.onmousemove = ev => {
    const r = svg.getBoundingClientRect();
    const i = Math.max(0, Math.min(pts.length-1,
      Math.round((ev.clientX-r.left)/r.width*(pts.length-1))));
    const d = svg.querySelector('#dot');
    d.setAttribute('cx', x(i)); d.setAttribute('cy', y(pts[i]));
    d.setAttribute('opacity', 1);
    const ago = Math.round((pts.length-1-i)*5/60*10)/10;
    hv.textContent = `${fmt(pts[i])} · ${ago} min ago`;
  };
  svg.onmouseleave = () => {
    svg.querySelector('#dot').setAttribute('opacity', 0);
    hv.textContent = `now ${fmt(pts[pts.length-1])} · min ${fmt(lo)} · max ${fmt(hi)}`;
  };
}
const TRENDS = [
  ['served fps — 10 min', 'served_fps', '#3987e5', v => v.toFixed(1)],
  ['detect p99 ms — 10 min', 'detect_p99_ms', '#d95926', v => v.toFixed(2)],
];
document.getElementById('trends').innerHTML = TRENDS.map((t,i) =>
  `<div class="card trend" id="tr${i}"><div class="k">${t[0]}</div><svg></svg><div class="hovv"></div></div>`).join('');
async function trendTick(){
  try{
    const h = (await (await fetch('/historyz')).json()).history || [];
    TRENDS.forEach((t,i) =>
      spark(document.getElementById('tr'+i), h, t[1], t[2], t[3]));
  }catch(e){}
}
trendTick(); setInterval(trendTick, 10000);
</script></body></html>"""


class ManagementApi:
    def __init__(self, status_fn: Callable[[], Dict],
                 models_dir: str = "models", logs_dir: str = "logs",
                 active_model: Optional[str] = None,
                 history_fn: Optional[Callable[[], list]] = None,
                 traces_fn: Optional[Callable[[], list]] = None,
                 profile_fn: Optional[Callable[[float], Dict]] = None,
                 profile_status_fn: Optional[Callable[[], Dict]] = None,
                 auth_token: str = "") -> None:
        self.status_fn = status_fn
        # network.web_auth_token: when set, every POST route (model upload —
        # which hot-swaps the serving model — log upload, /profilez) requires
        # `Authorization: Bearer <token>`. GET routes stay open: they are
        # read-only telemetry, and network.web_bind_address is the knob for
        # scoping those. Empty (the default) keeps the open-plane behavior.
        self.auth_token = auth_token
        self.history_fn = history_fn
        self.traces_fn = traces_fn
        self.profile_fn = profile_fn
        self.profile_status_fn = profile_status_fn
        self.models_dir = models_dir
        self.logs_dir = logs_dir
        # Basename of the file the SHA-256 watcher actually monitors
        # (config.model_path): uploads under any other name land on disk
        # but are NOT hot-swapped — the response must say so.
        self.active_model = active_model

    def auth_ok(self, auth: str) -> bool:
        """True when `auth` authorizes POST routes (always true with auth
        disabled). The transport calls this BEFORE reading a POST body so
        an unauthenticated client cannot make the server buffer up to
        256 MB per connection just by naming a Content-Length — the 401
        must cost the sender a header, not the server a buffer."""
        if not self.auth_token:
            return True
        import hmac
        # Constant-time over BYTES (see handle() — surrogatepass keeps
        # invalid-UTF-8 attacker headers a clean mismatch, not a raise).
        return hmac.compare_digest(
            (auth or "").encode("utf-8", "surrogatepass"),
            self.auth_token.encode("utf-8"))

    # ------------------------------------------------------------- routing
    async def handle(self, method: str, path: str, body: bytes,
                     auth: str = "") -> Tuple[int, Dict]:
        """Status routes answer inline (live in-process state, no I/O); file
        routes (model/log upload, log view) run in a worker thread — a
        256 MB model upload written synchronously would stall the SAME event
        loop that handles UDP datagrams and result sends, spiking the
        latency p99 the server exists to hold down."""
        import asyncio
        url = urllib.parse.urlsplit(path)
        route = url.path.rstrip("/") or "/"
        query = dict(urllib.parse.parse_qsl(url.query))
        try:
            if method == "POST" and not self.auth_ok(auth):
                # Constant-time compare over BYTES (auth_ok): str-mode
                # compare_digest raises TypeError on non-ASCII, and an
                # attacker-sent invalid UTF-8 header decodes
                # (errors="replace") to U+FFFD — the reject must be a 401,
                # not an exception that drops the connection. Inside the
                # try so any surprise still answers. (The transport also
                # pre-checks auth_ok before reading POST bodies.)
                return 401, {"error": "unauthorized: POST routes require "
                                      "'Authorization: Bearer <token>' "
                                      "(network.web_auth_token)"}
            if method == "GET":
                if route == "/dashboard":
                    return 200, {"__html__": DASHBOARD_HTML}
                if route in ("/", "/statusz", "/api/server/status"):
                    return 200, self.status_fn()
                if route == "/historyz":
                    # Rolling monitor-loop snapshots (5s cadence, ~10 min):
                    # the trend data the reference's web plane scraped from
                    # log files.
                    return 200, {"history": (self.history_fn()
                                             if self.history_fn else [])}
                if route == "/debugz":
                    # Sampled per-frame lifecycle traces (tpu.
                    # trace_sample_every > 0): stage spans for individual
                    # served frames — the reference's per-frame DEBUG
                    # timing line (onnx_engine.cpp:615-618) as structured
                    # data instead of log scraping.
                    return 200, {"traces": (self.traces_fn()
                                            if self.traces_fn else [])}
                if route == "/metricsz":
                    # Prometheus exposition format over the same live status
                    # tree — scrape-ready observability (the reference's web
                    # plane could only regex server logs, web/server.js:198).
                    return 200, {"__text__": self._prometheus_metrics()}
                if route == "/api/client/version":
                    return 200, CLIENT_VERSION
                if route == "/profilez":
                    if self.profile_status_fn is None:
                        return 404, {"error": "profiling not wired"}
                    return 200, self.profile_status_fn()
            if method == "POST" and route == "/profilez":
                # Blocks for the capture window — worker thread, never the
                # event loop that serves datagrams.
                if self.profile_fn is None:
                    return 404, {"error": "profiling not wired"}
                try:
                    seconds = float(query.get("seconds", "2"))
                except ValueError:
                    return 400, {"error": "seconds must be a number"}
                result = await asyncio.to_thread(self.profile_fn, seconds)
                if result.get("ok"):
                    return 200, result
                busy = "in flight" in str(result.get("error", ""))
                return (409 if busy else 400), result
            return await asyncio.to_thread(self._handle_file_route, method,
                                           route, query, body)
        except Exception as e:  # noqa: BLE001
            log.exception("management api error on %s %s", method, route)
            return 500, {"error": str(e)}

    # ------------------------------------------------------------- metrics
    def _prometheus_metrics(self) -> str:
        """Flatten the status tree's numeric leaves into Prometheus text
        lines (`zlt_transport_packets_received 1234`). Per-session rows are
        skipped: client ids churn, and unbounded label cardinality is the
        classic way to blow up a metrics backend — aggregate counters carry
        the same signal."""
        import math
        status = self.status_fn()
        lines = []

        def emit(prefix: str, val) -> None:
            if isinstance(val, bool):
                val = int(val)
            elif isinstance(val, str):
                # The engine's status map is all-string by design (the
                # reference's getStatus() contract, onnx_engine.cpp:279-312)
                # — numeric-looking strings must still export as series.
                try:
                    val = float(val) if ("." in val or "e" in val.lower()
                                         ) else int(val)
                except ValueError:
                    return
            if isinstance(val, (int, float)):
                if math.isfinite(val):
                    lines.append(f"{prefix} {val}")
            elif isinstance(val, dict):
                for k, v in val.items():
                    key = re.sub(r"[^a-zA-Z0-9_]", "_", str(k))
                    emit(f"{prefix}_{key}", v)

        for key, val in status.items():
            if key == "sessions":
                continue
            emit("zlt_" + re.sub(r"[^a-zA-Z0-9_]", "_", str(key)), val)
        return "\n".join(lines) + "\n"

    def _handle_file_route(self, method: str, route: str, query: Dict,
                           body: bytes) -> Tuple[int, Dict]:
        if method == "GET":
            if route == "/api/models":
                return 200, self._list_models()
            if route == "/api/logs":
                return 200, self._list_logs()
            if route.startswith("/api/logs/"):
                return self._view_log(route[len("/api/logs/"):])
        elif method == "POST":
            if route == "/api/models/upload":
                return self._upload_model(query.get("name", ""), body)
            if route == "/api/logs/upload":
                return self._upload_log(query.get("name", ""), body)
        return 404, {"error": "not found"}

    # -------------------------------------------------------------- models
    def _list_models(self) -> Dict:
        models = []
        if os.path.isdir(self.models_dir):
            for name in sorted(os.listdir(self.models_dir)):
                p = os.path.join(self.models_dir, name)
                if (os.path.isfile(p)
                        and name.lower().endswith(ALLOWED_MODEL_EXT)):
                    models.append({"name": name, "size": os.path.getsize(p),
                                   "mtime": int(os.path.getmtime(p))})
        return {"models": models}

    def _upload_model(self, name: str, body: bytes) -> Tuple[int, Dict]:
        if not _SAFE_NAME.fullmatch(name or ""):
            return 400, {"error": "invalid model name"}
        if not name.lower().endswith(ALLOWED_MODEL_EXT):
            return 400, {"error": f"model must be one of {ALLOWED_MODEL_EXT}"}
        if not body or len(body) > MAX_UPLOAD:
            return 400, {"error": "empty or oversized upload"}
        os.makedirs(self.models_dir, exist_ok=True)
        # Unique temp per request: concurrent uploads of the same name must
        # not interleave into one file and publish corrupt bytes to the
        # SHA-256 hot-swap watcher. os.replace keeps the publish atomic.
        import tempfile
        fd, tmp = tempfile.mkstemp(prefix=name + ".", suffix=".uploading",
                                   dir=self.models_dir)
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(body)
            os.replace(tmp, os.path.join(self.models_dir, name))
        except Exception:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        hot_swap = (self.active_model is None or name == self.active_model)
        if not hot_swap:
            log.warning("model uploaded as %r but the watcher monitors %r — "
                        "it will NOT be hot-swapped", name, self.active_model)
        log.info("model uploaded: %s (%d bytes)", name, len(body))
        resp = {"ok": True, "name": name, "size": len(body),
                "hot_swap": hot_swap}
        if not hot_swap:
            resp["note"] = (f"active model file is {self.active_model!r}; "
                            "upload under that name to hot-swap")
        return 200, resp

    # ---------------------------------------------------------------- logs
    def _list_logs(self) -> Dict:
        logs = []
        if os.path.isdir(self.logs_dir):
            for name in sorted(os.listdir(self.logs_dir)):
                p = os.path.join(self.logs_dir, name)
                if os.path.isfile(p):
                    logs.append({"name": name, "size": os.path.getsize(p)})
        return {"logs": logs}

    def _view_log(self, name: str) -> Tuple[int, Dict]:
        # Path-traversal guard (reference server.js:283-315).
        if not _SAFE_NAME.fullmatch(name):
            return 400, {"error": "invalid log name"}
        path = os.path.join(self.logs_dir, name)
        if not os.path.isfile(path):
            return 404, {"error": "log not found"}
        with open(path, "rb") as f:  # read only the tail, not the whole file
            f.seek(max(os.path.getsize(path) - 1_000_000, 0))
            content = f.read().decode(errors="replace")
        return 200, {"name": name, "content": content}

    def _upload_log(self, name: str, body: bytes) -> Tuple[int, Dict]:
        if not _SAFE_NAME.fullmatch(name or ""):
            return 400, {"error": "invalid log name"}
        if len(body) > MAX_UPLOAD:
            return 400, {"error": "oversized upload"}
        os.makedirs(self.logs_dir, exist_ok=True)
        with open(os.path.join(self.logs_dir, "upload_" + name), "wb") as f:
            f.write(body)
        return 200, {"ok": True}
