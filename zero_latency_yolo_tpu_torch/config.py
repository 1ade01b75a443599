"""Typed server configuration — parses the reference `configs/server.json` schema.

A stdlib-only copy of the JAX package's `config.py`, so the PyTorch port
reads the same `server.json` files unchanged without importing that package.

Schema compatibility is a hard requirement (reference src/server/config.h:305-630):
every key is optional with the reference's defaults, unknown keys are ignored,
and `save()` writes a file the reference's ConfigManager would load unchanged.
TPU-specific knobs live in a new optional `tpu` sub-object so old configs stay
valid.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

# Defaults mirror reference src/common/constants.h:13-29 and src/server/config.h.
DEFAULT_SERVER_PORT = 7788
DEFAULT_WEB_PORT = 3000
DEFAULT_MODEL_PATH = "models/yolo_nano_cs16.onnx"
DEFAULT_MODEL_SIZE = 416
DEFAULT_CONF_THRESHOLD = 0.5
DEFAULT_NMS_THRESHOLD = 0.45
MAX_DETECTION_COUNT = 32
MAX_CLIENTS = 10
TARGET_SERVER_FPS = 60
INFERENCE_QUEUE_SIZE = 8

# CS1.6 class ids (reference src/common/constants.h:37-40).
CLASS_T = 0
CLASS_CT = 1
CLASS_HEAD = 2
CLASS_WEAPON = 3
CS16_CLASS_NAMES = ("player_t", "player_ct", "head", "weapon")


@dataclass
class NetworkConfig:
    port: int = DEFAULT_SERVER_PORT
    web_port: int = DEFAULT_WEB_PORT
    recv_buffer_size: int = 1048576
    send_buffer_size: int = 1048576
    timeout_ms: int = 5000
    heartbeat_interval_ms: int = 1000
    max_retries: int = 3
    use_reliable_udp: bool = True
    # New optional knob: C++ recvmmsg transport (native/udp.cpp) instead of
    # the asyncio datagram endpoint. Old configs simply omit it.
    use_native_transport: bool = False
    # SO_REUSEPORT host sharding: N server processes bind the SAME UDP port
    # and the kernel flow-hashes clients across them (sticky per 4-tuple).
    # The multi-core/multi-chip scale-out mode (scripts/serve_fleet.py);
    # disables the port+1 fallback so every shard stays on the fleet port.
    reuse_port: bool = False
    # Interface-scoped binds (dotted IPv4; default = all interfaces). The
    # UDP serving socket and the management HTTP plane get separate knobs:
    # the common split is UDP public, statusz/dashboard on 127.0.0.1 behind
    # a reverse proxy. Validated at load (a typo must not silently listen
    # everywhere). The reference hardcoded INADDR_ANY for both.
    bind_address: str = "0.0.0.0"
    web_bind_address: str = "0.0.0.0"
    # When set, every management-plane POST (model upload — which hot-swaps
    # the serving model — log upload, /profilez capture) requires
    # `Authorization: Bearer <token>`. GET telemetry stays open; scope it
    # with web_bind_address. Empty (default) = open plane, reference parity.
    web_auth_token: str = ""
    # SET_CONFIG over the wire mutates GLOBAL serving thresholds (range-
    # gated, but a legitimate 0.99 confidence from one client still blanks
    # detections for every stream). Default on — single-operator parity with
    # the shipped clients; multi-tenant deployments turn it off and tune via
    # the (token-gated) management plane. GET_CONFIG stays read-open.
    allow_client_config: bool = True


@dataclass
class LoggingConfig:
    enable_logging: bool = True
    log_level: str = "info"
    log_file: str = "logs/server.log"
    max_log_size_mb: int = 10
    max_log_files: int = 5


@dataclass
class DetectionConfig:
    model_width: int = DEFAULT_MODEL_SIZE
    model_height: int = DEFAULT_MODEL_SIZE
    enable_tracking: bool = True
    max_tracking_age_ms: int = 500
    # Accuracy-SLA floor for adaptive serving (default for every client;
    # clients may raise their own over SET_CONFIG/CONFIG_UPDATE when
    # network.allow_client_config permits): the adaptive-resolution policy
    # never serves a floored client below this rung (snapped UP the
    # tpu.serve_sizes ladder). 0 = no floor.
    min_serve_size: int = 0
    class_weights: Dict[str, float] = field(default_factory=lambda: {
        "player_t": 1.0, "player_ct": 1.0, "head": 1.2, "weapon": 0.8,
    })

    def class_weight_vector(self, class_names=CS16_CLASS_NAMES):
        """Class weights as an ordered list aligned with model class ids.

        The reference parses class_weights but never applies them
        (SURVEY §2.3); here they multiply scores before threshold/NMS.
        Unknown class names default to 1.0.
        """
        return [float(self.class_weights.get(name, 1.0)) for name in class_names]


@dataclass
class WeaponConfig:
    recoil_factor: float = 1.0
    priority: float = 1.0


@dataclass
class GameConfig:
    enabled: bool = False
    aim_target_offset_y: float = -0.15
    head_size_factor: float = 0.7
    weapons: Dict[str, WeaponConfig] = field(default_factory=dict)


def _default_games() -> Dict[str, GameConfig]:
    # Reference default: cs16 enabled with the 4 stock weapons
    # (src/server/config.h:221-248, constants.h:42-47).
    return {
        "cs16": GameConfig(enabled=True, weapons={
            "ak47": WeaponConfig(2.5, 1.0),
            "m4a1": WeaponConfig(2.0, 1.0),
            "awp": WeaponConfig(0.0, 1.5),
            "deagle": WeaponConfig(3.0, 1.2),
        })
    }


@dataclass
class AnalyticsConfig:
    enable_analytics: bool = True
    stats_interval_sec: int = 60
    save_stats_to_file: bool = True
    stats_file: str = "logs/stats.json"
    # Dataset capture (runtime/capture.py): non-empty enables recording
    # sampled served keyframes + their detections as a YOLO-convention
    # directory (train/data.py's input format) — the serve -> fine-tune ->
    # hot-swap flywheel. Labels are the model's own confidence-gated
    # output (self-training data, not ground truth).
    capture_dir: str = ""
    # Every Nth full keyframe per client is recorded.
    capture_sample_every: int = 30
    # Disk bound for the capture directory (resumes across restarts).
    capture_max_images: int = 1000
    # Detections below this confidence are excluded from label files.
    capture_min_confidence: float = 0.25


@dataclass
class TpuConfig:
    """Device extras (optional sub-object; absent in old configs). The name
    stays `tpu` so existing server.json files parse unchanged. The TPU
    kernel switches (nms, act, conv1x1, dot1x1) have no effect in the
    PyTorch engine (runtime/engine.py)."""
    # Batch-size buckets the engine serves; requests are padded up.
    batch_buckets: tuple = (1, 2, 4, 8, 16, 32, 64)
    # Micro-batch collection window (ms) for continuous batching.
    batch_window_ms: float = 3.0
    # Model compute dtype on device.
    dtype: str = "bfloat16"
    # int8 quantized backbone (per-channel int8 weights, calibrated
    # activation scales; runtime/engine.py, ops/quant.py).
    quantize_int8: bool = False
    # Candidate boxes kept before NMS (top-k across anchors).
    pre_nms_topk: int = 256
    # Device mesh axis sizes for multi-device serving; (1, 1) = one device.
    mesh_data: int = 1
    mesh_model: int = 1
    # Host-side input frame buckets (h, w) frames are padded into.
    frame_buckets: tuple = ((600, 800), (1080, 1920))
    # Number of classes in the deployed model.
    num_classes: int = 4
    # Model variant: yolov8p / n / s / m / l / x.
    variant: str = "yolov8n"
    # Preprocess implementation: "letterbox_mxu" (interpolation-matrix
    # matmuls), "letterbox" (gathers), or "stretch" (reference-compatible
    # nearest-neighbor stretch).
    preprocess: str = "letterbox_mxu"
    # The next three name experiments of the JAX package's TPU kernels. They
    # have no effect in the PyTorch port, which always runs its own kernels.
    nms: str = "auto"
    act: str = "auto"
    # Serving-layout experiments of the JAX package:
    # stem="s2d": letterbox emits space-to-depth (S/2, S/2, 12) directly and
    # the stem runs as a k2 s1 conv. Needs a letterbox preprocess.
    stem: str = "conv"
    # dot1x1=True: k1 s1 convs via dot_general (no effect in the port, whose
    # k1 s1 convs always run as a matmul kernel).
    dot1x1: bool = False
    # select="perlevel": pre-NMS candidate top-k per FPN level before the
    # cross-level concat. "concat" = the global top-k.
    select: str = "concat"
    # conv1x1: a TPU kernel experiment of the JAX package (no effect here).
    conv1x1: str = "xla"
    # c2f="split": C2f without the channel slice/concat; "slice" the slice
    # form; "auto" split only where the JAX package picks it (runtime/
    # engine.py resolve_c2f: yolov8n at 416 in bf16, batch 32).
    c2f: str = "auto"
    # Dispatched-but-unread batch depth the scheduler keeps in flight.
    max_inflight: int = 2
    # Host-path measurement harness: > 0 replaces the device step with a
    # fixed-duration fake step of this many ms. Never set in production.
    synthetic_step_ms: float = 0.0
    # Per-batch-bucket fake-step durations (ms) for the harness above.
    synthetic_step_profile: Dict[str, float] = field(default_factory=dict)
    # Serve-size ladder for adaptive resolution, e.g. [416, 320]. Empty =
    # fixed detection.model_width only.
    serve_sizes: tuple = ()
    # Per-serve-size synthetic ladders ({"416": {...}, "320": {...}}).
    synthetic_step_profiles: Dict[str, Dict[str, float]] = field(
        default_factory=dict)
    # > 0 enables the adaptive resolution policy over serve_sizes.
    adaptive_slo_ms: float = 0.0
    # > 0 enables server->client AIMD rate control (a server setting).
    rate_control_slo_ms: float = 0.0
    rate_control_min_fps: int = 15
    # > 0 samples every Nth served frame into a lifecycle trace ring.
    trace_sample_every: int = 0
    # Host-tail GC posture applied after warmup (a server setting).
    gc_tune: bool = True
    # > 0 shortens the GIL switch interval (a server setting).
    gil_switch_interval_ms: float = 0.0


# Closed value sets for TpuConfig's layout/impl enums (validated in
# ServerConfig.from_dict). Keep in sync with the consumers cited per field
# in TpuConfig; models/yolov8.py get_spec() validates `variant` itself.
_TPU_ENUMS = {
    "dtype": {"bfloat16", "float32"},
    "preprocess": {"letterbox_mxu", "letterbox", "stretch"},
    "nms": {"auto", "xla", "pallas", "pallas_interpret"},
    "act": {"auto", "pallas", "pallas_interpret"},
    "stem": {"conv", "s2d"},
    "conv1x1": {"xla", "pallas", "pallas_interpret"},
    "select": {"concat", "perlevel"},
    "c2f": {"auto", "slice", "split"},
}


@dataclass
class ServerConfig:
    model_path: str = DEFAULT_MODEL_PATH
    inference_engine: str = "jax"
    max_clients: int = MAX_CLIENTS
    target_fps: int = TARGET_SERVER_FPS
    confidence_threshold: float = DEFAULT_CONF_THRESHOLD
    nms_threshold: float = DEFAULT_NMS_THRESHOLD
    max_queue_size: int = INFERENCE_QUEUE_SIZE
    use_cpu_affinity: bool = True
    cpu_core_id: int = 0
    use_high_priority: bool = True
    worker_threads: int = 4
    network: NetworkConfig = field(default_factory=NetworkConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    detection: DetectionConfig = field(default_factory=DetectionConfig)
    game_adapters: Dict[str, GameConfig] = field(default_factory=_default_games)
    analytics: AnalyticsConfig = field(default_factory=AnalyticsConfig)
    tpu: TpuConfig = field(default_factory=TpuConfig)

    # ------------------------------------------------------------------ load
    @classmethod
    def from_dict(cls, j: Dict[str, Any]) -> "ServerConfig":
        cfg = cls()
        for key in ("model_path", "inference_engine", "max_clients", "target_fps",
                    "confidence_threshold", "nms_threshold", "max_queue_size",
                    "use_cpu_affinity", "cpu_core_id", "use_high_priority",
                    "worker_threads"):
            if key in j:
                setattr(cfg, key, _coerce(j[key], getattr(cfg, key)))
        # Top-level port/web_port alias into network (reference config.h:387-390).
        if "port" in j:
            cfg.network.port = int(j["port"])
        if "web_port" in j:
            cfg.network.web_port = int(j["web_port"])
        # Thresholds range+NaN gate at LOAD — the SET_CONFIG runtime path
        # gates these (server.py), but a bad server.json was an unguarded
        # back door: a NaN confidence blanks every detection while the
        # server reports healthy (CLAUDE.md invariant).
        for name in ("confidence_threshold", "nms_threshold"):
            v = float(getattr(cfg, name))
            if not (v == v and 0.0 <= v <= 1.0):
                raise ValueError(f"{name}={v!r} must be finite in [0, 1]")
        _merge(cfg.network, j.get("network"))
        # Fail-at-load gate: a malformed bind address would otherwise fall
        # through to INADDR_ANY (native tier) or raise mid-boot (asyncio).
        import socket as _socket
        for name in ("bind_address", "web_bind_address"):
            addr = getattr(cfg.network, name)
            if not isinstance(addr, str):
                raise ValueError(f"network.{name} must be a string")
            if addr:
                try:
                    # inet_pton, not inet_aton: the native tier (zl_udp_open3)
                    # validates with inet_pton, which rejects the classic
                    # shorthand forms aton accepts ("127.1", octal octets).
                    # The gate must match the strictest tier or the same
                    # config boots on asyncio and EINVALs on native.
                    _socket.inet_pton(_socket.AF_INET, addr)
                except OSError:
                    raise ValueError(
                        f"network.{name}={addr!r} must be a dotted IPv4 "
                        "address (the wire tier is IPv4)") from None
        tok = cfg.network.web_auth_token
        if not isinstance(tok, str):
            raise ValueError("network.web_auth_token must be a string")
        if tok and (len(tok) < 8 or any(c.isspace() for c in tok)):
            # A 3-char or whitespace-bearing token is a misconfiguration a
            # header round-trip would mangle or a prober would brute-force;
            # fail at load, not at the first rejected upload.
            raise ValueError("network.web_auth_token must be >=8 chars with "
                             "no whitespace (or empty to disable auth)")
        if tok and not all(" " < c <= "~" for c in tok):
            # HTTP header values are bytes; a non-ASCII token survives JSON
            # but every Authorization round-trip then depends on client
            # encoding choices — and the operator locks THEMSELVES out of
            # the management plane. Printable ASCII only.
            raise ValueError("network.web_auth_token must be printable ASCII "
                             "(it travels in an HTTP header)")
        if tok and tok.upper().replace("_", "-").startswith("CHANGE-ME"):
            # The shipped hardened example's placeholder is publicly known;
            # a copy-paste deploy must not boot "hardened" with it. Prefix
            # match (covers the shipped token) — NOT a substring scan,
            # which would false-positive on a legitimate random secret
            # that happens to contain "change-me" (ADVICE r4).
            raise ValueError("network.web_auth_token is the example "
                             "placeholder — generate a real secret (e.g. "
                             "`openssl rand -hex 16`)")
        _merge(cfg.logging, j.get("logging"))
        _merge(cfg.detection, j.get("detection"))
        # The primary serving size obeys the SAME /32 anchor-grid constraint
        # the serve_sizes gate below enforces for the ladder.
        for name in ("model_width", "model_height"):
            mv = int(getattr(cfg.detection, name))
            if mv <= 0 or mv % 32:
                raise ValueError(
                    f"detection.{name}={mv} must be a positive multiple "
                    "of 32 (the FPN downsamples to /32)")
        # Accuracy-SLA floor: 0 (no floor) or a value the ladder can honor.
        # A floor above the model size could never be served — fail at load.
        msz = int(cfg.detection.min_serve_size)
        if msz < 0 or msz > int(cfg.detection.model_width):
            raise ValueError(
                f"detection.min_serve_size={msz} must be in "
                f"[0, detection.model_width={cfg.detection.model_width}]")
        _merge(cfg.analytics, j.get("analytics"))
        if cfg.analytics.capture_dir:
            # Same fail-at-load stance as the tpu gates: a zero sampling
            # stride or a NaN confidence gate would only surface as a
            # silently-poisoned capture set.
            if int(cfg.analytics.capture_sample_every) < 1:
                raise ValueError("analytics.capture_sample_every must be >= 1")
            if int(cfg.analytics.capture_max_images) < 1:
                raise ValueError("analytics.capture_max_images must be >= 1")
            conf = float(cfg.analytics.capture_min_confidence)
            if not (conf == conf and 0.0 <= conf <= 1.0):
                raise ValueError(
                    f"analytics.capture_min_confidence={conf!r} must be a "
                    "finite value in [0, 1]")
        if isinstance(j.get("game_adapters"), dict):
            for name, game_j in j["game_adapters"].items():
                if not isinstance(game_j, dict):
                    continue  # tolerate malformed entries (every key optional)
                game = cfg.game_adapters.get(name, GameConfig())
                _merge(game, game_j, skip=("weapons",))
                if isinstance(game_j.get("weapons"), dict):
                    for wname, wj in game_j["weapons"].items():
                        weapon = game.weapons.get(wname, WeaponConfig())
                        _merge(weapon, wj)
                        game.weapons[wname] = weapon
                cfg.game_adapters[name] = game
        if isinstance(j.get("tpu"), dict):
            tj = dict(j["tpu"])
            for tuple_key in ("batch_buckets", "frame_buckets", "serve_sizes"):
                if tuple_key in tj:
                    tj[tuple_key] = tuple(
                        tuple(v) if isinstance(v, (list, tuple)) else v
                        for v in tj[tuple_key])
            _merge(cfg.tpu, tj)
            # Serve sizes must be stride-32 multiples (the FPN downsamples
            # to /32; a non-multiple letterbox target misaligns the anchor
            # grid) — fail at load, not at first trace.
            for s in cfg.tpu.serve_sizes:
                if int(s) <= 0 or int(s) % 32:
                    raise ValueError(
                        f"tpu.serve_sizes entry {s!r} must be a positive "
                        "multiple of 32")
            aslo = float(cfg.tpu.adaptive_slo_ms)
            if not (aslo == aslo and 0.0 <= aslo < 1e6):  # NaN-proof gate
                raise ValueError(
                    f"tpu.adaptive_slo_ms={cfg.tpu.adaptive_slo_ms!r} must "
                    "be a finite ms value >= 0")
            # Count only REACHABLE rungs: the engine drops serve_sizes
            # above model_width (the policy never upshifts past the
            # configured size), so a ladder of larger rungs would pass
            # here and then silently disable adaptive serving.
            reachable = {int(v) for v in cfg.tpu.serve_sizes
                         if int(v) <= int(cfg.detection.model_width)}
            if aslo and len(
                    reachable | {int(cfg.detection.model_width)}) < 2:
                raise ValueError(
                    "tpu.adaptive_slo_ms needs a serve_sizes ladder with at "
                    "least one size besides (and not above) "
                    "detection.model_width")
            # Bucket shape discipline at load: serving programs are keyed
            # by (batch bucket, frame bucket) — an empty or malformed
            # ladder otherwise crashes the batcher thread at first
            # dispatch, not the boot.
            bb = tuple(int(b) for b in cfg.tpu.batch_buckets)
            if not bb or any(b <= 0 for b in bb):
                raise ValueError(
                    f"tpu.batch_buckets={cfg.tpu.batch_buckets!r} must be "
                    "a non-empty list of positive integers")
            cfg.tpu.batch_buckets = bb
            fb = []
            for entry in cfg.tpu.frame_buckets:
                pair = tuple(int(v) for v in entry)
                if len(pair) != 2 or any(v <= 0 for v in pair):
                    raise ValueError(
                        f"tpu.frame_buckets entry {entry!r} must be a "
                        "[height, width] pair of positive integers")
                fb.append(pair)
            if not fb:
                raise ValueError("tpu.frame_buckets must not be empty")
            cfg.tpu.frame_buckets = tuple(fb)
            # Rate control: same fail-at-load stance as the enums below —
            # a negative/NaN SLO or a zero fps floor would only surface as
            # a wedged monitor tick or clients commanded to 0 fps.
            slo = float(cfg.tpu.rate_control_slo_ms)
            if not (slo == slo and 0.0 <= slo < 1e6):  # NaN-proof range gate
                raise ValueError(
                    f"tpu.rate_control_slo_ms={cfg.tpu.rate_control_slo_ms!r}"
                    " must be a finite ms value >= 0")
            if int(cfg.tpu.rate_control_min_fps) < 1:
                raise ValueError("tpu.rate_control_min_fps must be >= 1")
            if int(cfg.tpu.trace_sample_every) < 0:
                raise ValueError("tpu.trace_sample_every must be >= 0")
            swi = float(cfg.tpu.gil_switch_interval_ms)
            if not (swi == swi and 0.0 <= swi <= 100.0):  # NaN-proof gate
                raise ValueError(
                    f"tpu.gil_switch_interval_ms={swi!r} must be a finite ms "
                    "value in [0, 100]")
            # Layout/impl enums fail FAST at load: a typo ("Split", "splt",
            # "perLevel") would otherwise silently serve the default layout
            # and the operator's intended measured win never happens. Same
            # rationale as the [0,1] range gates on runtime thresholds.
            for fname, allowed in _TPU_ENUMS.items():
                val = getattr(cfg.tpu, fname)
                if val not in allowed:
                    raise ValueError(
                        f"tpu.{fname}={val!r} is not one of {sorted(allowed)}")
        return cfg

    @classmethod
    def load(cls, path: str = "configs/server.json",
             create_if_missing: bool = True) -> "ServerConfig":
        """Load config; auto-create the default file if missing
        (reference src/server/config.h:541-581)."""
        if not os.path.exists(path):
            cfg = cls()
            if create_if_missing:
                cfg.save(path)
            return cfg
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    # ------------------------------------------------------------------ save
    def to_dict(self) -> Dict[str, Any]:
        j: Dict[str, Any] = {
            "model_path": self.model_path,
            "inference_engine": self.inference_engine,
            "port": self.network.port,
            "web_port": self.network.web_port,
            "max_clients": self.max_clients,
            "target_fps": self.target_fps,
            "confidence_threshold": self.confidence_threshold,
            "nms_threshold": self.nms_threshold,
            "max_queue_size": self.max_queue_size,
            "use_cpu_affinity": self.use_cpu_affinity,
            "cpu_core_id": self.cpu_core_id,
            "use_high_priority": self.use_high_priority,
            "worker_threads": self.worker_threads,
            "network": dataclasses.asdict(self.network),
            "logging": dataclasses.asdict(self.logging),
            "detection": dataclasses.asdict(self.detection),
            "game_adapters": {
                name: {
                    "enabled": g.enabled,
                    "aim_target_offset_y": g.aim_target_offset_y,
                    "head_size_factor": g.head_size_factor,
                    "weapons": {w: dataclasses.asdict(wc) for w, wc in g.weapons.items()},
                } for name, g in self.game_adapters.items()
            },
            "analytics": dataclasses.asdict(self.analytics),
            "tpu": dataclasses.asdict(self.tpu),
        }
        return j

    def save(self, path: str = "configs/server.json") -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f, indent=4)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=4)

    @classmethod
    def from_json(cls, text: str) -> "ServerConfig":
        return cls.from_dict(json.loads(text))


@dataclass
class CompressionSettings:
    """Client compression knobs (reference configs/client.json `compression`,
    src/common/types.h:58-63). Used by the loopback simulator."""
    quality: int = 75
    keyframe_interval: int = 30
    use_difference_encoding: bool = True
    use_roi_encoding: bool = True
    roi_padding: int = 20


@dataclass
class ClientNetworkSettings:
    timeout_ms: int = 5000
    heartbeat_interval_ms: int = 1000
    reconnect_attempts: int = 3
    reconnect_delay_ms: int = 2000


@dataclass
class ClientConfig:
    """Subset of the reference client config consumed by the loopback
    simulator (configs/client.json; the aim/esp/recoil sections are cheat
    functionality and are intentionally not modeled)."""
    server_ip: str = "127.0.0.1"
    server_port: int = DEFAULT_SERVER_PORT
    game_id: int = 1
    target_fps: int = 60
    screen_width: int = 800
    screen_height: int = 600
    auto_connect: bool = True
    compression: CompressionSettings = field(default_factory=CompressionSettings)
    network_settings: ClientNetworkSettings = field(
        default_factory=ClientNetworkSettings)

    @classmethod
    def from_dict(cls, j: Dict[str, Any]) -> "ClientConfig":
        cfg = cls()
        _merge(cfg, j, skip=("compression", "network_settings"))
        _merge(cfg.compression, j.get("compression"))
        _merge(cfg.network_settings, j.get("network_settings"))
        return cfg

    @classmethod
    def load(cls, path: str = "configs/client.json") -> "ClientConfig":
        if not os.path.exists(path):
            return cls()
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))


def _coerce(val: Any, cur: Any) -> Any:
    """Coerce a JSON scalar to the field's current (default) type. JSON does
    not distinguish 60 from 60.0 — an int field fed a float (or a float fed
    an int) must not leak a mistyped value into struct packing."""
    if isinstance(cur, bool):
        if isinstance(val, str):
            # bool("false") is True — a hand-edited "false"/"true" string
            # must parse by meaning, and anything else keeps the default.
            low = val.strip().lower()
            if low in ("true", "1", "yes", "on"):
                return True
            if low in ("false", "0", "no", "off"):
                return False
            return cur
        return bool(val)
    if isinstance(cur, int) and isinstance(val, (int, float)):
        return int(val)
    if isinstance(cur, float) and isinstance(val, (int, float)):
        return float(val)
    if isinstance(cur, (int, float)) and isinstance(val, str):
        # A hand-edited "60" must parse by meaning (the bool branch already
        # does); junk must fail AT LOAD, not as a TypeError in struct
        # packing or a comparison at runtime.
        try:
            return int(val) if isinstance(cur, int) else float(val)
        except ValueError:
            raise ValueError(
                f"config value {val!r} is not a number (field default "
                f"{cur!r})") from None
    if isinstance(cur, tuple) and isinstance(val, (list, tuple)):
        return tuple(val)
    return val


def _merge(obj: Any, j: Optional[Dict[str, Any]], skip=()) -> None:
    """Contains-check merge: only keys present in the JSON override defaults."""
    if not isinstance(j, dict):
        return
    for f in dataclasses.fields(obj):
        if f.name in skip or f.name not in j:
            continue
        setattr(obj, f.name, _coerce(j[f.name], getattr(obj, f.name)))
