"""Game/domain adapters: per-game detection shaping applied after inference.

Rebuilds the *detection-shaping* responsibilities of the reference adapters
(src/game/games/cs16/cs16_game_adapter.cpp, csgo clone):
- track-id assignment for untracked detections (:246-249) — here real track
  ids come from the Kalman tracker when `detection.enable_tracking` is on,
  with the reference's fresh-id-per-frame behavior as the fallback;
- head-box shrink by `head_size_factor` (:251-258);
- per-client state registry keyed by client id (game_adapter_base.h:118-213);
- best-target selection and linear motion prediction (:71-145) exposed as
  queries for parity, returning data only.

The aim-point / recoil-compensation outputs of the reference are cheat
functionality and are intentionally not rebuilt (SURVEY scope note).
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import CLASS_HEAD, CLASS_T, GameConfig
from ..protocol import Detection
from .tracker import MultiObjectTracker


@dataclass
class ClientState:
    client_id: int
    screen_width: int = 800
    screen_height: int = 600
    game_id: int = 1
    tracker: Optional[MultiObjectTracker] = None
    last_detections: List[Detection] = field(default_factory=list)
    # Last client-supplied frame timestamp (epoch ms): coast-only frames
    # stamp with THIS stream's clock, not the server's (mixing two hosts'
    # epoch clocks made Detection.timestamp jump backwards on every
    # coast-only frame for skewed clients).
    last_frame_ts: int = 0
    # Serializes tracker mutation (process_detections on the result path —
    # the asyncio event-loop thread; the batcher hops results there via
    # call_soon_threadsafe) against tracker state reads (predict_motion on
    # the query path) — the tracker's meta/X arrays shrink in update() and
    # an unsynchronized reader can index a dropped row.
    tracker_lock: threading.Lock = field(default_factory=threading.Lock)


class GameAdapter:
    """Base adapter: registry + shaping pipeline. Subclasses set GAME_NAME."""

    GAME_NAME = "generic"
    TARGET_CLASSES = (CLASS_T, CLASS_HEAD)

    def __init__(self, game_config: GameConfig,
                 enable_tracking: bool = True,
                 max_tracking_age_ms: float = 500.0) -> None:
        self.config = game_config
        self.enable_tracking = enable_tracking
        self.max_tracking_age_ms = max_tracking_age_ms
        self._clients: Dict[int, ClientState] = {}
        self._lock = threading.Lock()
        self._fresh_ids = itertools.count(1)

    # ------------------------------------------------------------- lifecycle
    def _new_state(self, client_id: int, screen_width: int,
                   screen_height: int, game_id: int) -> ClientState:
        """The ONE ClientState constructor — register and reset must mint
        identically-configured trackers or a STOP/START-cycled client
        silently diverges from a fresh one."""
        return ClientState(
            client_id=client_id, screen_width=screen_width,
            screen_height=screen_height, game_id=game_id,
            tracker=MultiObjectTracker(max_age_ms=self.max_tracking_age_ms)
            if self.enable_tracking else None)

    def register_client(self, client_id: int, screen_width: int = 800,
                        screen_height: int = 600, game_id: int = 1) -> None:
        with self._lock:
            self._clients[client_id] = self._new_state(
                client_id, screen_width, screen_height, game_id)

    def unregister_client(self, client_id: int) -> None:
        with self._lock:
            self._clients.pop(client_id, None)

    def reset_client(self, client_id: int) -> None:
        """Drop a live client's tracker/detection state (STOP_STREAM) while
        keeping its registration — the next processed frame starts from a
        clean track table instead of associating against stale boxes."""
        with self._lock:
            st = self._clients.get(client_id)
            if st is None:
                return
            self._clients[client_id] = self._new_state(
                client_id, st.screen_width, st.screen_height, st.game_id)

    def client_count(self) -> int:
        with self._lock:
            return len(self._clients)

    # -------------------------------------------------------------- shaping
    def process_detections(self, client_id: int, detections: List[Detection],
                           now_ms: Optional[float] = None) -> List[Detection]:
        """Track-id assignment (Kalman or fresh ids) + head-box shaping."""
        with self._lock:
            state = self._clients.get(client_id)
        if state is None:
            # Evicted between the session lookup and this call: still ship
            # shaped boxes (head_size_factor is adapter-wide, not
            # per-client) with the reference's fresh-id fallback — an
            # in-flight frame must not leave the pipeline unshaped.
            for d in detections:
                if d.track_id == 0:
                    d.track_id = next(self._fresh_ids)
            return [self._shape(d) for d in detections]
        now_ms = time.monotonic() * 1000.0 if now_ms is None else now_ms

        if state.tracker is not None:
            if detections:
                boxes = np.array(
                    [[d.x, d.y, d.width, d.height] for d in detections],
                    np.float32)
                classes = np.array([d.class_id for d in detections], np.int64)
                confs = np.array([d.confidence for d in detections],
                                 np.float32)
                ts = max(d.timestamp for d in detections)
                state.last_frame_ts = ts
            else:
                boxes = np.zeros((0, 4), np.float32)
                classes = np.zeros(0, np.int64)
                confs = np.zeros(0, np.float32)
                # Wire timestamps are epoch ms everywhere (packets.now_ms,
                # frame stamps); now_ms here is the tracker's monotonic
                # clock. Prefer the stream's OWN last frame stamp so one
                # time source covers consecutive results; fall back to the
                # server clock only before any stamped frame arrived.
                ts = state.last_frame_ts or int(time.time() * 1000.0)
            with state.tracker_lock:
                tracked = state.tracker.update(boxes, classes, confs,
                                               now_ms=now_ms)
            detections = [
                Detection(x=float(b[0]), y=float(b[1]), width=float(b[2]),
                          height=float(b[3]), confidence=c, class_id=k,
                          track_id=tid, timestamp=ts)
                for b, c, k, tid in tracked]
        else:
            # Reference behavior: fresh id per untracked detection
            # (cs16_game_adapter.cpp:246-249).
            for d in detections:
                if d.track_id == 0:
                    d.track_id = next(self._fresh_ids)

        detections = [self._shape(d) for d in detections]
        with self._lock:
            # Identity re-check (same pattern as the decode queue's
            # session re-check): a reset/unregister raced this frame —
            # don't write results onto the replacement state's clean
            # table; the frame itself still ships (one frame of ids from
            # the discarded tracker, then the fresh table takes over).
            if self._clients.get(client_id) is state:
                state.last_detections = detections
        return detections

    def _shape(self, d: Detection) -> Detection:
        if d.class_id == CLASS_HEAD:
            f = float(self.config.head_size_factor)
            d.width *= f
            d.height *= f
        return d

    # -------------------------------------------------------------- queries
    def best_target(self, client_id: int) -> Optional[Detection]:
        """Nearest-to-screen-center among target classes; heads weighted 0.5×
        distance (reference cs16_game_adapter.cpp:71-109). Data query only.

        Distance is measured in PIXELS via the client's registered screen
        dims — the reference's metric. Normalized-coordinate distance
        inverts the ranking on non-square screens (a 16:9 display
        compresses y: equal normalized offsets are very different pixel
        offsets)."""
        with self._lock:
            state = self._clients.get(client_id)
            dets = list(state.last_detections) if state else []
            sw = float(state.screen_width) if state else 1.0
            sh = float(state.screen_height) if state else 1.0
        best, best_dist = None, float("inf")
        for d in dets:
            if d.class_id not in self.TARGET_CLASSES:
                continue
            dist = float(np.hypot((d.x - 0.5) * sw, (d.y - 0.5) * sh))
            if d.class_id == CLASS_HEAD:
                dist *= 0.5
            if dist < best_dist:
                best, best_dist = d, dist
        return best

    def predict_motion(self, client_id: int, track_id: int,
                       horizon_ms: float = 100.0) -> Optional[Tuple[float, float]]:
        """Linear motion extrapolation of a track's center over horizon_ms
        (reference cs16_game_adapter.cpp:111-145), via the KF velocity state."""
        with self._lock:
            state = self._clients.get(client_id)
        if state is None or state.tracker is None:
            return None
        with state.tracker_lock:  # update() shrinks meta/X concurrently
            for i, t in enumerate(state.tracker.meta):
                if t.track_id == track_id:
                    x, y, vx, vy = (state.tracker.X[i, 0],
                                    state.tracker.X[i, 1],
                                    state.tracker.X[i, 4],
                                    state.tracker.X[i, 5])
                    h = min(horizon_ms, 200.0) / 1000.0
                    return (float(np.clip(x + vx * h, 0, 1)),
                            float(np.clip(y + vy * h, 0, 1)))
        return None

    def status(self) -> Dict[str, str]:
        with self._lock:
            return {
                "game": self.GAME_NAME,
                "clients": str(len(self._clients)),
                "tracking": "on" if self.enable_tracking else "off",
            }


class CS16Adapter(GameAdapter):
    GAME_NAME = "cs16"


class CSGOAdapter(GameAdapter):
    GAME_NAME = "csgo"


_ADAPTERS = {"cs16": CS16Adapter, "csgo": CSGOAdapter}


def get_adapter(name: str, game_config: GameConfig, enable_tracking: bool = True,
                max_tracking_age_ms: float = 500.0) -> GameAdapter:
    """Adapter factory (reference GameAdapterManager,
    src/game/base/game_adapter_manager.h:11-75). Unknown names get the
    generic adapter rather than failing."""
    cls = _ADAPTERS.get(name, GameAdapter)
    return cls(game_config, enable_tracking, max_tracking_age_ms)
