"""Multi-object Kalman tracking — promoted from the reference's orphaned design.

The reference ships a KalmanTracker/MultiObjectTracker pair that is wired to
nothing and depends on a nonexistent `cv::hungarian`
(src/game/kalman_tracker.{h,cpp}; SURVEY §2.5). This module makes the intended
capability real and honors `detection.enable_tracking` /
`max_tracking_age_ms` from the config (parsed-but-ignored in the reference,
src/server/config.h:110-129).

Design: a vectorized bank of constant-velocity Kalman filters over box
state [x, y, w, h, vx, vy, vw, vh] (normalized coords), batched predict /
update as (N, 8) NumPy array math on host — track counts are tiny (≤32/client)
and latency-critical, so host vector math beats a device round-trip.
Association: IoU cost matrix + Hungarian assignment (scipy
linear_sum_assignment — a real replacement for `cv::hungarian`).

Matches the reference's intended semantics (kalman_tracker.cpp):
- process/measurement noise CALIBRATED to this wire's units (deliberate
  deviation): the reference's constants (1e-2 / 5e-2 / 1e-1, :22-25) are
  variances in ITS coordinate scale; applied verbatim to normalized [0,1]
  boxes a 5e-2 measurement variance is a 0.22 std — near half a screen —
  and the filter all but ignores detections (measured: heavy-miss MOTA
  0.57, 211 id switches). Bank defaults are q=5e-2 / r=5e-3, the measured
  optimum of scripts/track_bench.py's noise sweep (heavy-miss MOTA 0.94,
  idsw 11 — BENCH_NOTES round-5 tracker section); the single-track
  KalmanTracker keeps the reference constants for API-parity tests
- confidence EMA 0.7·old + 0.3·new (:130) — maintained on the TRACK and
  served on coast frames; matched frames deliberately ship the raw
  measured box + confidence (zero added latency on live detections; the
  KF state exists for association, coasting, and predict_motion)
- expiry when silent > max_age/2 (:167-171's silence rule; the absolute-age
  half is a deliberate deviation, see update())
- min_hits=3 before a track is "confirmed"; coasted predictions for
  confirmed-but-unmatched tracks at 0.9× confidence (:273-354)
- IoU gate 0.3 on matches (:265-271)
- the bank is bounded (max_tracks) — association runs on the result path
  of the event loop, so a jittery detector must not grow NxM Hungarian
  cost without limit
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

from ..utils.geometry import iou_matrix_cxcywh


# One shared host-side pairwise IoU (utils/geometry.py) — the evaluator
# uses the same implementation; keep the historical name for callers/tests.
_iou_xywh = iou_matrix_cxcywh


@dataclass
class Track:
    track_id: int
    class_id: int
    confidence: float
    hits: int = 1
    last_update_ms: float = 0.0


class KalmanTracker:
    """Single-track constant-velocity KF over [x,y,w,h,vx,vy,vw,vh].

    Kept for API parity / unit tests; the serving path uses the vectorized
    bank inside MultiObjectTracker.
    """

    def __init__(self, box: np.ndarray, process_noise: float = 1e-2,
                 meas_noise: float = 5e-2, init_var: float = 1e-1) -> None:
        self.x = np.zeros(8, np.float64)
        self.x[:4] = box
        self.P = np.eye(8) * init_var
        self.q = process_noise
        self.r = meas_noise

    def predict(self, dt: float) -> np.ndarray:
        F = np.eye(8)
        for i in range(4):
            F[i, 4 + i] = dt
        self.x = F @ self.x
        self.P = F @ self.P @ F.T + np.eye(8) * self.q * max(dt, 1e-3)
        self.x[:4] = np.clip(self.x[:4], 0.0, 1.0)
        return self.x[:4].copy()

    def update(self, z: np.ndarray) -> np.ndarray:
        H = np.zeros((4, 8))
        H[:4, :4] = np.eye(4)
        S = H @ self.P @ H.T + np.eye(4) * self.r
        K = self.P @ H.T @ np.linalg.inv(S)
        self.x = self.x + K @ (z - H @ self.x)
        self.P = (np.eye(8) - K @ H) @ self.P
        self.x[:4] = np.clip(self.x[:4], 0.0, 1.0)
        return self.x[:4].copy()

    def trajectory(self, horizon_s: float, steps: int) -> np.ndarray:
        """Linear rollout of the predicted box centers (reference
        kalman_tracker.cpp:205-235)."""
        ts = np.linspace(0.0, horizon_s, steps)
        out = np.tile(self.x[:4], (steps, 1))
        out[:, 0] += self.x[4] * ts
        out[:, 1] += self.x[5] * ts
        return np.clip(out, 0.0, 1.0)


class MultiObjectTracker:
    """Vectorized KF bank + Hungarian association for one client stream."""

    # Motion-gated association constants (assoc="motion", measured in
    # scripts/track_bench.py — VERDICT r4 #5): chi-squared 99% quantile at
    # 2 dof for the Mahalanobis rescue gate, the box-scaled center-distance
    # rescue radius, and the tie-break weight on the IoU cost.
    _CHI2_99_2DOF = 9.21
    _RESCUE_NORM_D = 1.0
    _MOTION_LAMBDA = 0.15

    def __init__(self, max_age_ms: float = 500.0, min_hits: int = 3,
                 iou_threshold: float = 0.3, process_noise: float = 5e-2,
                 meas_noise: float = 5e-3, max_tracks: int = 64,
                 assoc: str = "motion") -> None:
        self.max_age_ms = float(max_age_ms)
        self.min_hits = int(min_hits)
        # Association mode: "motion" (default) breaks IoU ties with the
        # KF's own predicted-center distance and rescues sub-IoU matches
        # the filter predicted well (cuts id switches at crossing density
        # — measured in BENCH_NOTES); "iou" is the reference's intended
        # IoU-only association (kalman_tracker.cpp:427-465), kept for
        # parity A/Bs.
        if assoc not in ("motion", "iou"):
            raise ValueError(f"assoc={assoc!r} not in ('motion', 'iou')")
        self.assoc = assoc
        # Bank bound: the wire caps at 32 detections/frame, so 64 covers
        # live targets + a full coasting generation; past that, a jittery
        # detector is minting tracks it will never confirm, and the NxM
        # association cost lands on the latency-critical result path.
        self.max_tracks = max(int(max_tracks), 1)
        self.iou_threshold = float(iou_threshold)
        self.q = process_noise
        self.r = meas_noise
        self._next_id = 1
        # Vectorized state: (N, 8) means, (N, 8, 8) covariances.
        self.X = np.zeros((0, 8), np.float64)
        self.P = np.zeros((0, 8, 8), np.float64)
        self.meta: List[Track] = []
        self._last_ms: Optional[float] = None

    def __len__(self) -> int:
        return len(self.meta)

    # ------------------------------------------------------------- internals
    def _predict_all(self, dt: float) -> None:
        if len(self.meta) == 0:
            return
        F = np.eye(8)
        for i in range(4):
            F[i, 4 + i] = dt
        self.X = self.X @ F.T
        self.P = F @ self.P @ F.T + np.eye(8) * self.q * max(dt, 1e-3)
        self.X[:, :4] = np.clip(self.X[:, :4], 0.0, 1.0)

    def _update_rows(self, rows: np.ndarray, Z: np.ndarray) -> None:
        # Batched KF measurement update over the matched rows: H = [I4 0],
        # so S = P[:4,:4] + rI and K = P[:, :4] S^-1 without forming H.
        # One (k,4,4) batched inverse + einsums replace the per-track
        # Python loop — update() runs on the event-loop result path, and
        # at the 32-track wire cap the loop was most of its cost.
        P = self.P[rows]                                  # (k,8,8)
        S = P[:, :4, :4] + np.eye(4) * self.r             # (k,4,4)
        K = np.einsum("kij,kjl->kil", P[:, :, :4],
                      np.linalg.inv(S))                   # (k,8,4)
        innov = Z - self.X[rows][:, :4]                   # (k,4)
        self.X[rows] = self.X[rows] + np.einsum("kij,kj->ki", K, innov)
        self.P[rows] = P - np.einsum("kij,kjl->kil", K, P[:, :4, :])
        self.X[:, :4] = np.clip(self.X[:, :4], 0.0, 1.0)

    def _add(self, box: np.ndarray, class_id: int, conf: float, now_ms: float) -> None:
        x = np.zeros(8)
        x[:4] = box
        self.X = np.vstack([self.X, x[None]])
        self.P = np.concatenate([self.P, (np.eye(8) * 1e-1)[None]], axis=0)
        self.meta.append(Track(track_id=self._next_id, class_id=class_id,
                               confidence=conf, last_update_ms=now_ms))
        self._next_id += 1

    def _drop(self, keep_mask: np.ndarray) -> None:
        self.X = self.X[keep_mask]
        self.P = self.P[keep_mask]
        self.meta = [m for m, k in zip(self.meta, keep_mask) if k]

    # ----------------------------------------------------------------- update
    def update(self, boxes: np.ndarray, classes: np.ndarray,
               confidences: np.ndarray, now_ms: Optional[float] = None
               ) -> List[Tuple[np.ndarray, float, int, int]]:
        """Associate detections with tracks; returns the tracked detection set.

        boxes: (M, 4) normalized center-format; returns a list of
        (box, confidence, class_id, track_id) including coasted predictions
        for confirmed tracks missed this frame.
        """
        now_ms = time.monotonic() * 1000.0 if now_ms is None else float(now_ms)
        dt = 0.0 if self._last_ms is None else max(now_ms - self._last_ms, 0.0) / 1000.0
        self._last_ms = now_ms
        self._predict_all(dt)

        m, n = len(boxes), len(self.meta)
        matched_det = np.full(m, -1, np.int64)
        if n and m:
            iou = _iou_xywh(self.X[:, :4].astype(np.float32), boxes.astype(np.float32))
            # Class-gated association: different classes never match.
            track_cls = np.array([t.class_id for t in self.meta])
            gate = track_cls[:, None] == classes[None, :]
            if self.assoc == "motion":
                # Motion-gated association (VERDICT r4 #5): the KF state
                # the bank already maintains disambiguates what IoU alone
                # cannot. (a) Tie-break: at crossing density two tracks
                # overlap one detection with near-equal IoU — adding a
                # box-scaled predicted-center distance to the cost prefers
                # the track whose PREDICTION is closest, which encodes the
                # velocity history. (b) Rescue: a well-predicted target
                # whose jittered box slipped under the IoU gate would mint
                # a fresh id (an id switch by construction); admit it when
                # the center lands within the track's own box scale AND
                # inside the chi2-99% Mahalanobis ellipse of the position
                # innovation covariance.
                diff = (boxes[:, :2].astype(np.float64)[None, :, :]
                        - self.X[:, None, :2])                    # (N,M,2)
                S = self.P[:, :2, :2] + np.eye(2) * self.r        # (N,2,2)
                d2 = np.einsum("nmi,nij,nmj->nm", diff,
                               np.linalg.inv(S), diff)
                scale = np.maximum((self.X[:, 2] + self.X[:, 3]) / 4.0,
                                   1e-3)                          # (N,)
                norm_d = (np.linalg.norm(diff, axis=-1)
                          / scale[:, None])                       # (N,M)
                rescue = ((norm_d <= self._RESCUE_NORM_D)
                          & (d2 <= self._CHI2_99_2DOF))
                admit = gate & ((iou >= self.iou_threshold) | rescue)
                cost = np.where(
                    admit,
                    (1.0 - iou) + self._MOTION_LAMBDA
                    * np.minimum(norm_d, 4.0),
                    2.0)
            else:
                # Reference-intended IoU-only association.
                admit = gate & (iou >= self.iou_threshold)
                cost = 1.0 - np.where(gate, iou, -1.0)
            rows, cols = linear_sum_assignment(cost)
            upd_rows, upd_z = [], []
            for r_i, c_i in zip(rows, cols):
                if not admit[r_i, c_i]:
                    continue
                matched_det[c_i] = r_i
                upd_rows.append(r_i)
                upd_z.append(boxes[c_i])
                t = self.meta[r_i]
                t.hits += 1
                t.last_update_ms = now_ms
                t.confidence = 0.7 * t.confidence + 0.3 * float(confidences[c_i])
            if upd_rows:
                self._update_rows(np.asarray(upd_rows), np.asarray(upd_z))

        # New tracks for unmatched detections.
        for c_i in range(m):
            if matched_det[c_i] < 0:
                self._add(boxes[c_i], int(classes[c_i]), float(confidences[c_i]), now_ms)
                matched_det[c_i] = len(self.meta) - 1

        # Age out on SILENCE only (no match for > max_age/2). The reference
        # additionally expired on absolute age (kalman_tracker.cpp:167-171),
        # which forces a continuously-matched target onto a fresh id + a
        # 3-frame re-confirmation every max_age (500 ms default) — id churn
        # no wire client can want, in code the reference never actually ran
        # (its tracker was an orphan, SURVEY §2.3). Deliberate deviation:
        # matched tracks keep their id indefinitely; the silent-gap rule
        # alone bounds stale-track lifetime (docs/PARITY.md #17).
        keep = np.ones(len(self.meta), bool)
        for i, t in enumerate(self.meta):
            if now_ms - t.last_update_ms > self.max_age_ms / 2:
                keep[i] = False

        # Bound the bank (docstring contract): a jittery detector minting
        # low-IoU/class-flapping detections would otherwise grow the
        # Hungarian cost matrix without limit on the event-loop result
        # path. Keep matched-this-frame first, then confirmed, then most
        # recently updated.
        matched_rows = {int(r) for r in matched_det}
        if int(keep.sum()) > self.max_tracks:
            order = sorted(
                (int(i) for i in np.nonzero(keep)[0]),
                key=lambda i: (i in matched_rows,
                               self.meta[i].hits >= self.min_hits,
                               self.meta[i].last_update_ms),
                reverse=True)
            for i in order[self.max_tracks:]:
                keep[i] = False

        out: List[Tuple[np.ndarray, float, int, int]] = []
        for c_i in range(m):
            t = self.meta[matched_det[c_i]]
            out.append((boxes[c_i].copy(), float(confidences[c_i]),
                        int(classes[c_i]), t.track_id))
        # Coasted predictions for confirmed tracks unmatched this frame.
        for i, t in enumerate(self.meta):
            if i in matched_rows or not keep[i]:
                continue
            if t.hits >= self.min_hits:
                out.append((self.X[i, :4].astype(np.float32).copy(),
                            t.confidence * 0.9, t.class_id, t.track_id))
                t.confidence *= 0.9
        self._drop(keep)
        return out
