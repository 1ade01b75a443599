"""The one traffic generator: a workload file's parameters -> frames.

A traffic mix is a JSON file under `workloads/`; every key is read here:

    streams            open-loop client streams
    fps                frames a stream sends each second (its schedule)
    frame              [height, width] of a captured frame
    keyframe_interval  a keyframe every this many frames, region writes between
    roi_padding        padding of the changed-region box (the client's)
    rects              [fewest, most] rectangles in a scene
    speed_px           [slowest, fastest] rectangle speed, pixels a frame
    pool_groups        keyframe groups pre-rendered, shared by the streams
    scene_seed         draws the scenes' rectangles: sizes, counts, paths
    ramp_s             seconds of traffic before the measured window
    sample             served frames compared with the reference
    max_failed_share   above this share of offered frames without a result
                       of their own, the run warns that its load is not
                       below the knee on this host

Scenes are the task the trained weights learned (a NumPy copy of the
training painter: a 0.35-gray canvas and rectangles whose colour gives the
class). Every rectangle edge lies on the 4-pixel grid that the client's
change detector samples, so no motion escapes it and a keyframe plus its
region writes rebuild the client's frame exactly. The first rectangle
moves 4 pixels every frame and is painted last, so every frame has a
change to send.

Every run seed sends the same amount of work: the scenes' rectangles
(how many, their sizes, speeds and paths) come from the mix's fixed
`scene_seed`, so the region writes have the same sizes whatever the run's
seed. The run's seed draws, for each scene, a mirroring (left-right,
top-bottom) and a permutation of the classes (so of the colours), the
order of the scenes in the pool, and each stream's offset into it: the
same sizes and arrivals in another order, on content that differs.

Stream s sends at due times T0 + (k + s / streams) / fps. Its frames walk
the pool's groups from its offset, one group a keyframe interval, each
group a keyframe and its region writes.
"""

from __future__ import annotations

import copy
import json
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

GRID = 4            # the change detector's sampling step
BACKGROUND = 0.35   # the training painter's canvas


def load(name: str, root: Path) -> dict:
    with open(root / "workloads" / f"{name}.json") as f:
        return json.load(f)


def compute_diff_region(current: np.ndarray, previous: np.ndarray,
                        threshold: int = 10, sample_step: int = GRID,
                        padding: int = 20, align: int = 8
                        ) -> Optional[Tuple[int, int, int, int]]:
    """Changed-region box (x, y, w, h) between two RGB frames, or None: the
    reference client's grid-sampled diff (a copy of the simulator's)."""
    h, w = current.shape[:2]
    cur = current[::sample_step, ::sample_step].astype(np.int16)
    prev = previous[::sample_step, ::sample_step].astype(np.int16)
    changed = (np.abs(cur - prev) > threshold).any(axis=-1)
    ys, xs = np.nonzero(changed)
    if len(ys) == 0:
        return None
    x0 = max(0, int(xs.min()) * sample_step - padding)
    y0 = max(0, int(ys.min()) * sample_step - padding)
    x1 = min(w - 1, int(xs.max()) * sample_step + padding)
    y1 = min(h - 1, int(ys.max()) * sample_step + padding)
    x0 = (x0 // align) * align
    y0 = (y0 // align) * align
    rw = min(w - x0, ((x1 - x0 + 1 + align - 1) // align) * align)
    rh = min(h - y0, ((y1 - y0 + 1 + align - 1) // align) * align)
    return (x0, y0, rw, rh)


def _to_u8(v: float) -> int:
    return int(np.round(v * 255.0))


def _bounce(p: np.ndarray, span: np.ndarray) -> np.ndarray:
    """Positions reflected into [0, span] (a triangle wave)."""
    m = np.mod(p, 2 * span)
    return np.where(m > span, 2 * span - m, m)


class Scene:
    """Rectangles of one keyframe group: sizes, classes, start and speed."""

    def __init__(self, rng: np.random.Generator, h: int, w: int,
                 rects: Tuple[int, int], speed: Tuple[float, float]) -> None:
        self.flip = (False, False)
        self.classes = np.arange(4)
        n = int(rng.integers(rects[0], rects[1] + 1))
        self.h, self.w = h, w
        self.size = np.stack([_snap(rng.uniform(0.15, 0.5, n) * h),
                              _snap(rng.uniform(0.15, 0.5, n) * w)], -1)
        self.cls = rng.integers(0, 4, n)
        self.span = np.stack([h - self.size[:, 0], w - self.size[:, 1]], -1)
        self.start = _snap(rng.uniform(0, 1, (n, 2)) * self.span)
        angle = rng.uniform(0, 2 * np.pi, n)
        v = rng.uniform(speed[0], speed[1], n)
        self.vel = np.stack([v * np.sin(angle), v * np.cos(angle)], -1)
        axis = int(rng.integers(0, 2))
        self.vel[0] = 0.0
        self.vel[0, axis] = GRID * (1 if rng.integers(0, 2) else -1)

    def variant(self, rng: np.random.Generator) -> "Scene":
        """This scene mirrored and with its classes permuted, as drawn."""
        out = copy.copy(self)
        out.flip = (bool(rng.integers(0, 2)), bool(rng.integers(0, 2)))
        out.classes = rng.permutation(4)
        return out

    def paint(self, t: int) -> np.ndarray:
        frame = np.full((self.h, self.w, 3), _to_u8(BACKGROUND), np.uint8)
        pos = _snap(_bounce(self.start + self.vel * t, self.span))
        if self.flip[0]:
            pos[:, 0] = self.span[:, 0] - pos[:, 0]
        if self.flip[1]:
            pos[:, 1] = self.span[:, 1] - pos[:, 1]
        for i in list(range(1, len(self.cls))) + [0]:
            y, x = pos[i]
            rh, rw = self.size[i]
            color = np.zeros(3, np.uint8)
            c = int(self.classes[self.cls[i]])
            color[c % 3] = _to_u8(0.9 if c < 3 else 0.6)
            frame[y:y + rh, x:x + rw] = color
        return frame


def _snap(v: np.ndarray) -> np.ndarray:
    return (np.round(np.asarray(v) / GRID) * GRID).astype(np.int64)


@dataclass
class Group:
    """A keyframe and the (x, y, pixels) region writes that follow it."""
    keyframe: np.ndarray
    regions: List[Tuple[int, int, np.ndarray]]


def render_group(scene: Scene, mix: dict) -> Tuple[Optional[Group], list]:
    """One group and the frames the client captured (for tests); no group
    where a frame has no change to send."""
    frames = [scene.paint(t) for t in range(mix["keyframe_interval"])]
    regions = []
    for prev, cur in zip(frames, frames[1:]):
        box = compute_diff_region(cur, prev, padding=mix["roi_padding"])
        if box is None:
            return None, frames
        x, y, rw, rh = box
        regions.append((x, y, np.ascontiguousarray(cur[y:y + rh, x:x + rw])))
    return Group(frames[0], regions), frames


def pool(mix: dict, seed: int) -> List[Tuple[Group, list]]:
    """The pool's groups (and their captured frames): the mix's scenes,
    each mirrored and recoloured as the seed draws, in the seed's order.
    A scene whose every drawn variant leaves a frame without a change is
    left out (as a scene is whose own frames do)."""
    h, w = mix["frame"]
    base = np.random.default_rng(mix["scene_seed"])
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(int(mix["pool_groups"])):
        scene = Scene(base, h, w, tuple(mix["rects"]), tuple(mix["speed_px"]))
        for _ in range(8):
            group, frames = render_group(scene.variant(rng), mix)
            if group is not None:
                out.append((group, frames))
                break
    return [out[i] for i in rng.permutation(len(out))]


class Traffic:
    """A run's frames and schedule, all drawn from the seed."""

    def __init__(self, mix: dict, seed: int) -> None:
        self.mix = mix
        self.streams = int(mix["streams"])
        self.fps = float(mix["fps"])
        self.interval = int(mix["keyframe_interval"])
        self.groups = [g for g, _ in pool(mix, seed)]
        rng = np.random.default_rng([seed, 2])
        self.offsets = rng.integers(0, len(self.groups), self.streams)

    def due(self, event: int) -> Tuple[int, int, float]:
        """(stream, frame index, seconds after T0) of the event-th send."""
        k, s = divmod(event, self.streams)
        return s, k, (k + s / self.streams) / self.fps

    def write(self, stream: int, k: int):
        """("key", pixels) or ("roi", (x, y, pixels)) of stream's frame k."""
        g = self.groups[(self.offsets[stream] + k // self.interval)
                        % len(self.groups)]
        pos = k % self.interval
        return ("key", g.keyframe) if pos == 0 else ("roi", g.regions[pos - 1])

    def history(self, stream: int, k: int):
        """The keyframe and the region writes a server holds for frame k."""
        g = self.groups[(self.offsets[stream] + k // self.interval)
                        % len(self.groups)]
        return g.keyframe, g.regions[:k % self.interval]
