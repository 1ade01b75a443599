"""Out-of-distribution synthetic eval domain.

A copy of the JAX package's `train/ood.py` (NumPy; the level-3 JPEG round
trip needs `cv2`, behind `jpeg_available`): for a seed and level it draws
the same scenes.

Every accuracy number through round 3 was scored on the training task's own
distribution (clean gray background, large flat-color rectangles — the
generators in train/loop.py). This module is a deliberately HARDER held-out
domain with the SAME label semantics, used only for evaluation, so claims
like "accuracy holds at the 320 serve rung" and "the distilled student beats
its teacher" can be re-scored out of distribution:

  - textured backgrounds: multi-octave value noise + low-saturation clutter
    rectangles/stripes (distractors share shape, not class color)
  - objects: the training task's class→color code (channel `cls%3` dominant,
    bright for cls<3, dim for cls 3) kept DECODABLE but perturbed — textured
    fill, per-instance gain jitter, elliptical masks, small boxes down to
    4% of the image, back-to-front occlusion with visibility-based label
    dropping (<30% visible ⇒ not a label, same rule as crowded_batches)
  - photometric: global gamma/brightness/channel-gain jitter, additive
    Gaussian noise
  - codec: JPEG round-trip at quality 40-85 (the wire path's own lossy
    codec — runtime/frames.py serves JPEG keyframes)

The class code survives all of this by construction (dominant channel and
bright/dim level are preserved within decodable margins), so a perfect
detector CAN solve the domain; the gap between in-distribution and OOD
scores measures how much of a model's accuracy is distribution memorization.

Levels: 1 = textured+photometric+small boxes; 2 = + occlusion + clutter;
3 = + JPEG round-trip + heavier noise. Eval entry:
`scripts/eval_artifact.py --task ood[1-3]`.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def _value_noise(rng: np.random.Generator, size: int,
                 octaves: Tuple[int, ...] = (4, 8, 16, 32)) -> np.ndarray:
    """Multi-octave value noise in [0,1], (size, size)."""
    acc = np.zeros((size, size), np.float32)
    amp_total = 0.0
    amp = 1.0
    for cells in octaves:
        grid = rng.random((cells + 1, cells + 1), dtype=np.float32)
        # Bilinear upsample grid -> size.
        xs = np.linspace(0, cells, size, dtype=np.float32)
        i0 = np.minimum(xs.astype(np.int32), cells - 1)
        f = xs - i0
        row = (grid[i0] * (1 - f)[:, None] + grid[i0 + 1] * f[:, None])
        col = (row[:, i0] * (1 - f)[None, :] + row[:, i0 + 1] * f[None, :])
        acc += amp * col
        amp_total += amp
        amp *= 0.55
    return acc / amp_total


def paint_distractors(rng: np.random.Generator, img: np.ndarray,
                      n_rects: int, n_stripes: int,
                      avoid_boxes=None) -> None:
    """Paint low-saturation distractor rectangles + thin stripes in place:
    object-like SHAPES whose color code is deliberately ambiguous (no
    dominant channel) — a color-code detector should reject them.

    Shared by the OOD eval domain (backgrounds, painted BEFORE objects so
    avoidance is unnecessary) and the `--clutter` training augmentation
    (painted AFTER labeled objects, so `avoid_boxes` — (M, 4) normalized
    cxcywh — enforces label safety: each labeled box has a CUMULATIVE 20%
    coverage budget across all accepted rectangles (several small rects
    must not together bury a box whose label survives), and stripes skip
    the labeled boxes' pixels entirely, never burying a label the targets
    still assert exists). The RNG call sequence with avoid_boxes=None is
    frozen: the committed OOD eval numbers depend on it."""
    size = img.shape[0]
    mask = None
    if avoid_boxes is not None and len(avoid_boxes):
        mask = np.zeros((size, size), bool)
        for bx in avoid_boxes:
            bx0 = int((bx[0] - bx[2] / 2) * size)
            bx1 = max(int((bx[0] + bx[2] / 2) * size), bx0 + 1)
            by0 = int((bx[1] - bx[3] / 2) * size)
            by1 = max(int((bx[1] + bx[3] / 2) * size), by0 + 1)
            mask[max(by0, 0):max(by1, 0), max(bx0, 0):max(bx1, 0)] = True
    # Cumulative per-box coverage budget: the 20% label-safety
    # bound holds across ALL accepted rects, not per rect — up to 4 rects
    # at full strength could otherwise bury half a box piecewise. The
    # overlap sum can double-count rect intersections; that only makes the
    # budget conservative.
    cover = (np.zeros(len(avoid_boxes), np.float32)
             if avoid_boxes is not None else None)
    for _ in range(n_rects):
        w = rng.uniform(0.05, 0.3)
        h = rng.uniform(0.05, 0.3)
        cx, cy = rng.uniform(0.1, 0.9, 2)
        if avoid_boxes is not None:
            blocked = False
            ov = np.zeros(len(avoid_boxes), np.float32)
            for k, bx in enumerate(avoid_boxes):
                ox = max(0.0, min(cx + w / 2, bx[0] + bx[2] / 2)
                         - max(cx - w / 2, bx[0] - bx[2] / 2))
                oy = max(0.0, min(cy + h / 2, bx[1] + bx[3] / 2)
                         - max(cy - h / 2, bx[1] - bx[3] / 2))
                ov[k] = ox * oy
                if cover[k] + ov[k] > 0.2 * bx[2] * bx[3]:
                    blocked = True
                    break
            if blocked:
                continue
            cover += ov
        x0, x1 = int((cx - w / 2) * size), int((cx + w / 2) * size)
        y0, y1 = int((cy - h / 2) * size), int((cy + h / 2) * size)
        level = rng.uniform(0.2, 0.75)
        col = np.full(3, level, np.float32) \
            + rng.uniform(-0.06, 0.06, 3).astype(np.float32)
        img[max(y0, 0):max(y1, 0), max(x0, 0):max(x1, 0)] = col
    for _ in range(n_stripes):
        y = int(rng.uniform(0, 1) * size)
        t = max(int(rng.uniform(0.005, 0.02) * size), 1)
        gain = rng.uniform(0.6, 1.4)
        if mask is None:
            img[y:y + t] *= gain
        else:
            # Label-safe stripes: a full-width band can bury a small
            # (mosaic-cropped) labeled box entirely — apply the gain only
            # OUTSIDE labeled pixels.
            rows = img[y:y + t]
            keep = ~mask[y:y + t]
            rows[keep] = rows[keep] * gain


def _paint_background(rng: np.random.Generator, size: int,
                      clutter: bool) -> np.ndarray:
    base = 0.35 + 0.25 * (_value_noise(rng, size) - 0.5)
    img = np.stack([base, base, base], axis=-1)
    # Mild color cast in the texture.
    img *= (1.0 + rng.uniform(-0.08, 0.08, 3)).astype(np.float32)
    if clutter:
        # Two calls so the count draws stay at their historical positions
        # in the RNG sequence (rect count -> rects -> stripe count ->
        # stripes): the committed OOD numbers depend on these scenes.
        paint_distractors(rng, img, int(rng.integers(3, 8)), 0)
        paint_distractors(rng, img, 0, int(rng.integers(1, 4)))
    return np.clip(img, 0.0, 1.0)


def _class_color(rng: np.random.Generator, cls: int) -> np.ndarray:
    """The training task's class code (train/loop.py synthetic_batches:
    channel cls%3 dominant; bright 0.9 for cls<3, dim 0.6 for cls 3),
    jittered within decodable margins."""
    level = (0.9 if cls < 3 else 0.6) + rng.uniform(-0.07, 0.07)
    col = np.full(3, rng.uniform(0.02, 0.12), np.float32)
    col[cls % 3] = level
    return col


def jpeg_available() -> bool:
    """True when cv2 (the wire codec) can run the ood3 JPEG roundtrip."""
    try:
        import cv2  # noqa: F401
        return True
    except Exception:  # pragma: no cover - cv2 is in-image
        return False


def _jpeg_roundtrip(img: np.ndarray, quality: int) -> np.ndarray:
    """JPEG encode/decode via cv2 (the wire codec); no-op without cv2
    (level-3 callers must gate on jpeg_available() first — a silent no-op
    here would score ood3 on a measurably easier domain)."""
    try:
        import cv2
    except Exception:  # pragma: no cover - cv2 is in-image
        return img
    u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    ok, enc = cv2.imencode(".jpg", u8[:, :, ::-1],
                           [cv2.IMWRITE_JPEG_QUALITY, int(quality)])
    if not ok:  # pragma: no cover
        return img
    dec = cv2.imdecode(enc, cv2.IMREAD_COLOR)[:, :, ::-1]
    return dec.astype(np.float32) / 255.0


def ood_batches(batch: int, size: int, max_boxes: int = 12, seed: int = 0,
                level: int = 2) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless OOD eval scenes; same (images, targets) contract as
    synthetic_batches. Deterministic per (seed, level)."""
    if level not in (1, 2, 3):
        raise ValueError(f"ood level {level} not in 1..3")
    rng = np.random.default_rng(seed)
    occlusion = level >= 2
    clutter = level >= 2
    jpeg = level >= 3
    if jpeg and not jpeg_available():
        # Fail loudly: a silent JPEG no-op would score ood3 on
        # a measurably easier domain, and the committed rows would not
        # reproduce across environments.
        raise RuntimeError(
            "ood level 3 requires cv2 for the JPEG roundtrip; refusing to "
            "score the no-compression domain as ood3")
    noise_sigma = {1: 0.02, 2: 0.03, 3: 0.05}[level]
    while True:
        images = np.empty((batch, size, size, 3), np.float32)
        targets = np.full((batch, max_boxes, 5), -1.0, np.float32)
        for b in range(batch):
            img = _paint_background(rng, size, clutter)
            # Level 1 keeps scenes sparse (occlusion is a level-2 axis);
            # level 2+ crowds up to 8 instances so boxes genuinely occlude.
            n = int(rng.integers(2, (min(max_boxes, 8) if occlusion else 4)
                                 + 1))
            owner = np.full((size, size), -1, np.int32)
            boxes = []
            for m in range(n):
                # Small-to-medium boxes: down to 4% of the image (the
                # training task floor is 15%).
                w = rng.uniform(0.04, 0.25)
                h = rng.uniform(0.04, 0.25)
                cx = rng.uniform(w / 2, 1 - w / 2)
                cy = rng.uniform(h / 2, 1 - h / 2)
                cls = int(rng.integers(0, 4))
                col = _class_color(rng, cls)
                x0, x1 = int((cx - w / 2) * size), int((cx + w / 2) * size)
                y0, y1 = int((cy - h / 2) * size), int((cy + h / 2) * size)
                x1, y1 = max(x1, x0 + 1), max(y1, y0 + 1)
                ph, pw = y1 - y0, x1 - x0
                # Textured fill: multiplicative noise keeps the dominant-
                # channel code while killing the flat-fill shortcut.
                tex = 1.0 + 0.2 * (rng.random((ph, pw, 1),
                                              dtype=np.float32) - 0.5)
                patch = np.clip(col[None, None] * tex, 0.0, 1.0)
                if rng.random() < 0.5:
                    # Elliptical mask: box labels, non-box support.
                    yy, xx = np.mgrid[0:ph, 0:pw].astype(np.float32)
                    ell = (((yy - (ph - 1) / 2) / (ph / 2 + 1e-6)) ** 2
                           + ((xx - (pw - 1) / 2) / (pw / 2 + 1e-6)) ** 2
                           ) <= 1.0
                else:
                    ell = np.ones((ph, pw), bool)
                region = img[y0:y1, x0:x1]
                region[ell] = patch[ell]
                own = owner[y0:y1, x0:x1]
                own[ell] = m
                boxes.append((cls, cx, cy, w, h, max(int(ell.sum()), 1)))
            kept = 0
            for m, (cls, cx, cy, w, h, area) in enumerate(boxes):
                if kept >= max_boxes:
                    break
                # Visibility rule shared with crowded_batches: a mostly
                # painted-over box is label noise, not a target.
                if float((owner == m).sum()) / area >= 0.3:
                    targets[b, kept] = (cls, cx, cy, w, h)
                    kept += 1
            # Photometric: gamma + brightness + per-channel gain.
            img = np.clip(img, 0.0, 1.0) ** rng.uniform(0.8, 1.25)
            img *= rng.uniform(0.85, 1.1)
            img *= (1.0 + rng.uniform(-0.08, 0.08, 3)).astype(np.float32)
            img += rng.normal(0.0, noise_sigma, img.shape).astype(np.float32)
            img = np.clip(img, 0.0, 1.0)
            if jpeg:
                img = _jpeg_roundtrip(img, int(rng.integers(40, 86)))
            images[b] = img
        yield images, targets
