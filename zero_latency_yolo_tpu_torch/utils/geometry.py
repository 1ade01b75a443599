"""Shared NumPy box geometry (host-side).

One pairwise-IoU implementation for every host consumer — the tracker's
association cost matrix (runtime/tracker.py) and the evaluator's greedy
matching (train/eval.py). Boxes are center-format (cx, cy, w, h), the wire
Detection convention (protocol/packets.py; reference types.h:16-26). The
device-side (jnp) IoU lives with the NMS kernel in ops/nms.py — serving
never calls into host NumPy.
"""

from __future__ import annotations

import numpy as np


def iou_matrix_cxcywh(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of (N,4) vs (M,4) center-format boxes -> (N, M) f32."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    ax1, ay1 = a[:, 0] - a[:, 2] / 2, a[:, 1] - a[:, 3] / 2
    ax2, ay2 = a[:, 0] + a[:, 2] / 2, a[:, 1] + a[:, 3] / 2
    bx1, by1 = b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2
    bx2, by2 = b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2
    iw = np.maximum(0.0, np.minimum(ax2[:, None], bx2[None])
                    - np.maximum(ax1[:, None], bx1[None]))
    ih = np.maximum(0.0, np.minimum(ay2[:, None], by2[None])
                    - np.maximum(ay1[:, None], by1[None]))
    inter = iw * ih
    area_a = (a[:, 2] * a[:, 3])[:, None]
    area_b = (b[:, 2] * b[:, 3])[None]
    return (inter / np.maximum(area_a + area_b - inter, 1e-9)
            ).astype(np.float32)
