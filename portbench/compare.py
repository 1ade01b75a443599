"""How a served frame's detections are held against the reference's.

Both directions are compared, and the served set's own guarantees.

Served to reference. bf16 and f32 rank an object's competing anchors (and,
where rectangles of one class touch, whole merged or split objects)
differently now and then, so the served set and the reference's may keep
different, equally valid anchors of one object, and differ in size by one
or two. So each served detection is compared with the reference's own
anchor that lies nearest to it, among the anchors whose weighted score for
the served class comes within `CAND_MARGIN` of the threshold. Nearest in
box and score together: neighbouring anchors can predict one box to a pixel
with scores far apart, so the anchor is the one whose larger of box gap /
`BOX_UNIT` and score gap / `SCORE_UNIT` (the gaps bf16 leaves against f32)
is least:

    box_gap_px     the widest gap, over served detections, between a served
                   box and that anchor's box (centre, width, height; the
                   largest coordinate gap in source pixels), or the frame's
                   width where the reference has no such anchor
    score_gap      the widest gap between a served score and that anchor's
                   score for the served class (clipped to [0, 1])

Reference to served. A detection the reference serves has to turn up in
the served set, where bf16 cannot rightly drop it: its score lies at least
`RECALL_MARGIN` above the threshold, its class leads the anchor's next by
as much, and fewer than `pre_nms_topk` of the reference's anchors score
within twice that of it (so bf16's reordering keeps it among the top-K).
Then the program either serves it or suppressed it with a served
same-class box that overlaps it by more than the suppression threshold.

    lost_rows      over the sampled frames, how many such reference
                   detections no served box of their class overlaps by
                   `LOST_IOU` or more: a frame served empty, a lost object,
                   a result taken from another frame, suppression that
                   left the top-K to one object

The served set's own guarantees, which the configuration states.

    dup_iou        the largest IoU of two served detections of one class:
                   greedy suppression keeps none above `nms_threshold`
    below_conf     how far the lowest served score lies under the
                   confidence threshold (0 where none does): the program
                   compares the very score it serves

Only the numbers the configuration file's `limits` names decide
`correct`; `count_gap`, the widest difference in detections a frame, is
reported beside them.

A detection is a row [cx, cy, w, h, score, class], its box normalised to
the source frame and its score clipped to [0, 1].
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

CAND_MARGIN = 0.2
RECALL_MARGIN = 0.05
LOST_IOU = 0.1
BOX_UNIT = 1.0     # px
SCORE_UNIT = 0.01
NUMBERS = ("box_gap_px", "score_gap", "lost_rows", "dup_iou", "below_conf",
           "count_gap")
SUMMED = ("lost_rows",)   # added over the frames; the others their widest


def iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of centre-format boxes: (n, 4) against (m, 4) -> (n, m)."""
    a1, a2 = a[:, None, :2] - a[:, None, 2:] / 2, a[:, None, :2] + a[:, None, 2:] / 2
    b1, b2 = b[None, :, :2] - b[None, :, 2:] / 2, b[None, :, :2] + b[None, :, 2:] / 2
    wh = np.clip(np.minimum(a2, b2) - np.maximum(a1, b1), 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = (a[:, None, 2] * a[:, None, 3] + b[None, :, 2] * b[None, :, 3]
             - inter)
    return inter / np.maximum(union, 1e-12)


def frame_numbers(got: np.ndarray, ref, conf: float, topk: int, width: int,
                  height: int) -> Dict[str, float]:
    """Every number of one frame; `ref` is the reference's `Frame`."""
    px = np.array([width, height, width, height], np.float64)
    box, score = 0.0, 0.0
    for d in got:
        c = int(d[5])
        near = ref.scores[:, c] >= conf - CAND_MARGIN
        if not near.any():
            box = max(box, float(width))
            continue
        dist = np.max(np.abs(ref.boxes[near] - d[:4]) * px, axis=1)
        gap = np.abs(ref.scores[near][:, c] - float(d[4]))
        i = int(np.argmin(np.maximum(dist / BOX_UNIT, gap / SCORE_UNIT)))
        box = max(box, float(dist[i]))
        score = max(score, float(gap[i]))
    lost = 0
    best = ref.scores.max(axis=1) if len(ref.scores) else ref.scores[:, 0]
    for r, lead in zip(ref.rows, ref.leads):
        if (r[4] < conf + RECALL_MARGIN or lead < RECALL_MARGIN
                or np.sum(best >= r[4] - 2 * RECALL_MARGIN) >= topk):
            continue
        same = got[got[:, 5] == r[5]]
        if not len(same) or np.max(iou(r[None, :4], same[:, :4])) < LOST_IOU:
            lost += 1
    dup = 0.0
    for c in np.unique(got[:, 5]):
        same = got[got[:, 5] == c]
        if len(same) > 1:
            m = iou(same[:, :4], same[:, :4])
            dup = max(dup, float(np.max(m[np.triu_indices(len(same), 1)])))
    below = max(0.0, conf - float(np.min(got[:, 4]))) if len(got) else 0.0
    return {"box_gap_px": box, "score_gap": score, "lost_rows": float(lost),
            "dup_iou": dup, "below_conf": below,
            "count_gap": float(abs(len(got) - len(ref.rows)))}


def rows_of(detections) -> np.ndarray:
    """The program's `Detection` list as rows."""
    return np.array([[d.x, d.y, d.width, d.height, d.confidence, d.class_id]
                     for d in detections], np.float64).reshape(-1, 6)


def judge(got: Sequence[np.ndarray], ref: Sequence, conf: float, topk: int,
          width: int, height: int, limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]], Dict[str, float],
                     Dict[str, int]]:
    """(correct, {number: {value, limit}} for the numbers `limits` names,
    {number: worst value} for all of them, counts) over the sampled
    frames."""
    worst = dict.fromkeys(NUMBERS, 0.0)
    for g, r in zip(got, ref):
        for k, v in frame_numbers(g, r, conf, topk, width, height).items():
            worst[k] = worst[k] + v if k in SUMMED else max(worst[k], v)
    checks = {k: {"value": worst[k], "limit": float(limits[k])}
              for k in NUMBERS if k in limits}
    counts = {"frames": len(got),
              "detections": int(sum(len(g) for g in got)),
              "reference_detections": int(sum(len(r.rows) for r in ref))}
    # A sample in which the reference finds nothing compares nothing.
    ok = counts["reference_detections"] > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    return ok, checks, worst, counts
