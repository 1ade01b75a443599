"""The serving contract, plainly: frame rebuild, letterbox, postprocess.

`Detector.detect` takes rebuilt uint8 frames and returns, per frame, the
served detections (up to `MAX_DET` rows of (cx, cy, w, h) normalised to
the source frame, the class-weighted score clipped to [0, 1], and the
class) and the anchors that come near the confidence threshold.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .model import Scale, decode, forward, load_weights

MAX_DET = 32
FILL = 114.0 / 255.0  # ultralytics letterbox gray


def rebuild(keyframe: np.ndarray,
            regions: Sequence[Tuple[int, int, np.ndarray]]) -> np.ndarray:
    """The frame a server holds after a keyframe and the (x, y, pixels)
    region writes that followed it, in order."""
    frame = keyframe.copy()
    for x, y, px in regions:
        frame[y:y + px.shape[0], x:x + px.shape[1]] = px
    return frame


def letterbox(frame: torch.Tensor, size: int) -> torch.Tensor:
    """(H, W, 3) uint8 -> (3, size, size) f32 in [0, 1]: an aspect-keeping
    bilinear resize centred on a 114-gray canvas. Output pixel o samples
    source (o - pad + 0.5) / scale - 0.5, edge rows and columns repeated,
    gray where that lies outside [-0.5, extent - 0.5]."""
    h, w = frame.shape[:2]
    dev = frame.device
    hf = torch.tensor(float(h), dtype=torch.float32)
    wf = torch.tensor(float(w), dtype=torch.float32)
    scale = torch.minimum(size / hf, size / wf)
    pad_y = (size - torch.round(hf * scale)) / 2
    pad_x = (size - torch.round(wf * scale)) / 2
    o = torch.arange(size, dtype=torch.float32)

    def taps(pad, extent):
        src = (o - pad + 0.5) / scale - 0.5
        lo = torch.floor(src)
        frac = (src - lo).to(dev)
        i0 = lo.clamp(0, extent - 1).long().to(dev)
        i1 = (lo + 1).clamp(0, extent - 1).long().to(dev)
        inside = ((src >= -0.5) & (src <= extent - 0.5)).to(dev)
        return i0, i1, frac, inside

    y0, y1, fy, iny = taps(pad_y, h)
    x0, x1, fx, inx = taps(pad_x, w)
    f = frame.to(torch.float32)
    rows = f[y0] * (1 - fy)[:, None, None] + f[y1] * fy[:, None, None]
    out = (rows[:, x0] * (1 - fx)[None, :, None]
           + rows[:, x1] * fx[None, :, None]) / 255.0
    inside = (iny[:, None] & inx[None, :])[..., None]
    out = torch.where(inside, out, torch.full((), FILL, device=dev))
    return out.permute(2, 0, 1), float(scale), float(pad_x), float(pad_y)


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of one centre-format box against (K, 4) boxes."""
    ax1, ay1, ax2, ay2 = (a[0] - a[2] / 2, a[1] - a[3] / 2,
                          a[0] + a[2] / 2, a[1] + a[3] / 2)
    bx1, by1 = b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2
    bx2, by2 = b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp(min=0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp(min=0)
    inter = iw * ih
    union = a[2].clamp(min=0) * a[3].clamp(min=0) \
        + b[:, 2].clamp(min=0) * b[:, 3].clamp(min=0) - inter
    return inter / union.clamp(min=1e-9)


def to_source(boxes: torch.Tensor, scale: float, pad_x: float, pad_y: float,
              src_w: int, src_h: int) -> torch.Tensor:
    """(K, 4) centre-format boxes in model-input pixels -> normalised to the
    source frame, clipped to [0, 1]."""
    out = torch.stack([(boxes[:, 0] - pad_x) / scale / src_w,
                       (boxes[:, 1] - pad_y) / scale / src_h,
                       boxes[:, 2] / scale / src_w,
                       boxes[:, 3] / scale / src_h], -1)
    return out.clamp(0.0, 1.0)


def postprocess(boxes: torch.Tensor, probs: torch.Tensor,
                class_weights: torch.Tensor, conf: float, iou: float,
                topk: int, scale: float, pad_x: float, pad_y: float,
                src_w: int, src_h: int, with_margin: bool = False):
    """One frame's (A, 4) boxes and (A, nc) probabilities -> (n, 6) rows
    [cx, cy, w, h, score, class]: each anchor's best class-weighted score,
    those at or above `conf`, the `topk` highest (lower anchor first on
    ties), greedy same-class suppression above `iou`, the first MAX_DET
    kept, boxes back in the source frame and normalised. With
    `with_margin`, also each row's lead of its class over the anchor's
    next best weighted score."""
    weighted = probs * class_weights
    best, cls = weighted.max(-1)
    lead = best - weighted.topk(2, dim=-1)[0][:, 1]
    best = torch.where(best >= float(np.float32(conf)), best,
                       torch.full_like(best, -1.0))
    order = torch.sort(best, descending=True, stable=True)[1][:topk]
    order = order[best[order] > 0]
    cand, scores, classes = boxes[order], best[order], cls[order]
    keep: List[int] = []
    suppressed = torch.zeros(len(order), dtype=torch.bool)
    for i in range(len(order)):
        if suppressed[i]:
            continue
        keep.append(i)
        if len(keep) == MAX_DET:
            break
        over = (_iou(cand[i], cand).cpu() > iou) & (classes == classes[i]).cpu()
        over[:i + 1] = False
        suppressed |= over
    rows = np.zeros((len(keep), 6), np.float64)
    if keep:
        rows[:, :4] = to_source(cand[keep], scale, pad_x, pad_y, src_w,
                                src_h).cpu().numpy()
        rows[:, 4] = scores[keep].clamp(0.0, 1.0).cpu().numpy()
        rows[:, 5] = classes[keep].cpu().numpy()
    if with_margin:
        return rows, lead[order][keep].cpu().numpy().astype(np.float64)
    return rows


class Frame:
    """The reference's answer for one frame: its served detections (rows
    [cx, cy, w, h, score, class]) with each one's lead over its anchor's
    next best class, and every anchor whose class-weighted score for some
    class reaches `floor` (boxes as rows, scores (K, nc) clipped to
    [0, 1])."""

    def __init__(self, rows: np.ndarray, boxes: np.ndarray,
                 scores: np.ndarray, leads: np.ndarray) -> None:
        self.rows, self.boxes, self.scores = rows, boxes, scores
        self.leads = leads


class Detector:
    """The reference detector of one configuration file."""

    def __init__(self, cfg: Dict, weights_path: str, device) -> None:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        m = cfg["model"]
        self.scale = Scale(m["depth_multiple"], m["width_multiple"],
                           m["max_channels"], m["nc"])
        self.size = int(m["imgsz"])
        self.device = torch.device(device)
        self.wts = load_weights(weights_path, cfg["weights_sha256"],
                                self.device)
        s = cfg["server"]
        names = cfg["class_names"]
        cw = s["detection"].get("class_weights", {})
        self.class_weights = torch.tensor(
            [float(cw.get(n, 1.0)) for n in names], dtype=torch.float32,
            device=self.device)
        self.conf = float(s["confidence_threshold"])
        self.iou = float(s["nms_threshold"])
        self.topk = int(s["tpu"]["pre_nms_topk"])

    @torch.inference_mode()
    def detect(self, frames: Sequence[np.ndarray], block: int = 16,
               floor: float = 0.0) -> List[Frame]:
        """Per frame, the served detections and the anchors whose weighted
        score reaches `floor`."""
        out: List[Frame] = []
        for i in range(0, len(frames), block):
            part = frames[i:i + block]
            lbs = [letterbox(torch.from_numpy(f).to(self.device), self.size)
                   for f in part]
            x = torch.stack([lb[0] for lb in lbs])
            boxes, probs = decode(forward(self.wts, self.scale, x))
            for j, (f, (_, sc, px, py)) in enumerate(zip(part, lbs)):
                h, w = f.shape[:2]
                rows, leads = postprocess(
                    boxes[j], probs[j], self.class_weights, self.conf,
                    self.iou, self.topk, sc, px, py, w, h, with_margin=True)
                weighted = probs[j] * self.class_weights
                near = weighted.max(-1)[0] >= floor
                out.append(Frame(
                    rows,
                    to_source(boxes[j][near], sc, px, py, w, h).cpu().numpy()
                    .astype(np.float64),
                    weighted[near].clamp(0.0, 1.0).cpu().numpy()
                    .astype(np.float64), leads))
        return out
