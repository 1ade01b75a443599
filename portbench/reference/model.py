"""YOLOv8 (ultralytics `yolov8.yaml`) in plain float32 PyTorch, NCHW.

Weights come from the native `.npz` archive: a flat "m0/w"-keyed tree of
HWIO kernels, with either a folded bias ("b") or an unfolded BatchNorm
block ("bn/gamma", "bn/beta", "bn/mean", "bn/var"), which is folded here.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-3  # ultralytics BatchNorm2d
REG_MAX = 16
STRIDES = (8, 16, 32)
BASE_CHANNELS = (64, 128, 256, 512, 1024)


class Scale:
    """A published YOLOv8 scale: depth and width multiples, channel cap,
    and the number of classes."""

    def __init__(self, depth: float, width: float, max_channels: int,
                 nc: int) -> None:
        self.depth, self.width = depth, width
        self.max_channels, self.nc = max_channels, nc

    def ch(self, base: int) -> int:
        return int(math.ceil(min(base, self.max_channels) * self.width / 8)
                   * 8)

    def n(self, repeats: int) -> int:
        return max(round(repeats * self.depth), 1)


def sha256_of(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def load_weights(path: str, sha256: str, device) -> Dict[str, torch.Tensor]:
    """{conv path: OIHW weight, conv path + "#b": bias} in float32 on
    `device`, BatchNorm folded. Refuses a file whose hash differs."""
    got = sha256_of(path)
    if got != sha256:
        raise ValueError(f"{path}: sha256 {got}, the configuration names "
                         f"{sha256}")
    with np.load(path) as z:
        flat = {k: z[k].astype(np.float64) for k in z.files}
    convs = sorted({k.rsplit("/", 1)[0] for k in flat if k.endswith("/w")})
    out: Dict[str, torch.Tensor] = {}
    for c in convs:
        w = flat[f"{c}/w"]
        b = flat.get(f"{c}/b", np.zeros(w.shape[-1]))
        if f"{c}/bn/gamma" in flat:
            scale = flat[f"{c}/bn/gamma"] / np.sqrt(flat[f"{c}/bn/var"]
                                                    + BN_EPS)
            w = w * scale
            b = flat[f"{c}/bn/beta"] + (b - flat[f"{c}/bn/mean"]) * scale
        out[c] = torch.tensor(np.transpose(w, (3, 2, 0, 1)),
                              dtype=torch.float32, device=device)
        out[c + "#b"] = torch.tensor(b, dtype=torch.float32, device=device)
    return out


def _conv(wts, name: str, x: torch.Tensor, stride: int = 1,
          act: bool = True) -> torch.Tensor:
    w = wts[name]
    y = F.conv2d(x, w, wts[name + "#b"], stride=stride,
                 padding=(w.shape[-1] - 1) // 2)
    return F.silu(y) if act else y


def _c2f(wts, name: str, x: torch.Tensor, n: int,
         shortcut: bool) -> torch.Tensor:
    y = _conv(wts, f"{name}/cv1", x)
    ys = list(y.chunk(2, dim=1))
    for i in range(n):
        t = _conv(wts, f"{name}/m/{i}/cv2", _conv(wts, f"{name}/m/{i}/cv1",
                                                  ys[-1]))
        ys.append(ys[-1] + t if shortcut else t)
    return _conv(wts, f"{name}/cv2", torch.cat(ys, dim=1))


def _sppf(wts, name: str, x: torch.Tensor) -> torch.Tensor:
    ys = [_conv(wts, f"{name}/cv1", x)]
    for _ in range(3):
        ys.append(F.max_pool2d(ys[-1], 5, stride=1, padding=2))
    return _conv(wts, f"{name}/cv2", torch.cat(ys, dim=1))


def _up(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def forward(wts, scale: Scale, x: torch.Tensor) -> List[torch.Tensor]:
    """x (B, 3, S, S) in [0, 1] -> per level (B, 4 * REG_MAX + nc, H, W)."""
    n = scale.n
    x = _conv(wts, "m0", x, 2)
    x = _conv(wts, "m1", x, 2)
    x = _c2f(wts, "m2", x, n(3), True)
    x = _conv(wts, "m3", x, 2)
    p3_in = _c2f(wts, "m4", x, n(6), True)
    x = _conv(wts, "m5", p3_in, 2)
    p4_in = _c2f(wts, "m6", x, n(6), True)
    x = _conv(wts, "m7", p4_in, 2)
    x = _c2f(wts, "m8", x, n(3), True)
    p5_in = _sppf(wts, "m9", x)
    n12 = _c2f(wts, "m12", torch.cat([_up(p5_in), p4_in], 1), n(3), False)
    p3 = _c2f(wts, "m15", torch.cat([_up(n12), p3_in], 1), n(3), False)
    p4 = _c2f(wts, "m18", torch.cat([_conv(wts, "m16", p3, 2), n12], 1),
              n(3), False)
    p5 = _c2f(wts, "m21", torch.cat([_conv(wts, "m19", p4, 2), p5_in], 1),
              n(3), False)
    outs = []
    for lvl, f in enumerate((p3, p4, p5)):
        box, cls = f, f
        for i in range(3):
            box = _conv(wts, f"m22/cv2/{lvl}/{i}", box, act=i < 2)
            cls = _conv(wts, f"m22/cv3/{lvl}/{i}", cls, act=i < 2)
        outs.append(torch.cat([box, cls], dim=1))
    return outs


def decode(outs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-level maps -> (boxes (B, A, 4) cx, cy, w, h in input pixels,
    class probabilities (B, A, nc)), anchors level by level, row-major."""
    boxes, probs = [], []
    bins = torch.arange(REG_MAX, dtype=torch.float32, device=outs[0].device)
    for o, s in zip(outs, STRIDES):
        b, _, h, w = o.shape
        o = o.permute(0, 2, 3, 1).reshape(b, h * w, -1)
        dist = (torch.softmax(o[..., :4 * REG_MAX].reshape(b, h * w, 4,
                                                           REG_MAX), -1)
                * bins).sum(-1)
        gy, gx = torch.meshgrid(torch.arange(h, device=o.device),
                                torch.arange(w, device=o.device),
                                indexing="ij")
        anc = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1).float() + 0.5
        x1y1 = anc - dist[..., :2]
        x2y2 = anc + dist[..., 2:]
        boxes.append(torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], -1) * s)
        probs.append(torch.sigmoid(o[..., 4 * REG_MAX:]))
    return torch.cat(boxes, 1), torch.cat(probs, 1)
