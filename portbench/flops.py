"""Operations, bytes and roofline bounds of the YOLOv8 convs, from shapes.

Every conv of the model at a served size, as the published architecture
(ultralytics `yolov8.yaml`) lays them out: 2 x MACs, and its input,
weights and output counted once in the serving dtype (the bias in f32).
Nothing here depends on which kernel runs a conv, so a later fusion or
split of kernels leaves these numbers right. The letterbox is not counted:
its operations depend on how it is implemented.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List


@dataclass(frozen=True)
class Conv:
    name: str
    cin: int
    cout: int
    k: int
    stride: int
    hin: int
    win: int

    @property
    def hout(self) -> int:
        return -(-self.hin // self.stride)

    @property
    def wout(self) -> int:
        return -(-self.win // self.stride)

    def flops(self, batch: int) -> int:
        return (2 * batch * self.hout * self.wout * self.cout * self.cin
                * self.k * self.k)

    def bytes(self, batch: int) -> int:
        elem = 2  # bf16 activations and weights
        return (elem * (batch * self.hin * self.win * self.cin
                        + self.k * self.k * self.cin * self.cout
                        + batch * self.hout * self.wout * self.cout)
                + 4 * self.cout)


def convs(model: Dict) -> List[Conv]:
    """Every conv of the model described by a configuration's "model"
    block (depth_multiple, width_multiple, max_channels, nc, imgsz)."""
    d, wm = model["depth_multiple"], model["width_multiple"]
    mc, nc, s = model["max_channels"], model["nc"], model["imgsz"]

    def ch(base):
        return int(math.ceil(min(base, mc) * wm / 8) * 8)

    def rep(n):
        return max(round(n * d), 1)

    out: List[Conv] = []

    def conv(name, cin, cout, k, stride, hw):
        out.append(Conv(name, cin, cout, k, stride, hw, hw))
        return -(-hw // stride)

    def c2f(name, cin, cout, n, hw):
        c = cout // 2
        conv(f"{name}/cv1", cin, 2 * c, 1, 1, hw)
        for i in range(n):
            conv(f"{name}/m/{i}/cv1", c, c, 3, 1, hw)
            conv(f"{name}/m/{i}/cv2", c, c, 3, 1, hw)
        conv(f"{name}/cv2", (2 + n) * c, cout, 1, 1, hw)

    hw = conv("m0", 3, ch(64), 3, 2, s)
    hw = conv("m1", ch(64), ch(128), 3, 2, hw)
    c2f("m2", ch(128), ch(128), rep(3), hw)
    p3 = conv("m3", ch(128), ch(256), 3, 2, hw)
    c2f("m4", ch(256), ch(256), rep(6), p3)
    p4 = conv("m5", ch(256), ch(512), 3, 2, p3)
    c2f("m6", ch(512), ch(512), rep(6), p4)
    p5 = conv("m7", ch(512), ch(1024), 3, 2, p4)
    c2f("m8", ch(1024), ch(1024), rep(3), p5)
    conv("m9/cv1", ch(1024), ch(1024) // 2, 1, 1, p5)
    conv("m9/cv2", 2 * ch(1024), ch(1024), 1, 1, p5)
    c2f("m12", ch(1024) + ch(512), ch(512), rep(3), p4)
    c2f("m15", ch(512) + ch(256), ch(256), rep(3), p3)
    conv("m16", ch(256), ch(256), 3, 2, p3)
    c2f("m18", ch(256) + ch(512), ch(512), rep(3), p4)
    conv("m19", ch(512), ch(512), 3, 2, p4)
    c2f("m21", ch(512) + ch(1024), ch(1024), rep(3), p5)
    c2 = max(16, ch(256) // 4, 64)
    c3 = max(ch(256), min(nc, 100))
    for lvl, (cin, hw) in enumerate(zip((ch(256), ch(512), ch(1024)),
                                        (p3, p4, p5))):
        for branch, mid, tip in (("cv2", c2, 64), ("cv3", c3, nc)):
            conv(f"m22/{branch}/{lvl}/0", cin, mid, 3, 1, hw)
            conv(f"m22/{branch}/{lvl}/1", mid, mid, 3, 1, hw)
            conv(f"m22/{branch}/{lvl}/2", mid, tip, 1, 1, hw)
    return out


def flops_per_frame(model: Dict) -> int:
    return sum(c.flops(1) for c in convs(model))


def peaks(device_name: str, root: Path) -> Dict[str, float]:
    """The card's published peaks (`peaks.json`), or {} for a card the
    table does not hold."""
    with open(root / "peaks.json") as f:
        return json.load(f).get(device_name, {})


def conv_bound_s(model: Dict, batch: int, peak: Dict[str, float]) -> float:
    """Least seconds the card could take for every conv of one step of
    `batch` rows: each conv's larger of bytes over bandwidth and operations
    over the bf16 peak, summed."""
    return sum(max(c.bytes(batch) / peak["hbm_bytes_per_s"],
                   c.flops(batch) / peak["bf16_flops_per_s"])
               for c in convs(model))
