"""The conv operation and byte counts against hand counts."""

import json
from pathlib import Path

import torch
import torch.nn.functional as F

from portbench import flops
from portbench.reference import model as ref_model

ROOT = Path(__file__).resolve().parent.parent


def n416():
    with open(ROOT / "configs" / "yolov8n-416.json") as f:
        return json.load(f)["model"]


def test_one_layer_by_hand():
    m1 = next(c for c in flops.convs(n416()) if c.name == "m1")
    # yolov8n m1: 16 -> 32 channels, k3 s2, 208x208 -> 104x104
    assert (m1.cin, m1.cout, m1.k, m1.stride, m1.hin) == (16, 32, 3, 2, 208)
    assert m1.flops(1) == 2 * 104 * 104 * 32 * 16 * 9 == 99_680_256
    assert m1.bytes(1) == 2 * (208 * 208 * 16 + 9 * 16 * 32
                               + 104 * 104 * 32) + 4 * 32 == 2_086_016
    assert m1.flops(8) == 8 * m1.flops(1)
    assert m1.bytes(8) - m1.bytes(1) == 7 * 2 * (208 * 208 * 16
                                                 + 104 * 104 * 32)


def test_whole_yolov8n_416_counted_from_the_reference_forward():
    """Every conv the reference's forward runs, counted from the tensors it
    sees, equals flops.convs layer for layer."""
    model = n416()
    convs = flops.convs(model)
    wts = {}
    for c in convs:
        wts[c.name] = torch.zeros(c.cout, c.cin, c.k, c.k)
        wts[c.name + "#b"] = torch.zeros(c.cout)
    seen = []
    real = F.conv2d

    def counting(x, w, b=None, stride=1, padding=0):
        y = real(x, w, b, stride=stride, padding=padding)
        seen.append((2 * y.shape[0] * y.shape[2] * y.shape[3] * w.shape[0]
                     * w.shape[1] * w.shape[2] * w.shape[3],
                     2 * (x.numel() + w.numel() + y.numel()) + 4 * w.shape[0]))
        return y
    scale = ref_model.Scale(model["depth_multiple"], model["width_multiple"],
                            model["max_channels"], model["nc"])
    ref_model.F.conv2d = counting
    try:
        ref_model.forward(wts, scale, torch.zeros(1, 3, 416, 416))
    finally:
        ref_model.F.conv2d = real
    assert len(seen) == len(convs) == 63
    assert sum(s[0] for s in seen) == flops.flops_per_frame(model)
    assert sum(s[1] for s in seen) == sum(c.bytes(1) for c in convs)
    assert flops.flops_per_frame(model) == 3_415_865_856
