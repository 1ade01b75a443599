"""Faithful ultralytics-DetectionModel torch twin: ONNX export + compat.

The port's copy of the JAX package's `models/ultra.py` (already PyTorch
there; this copy takes `ModelSpec` and `_depth` from the port's own
`models/yolov8.py`). It reconstructs the exact module tree (names, nesting,
BN placement, DFL conv, fuse() semantics) of ultralytics' YOLOv8, so that
`state_dict()` and `torch.onnx.export` produce artifacts with the real
deployment flow's naming and fusion conventions (reference
start.sh:113-149 exports exactly this via `yolo export format=onnx`).

- **Deployment export** (`export_deployment_onnx`, `python -m
  zero_latency_yolo_tpu_torch.export_onnx`): weights fine-tuned by this
  framework leave as ultralytics-convention .onnx files, loadable by ONNX
  Runtime, by the reference server (src/inference/onnx_engine.cpp:957-1062)
  and by `models/weights.py` `from_onnx`, which reads real exports.
- **Compat**: `decoded_reference` runs the twin as the parity reference of
  the exported graph.

Independent implementation: module layout/naming follows the public
ultralytics architecture; no ultralytics code is used.
"""

from __future__ import annotations

import math
import os
from typing import List

import numpy as np
import torch
import torch.nn as nn

from .yolov8 import ModelSpec, _depth


class UConv(nn.Module):
    """ultralytics Conv: conv -> bn -> SiLU (bn eps 1e-3)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1) -> None:
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, (k - 1) // 2, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=1e-3, momentum=0.03)
        self.act = nn.SiLU()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))

    def fuse(self) -> None:
        """ultralytics fuse_conv_and_bn: fold BN into the conv, drop bn.

        After fusing, state_dict/ONNX initializers carry
        `...conv.weight` + `...conv.bias` and no bn entries — the form every
        real `yolo export` artifact ships."""
        w = self.conv.weight.data
        bn = self.bn
        scale = bn.weight.data / torch.sqrt(bn.running_var.data + bn.eps)
        fused = nn.Conv2d(self.conv.in_channels, self.conv.out_channels,
                          self.conv.kernel_size, self.conv.stride,
                          self.conv.padding, bias=True)
        fused.weight.data = w * scale[:, None, None, None]
        fused.bias.data = bn.bias.data - bn.running_mean.data * scale
        self.conv = fused
        self.bn = nn.Identity()


class UBottleneck(nn.Module):
    def __init__(self, c: int, shortcut: bool) -> None:
        super().__init__()
        self.cv1 = UConv(c, c, 3)
        self.cv2 = UConv(c, c, 3)
        self.add = shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class UC2f(nn.Module):
    def __init__(self, c1: int, c2: int, n: int, shortcut: bool) -> None:
        super().__init__()
        self.c = c2 // 2
        self.cv1 = UConv(c1, 2 * self.c, 1)
        self.cv2 = UConv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(UBottleneck(self.c, shortcut)
                               for _ in range(n))

    def forward(self, x):
        y = list(self.cv1(x).chunk(2, 1))
        y.extend(m(y[-1]) for m in self.m)
        return self.cv2(torch.cat(y, 1))


class USPPF(nn.Module):
    def __init__(self, c1: int, c2: int) -> None:
        super().__init__()
        c = c1 // 2
        self.cv1 = UConv(c1, c, 1)
        self.cv2 = UConv(4 * c, c2, 1)
        self.m = nn.MaxPool2d(kernel_size=5, stride=1, padding=2)

    def forward(self, x):
        y = [self.cv1(x)]
        y.extend(self.m(y[-1]) for _ in range(3))
        return self.cv2(torch.cat(y, 1))


class UDFL(nn.Module):
    """Distribution Focal Loss expectation as the fixed-arange 1x1 conv
    ultralytics ships (`model.22.dfl.conv.weight` in every real export —
    weights.py must SKIP it, not map it)."""

    def __init__(self, reg_max: int) -> None:
        super().__init__()
        self.conv = nn.Conv2d(reg_max, 1, 1, bias=False).requires_grad_(False)
        self.conv.weight.data = torch.arange(
            reg_max, dtype=torch.float32).view(1, reg_max, 1, 1)
        self.reg_max = reg_max

    def forward(self, x):
        b, _, a = x.shape
        return self.conv(
            x.view(b, 4, self.reg_max, a).transpose(2, 1).softmax(1)
        ).view(b, 4, a)


class UConcat(nn.Module):
    def forward(self, xs):
        return torch.cat(xs, 1)


class UDetect(nn.Module):
    def __init__(self, nc: int, reg_max: int, chs, strides) -> None:
        super().__init__()
        c2 = max(16, chs[0] // 4, 4 * reg_max)
        c3 = max(chs[0], min(nc, 100))
        self.nc = nc
        self.reg_max = reg_max
        self.strides = strides
        self.cv2 = nn.ModuleList(
            nn.Sequential(UConv(ch, c2, 3), UConv(c2, c2, 3),
                          nn.Conv2d(c2, 4 * reg_max, 1)) for ch in chs)
        self.cv3 = nn.ModuleList(
            nn.Sequential(UConv(ch, c3, 3), UConv(c3, c3, 3),
                          nn.Conv2d(c3, nc, 1)) for ch in chs)
        self.dfl = UDFL(reg_max)

    def forward(self, feats: List[torch.Tensor]):
        outs = [torch.cat([self.cv2[i](f), self.cv3[i](f)], 1)
                for i, f in enumerate(feats)]
        shapes = [(f.shape[2], f.shape[3]) for f in feats]
        flat = torch.cat([o.flatten(2) for o in outs], 2)
        box, cls = flat.split((4 * self.reg_max, self.nc), 1)
        dist = self.dfl(box)
        anchors, strides = [], []
        dev = flat.device  # the anchors on the model's device (traced there)
        for (h, w), s in zip(shapes, self.strides):
            ys, xs = torch.meshgrid(torch.arange(h, device=dev) + 0.5,
                                    torch.arange(w, device=dev) + 0.5,
                                    indexing="ij")
            anchors.append(torch.stack(
                [xs.reshape(-1), ys.reshape(-1)]).float())
            strides.append(torch.full((1, h * w), float(s), device=dev))
        anc = torch.cat(anchors, 1)[None]
        strd = torch.cat(strides, 1)[None]
        x1y1 = anc - dist[:, :2]
        x2y2 = anc + dist[:, 2:]
        dbox = torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], 1) * strd
        # ultralytics export head output: (B, 4+nc, A), boxes in px,
        # sigmoid class probabilities.
        return torch.cat([dbox, cls.sigmoid()], 1)


class UltralyticsTwin(nn.Module):
    """`DetectionModel`-shaped tree: every parameterized submodule lives at
    `model.<idx>` with the real ultralytics yolov8.yaml indices."""

    def __init__(self, spec: ModelSpec) -> None:
        super().__init__()
        ch, d = spec.ch, spec.depth
        n3, n6 = _depth(3, d), _depth(6, d)
        self.model = nn.Sequential(
            UConv(3, ch(64), 3, 2),                           # 0
            UConv(ch(64), ch(128), 3, 2),                     # 1
            UC2f(ch(128), ch(128), n3, True),                 # 2
            UConv(ch(128), ch(256), 3, 2),                    # 3
            UC2f(ch(256), ch(256), n6, True),                 # 4
            UConv(ch(256), ch(512), 3, 2),                    # 5
            UC2f(ch(512), ch(512), n6, True),                 # 6
            UConv(ch(512), ch(1024), 3, 2),                   # 7
            UC2f(ch(1024), ch(1024), n3, True),               # 8
            USPPF(ch(1024), ch(1024)),                        # 9
            nn.Upsample(scale_factor=2.0, mode="nearest"),    # 10
            UConcat(),                                        # 11
            UC2f(ch(1024) + ch(512), ch(512), n3, False),     # 12
            nn.Upsample(scale_factor=2.0, mode="nearest"),    # 13
            UConcat(),                                        # 14
            UC2f(ch(512) + ch(256), ch(256), n3, False),      # 15
            UConv(ch(256), ch(256), 3, 2),                    # 16
            UConcat(),                                        # 17
            UC2f(ch(256) + ch(512), ch(512), n3, False),      # 18
            UConv(ch(512), ch(512), 3, 2),                    # 19
            UConcat(),                                        # 20
            UC2f(ch(512) + ch(1024), ch(1024), n3, False),    # 21
            UDetect(spec.num_classes, spec.reg_max,
                    spec.backbone_channels, spec.strides),    # 22
        )
        self.spec = spec

    def forward(self, x):
        m = self.model
        x2 = m[2](m[1](m[0](x)))
        x4 = m[4](m[3](x2))
        x6 = m[6](m[5](x4))
        x9 = m[9](m[8](m[7](x6)))
        n12 = m[12](m[11]([m[10](x9), x6]))
        p3 = m[15](m[14]([m[13](n12), x4]))
        p4 = m[18](m[17]([m[16](p3), n12]))
        p5 = m[21](m[20]([m[19](p4), x9]))
        return m[22]([p3, p4, p5])

    def fuse(self) -> "UltralyticsTwin":
        for mod in self.modules():
            if isinstance(mod, UConv):
                mod.fuse()
        return self

    def randomize(self, seed: int = 0) -> "UltralyticsTwin":
        """Non-trivial weights + BN running stats (a fresh BN has mean 0 /
        var 1, which would make fold bugs invisible)."""
        g = torch.Generator().manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d) and mod.weight.requires_grad:
                fan_in = mod.in_channels * mod.kernel_size[0] ** 2
                mod.weight.data.normal_(0.0, math.sqrt(2.0 / fan_in),
                                        generator=g)
                if mod.bias is not None:
                    mod.bias.data.normal_(0.0, 0.02, generator=g)
            elif isinstance(mod, nn.BatchNorm2d):
                mod.weight.data.uniform_(0.6, 1.4, generator=g)
                mod.bias.data.normal_(0.0, 0.1, generator=g)
                mod.running_mean.normal_(0.0, 0.2, generator=g)
                mod.running_var.uniform_(0.5, 1.5, generator=g)
        return self


def export_onnx(model: UltralyticsTwin, path: str, size: int,
                device="cpu") -> None:
    """Real `torch.onnx.export` of the fused model — same exporter family
    the reference deployment flow uses (TorchScript path; initializer names
    are the state-dict parameter names, as in every ultralytics export).
    The model is traced on `device`.

    Without the `onnx` package the exporter still serializes the
    ModelProto in C++ (`graph._export_onnx`), but then imports onnx solely
    to splice in onnxscript custom functions — which this model has none
    of. Bypass that one post-pass so the genuinely torch-serialized bytes
    reach disk unmodified. The module path is torch-internal and moves
    between releases — on a torch where it's gone (or where `onnx` IS
    installed and the post-pass just works), export unpatched."""
    try:
        from torch.onnx._internal.torchscript_exporter import (
            onnx_proto_utils,
        )
    except ImportError:
        onnx_proto_utils = None
    model = model.eval().to(device)
    dummy = torch.zeros(1, 3, size, size, device=device)
    orig = (onnx_proto_utils._add_onnxscript_fn
            if onnx_proto_utils is not None else None)
    if onnx_proto_utils is not None:
        onnx_proto_utils._add_onnxscript_fn = (
            lambda model_bytes, _ops: model_bytes)
    try:
        torch.onnx.export(model, (dummy,), path, input_names=["images"],
                          output_names=["output0"], opset_version=12,
                          dynamo=False)
    finally:
        if onnx_proto_utils is not None:
            onnx_proto_utils._add_onnxscript_fn = orig


def decoded_reference(model: UltralyticsTwin, x_nhwc: np.ndarray) -> np.ndarray:
    """(B, A, 4+nc) decoded output for parity gates, computed on the
    twin's device."""
    dev = next(model.parameters()).device
    with torch.no_grad():
        x = torch.from_numpy(np.asarray(x_nhwc)).float().permute(0, 3, 1, 2)
        return model(x.to(dev)).permute(0, 2, 1).cpu().numpy()


# ---------------------------------------------------------------------------
# Params tree -> twin (the inverse of weights.from_ultralytics_state_dict)
# ---------------------------------------------------------------------------

def load_params_into_twin(twin: UltralyticsTwin, params) -> UltralyticsTwin:
    """Fill the twin from our param pytree (folded or BN-carrying).

    The mapping is driven by the twin's own state_dict keys through the SAME
    `_map_ultra_path` table the import direction uses, so export and import
    stay inverses by construction. Folded params fuse the twin first (the
    form every real `yolo export` artifact ships); any unmatched or
    shape-mismatched parameter raises — a silently-partial export would
    serve garbage."""
    from .weights import _map_ultra_path, flatten

    flat = {k: np.asarray(v) for k, v in flatten(params).items()}
    if not any("/bn/" in k for k in flat):
        twin.fuse()
    sd = twin.state_dict()
    new_sd = {}
    problems: List[str] = []
    consumed = set()
    for key, cur in sd.items():
        parts = key.split(".")
        rest = parts[2:]
        if rest[:1] == ["dfl"]:
            new_sd[key] = cur  # fixed arange conv, not a learned weight
            continue
        mapped = _map_ultra_path(rest)
        if mapped is None:  # num_batches_tracked
            new_sd[key] = cur
            continue
        fk = f"m{parts[1]}/" + "/".join(mapped)
        if fk not in flat:
            problems.append(f"{key}: no source param {fk}")
            continue
        consumed.add(fk)
        arr = flat[fk].astype(np.float32)
        if mapped[-1] == "w" and arr.ndim == 4:
            arr = np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
        if tuple(arr.shape) != tuple(cur.shape):
            problems.append(f"{key}: shape {tuple(arr.shape)} != twin "
                            f"{tuple(cur.shape)} (wrong variant/num_classes?)")
            continue
        new_sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    # SOURCE-side leftovers are errors too (the docstring's contract):
    # a checkpoint carrying both 'b' and 'bn' for a conv maps its bias to
    # no twin key (the unfused twin's Conv2d has bias=False), and silently
    # dropping it would export diverging weights.
    leftover = sorted(set(flat) - consumed)
    if leftover:
        problems.extend(f"source param {fk} has no twin counterpart"
                        for fk in leftover)
    if problems:
        raise ValueError("params do not fit the twin:\n  " +
                         "\n  ".join(problems[:8]))
    twin.load_state_dict(new_sd)
    return twin.eval()


def export_deployment_onnx(params, spec: ModelSpec, path: str,
                           size: int, device="cpu") -> None:
    """Write a genuine ultralytics-convention .onnx from our params.

    Output: fused Conv+BN initializers named `model.<idx>...conv.weight`,
    input `images` (1,3,size,size), output `output0` (1,4+nc,A) with decoded
    px boxes + sigmoid class scores — the exact artifact shape the reference
    deploys (src/inference/onnx_engine.cpp:957-1062, start.sh:113-149), and
    one that weights.from_onnx round-trips. The twin is traced on
    `device`."""
    from .weights import flatten, read_onnx_initializers
    from .yolov8 import fold_batchnorm

    if any("/bn/" in k for k in flatten(params)):
        params = fold_batchnorm(params)
    twin = UltralyticsTwin(spec)
    load_params_into_twin(twin, params)
    export_onnx(twin, path, size, device)
    # The exporter deduplicates identical-valued initializers (legal ONNX,
    # and ONNX Runtime serves it fine) — but then the file no longer carries
    # one named initializer per parameter, so OUR name-based re-import and
    # the reference's introspection see a partial model. Identical tensors
    # across layers only happen with untrained/degenerate weights; refuse
    # loudly rather than ship an artifact that round-trips wrong.
    have = set(read_onnx_initializers(path))
    want = {f"model.{k}" for k in _twin_param_names(twin)}
    missing = sorted(want - have)
    if missing:
        os.remove(path)
        raise ValueError(
            "export deduplicated identical-valued parameters (weights look "
            f"untrained/degenerate); first missing: {missing[:4]}")


def _twin_param_names(twin: UltralyticsTwin) -> List[str]:
    """state_dict keys (sans the leading 'model.') that must appear as ONNX
    initializers: every learned tensor; the fixed DFL conv is graph-folded
    by the exporter and num_batches_tracked never exports."""
    out = []
    for key in twin.state_dict():
        rest = key.split(".")[2:]
        if rest[:1] == ["dfl"] or rest[-1] == "num_batches_tracked":
            continue
        out.append(key.split(".", 1)[1])
    return out
