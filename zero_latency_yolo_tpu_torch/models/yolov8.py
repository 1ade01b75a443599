"""YOLOv8 detection family (n/s/m/l/x) as PyTorch functions over NHWC tensors.

The PyTorch counterpart of the JAX package's `models/yolov8.py`, with the same
functions, names and parameter layout:

- Activations are NHWC tensors (channels-last memory), so a 1x1 conv reads
  its input as a flat (B*H*W, C) matrix without a copy and the bias+SiLU
  kernel walks one flat buffer. Public functions take and return NHWC, as
  the JAX package does.
- Parameters are the `m0`..`m22` tree of the JAX package. `init_params` and
  `fold_batchnorm` work on that tree in NumPy (HWIO kernels), exactly as the
  JAX package does; `models/weights.py` `params_from_jax` turns it into the
  device form the forward functions take: OIHW kernels for `F.conv2d`, and a
  (Cin, Cout) matrix for each 1x1 conv.
- Conv dispatch (`_conv`): an int8 conv block (tpu.quantize_int8,
  `ops/quant.py`) runs as the int8 conv kernel with the activation
  quantize, the dequant, bias and SiLU fused (`ops/conv_int8_cuda.py`); a
  folded k=1 s=1 conv runs as the 1x1 matmul kernel with its bias and SiLU
  fused (`ops/conv1x1_cuda.py`); a folded k=3 conv with SiLU over a bf16
  activation that `ops/conv3x3_cuda.py` `conv3x3_plan` takes runs as the
  k=3 implicit-GEMM kernel with its bias and SiLU fused; every other conv
  (f32, the stem's Cin 3, act=False) runs `F.conv2d` without bias, then
  the bias+SiLU kernel (`ops/act_cuda.py`). `plain=True` routes all four
  through their plain PyTorch versions instead (the reference the kernels
  are checked against). `conv_fn` replaces `_conv` (same
  signature): the hook activation calibration records through, and the
  one tensor parallelism runs through (`tp_conv`: each channel-sharded
  block's slices on their devices, gathered along channels).
- In bf16 the kernels add the bias and apply SiLU in f32 registers and round
  once (the k=3 kernel also keeps its conv's sum in f32 up to that one
  rounding); the JAX package's bf16 serving path does the tail in bf16.
- Training (`forward_train_raw`) runs the JAX package's training branch on
  the unfolded tree in its JAX layout (`models/weights.py`
  `train_params_from_jax`): `F.conv2d` in the compute dtype and an f32 tail
  of bias, BN with its running statistics and SiLU, differentiable end to
  end; no kernel of this package has a backward.
- The JAX package's serving-layout switches: `c2f="split"` (C2f without the
  channel slice and concat, over weight pieces `place_params` lays out once),
  `stem="s2d"` (the stem as a k2 s1 conv over the space-to-depth letterbox)
  and the per-level decode (`forward_decoded_levels`). `dot1x1` is accepted
  and does nothing: every k1 s1 conv already runs as the 1x1 matmul kernel.

Architecture (ultralytics yolov8.yaml): stem + C2f stages + SPPF backbone,
PAN-FPN neck, decoupled anchor-free detect head with DFL (reg_max=16),
strides (8, 16, 32).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.act_cuda import bias_silu, bias_silu_plain
from ..ops.conv1x1_cuda import conv1x1_bias_act, conv1x1_bias_act_plain
from ..ops.conv3x3_cuda import (conv3x3_bias_act, conv3x3_bias_act_plain,
                                conv3x3_plan)
from ..ops.conv_int8_cuda import conv_int8, conv_int8_plain, dynamic_scale

Params = Dict[str, Any]

# variant -> (depth_multiple, width_multiple, max_channels)
VARIANTS = {
    # pico: a reduced test/edge variant of this framework (not an
    # ultralytics size) — fast CPU runs for CI and tiny deployments.
    "yolov8p": (0.33, 0.125, 256),
    "yolov8n": (0.33, 0.25, 1024),
    "yolov8s": (0.33, 0.50, 1024),
    "yolov8m": (0.67, 0.75, 768),
    "yolov8l": (1.00, 1.00, 512),
    "yolov8x": (1.00, 1.25, 512),
}

_BASE_CH = (64, 128, 256, 512, 1024)
BN_EPS = 1e-3  # ultralytics BatchNorm2d eps


def _make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


def _depth(n: int, d: float) -> int:
    return max(round(n * d), 1)


@dataclass(frozen=True)
class ModelSpec:
    variant: str
    num_classes: int
    depth: float
    width: float
    max_channels: int
    reg_max: int = 16
    strides: Tuple[int, ...] = (8, 16, 32)

    def ch(self, base: int) -> int:
        return _make_divisible(min(base, self.max_channels) * self.width)

    @property
    def backbone_channels(self) -> Tuple[int, int, int]:
        """(P3, P4, P5) channels feeding the detect head."""
        return (self.ch(256), self.ch(512), self.ch(1024))

    @property
    def no(self) -> int:
        """Per-anchor output width: 4*reg_max box bins + nc class logits."""
        return 4 * self.reg_max + self.num_classes

    def num_anchors(self, h: int, w: int) -> int:
        return sum((h // s) * (w // s) for s in self.strides)


# Parametric scaling: "yolov8-d{depth}-w{width}[-mc{max_channels}]".
_CUSTOM_VARIANT_RE = re.compile(
    r"^yolov8-d(\d*\.?\d+)-w(\d*\.?\d+)(?:-mc(\d+))?$")


def get_spec(variant: str = "yolov8n", num_classes: int = 4) -> ModelSpec:
    if variant in VARIANTS:
        d, w, mc = VARIANTS[variant]
    else:
        m = _CUSTOM_VARIANT_RE.match(variant)
        if m is None:
            raise ValueError(
                f"unknown variant {variant!r}; choose from {sorted(VARIANTS)} "
                "or a parametric 'yolov8-d<depth>-w<width>[-mc<max_channels>]'")
        d, w = float(m.group(1)), float(m.group(2))
        mc = int(m.group(3)) if m.group(3) else 1024
        if not (0.0 < d <= 2.0 and 0.0 < w <= 2.0):
            raise ValueError(
                f"parametric variant {variant!r}: depth/width multiples must "
                "be in (0, 2]")
        if mc < 8:
            raise ValueError(
                f"parametric variant {variant!r}: max_channels must be >= 8")
    return ModelSpec(variant=variant, num_classes=num_classes,
                     depth=d, width=w, max_channels=mc)


# ---------------------------------------------------------------------------
# Parameter initialization (NumPy, HWIO: the JAX package's tree, number for
# number from the same int seed)
# ---------------------------------------------------------------------------

def _init_conv(rng, cin: int, cout: int, k: int, folded: bool,
               bias: bool = False) -> Params:
    std = math.sqrt(2.0 / (cin * k * k))
    w = (rng.standard_normal((k, k, cin, cout)) * std).astype(np.float32)
    p: Params = {"w": w}
    if folded or bias:
        p["b"] = np.zeros((cout,), np.float32)
    if not folded and not bias:
        p["bn"] = {
            "gamma": np.ones((cout,), np.float32),
            "beta": np.zeros((cout,), np.float32),
            "mean": np.zeros((cout,), np.float32),
            "var": np.abs(rng.standard_normal(cout)).astype(np.float32)
            * 0.5 + 0.5,
        }
    return p


def _init_bottleneck(rng, c: int, folded: bool) -> Params:
    return {"cv1": _init_conv(rng, c, c, 3, folded),
            "cv2": _init_conv(rng, c, c, 3, folded)}


def _init_c2f(rng, cin: int, cout: int, n: int, folded: bool) -> Params:
    c = cout // 2
    return {
        "cv1": _init_conv(rng, cin, 2 * c, 1, folded),
        "cv2": _init_conv(rng, (2 + n) * c, cout, 1, folded),
        "m": [_init_bottleneck(rng, c, folded) for _ in range(n)],
    }


def _init_sppf(rng, cin: int, cout: int, folded: bool) -> Params:
    c = cin // 2
    return {"cv1": _init_conv(rng, cin, c, 1, folded),
            "cv2": _init_conv(rng, 4 * c, cout, 1, folded)}


def _init_detect(rng, spec: ModelSpec, folded: bool) -> Params:
    chs = spec.backbone_channels
    c2 = max(16, chs[0] // 4, 4 * spec.reg_max)
    c3 = max(chs[0], min(spec.num_classes, 100))
    cv2, cv3 = [], []
    for cin in chs:
        cv2.append([
            _init_conv(rng, cin, c2, 3, folded),
            _init_conv(rng, c2, c2, 3, folded),
            _init_conv(rng, c2, 4 * spec.reg_max, 1, folded=True, bias=True),
        ])
        cv3.append([
            _init_conv(rng, cin, c3, 3, folded),
            _init_conv(rng, c3, c3, 3, folded),
            _init_conv(rng, c3, spec.num_classes, 1, folded=True, bias=True),
        ])
    return {"cv2": cv2, "cv3": cv3}


def init_params(seed: int, spec: ModelSpec, folded: bool = True) -> Params:
    """Random-initialized NumPy parameter tree (HWIO, layer keys match the
    ultralytics indices) from an int seed."""
    rng = np.random.default_rng(seed)
    ch, d = spec.ch, spec.depth
    p: Params = {}
    p["m0"] = _init_conv(rng, 3, ch(64), 3, folded)
    p["m1"] = _init_conv(rng, ch(64), ch(128), 3, folded)
    p["m2"] = _init_c2f(rng, ch(128), ch(128), _depth(3, d), folded)
    p["m3"] = _init_conv(rng, ch(128), ch(256), 3, folded)
    p["m4"] = _init_c2f(rng, ch(256), ch(256), _depth(6, d), folded)
    p["m5"] = _init_conv(rng, ch(256), ch(512), 3, folded)
    p["m6"] = _init_c2f(rng, ch(512), ch(512), _depth(6, d), folded)
    p["m7"] = _init_conv(rng, ch(512), ch(1024), 3, folded)
    p["m8"] = _init_c2f(rng, ch(1024), ch(1024), _depth(3, d), folded)
    p["m9"] = _init_sppf(rng, ch(1024), ch(1024), folded)
    p["m12"] = _init_c2f(rng, ch(1024) + ch(512), ch(512), _depth(3, d), folded)
    p["m15"] = _init_c2f(rng, ch(512) + ch(256), ch(256), _depth(3, d), folded)
    p["m16"] = _init_conv(rng, ch(256), ch(256), 3, folded)
    p["m18"] = _init_c2f(rng, ch(256) + ch(512), ch(512), _depth(3, d), folded)
    p["m19"] = _init_conv(rng, ch(512), ch(512), 3, folded)
    p["m21"] = _init_c2f(rng, ch(512) + ch(1024), ch(1024), _depth(3, d), folded)
    p["m22"] = _init_detect(rng, spec, folded)
    return p


def fold_batchnorm(params: Params, eps: float = BN_EPS) -> Params:
    """Fold {w, bn} conv blocks of a NumPy tree into {w, b} (exact algebra).

    W'[...o] = W[...o] * gamma[o] / sqrt(var[o]+eps)
    b'[o]    = beta[o] + (b0[o] - mean[o]) * gamma[o] / sqrt(var[o]+eps)
    """
    def fold(node):
        if isinstance(node, dict):
            if "bn" in node and "w" in node:
                bn = node["bn"]
                scale = bn["gamma"] / np.sqrt(bn["var"] + np.float32(eps))
                b0 = node.get("b", 0.0)
                return {"w": node["w"] * scale,
                        "b": bn["beta"] + (b0 - bn["mean"]) * scale}
            return {k: fold(v) for k, v in node.items()}
        if isinstance(node, list):
            return [fold(v) for v in node]
        return node
    return fold(params)


# ---------------------------------------------------------------------------
# Forward pass. Every conv block `p` is in device form (models/weights.py
# params_from_jax): {"w": OIHW, "b": (Cout,) f32} or, for a 1x1 conv,
# {"w_mm": (Cin, Cout), "b": (Cout,) f32}; placed (place_params), w_mm is
# laid out K-major for the tensor-core 1x1 kernel. A placed int8 block is
# {"w_q": (Cout, Kp) int8, "k", "w_scale", "b"[, "x_scale"]}.
# ---------------------------------------------------------------------------

CONV1X1_ROUTES = ("kernel", "library")


def _conv(p: Params, x: torch.Tensor, stride: int = 1, act: bool = True,
          plain: bool = False, conv1x1: str = "kernel") -> torch.Tensor:
    """Conv + bias (+ SiLU) over NHWC `x`; SAME padding ((k-1)//2).

    conv1x1="library" runs a folded k=1 s=1 conv as `torch.addmm` of the
    bias and the flattened activation with the weight, then `F.silu`, in
    x's dtype: the library's computation of the 1x1 kernel's function,
    the other route of `conv1x1_compare`'s A/B (no serving path takes it).

    An int8 block: per-tensor activation scale (the calibrated `x_scale`,
    else max(|x|) / 127 computed on the device), int8 conv with int32
    accumulation, y * (x_scale * w_scale) + b and SiLU in f32, then x's
    type (the JAX package's int8 tail is f32 too)."""
    if "w_q" in p:
        x_scale = p["x_scale"] if "x_scale" in p else dynamic_scale(x)
        fn = conv_int8_plain if plain else conv_int8
        return fn(x, x_scale, p["w_q"], p["w_scale"], p["b"], p["k"], stride,
                  act)
    if "w_mm" in p:
        if stride != 1:
            raise ValueError("1x1 conv blocks run at stride 1 only")
        b, h, w, cin = x.shape
        x2 = x.reshape(b * h * w, cin)
        if conv1x1 == "library":
            y = torch.addmm(p["b"].to(x.dtype), x2, p["w_mm"])
            y = F.silu(y) if act else y
        elif conv1x1 == "kernel":
            fn = conv1x1_bias_act_plain if plain else conv1x1_bias_act
            y = fn(x2, p["w_mm"], p["b"], act=act)
        else:
            raise ValueError(f"conv1x1 route {conv1x1!r}: one of "
                             f"{CONV1X1_ROUTES}")
        return y.view(b, h, w, -1)
    wt = p["w"]
    if (act and wt.shape[-1] == 3 and x.dtype == torch.bfloat16
            and conv3x3_plan(x, wt, stride).route == "wgmma"):
        fn = conv3x3_bias_act_plain if plain else conv3x3_bias_act
        return fn(x, wt, p["b"], stride)
    pad = (wt.shape[-1] - 1) // 2
    y = F.conv2d(x.permute(0, 3, 1, 2), wt, stride=stride, padding=pad)
    # No copy when the conv wrote channels-last (it does for channels-last
    # weights); the kernels need one flat NHWC buffer.
    y = y.permute(0, 2, 3, 1).contiguous()
    if not act:
        return y + p["b"].to(y.dtype)
    return (bias_silu_plain if plain else bias_silu)(y, p["b"])


def _on_shards(p: Params, x: torch.Tensor, fn) -> torch.Tensor:
    """A channel-sharded block ({"shards": [...], "b"}, `parallel/mesh.py`
    `row_params`): fn(shard, x on the shard's device) for each shard, the
    outputs gathered along channels on x's device in shard order."""
    ys = [fn(q, x.to(q["b"].device, non_blocking=True)) for q in p["shards"]]
    return torch.cat([y.to(x.device, non_blocking=True) for y in ys], dim=-1)


def tp_conv(p: Params, x: torch.Tensor, stride: int = 1, act: bool = True,
            plain: bool = False, conv1x1: str = "kernel") -> torch.Tensor:
    """`_conv` under tensor parallelism, the `conv_fn` a serving mesh with
    model > 1 runs: a channel-sharded block runs each output-channel slice
    through `_conv` on its own device and gathers the slices along
    channels; a whole block runs `_conv` as it is."""
    if "shards" in p:
        return _on_shards(p, x, lambda q, t: _conv(
            q, t, stride=stride, act=act, plain=plain, conv1x1=conv1x1))
    return _conv(p, x, stride=stride, act=act, plain=plain, conv1x1=conv1x1)


def _bottleneck(p: Params, x: torch.Tensor, shortcut: bool, cv) -> torch.Tensor:
    y = cv(p["cv2"], cv(p["cv1"], x))
    return x + y if shortcut else y


def _c2f(p: Params, x: torch.Tensor, shortcut: bool, cv,
         split: bool = False, plain: bool = False) -> torch.Tensor:
    """C2f block. The slice form takes a channel slice of cv1 and concats
    the pieces into cv2. split=True (tpu.c2f="split") runs cv1 as two
    half-width 1x1 convs and cv2 as a sum of per-piece 1x1 convs without
    bias or SiLU, then silu(sum + b) through the bias+SiLU kernel: the same
    contractions over weight pieces, so the result matches up to the
    rounding of the partial sums. The pieces are laid out once by
    `models/weights.py` `place_params(c2f_split=True)`, each K-major and
    contiguous (a column slice of a K-major matrix is not, and the
    tensor-core kernel's TMA needs 16-byte rows). int8 blocks (w_q) run the
    slice form, as the JAX package's do. The JAX package also falls back to
    it on unfolded (BN) params; the port folds BN at load, so that case
    does not arise here."""
    split = split and "w_q" not in p["cv1"]
    if split:
        if "cv1_pieces" not in p:
            raise ValueError("c2f='split' needs the weight pieces that "
                             "place_params(c2f_split=True) lays out")
        ys = [cv(q, x) for q in p["cv1_pieces"]]
    else:
        y = cv(p["cv1"], x)
        c = y.shape[-1] // 2
        ys = [y[..., :c], y[..., c:]]
    for mp in p["m"]:
        ys.append(_bottleneck(mp, ys[-1], shortcut, cv))
    if not split:
        return cv(p["cv2"], torch.cat(ys, dim=-1))
    acc = None
    for q, yi in zip(p["cv2_pieces"], ys):
        part = cv(q, yi, act=False)
        acc = part if acc is None else acc + part
    return (bias_silu_plain if plain else bias_silu)(acc, p["cv2"]["b"])


def _maxpool5(x: torch.Tensor) -> torch.Tensor:
    """5x5 stride-1 SAME max pool over NHWC (the border pads with -inf)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel_size=5, stride=1, padding=2)
    return y.permute(0, 2, 3, 1)


def _sppf(p: Params, x: torch.Tensor, cv) -> torch.Tensor:
    y = cv(p["cv1"], x)
    pools = [y]
    for _ in range(3):
        pools.append(_maxpool5(pools[-1]))
    return cv(p["cv2"], torch.cat(pools, dim=-1))


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return x.reshape(b, 2 * h, 2 * w, c)


def stem_s2d_weights(w: torch.Tensor) -> torch.Tensor:
    """The k3 s2 stem kernel (Co, 3, 3, 3) OIHW as the equivalent k2 s1
    kernel (Co, 12, 2, 2) over space-to-depth input.

    With z[p, q, a*6+b*3+c] = x[2p+a, 2q+b, c] (a, b in {0,1}), the stride-2
    tap x[2i+di-1] maps to kernel position/offset (kp, a) = (0,1), (1,0),
    (1,1) for di = 0, 1, 2; position (0, 0) never contributes and stays
    zero (the JAX package's `_stem_s2d_weights`)."""
    co = w.shape[0]
    w2 = torch.zeros((co, 12, 2, 2), dtype=w.dtype, device=w.device)
    taps = ((0, 1, 0), (1, 0, 1), (1, 1, 2))  # (kernel pos, offset, orig tap)
    for kp, a, di in taps:
        for kq, b, dj in taps:
            ch = a * 6 + b * 3
            w2[:, ch:ch + 3, kp, kq] = w[:, :, di, dj]
    return w2


def _stem_s2d(p: Params, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """The stem over space-to-depth input (B, S/2, S/2, 12): the exact
    equivalent of _conv(m0, letterboxed, stride=2), as F.conv2d of the k2 s1
    kernel over the input padded by (1, 0) on both axes (the original SAME
    pad-1 border zeros), then the bias+SiLU kernel. BN-folded params only,
    refused otherwise as the JAX package refuses them (the port folds BN at
    load, so only a hand-built tree can reach the refusal)."""
    if "shards" in p:
        return _on_shards(p, x, lambda q, t: _stem_s2d(q, t, plain=plain))
    if "w_q" in p:
        raise ValueError("s2d stem incompatible with quantized m0")
    if "bn" in p or "b" not in p:
        raise ValueError(
            "stem='s2d' requires BN-folded stem params (w + b, no bn "
            "block) — run fold_batchnorm() on the checkpoint first")
    w2 = p["w_s2d"] if "w_s2d" in p else stem_s2d_weights(p["w"])
    xp = F.pad(x, (0, 0, 1, 0, 1, 0))  # NHWC: one zero row and column first
    y = F.conv2d(xp.permute(0, 3, 1, 2), w2).permute(0, 2, 3, 1).contiguous()
    return (bias_silu_plain if plain else bias_silu)(y, p["b"])


def apply_backbone(params: Params, x: torch.Tensor, dtype=torch.float32,
                   plain: bool = False, stem: str = "conv",
                   c2f: str = "slice", dot1x1: bool = False, conv_fn=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backbone + neck. x: (B, H, W, 3) float in [0,1], or with stem="s2d"
    the space-to-depth form (B, H/2, W/2, 12) of
    ops/preprocess.letterbox_batch_mxu_s2d. Returns (P3, P4, P5). c2f:
    "slice" or "split" (see _c2f). dot1x1: no effect (see the module
    docstring). conv_fn: a replacement for _conv (same signature), the
    hook `ops/quant.py` calibration records through."""
    conv = conv_fn or _conv

    def cv(p, t, stride=1, act=True):
        return conv(p, t, stride=stride, act=act, plain=plain)

    def c2(p, t, shortcut):
        return _c2f(p, t, shortcut, cv, split=(c2f == "split"), plain=plain)

    x = x.to(dtype)
    if stem == "s2d":
        x = _stem_s2d(params["m0"], x, plain=plain)
    else:
        x = cv(params["m0"], x, stride=2)
    x = cv(params["m1"], x, stride=2)
    x = c2(params["m2"], x, True)
    x = cv(params["m3"], x, stride=2)
    p3_in = c2(params["m4"], x, True)                       # idx 4
    x = cv(params["m5"], p3_in, stride=2)
    p4_in = c2(params["m6"], x, True)                       # idx 6
    x = cv(params["m7"], p4_in, stride=2)
    x = c2(params["m8"], x, True)
    p5_in = _sppf(params["m9"], x, cv)                      # idx 9

    # Top-down
    x = torch.cat([_upsample2x(p5_in), p4_in], dim=-1)      # 10, 11
    n12 = c2(params["m12"], x, False)
    x = torch.cat([_upsample2x(n12), p3_in], dim=-1)        # 13, 14
    p3 = c2(params["m15"], x, False)
    # Bottom-up
    x = torch.cat([cv(params["m16"], p3, stride=2), n12], dim=-1)    # 16, 17
    p4 = c2(params["m18"], x, False)
    x = torch.cat([cv(params["m19"], p4, stride=2), p5_in], dim=-1)  # 19, 20
    p5 = c2(params["m21"], x, False)
    return p3, p4, p5


def forward_raw(params: Params, spec: ModelSpec, x: torch.Tensor,
                dtype=torch.float32, plain: bool = False, stem: str = "conv",
                c2f: str = "slice", dot1x1: bool = False, conv_fn=None
                ) -> List[torch.Tensor]:
    """Full forward. Returns per-level (B, Hi, Wi, 4*reg_max + nc) maps in
    f32. conv_fn: optional _conv replacement (see apply_backbone)."""
    conv = conv_fn or _conv
    feats = apply_backbone(params, x, dtype=dtype, plain=plain, stem=stem,
                           c2f=c2f, dot1x1=dot1x1, conv_fn=conv_fn)
    det = params["m22"]
    outs = []
    for level, f in enumerate(feats):
        box = f
        for i, bp in enumerate(det["cv2"][level]):
            box = conv(bp, box, act=(i < 2), plain=plain)
        cls = f
        for i, cp in enumerate(det["cv3"][level]):
            cls = conv(cp, cls, act=(i < 2), plain=plain)
        outs.append(torch.cat([box.float(), cls.float()], dim=-1))
    return outs


# ---------------------------------------------------------------------------
# Training forward: the JAX package's `accum_f32=False` branch of `_conv`
# (`models/yolov8.py:336-354` there), differentiable. Its params are the
# training form (`models/weights.py` `train_params_from_jax`): the JAX
# tree's keys and HWIO kernels as f32 leaf tensors, unfolded {w, bn} blocks
# or folded {w, b} ones (a --init-from artifact). Gradients land on those
# leaves, BN statistics included, as they do on the JAX tree's.
# ---------------------------------------------------------------------------

def _train_conv(p: Params, x: torch.Tensor, stride: int = 1, act: bool = True,
                dtype=torch.float32) -> torch.Tensor:
    """Conv in the compute dtype (its output rounded to it, as
    `lax.conv_general_dilated` in bf16 rounds), then an f32 tail: + b, BN
    with its running statistics, SiLU; one cast back. The HWIO kernel moves
    to OIHW here, so its gradient lands on the HWIO leaf."""
    w = p["w"]
    pad = (w.shape[0] - 1) // 2
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(dtype).permute(3, 2, 0, 1),
                 stride=stride, padding=pad)
    y = y.permute(0, 2, 3, 1).float()
    if "b" in p:
        y = y + p["b"].float()
    if "bn" in p:
        bn = p["bn"]
        scale = bn["gamma"] * torch.rsqrt(bn["var"] + BN_EPS)
        y = (y - bn["mean"]) * scale + bn["beta"]
    if act:
        y = F.silu(y)
    return y.to(dtype)


def tp_train_conv(p: Params, x: torch.Tensor, stride: int = 1,
                  act: bool = True, dtype=torch.float32) -> torch.Tensor:
    """`_train_conv` under tensor parallelism, the `conv_fn` of a training
    mesh with model > 1 (`parallel/mesh.py` `train_row_params`): a
    channel-sharded block ({"shards": [...]}) runs each device's
    output-channel slice of the kernel and bias on that device, with the
    BN affine on the same slice of that device's copy of the (replicated)
    BN vectors, and the slices are gathered along channels on x's device.
    Autograd flows back across the copies, so each device's BN copy gets
    the gradient of its slice. A whole block runs `_train_conv` as it is."""
    if "shards" not in p:
        return _train_conv(p, x, stride=stride, act=act, dtype=dtype)
    ys = []
    for col, q in enumerate(p["shards"]):
        if "bn" in q:
            n = q["w"].shape[-1]
            q = dict(q, bn={k: v[col * n:(col + 1) * n]
                            for k, v in q["bn"].items()})
        ys.append(_train_conv(q, x.to(q["w"].device), stride=stride,
                              act=act, dtype=dtype))
    return torch.cat([y.to(x.device) for y in ys], dim=-1)


def _train_c2f(p: Params, x: torch.Tensor, shortcut: bool, cv,
               split: bool = False) -> torch.Tensor:
    """C2f over training-form params, as the JAX package's `_c2f`: with
    split=True and a folded block (b, no bn), cv1 runs as its two column
    halves and cv2 as a sum of per-piece convs without bias, then + b and
    SiLU in the compute dtype; an unfolded block runs the slice form."""
    cv1, cv2 = p["cv1"], p["cv2"]

    def folded(q):
        return "bn" not in q and "b" in q

    if split and folded(cv1):
        w, b = cv1["w"], cv1["b"]
        c = w.shape[-1] // 2
        ys = [cv({"w": w[..., :c], "b": b[:c]}, x),
              cv({"w": w[..., c:], "b": b[c:]}, x)]
    else:
        y = cv(cv1, x)
        c = y.shape[-1] // 2
        ys = [y[..., :c], y[..., c:]]
    for mp in p["m"]:
        ys.append(_bottleneck(mp, ys[-1], shortcut, cv))
    if split and folded(cv2) and cv2["w"].shape[0] == 1:
        w2 = cv2["w"]
        acc = None
        for i, yi in enumerate(ys):
            part = cv({"w": w2[:, :, i * c:(i + 1) * c]}, yi, act=False)
            acc = part if acc is None else acc + part
        return F.silu(acc + cv2["b"].to(acc.dtype))
    return cv(cv2, torch.cat(ys, dim=-1))


def _train_stem_s2d(p: Params, x: torch.Tensor, dtype) -> torch.Tensor:
    """The s2d stem over training-form params (folded only, refused
    otherwise as the JAX package refuses them)."""
    if "bn" in p or "b" not in p:
        raise ValueError(
            "stem='s2d' requires BN-folded stem params (w + b, no bn "
            "block) — run fold_batchnorm() on the checkpoint first")
    w2 = stem_s2d_weights(p["w"].permute(3, 2, 0, 1)).to(dtype)
    xp = F.pad(x.to(dtype), (0, 0, 1, 0, 1, 0))
    y = F.conv2d(xp.permute(0, 3, 1, 2), w2).permute(0, 2, 3, 1).float()
    return F.silu(y + p["b"].float()).to(dtype)


def forward_train_raw(params: Params, spec: ModelSpec, x: torch.Tensor,
                      dtype=torch.float32, stem: str = "conv",
                      c2f: str = "slice", conv_fn=None) -> List[torch.Tensor]:
    """The training forward (the JAX package's `forward_raw(...,
    accum_f32=False)`): per-level (B, Hi, Wi, 4*reg_max + nc) maps in f32.
    conv_fn replaces `_train_conv` (same signature)."""
    conv = conv_fn or _train_conv

    def cv(p, t, stride=1, act=True):
        return conv(p, t, stride=stride, act=act, dtype=dtype)

    def c2(p, t, shortcut):
        return _train_c2f(p, t, shortcut, cv, split=(c2f == "split"))

    x = x.to(dtype)
    if stem == "s2d":
        x = _train_stem_s2d(params["m0"], x, dtype)
    else:
        x = cv(params["m0"], x, stride=2)
    x = cv(params["m1"], x, stride=2)
    x = c2(params["m2"], x, True)
    x = cv(params["m3"], x, stride=2)
    p3_in = c2(params["m4"], x, True)
    x = cv(params["m5"], p3_in, stride=2)
    p4_in = c2(params["m6"], x, True)
    x = cv(params["m7"], p4_in, stride=2)
    x = c2(params["m8"], x, True)
    p5_in = _sppf(params["m9"], x, cv)
    x = torch.cat([_upsample2x(p5_in), p4_in], dim=-1)
    n12 = c2(params["m12"], x, False)
    x = torch.cat([_upsample2x(n12), p3_in], dim=-1)
    p3 = c2(params["m15"], x, False)
    x = torch.cat([cv(params["m16"], p3, stride=2), n12], dim=-1)
    p4 = c2(params["m18"], x, False)
    x = torch.cat([cv(params["m19"], p4, stride=2), p5_in], dim=-1)
    p5 = c2(params["m21"], x, False)
    det = params["m22"]
    outs = []
    for level, f in enumerate((p3, p4, p5)):
        box = f
        for i, bp in enumerate(det["cv2"][level]):
            box = cv(bp, box, act=(i < 2))
        cls = f
        for i, cp in enumerate(det["cv3"][level]):
            cls = cv(cp, cls, act=(i < 2))
        outs.append(torch.cat([box.float(), cls.float()], dim=-1))
    return outs


# ---------------------------------------------------------------------------
# Decode (DFL + anchor-free box recovery)
# ---------------------------------------------------------------------------

def anchors_for(spec: ModelSpec, h: int, w: int, offset: float = 0.5
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Anchor centers (A, 2) in feature-grid units and per-anchor stride (A, 1)."""
    pts, strides = [], []
    for s in spec.strides:
        gh, gw = h // s, w // s
        xs = np.arange(gw, dtype=np.float32) + offset
        ys = np.arange(gh, dtype=np.float32) + offset
        gx, gy = np.meshgrid(xs, ys)
        pts.append(np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1))
        strides.append(np.full((gh * gw, 1), s, dtype=np.float32))
    return np.concatenate(pts, 0), np.concatenate(strides, 0)


def decode_output_levels(spec: ModelSpec, outs: Sequence[torch.Tensor]
                         ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Per-level decode: lists of boxes (B, A_l, 4) and probs (B, A_l, nc)."""
    reg_max, nc = spec.reg_max, spec.num_classes
    b = outs[0].shape[0]
    dev = outs[0].device
    bin_idx = torch.arange(reg_max, dtype=torch.float32, device=dev)
    boxes_l, probs_l = [], []
    for o, s in zip(outs, spec.strides):
        gh, gw = o.shape[1], o.shape[2]
        bins = o[..., :4 * reg_max].reshape(b, gh, gw, 4, reg_max)
        dist = torch.sum(torch.softmax(bins, dim=-1) * bin_idx, dim=-1)
        xs = (torch.arange(gw, dtype=torch.float32, device=dev) + 0.5)
        ys = (torch.arange(gh, dtype=torch.float32, device=dev) + 0.5)
        ax = xs[None, None, :].expand(b, gh, gw)
        ay = ys[None, :, None].expand(b, gh, gw)
        lt, rb = dist[..., :2], dist[..., 2:]
        anc = torch.stack([ax, ay], dim=-1)
        x1y1 = anc - lt
        x2y2 = anc + rb
        cxy = (x1y1 + x2y2) / 2.0
        wh = x2y2 - x1y1
        boxes_l.append((torch.cat([cxy, wh], dim=-1) * float(s))
                       .reshape(b, gh * gw, 4))
        probs_l.append(torch.sigmoid(o[..., 4 * reg_max:])
                       .reshape(b, gh * gw, nc))
    return boxes_l, probs_l


def decode_outputs(spec: ModelSpec, outs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Decode raw level maps to (B, A, 4 + nc): xywh in input pixels + class
    probs (DFL softmax expectation -> ltrb, dist2bbox, x stride; sigmoid)."""
    boxes_l, probs_l = decode_output_levels(spec, outs)
    return torch.cat([torch.cat(boxes_l, dim=1),
                      torch.cat(probs_l, dim=1)], dim=-1)


def forward_decoded(params: Params, spec: ModelSpec, x: torch.Tensor,
                    dtype=torch.float32, plain: bool = False,
                    stem: str = "conv", c2f: str = "slice",
                    dot1x1: bool = False, conv_fn=None) -> torch.Tensor:
    """(B, A, 4+nc) decoded output — the ONNX `output0` equivalent
    (transposed). conv_fn: see apply_backbone (`tp_conv` on a mesh)."""
    return decode_outputs(spec, forward_raw(
        params, spec, x, dtype=dtype, plain=plain, stem=stem, c2f=c2f,
        dot1x1=dot1x1, conv_fn=conv_fn))


def forward_decoded_levels(params: Params, spec: ModelSpec, x: torch.Tensor,
                           dtype=torch.float32, plain: bool = False,
                           stem: str = "conv", c2f: str = "slice",
                           dot1x1: bool = False, conv_fn=None
                           ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Level-separated decoded output (boxes_l, probs_l), for the per-level
    candidate selection (ops/nms.postprocess_batch_levels)."""
    return decode_output_levels(spec, forward_raw(
        params, spec, x, dtype=dtype, plain=plain, stem=stem, c2f=c2f,
        dot1x1=dot1x1, conv_fn=conv_fn))
