"""int8 weight quantization for the conv backbone (tpu.quantize_int8).

The PyTorch counterpart of the JAX package's `ops/quant.py`: static
symmetric per-output-channel int8 weights, a per-tensor int8 activation
scale (dynamic, or calibrated once by `calibrate_activations`), an int8
conv with int32 accumulation (`ops/conv_int8_cuda.py`) and the dequant
into an f32 bias + SiLU tail.

The detect head (m22) and the stem (m0: 3 input channels, few operations,
sensitive to precision) stay unquantized; every backbone and neck conv
quantizes.

`quantize_params` and `dequantize_params` work on the NumPy parameter tree
(HWIO kernels) that `models/weights.py` loads, as the JAX package's do, and
give the same bits: a conv's {w, b} becomes {w_q int8 (H, W, I, O),
w_scale f32 (O,), b f32}. `models/weights.py` `params_from_jax` and
`place_params` turn that into the device form; `calibrate_activations` runs
on the placed tree and attaches each int8 conv's `x_scale`.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

Params = Dict[str, Any]

SKIP_KEYS = ("m22", "m0")  # head + stem stay high precision


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


def _like(t: torch.Tensor, ref):
    """t as NumPy when the input was not a tensor."""
    return t if isinstance(ref, torch.Tensor) else t.numpy()


def quantize_conv(p: Params) -> Params:
    """{w, b} -> {w_q, w_scale, b}; per-output-channel symmetric int8:
    scale = max(amax, 1e-8) / 127 in f32, w_q = clip(round(w / scale),
    -127, 127), round half to even."""
    w = _as_tensor(p["w"]).to(torch.float32)
    amax = torch.amax(torch.abs(w), dim=(0, 1, 2), keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    out: Params = {"w_q": _like(w_q, p["w"]),
                   "w_scale": _like(scale[0, 0, 0].contiguous(), p["w"])}
    if "b" in p:
        out["b"] = _like(_as_tensor(p["b"]).to(torch.float32), p["b"])
    return out


def quantize_params(params: Params) -> Params:
    """Quantize all folded conv blocks except SKIP_KEYS subtrees."""
    def walk(node, top: str):
        if isinstance(node, dict):
            if "w" in node and "bn" not in node and np.ndim(node["w"]) == 4:
                if top in SKIP_KEYS:
                    return node
                return quantize_conv(node)
            return {k: walk(v, top if top else k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, top) for v in node]
        return node

    return {k: walk(v, k) for k, v in params.items()}


def dequantize_params(params: Params) -> Params:
    """Inverse (for testing): {w_q, w_scale, b} -> {w, b}."""
    def walk(node):
        if isinstance(node, dict):
            if "w_q" in node:
                w = (_as_tensor(node["w_q"]).to(torch.float32)
                     * _as_tensor(node["w_scale"]).to(torch.float32))
                out = {"w": _like(w, node["w_q"])}
                if "b" in node:
                    out["b"] = node["b"]
                return out
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node
    return walk(params)


def calibrate_activations(qparams: Params, spec, sample_inputs,
                          dtype=None, margin: float = 1.1) -> int:
    """Record each int8 conv's input abs-max on calibration data and attach
    static activation scales, removing the per-conv reduction from the
    serving step.

    qparams: the placed device-form tree (`models/weights.py`
    `place_params` of a quantized tree), mutated in place: each int8 conv
    block gains an "x_scale" f32 scalar on its device.
    sample_inputs: (B, S, S, 3) float inputs (post-letterbox), NumPy or a
    tensor.
    The forward runs with dynamic quant (each conv's input depends on the
    int8 convs before it), through forward_raw's conv_fn hook; the maxima
    stay on the device until one read at the end. x_scale = max(seen, 1e-6)
    * margin / 127 in Python floats, then f32, as the JAX package computes
    it. Returns the number of calibrated convs.
    """
    from ..models import yolov8 as _y

    block_ids = []
    maxima = []

    def recording_conv(p, x, stride=1, act=True, plain=False):
        if "w_q" in p:
            block_ids.append(id(p))
            maxima.append(torch.max(torch.abs(x.float())))
        return _y._conv(p, x, stride=stride, act=act, plain=plain)

    device = qparams["m1"]["b"].device
    x = _as_tensor(sample_inputs).to(device=device, dtype=torch.float32)
    with torch.inference_mode():
        _y.forward_raw(qparams, spec, x, dtype=dtype or torch.float32,
                       conv_fn=recording_conv)
        vals = torch.stack(maxima).cpu().tolist() if maxima else []
    seen: Dict[int, float] = dict(zip(block_ids, vals))

    count = 0

    def attach(node):
        nonlocal count
        if isinstance(node, dict):
            if "w_q" in node and id(node) in seen:
                node["x_scale"] = torch.tensor(
                    max(seen[id(node)], 1e-6) * margin / 127.0,
                    dtype=torch.float32, device=device)
                count += 1
                return
            for v in node.values():
                attach(v)
        elif isinstance(node, list):
            for v in node:
                attach(v)

    attach(qparams)
    return count


def int8_blocks(params: Params, prefix: str = "") -> Iterator[Tuple[str, Params]]:
    """(path, block) of every int8 conv block, paths as `models/weights.py`
    `flatten` names them ("m2/m/0/cv1"), in tree order."""
    if isinstance(params, dict):
        if "w_q" in params:
            yield prefix[:-1], params
            return
        for k, v in params.items():
            yield from int8_blocks(v, f"{prefix}{k}/")
    elif isinstance(params, list):
        for i, v in enumerate(params):
            yield from int8_blocks(v, f"{prefix}{i}/")


def x_scales(params: Params) -> Dict[str, float]:
    """{path: x_scale} of every calibrated int8 conv block."""
    return {path: float(b["x_scale"]) for path, b in int8_blocks(params)
            if "x_scale" in b}


def set_x_scales(params: Params, scales: Mapping[str, float]) -> int:
    """Give the placed int8 blocks named in `scales` those static activation
    scales (f32, on each block's device; e.g. another run's calibration
    carried across). Every int8 block must be named. Returns the count."""
    blocks = dict(int8_blocks(params))
    if set(blocks) != set(scales):
        raise ValueError(f"x_scales name {sorted(set(scales) ^ set(blocks))} "
                         "that are not the tree's int8 blocks")
    for path, b in blocks.items():
        b["x_scale"] = torch.tensor(float(scales[path]), dtype=torch.float32,
                                    device=b["b"].device)
    return len(blocks)
