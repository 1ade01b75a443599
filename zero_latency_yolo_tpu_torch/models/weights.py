"""Weight files and the device form of the parameters.

The port reads the JAX package's native `.npz` files: a flat "m0/cv1/w"-keyed
archive of the `m0`..`m22` tree with HWIO kernels. The tree stays in NumPy
until `params_from_jax` turns it into the device form that
`models/yolov8.py` runs (BN folded, OIHW kernels for `F.conv2d`, a (Cin, Cout)
matrix for each 1x1 conv), and `place_params` moves that to a device.

If the configured model file is missing or unreadable the engine falls back to
simulation mode (reference behavior: src/inference/onnx_engine.cpp:70-75).
The `.pt` and `.onnx` readers of the JAX package are not ported yet.
"""

from __future__ import annotations

import hashlib
import logging
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..ops.conv1x1_cuda import k_major
from .yolov8 import (VARIANTS, ModelSpec, _depth, fold_batchnorm, get_spec,
                     init_params)

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Flat <-> nested tree and .npz files
# ---------------------------------------------------------------------------

def flatten(params: Params, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(params, dict):
        for k, v in params.items():
            out.update(flatten(v, f"{prefix}{k}/"))
    elif isinstance(params, list):
        for i, v in enumerate(params):
            out.update(flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(params)
    return out


def unflatten(flat: Dict[str, np.ndarray]) -> Params:
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            missing = [str(i) for i in range(len(keys)) if str(i) not in node]
            if missing:
                raise ValueError(
                    f"non-contiguous indexed checkpoint entries: have "
                    f"{sorted(keys)}, missing {missing}")
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def load_params(path: str) -> Params:
    """NumPy tree (HWIO) from a native `.npz` file."""
    with np.load(path) as z:
        return unflatten({k: z[k] for k in z.files})


def file_sha256(path: str) -> str:
    """Model-file hash (reference src/inference/onnx_engine.cpp:1087-1124)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Spec introspection: recover (depth, width, max_channels, nc) from weights
# ---------------------------------------------------------------------------

def _expected_shapes(spec: ModelSpec, folded: bool) -> Dict[str, Tuple[int, ...]]:
    ref = init_params(0, spec, folded=folded)
    return {k: tuple(np.shape(v)) for k, v in flatten(ref).items()}


def spec_shape_mismatch(params: Params, spec: ModelSpec) -> List[str]:
    """[] when the param tree fits the spec exactly; else human-readable
    diffs (missing / extra / wrong-shape keys), a few at most."""
    flat = {k: tuple(np.shape(v)) for k, v in flatten(params).items()}
    want = _expected_shapes(spec, folded=not any("/bn/" in k for k in flat))
    out = []
    for k in sorted(set(want) - set(flat)):
        out.append(f"missing {k}")
    for k in sorted(set(flat) - set(want)):
        out.append(f"unexpected {k}")
    for k in sorted(set(flat) & set(want)):
        if flat[k] != want[k]:
            out.append(f"{k}: file {flat[k]} != spec {want[k]}")
    return out[:8]


def infer_spec_from_params(params: Params) -> ModelSpec:
    """Recover the ModelSpec from a param tree's landmark shapes. Raises
    ValueError when the tree isn't a recognizable YOLOv8."""
    try:
        c64 = int(np.shape(params["m0"]["w"])[3])
        ladder = tuple(int(np.shape(params[m]["w"])[3])
                       for m in ("m1", "m3", "m5", "m7"))
        n3 = len(params["m2"]["m"])
        n6 = len(params["m4"]["m"])
        det = params["m22"]
        nc = int(np.shape(det["cv3"][0][2]["w"])[3])
        reg_max = int(np.shape(det["cv2"][0][2]["w"])[3]) // 4
    except (KeyError, IndexError, TypeError) as e:
        raise ValueError(f"not a YOLOv8 param tree: {e!r}") from e

    observed = (c64,) + ladder

    def fits(spec: ModelSpec) -> bool:
        return (tuple(spec.ch(b) for b in (64, 128, 256, 512, 1024))
                == observed
                and _depth(3, spec.depth) == n3
                and _depth(6, spec.depth) == n6
                and not spec_shape_mismatch(params, spec))

    for name, (d, w, mc) in sorted(VARIANTS.items()):
        spec = ModelSpec(variant=name, num_classes=nc, depth=d, width=w,
                         max_channels=mc, reg_max=reg_max)
        if fits(spec):
            return spec
    # Parametric point: candidate widths inverted from every ladder rung,
    # depth from the bottleneck counts, channel cap from the deepest rung.
    width_cands = []
    for c, base in zip(observed, (64, 128, 256, 512, 1024)):
        cand = c / base
        if cand not in width_cands:
            width_cands.append(cand)
    d = next((round(dd, 2) for dd in [n3 / 3.0, n6 / 6.0] +
              [x / 100.0 for x in range(5, 201)]
              if _depth(3, round(dd, 2)) == n3
              and _depth(6, round(dd, 2)) == n6), None)
    for w in width_cands:
        for mc in (1024, int(round(observed[-1] / w))):
            if d is None:
                break
            name = f"yolov8-d{d:g}-w{w:g}-mc{mc}"
            spec = ModelSpec(variant=name, num_classes=nc, depth=d, width=w,
                             max_channels=mc, reg_max=reg_max)
            if fits(spec):
                return spec
    raise ValueError(
        f"params have an unrecognized geometry: stem {c64}, ladder "
        f"{ladder}, bottlenecks ({n3},{n6}), nc {nc}")


def load_model(path: str, variant: str = "yolov8n", num_classes: int = 4,
               seed: int = 0) -> Tuple[Params, ModelSpec, bool]:
    """Load a `.npz` NumPy tree. Returns (params, spec, simulation).

    On a geometry mismatch the spec is inferred from the file. On any failure
    returns random-init params with simulation=True, mirroring the
    reference's graceful degradation to simulation mode.
    """
    spec = get_spec(variant, num_classes)
    try:
        if not path.endswith(".npz"):
            raise ValueError(f"unsupported weight format: {path} (the "
                             "PyTorch port reads .npz only)")
        params = load_params(path)
        mismatch = spec_shape_mismatch(params, spec)
        if mismatch:
            inferred = infer_spec_from_params(params)
            logging.getLogger("zlt.weights").warning(
                "%s does not fit configured %s/nc=%d (%s) — serving the "
                "file's own geometry %s/nc=%d", path, variant, num_classes,
                mismatch[0], inferred.variant, inferred.num_classes)
            spec = inferred
        return params, spec, False
    except Exception as e:  # noqa: BLE001 — any failure => simulation mode
        logging.getLogger("zlt.weights").warning(
            "model %s not loadable (%s: %s) — simulation mode",
            path, type(e).__name__, e)
        return init_params(seed, spec, folded=True), spec, True


# ---------------------------------------------------------------------------
# Device form
# ---------------------------------------------------------------------------

def params_from_jax(tree: Params) -> Params:
    """The JAX package's parameter tree (NumPy arrays, HWIO kernels) -> the
    port's parameters (CPU f32 tensors): BN folded; HWIO -> OIHW for
    `F.conv2d`; a 1x1 kernel as its (Cin, Cout) matrix `w_mm`."""
    def conv(node):
        w = np.asarray(node["w"], np.float32)
        b = torch.from_numpy(np.array(node["b"], np.float32))
        if w.shape[0] == 1 and w.shape[1] == 1:
            return {"w_mm": torch.from_numpy(np.array(w[0, 0])), "b": b}
        return {"w": torch.from_numpy(np.ascontiguousarray(
            w.transpose(3, 2, 0, 1))), "b": b}

    def walk(node):
        if isinstance(node, dict):
            if "w" in node:
                return conv(node)
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        raise ValueError(f"unexpected parameter leaf {type(node).__name__}")

    flat = flatten(tree)
    if any("/w_q" in k for k in flat):
        raise ValueError("int8-quantized parameter trees are not ported yet")
    if any("/bn/" in k for k in flat):
        tree = fold_batchnorm(unflatten(flat))
    return walk(tree)


def place_params(params: Params, device, dtype: torch.dtype) -> Params:
    """Copy device-form params to `device`: kernels in `dtype` (channels-last
    OIHW, so convs write NHWC; a 1x1 matrix K-major, the layout the
    tensor-core 1x1 kernel reads, laid out here once), biases in f32."""
    def walk(node):
        if isinstance(node, list):
            return [walk(v) for v in node]
        if "b" not in node:
            return {k: walk(v) for k, v in node.items()}
        out = {"b": node["b"].to(device=device, dtype=torch.float32)}
        if "w_mm" in node:
            out["w_mm"] = k_major(node["w_mm"].to(device=device, dtype=dtype))
        else:
            out["w"] = node["w"].to(device=device, dtype=dtype).contiguous(
                memory_format=torch.channels_last)
        return out
    return walk(params)
