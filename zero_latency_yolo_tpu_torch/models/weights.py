"""Weight files and the device form of the parameters.

The port reads what the JAX package reads, into the same NumPy tree (the
`m0`..`m22` tree with HWIO kernels):

- the native `.npz`: a flat "m0/cv1/w"-keyed archive of that tree;
- ultralytics PyTorch state_dicts in `.pt` / `.pth` files ("model.0.conv.weight",
  BN statistics folded), loaded with `torch.load(weights_only=True)`: a file
  holding pickled objects is refused unless ZLT_TRUST_PICKLE=1;
- `.onnx` files exported by ultralytics (Conv+BN fused before export), read
  by a protobuf walker in NumPy: no `onnx` package.

The tree stays in NumPy until `params_from_jax` turns it into the device form
that `models/yolov8.py` runs (BN folded, OIHW kernels for `F.conv2d`, a (Cin,
Cout) matrix for each 1x1 conv), and `place_params` moves that to a device.

If the configured model file is missing or unreadable the engine falls back to
simulation mode (reference behavior: src/inference/onnx_engine.cpp:70-75).
"""

from __future__ import annotations

import hashlib
import logging
import os
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.conv1x1_cuda import k_major
from ..ops.conv_int8_cuda import pack_weight
from .yolov8 import (VARIANTS, ModelSpec, _depth, fold_batchnorm, get_spec,
                     init_params, stem_s2d_weights)

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


def save_params(params: Params, path: str) -> None:
    """Write a tree (NumPy arrays or tensors, HWIO) as a native `.npz`."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flatten(train_params_to_numpy(params)))


def load_params(path: str) -> Params:
    """NumPy tree (HWIO) from a native `.npz` file."""
    with np.load(path) as z:
        return unflatten({k: z[k] for k in z.files})


def load_artifact(path: str) -> Params:
    """Load a weight file by its extension: .npz (native), .pt/.pth
    (ultralytics checkpoint or state_dict), .onnx (exported graph)."""
    if path.endswith(".npz"):
        return load_params(path)
    if path.endswith((".pt", ".pth")):
        return load_torch_checkpoint(path)
    if path.endswith(".onnx"):
        return from_onnx(path)
    raise ValueError(f"unknown weight format: {path} "
                     "(expected .npz, .pt/.pth or .onnx)")


def file_sha256(path: str) -> str:
    """Model-file hash (reference src/inference/onnx_engine.cpp:1087-1124)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


# ---------------------------------------------------------------------------
# ultralytics state_dict conversion
# ---------------------------------------------------------------------------

def _torch_to_hwio(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))  # OIHW -> HWIO


def from_ultralytics_state_dict(sd: Dict[str, np.ndarray]) -> Params:
    """Convert an ultralytics DetectionModel state_dict (NumPy values, keys
    like 'model.0.conv.weight' / 'model.22.cv2.0.1.bn.running_mean') into
    the tree. BN blocks are folded; the DFL conv (fixed arange weights) is
    dropped, since the decode computes the expectation directly."""
    flat: Dict[str, np.ndarray] = {}
    for key, val in sd.items():
        if not key.startswith("model."):
            continue
        parts = key.split(".")
        rest = parts[2:]
        if rest[:1] == ["dfl"]:
            continue
        mapped = _map_ultra_path(rest)
        if mapped is None:
            continue
        arr = np.asarray(val)
        if mapped[-1] == "w" and arr.ndim == 4:
            arr = _torch_to_hwio(arr)
        flat[f"m{parts[1]}/" + "/".join(mapped)] = arr
    return fold_batchnorm(_bn_arrays_to_tree(unflatten(flat)))


def _map_ultra_path(rest: List[str]) -> Optional[List[str]]:
    """ultralytics module path -> the tree's path.

    Conv block: conv.weight -> w; bn.{weight,bias,running_mean,running_var}
    C2f:        cv1/cv2 conv blocks, m.<i>.cv1/cv2
    Detect:     cv2.<lvl>.<j>.(conv|bn|weight|bias), j=2 is the bare Conv2d
    """
    bn_map = {"weight": "gamma", "bias": "beta",
              "running_mean": "mean", "running_var": "var"}
    out: List[str] = []
    i = 0
    while i < len(rest):
        tok = rest[i]
        if tok == "conv":
            out.append("w" if rest[i + 1] == "weight" else "b")
            return out
        if tok == "bn":
            stat = bn_map.get(rest[i + 1])
            if stat is None:
                return None  # num_batches_tracked
            out.extend(["bn", stat])
            return out
        if tok == "weight":  # bare Conv2d at the detect head's tip
            out.append("w")
            return out
        if tok == "bias":
            out.append("b")
            return out
        out.append(tok)
        i += 1
    return None


def _bn_arrays_to_tree(params: Params) -> Params:
    return params  # bn subdicts already nested by unflatten


def load_torch_checkpoint(path: str) -> Params:
    """The tree from a `.pt`/`.pth` file: a state_dict, or a checkpoint
    holding a module. Only tensors are unpickled unless ZLT_TRUST_PICKLE=1:
    the dashboard's model upload and the hot-reload watcher load these files,
    so unpickling arbitrary objects by default would run whatever code an
    uploaded file carries."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # pickled objects present
        if os.environ.get("ZLT_TRUST_PICKLE") == "1":
            obj = torch.load(path, map_location="cpu", weights_only=False)
        else:
            raise ValueError(
                f"{path} contains pickled objects (a full ultralytics "
                f"checkpoint?). Load only tensor checkpoints by default; "
                f"export a state_dict / .onnx instead, or set "
                f"ZLT_TRUST_PICKLE=1 if you trust this file. ({e})") from e
    if hasattr(obj, "state_dict"):
        sd = obj.state_dict()
    elif isinstance(obj, dict) and "model" in obj and hasattr(
            obj["model"], "state_dict"):
        sd = obj["model"].float().state_dict()
    elif isinstance(obj, dict):
        sd = obj
    else:
        raise ValueError(f"unsupported checkpoint object in {path}")
    return from_ultralytics_state_dict(
        {k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
         for k, v in sd.items()})


# ---------------------------------------------------------------------------
# ONNX initializers (protobuf wire format, NumPy only)
# ---------------------------------------------------------------------------

def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _walk_fields(buf: memoryview):
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
            yield field, wire, val
        elif wire == 1:
            yield field, wire, bytes(buf[pos:pos + 8])
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            yield field, wire, bytes(buf[pos:pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")


_ONNX_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32,
                7: np.int64, 10: np.float16, 11: np.float64}


def _parse_tensor(buf: memoryview) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype = np.float32
    name = ""
    raw = b""
    floats: List[float] = []
    for field, wire, val in _walk_fields(buf):
        if field == 1 and wire == 0:
            dims.append(val)
        elif field == 2 and wire == 0:
            dtype = _ONNX_DTYPES.get(val, np.float32)
        elif field == 4:
            if wire == 2:  # packed float_data
                floats.extend(struct.unpack(f"<{len(val) // 4}f", bytes(val)))
            elif wire == 5:
                floats.append(struct.unpack("<f", val)[0])
        elif field == 8 and wire == 2:
            name = bytes(val).decode("utf-8")
        elif field == 9 and wire == 2:
            raw = bytes(val)
    if raw:
        arr = np.frombuffer(raw, dtype=dtype).reshape(dims)
    elif floats:
        arr = np.asarray(floats, dtype=np.float32).reshape(dims)
    else:
        arr = np.zeros(dims, dtype=dtype)
    return name, arr


def read_onnx_initializers(path: str) -> Dict[str, np.ndarray]:
    """{name: array} of the graph's initializers."""
    with open(path, "rb") as f:
        data = f.read()
    tensors: Dict[str, np.ndarray] = {}
    for field, wire, val in _walk_fields(memoryview(data)):
        if field == 7 and wire == 2:  # ModelProto.graph
            for gfield, gwire, gval in _walk_fields(val):
                if gfield == 5 and gwire == 2:  # GraphProto.initializer
                    name, arr = _parse_tensor(gval)
                    tensors[name] = arr
    return tensors


def from_onnx(path: str) -> Params:
    """The tree from an ultralytics-exported .onnx (Conv+BN fused)."""
    tensors = read_onnx_initializers(path)
    flat: Dict[str, np.ndarray] = {}
    for name, arr in tensors.items():
        if not name.startswith("model.") or ".dfl." in name:
            continue
        parts = name.split(".")
        mapped = _map_ultra_path(parts[2:])
        if mapped is None:
            continue
        if mapped[-1] == "w" and arr.ndim == 4:
            arr = _torch_to_hwio(arr)
        flat[f"m{parts[1]}/" + "/".join(mapped)] = arr
    if not flat:
        raise ValueError(
            f"{path}: no recognizable YOLOv8 initializers "
            "(placeholder or graph-optimized export)")
    return unflatten(flat)


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
    """Load a `.npz`, `.pt`/`.pth` or `.onnx` file into the NumPy tree.
    Returns (params, spec, simulation).

    On a geometry mismatch the spec is inferred from the file. On any failure
    returns random-init params with simulation=True, mirroring the
    reference's graceful degradation to simulation mode.
    """
    spec = get_spec(variant, num_classes)
    try:
        params = load_artifact(path)
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
# Training form: the JAX package's tree, key for key, as f32 leaf tensors
# ---------------------------------------------------------------------------

def tree_map(fn, tree: Params) -> Params:
    """`fn` over every leaf of a dict/list tree; the structure is kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree: Params) -> List[Any]:
    """The leaves in `jax.tree.flatten`'s order: dict keys sorted, lists in
    order. The optimizer's moments and `train/checkpoint.py`'s opt.npz
    follow it, so the state's leaves line up with optax's."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_from_leaves(like: Params, leaves: List[Any]) -> Params:
    """The inverse of `tree_leaves`: `like`'s structure over `leaves`, given
    in `tree_leaves`' order."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            out = {k: walk(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return next(it)
    tree = walk(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return tree


def train_params_from_jax(tree: Params, device="cpu") -> Params:
    """The JAX package's tree (NumPy, HWIO; unfolded {w, bn: {gamma, beta,
    mean, var}} or folded {w, b} blocks) as f32 leaf tensors on `device`,
    with its keys and layouts unchanged: `flatten` of the result gives the
    JAX package's keys, so checkpoints and `save_params` files of either
    package load in the other. The training forward
    (`models/yolov8.py` `forward_train_raw`) runs this form; eval folds it
    through `params_from_jax`."""
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32),
                                           device=device), tree)


def train_params_to_numpy(tree: Params) -> Params:
    """The way back: every leaf (tensor or array) as a NumPy f32 array."""
    def leaf(a):
        if isinstance(a, torch.Tensor):
            return a.detach().to("cpu", torch.float32).numpy()
        return np.asarray(a)
    return tree_map(leaf, tree)


# ---------------------------------------------------------------------------
# Device form
# ---------------------------------------------------------------------------

def params_from_jax(tree: Params) -> Params:
    """The JAX package's parameter tree (NumPy arrays, HWIO kernels) -> the
    port's parameters (CPU tensors): BN folded; HWIO -> OIHW for
    `F.conv2d`; a 1x1 kernel as its (Cin, Cout) matrix `w_mm`. An int8 conv
    block of `ops/quant.py` `quantize_params` ({w_q, w_scale, b} and,
    calibrated, x_scale) keeps its int8 kernel as (Cout, kh, kw, Cin), the
    order of an NHWC patch, and its scales and bias in f32."""
    def f32(a):
        return torch.from_numpy(np.array(a, np.float32))

    def conv(node):
        b = f32(node["b"])
        if "w_q" in node:
            w_q = np.asarray(node["w_q"])
            if w_q.dtype != np.int8:
                raise ValueError(f"w_q must be int8, got {w_q.dtype}")
            out = {"w_q": torch.from_numpy(np.array(w_q.transpose(3, 0, 1, 2),
                                                    order="C")),
                   "w_scale": f32(node["w_scale"]), "b": b}
            if "x_scale" in node:
                out["x_scale"] = f32(node["x_scale"]).reshape(())
            return out
        w = np.asarray(node["w"], np.float32)
        if w.shape[0] == 1 and w.shape[1] == 1:
            return {"w_mm": torch.from_numpy(np.array(w[0, 0])), "b": b}
        return {"w": torch.from_numpy(np.array(w.transpose(3, 2, 0, 1),
                                                order="C")), "b": b}

    def walk(node):
        if isinstance(node, dict):
            if "w" in node or "w_q" in node:
                return conv(node)
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        raise ValueError(f"unexpected parameter leaf {type(node).__name__}")

    flat = flatten(tree)
    if any("/bn/" in k for k in flat):
        tree = fold_batchnorm(unflatten(flat))
    return walk(tree)


def place_params(params: Params, device, dtype: torch.dtype,
                 c2f_split: bool = False, stem_s2d: bool = False,
                 shard: Optional[Tuple[int, int]] = None) -> Params:
    """Copy device-form params to `device`: kernels in `dtype` (channels-last
    OIHW, so convs write NHWC, and a k=3 kernel's bytes are the K-major
    (Cout, 9 * Cin) matrix the k=3 kernel reads; a 1x1 matrix K-major, the
    layout the tensor-core 1x1 kernel reads, laid out here once), biases in
    f32.

    c2f_split: also lay out each C2f block's pieces for the split form
    (models/yolov8.py `_c2f`), once: `cv1_pieces`, the two column halves of
    cv1 with their biases, and `cv2_pieces`, cv2's row blocks of c = Cout/2
    input channels with an f32 zero bias each (the 1x1 kernel takes a bias).
    Every piece is its own contiguous K-major matrix.
    stem_s2d: also place m0's kernel as the k2 s1 kernel of the
    space-to-depth stem (`w_s2d`, models/yolov8.py `_stem_s2d`).
    An int8 block ({w_q, w_scale, b[, x_scale]}) is laid out once as the
    int8 kernel reads it: `w_q` a (Cout, Kp) int8 matrix, K-major in (ky,
    kx, cin) order, K zero-padded to the MMA's K step
    (`ops/conv_int8_cuda.py` `pack_weight`), with its kernel size `k`; the
    scales and bias f32. It gets no `w_mm` and no split-C2f pieces: its C2f
    runs the slice form.
    shard: (index, count), this device's part of a tensor-parallel
    placement over `count` devices (`parallel/mesh.py` `shard_params`):
    every float conv block that `parallel/mesh.py` `shards_conv` names by
    its path keeps output channels [index * Cout / count, (index + 1) *
    Cout / count) of its kernel and bias, and is marked "shard": (index,
    count). Each slice is its own contiguous copy: a column slice of a
    K-major 1x1 matrix is not contiguous, and the tensor-core kernel's TMA
    needs 16-byte rows. The split C2f's pieces are cut from the whole
    kernels by the same rule on their own Cout, and the s2d stem kernel
    from m0's slice. int8 blocks stay whole."""
    from ..parallel.mesh import shards_conv

    def cut(node, path):
        """The block's slice for this shard (the block itself when whole)."""
        if shard is None or "w_q" in node:
            return node
        index, count = shard
        cout = int(node["b"].shape[0])
        if not shards_conv(path, cout, count):
            return node
        lo, hi = index * cout // count, (index + 1) * cout // count
        out = {"b": node["b"][lo:hi], "shard": (index, count)}
        if "w_mm" in node:
            out["w_mm"] = node["w_mm"][:, lo:hi]
        else:
            out["w"] = node["w"][lo:hi]
        return out

    def conv(node, path):
        node = cut(node, path)
        out = {"b": node["b"].to(device=device, dtype=torch.float32)}
        if "shard" in node:
            out["shard"] = node["shard"]
        if "w_q" in node:
            out["w_q"] = pack_weight(node["w_q"]).to(device)
            out["k"] = int(node["w_q"].shape[1])
            for key in ("w_scale", "x_scale"):
                if key in node:
                    out[key] = node[key].to(device=device, dtype=torch.float32)
        elif "w_mm" in node:
            out["w_mm"] = k_major(node["w_mm"].to(device=device, dtype=dtype))
        else:
            out["w"] = node["w"].to(device=device, dtype=dtype).contiguous(
                memory_format=torch.channels_last)
            if stem_s2d and path == "m0":
                out["w_s2d"] = stem_s2d_weights(out["w"]).contiguous(
                    memory_format=torch.channels_last)
        return out

    def pieces(node, path):
        w1, b1 = node["cv1"]["w_mm"], node["cv1"]["b"]
        c = w1.shape[1] // 2
        w2, b2 = node["cv2"]["w_mm"], node["cv2"]["b"]
        zero = torch.zeros_like(b2)
        return {"cv1_pieces": [
                    conv({"w_mm": w1[:, :c], "b": b1[:c]},
                         f"{path}/cv1_pieces/0"),
                    conv({"w_mm": w1[:, c:], "b": b1[c:]},
                         f"{path}/cv1_pieces/1")],
                "cv2_pieces": [
                    conv({"w_mm": w2[i * c:(i + 1) * c], "b": zero},
                         f"{path}/cv2_pieces/{i}")
                    for i in range(w2.shape[0] // c)]}

    def walk(node, path):
        if isinstance(node, list):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(node)]
        if "b" in node:
            return conv(node, path)
        out = {k: walk(v, f"{path}/{k}" if path else k)
               for k, v in node.items()}
        if (c2f_split and "m" in node and "w_q" not in node["cv1"]
                and "w_mm" in node["cv1"]):
            out.update(pieces(node, path))
        return out

    return walk(params, "")
