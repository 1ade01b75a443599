"""Real-dataset pipeline: the ultralytics YOLO directory convention.

A copy of the JAX package's `train/data.py` (NumPy; `cv2` imported only
where an image is decoded or resized, so the port does not depend on it).

The reference's deployment flow trains with ultralytics and drops the export
into ``models/`` (reference start.sh:113-149); the datasets its users hold
are therefore in the YOLO directory convention:

    root/images/*.{jpg,png,bmp,...}     root/labels/<stem>.txt
      -- or a flat directory with <stem>.txt next to each image --

with one ``class cx cy w h`` line per box, normalized to the ORIGINAL image.
This module loads that layout for the native train loop (train/loop.py) and
the evaluator (train/eval.py), closing the last gap between "synthetic-only
training" and "fine-tune on your own data".

Geometry: images are letterboxed to the square train size with the SAME
parameters the serving preprocess uses (ops/preprocess.letterbox_params:
scale = min(S/h, S/w), centered pad, 114-gray fill) and the boxes are remapped
into letterboxed coordinates — a model fine-tuned here sees exactly the
serving-time geometry. Host-side the paste lands on integer pixels (the
device kernel samples at fractional pads; the difference is bounded by half
a pixel), and the box remap uses the same integer pads as the paste so
labels stay aligned with the pixels.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def _require_cv2():
    try:
        import cv2
        return cv2
    except ImportError as e:  # pragma: no cover - cv2 ships in this image
        raise ImportError(
            "the YOLO directory loader decodes images with cv2; install "
            "opencv-python or convert the dataset to .npz shards "
            "(train/loop.py npz_batches)") from e


def find_pairs(root: str) -> List[Tuple[str, Optional[str]]]:
    """(image_path, label_path|None) pairs under a YOLO-convention root.

    Accepts either ``root/images`` + ``root/labels`` or a flat directory
    with ``<stem>.txt`` beside each image. Images without a label file are
    kept as negative (background-only) samples — the standard convention.
    """
    img_dir = os.path.join(root, "images")
    lbl_dir = os.path.join(root, "labels")
    flat = not os.path.isdir(img_dir)
    if flat:
        img_dir, lbl_dir = root, root
    pairs: List[Tuple[str, Optional[str]]] = []
    for name in sorted(os.listdir(img_dir)):
        stem, ext = os.path.splitext(name)
        if ext.lower() not in IMAGE_EXTS:
            continue
        lbl = os.path.join(lbl_dir, stem + ".txt")
        pairs.append((os.path.join(img_dir, name),
                      lbl if os.path.isfile(lbl) else None))
    if not pairs:
        raise FileNotFoundError(
            f"no images under {root!r} (looked in {img_dir!r}; "
            f"extensions {IMAGE_EXTS})")
    return pairs


def read_labels(path: Optional[str], num_classes: Optional[int] = None
                ) -> np.ndarray:
    """Parse one YOLO label file -> (M, 5) [class, cx, cy, w, h] float32.

    Malformed lines raise (silent label loss poisons a fine-tune); class ids
    outside [0, num_classes) raise when num_classes is given.
    """
    if path is None:
        return np.zeros((0, 5), np.float32)
    rows = []
    with open(path, "r", encoding="utf-8") as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) != 5:
                raise ValueError(f"{path}:{ln}: expected 'class cx cy w h', "
                                 f"got {line!r}")
            cls = float(parts[0])
            vals = [float(v) for v in parts[1:]]
            if not cls.is_integer():
                raise ValueError(f"{path}:{ln}: class id {parts[0]!r} is "
                                 "not an integer")
            if num_classes is not None and not 0 <= cls < num_classes:
                raise ValueError(f"{path}:{ln}: class {cls:g} outside "
                                 f"[0, {num_classes})")
            if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in vals):
                # One NaN coordinate silently NaNs the whole training loss
                # (CIoU of a NaN GT) with nothing pointing at the bad file.
                raise ValueError(f"{path}:{ln}: box values must be finite "
                                 f"and normalized to [0, 1], got {line!r}")
            rows.append((cls, *vals))
    return np.asarray(rows, np.float32).reshape(-1, 5)


def letterbox_image(img: np.ndarray, size: int, fill: int = 114
                    ) -> Tuple[np.ndarray, float, int, int]:
    """Letterbox an HWC uint8 image to (size, size); returns (out, scale,
    pad_x, pad_y) with the serving preprocess's geometry (integer paste)
    AND its gray pad (ops/preprocess.FILL = 114/255): a model fine-tuned on
    non-square data must see serving-time pad pixels, not black borders.
    (The committed artifacts trained on square synthetic data — no pad
    pixels existed — so the default flip is behavior-neutral for them.)"""
    cv2 = _require_cv2()
    h, w = img.shape[:2]
    scale = min(size / h, size / w)
    new_h = max(int(round(h * scale)), 1)
    new_w = max(int(round(w * scale)), 1)
    resized = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    pad_y = (size - new_h) // 2
    pad_x = (size - new_w) // 2
    out = np.full((size, size, 3), np.uint8(fill), np.uint8)
    out[pad_y:pad_y + new_h, pad_x:pad_x + new_w] = resized
    return out, scale, pad_x, pad_y


def load_sample(img_path: str, lbl_path: Optional[str], size: int,
                max_boxes: int, num_classes: Optional[int] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """One letterboxed (size,size,3) uint8 image + (max_boxes,5) targets."""
    cv2 = _require_cv2()
    bgr = cv2.imread(img_path, cv2.IMREAD_COLOR)
    if bgr is None:
        raise ValueError(f"cv2 could not decode image {img_path!r}")
    img = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    h, w = img.shape[:2]
    out, scale, pad_x, pad_y = letterbox_image(img, size)
    labels = read_labels(lbl_path, num_classes)
    targets = np.full((max_boxes, 5), -1.0, np.float32)
    n = min(len(labels), max_boxes)
    if n:
        t = labels[:n].copy()
        # Original-normalized -> letterboxed-normalized coordinates.
        t[:, 1] = (t[:, 1] * w * scale + pad_x) / size
        t[:, 2] = (t[:, 2] * h * scale + pad_y) / size
        t[:, 3] = t[:, 3] * w * scale / size
        t[:, 4] = t[:, 4] * h * scale / size
        targets[:n] = t
    return out, targets


def load_yolo_dir(root: str, size: int, max_boxes: int = 32,
                  num_classes: Optional[int] = None,
                  limit: Optional[int] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Materialize a whole split: (N,S,S,3) uint8 + (N,max_boxes,5) targets.

    Feed ``images.astype(np.float32)/255`` straight into train/eval (this is
    the evaluator's expected input; the batch iterator below does the
    conversion per batch to keep the resident cache at uint8 size).
    """
    pairs = find_pairs(root)
    if limit is not None:
        pairs = pairs[:limit]
    images = np.empty((len(pairs), size, size, 3), np.uint8)
    targets = np.empty((len(pairs), max_boxes, 5), np.float32)
    for i, (img, lbl) in enumerate(pairs):
        images[i], targets[i] = load_sample(img, lbl, size, max_boxes,
                                            num_classes)
    return images, targets


def coco_to_yolo(ann_file: str, images_dir: str, out_dir: str,
                 skip_crowd: bool = True) -> Tuple[int, dict]:
    """Convert a COCO-format annotation file into the YOLO directory layout
    this loader (and ultralytics) consumes: ``out_dir/images`` (symlinks to
    the originals) + ``out_dir/labels/<stem>.txt``.

    Most public detection datasets ship COCO JSON; the reference's training
    story assumes users already hold YOLO-layout data (start.sh:113-149
    just exports a pretrained model). Category ids (arbitrary, sparse in
    COCO) remap to contiguous [0, C) in ascending id order — the mapping is
    returned and written to ``out_dir/classes.txt`` one name per line.
    COCO boxes are absolute [x_min, y_min, w, h]; YOLO wants normalized
    center-format. Boxes are clamped to the image and degenerate (empty
    after clamping) or iscrowd annotations are skipped. Returns
    (num_images, {coco_category_id: contiguous_id})."""
    import json as _json

    with open(ann_file, "r", encoding="utf-8") as f:
        coco = _json.load(f)
    cats = sorted(c["id"] for c in coco.get("categories", []))
    cat_map = {cid: i for i, cid in enumerate(cats)}
    names = {c["id"]: str(c.get("name", c["id"]))
             for c in coco.get("categories", [])}
    imgs = {im["id"]: im for im in coco.get("images", [])}
    per_image: dict = {im_id: [] for im_id in imgs}
    for a in coco.get("annotations", []):
        if skip_crowd and a.get("iscrowd"):
            continue
        im = imgs.get(a.get("image_id"))
        if im is None or a.get("category_id") not in cat_map:
            continue
        W, H = float(im["width"]), float(im["height"])
        x, y, w, h = (float(v) for v in a["bbox"])
        x0, y0 = max(x, 0.0), max(y, 0.0)
        x1, y1 = min(x + w, W), min(y + h, H)
        if x1 <= x0 or y1 <= y0:
            continue
        per_image[im["id"]].append(
            (cat_map[a["category_id"]],
             (x0 + x1) / 2 / W, (y0 + y1) / 2 / H,
             (x1 - x0) / W, (y1 - y0) / H))
    img_out = os.path.join(out_dir, "images")
    lbl_out = os.path.join(out_dir, "labels")
    os.makedirs(img_out, exist_ok=True)
    os.makedirs(lbl_out, exist_ok=True)
    # COCO file_name may contain subdirectories and may repeat basenames
    # across them ('part1/0001.jpg', 'part2/0001.jpg'): flatten separators
    # into the output name so nothing silently cross-links images and
    # labels, and refuse outright if two entries still collide.
    flat_names: dict = {}
    for im in imgs.values():
        flat = im["file_name"].replace(os.sep, "_").replace("/", "_")
        other = flat_names.get(flat)
        if other is not None:
            # Covers BOTH collision modes: distinct names flattening to one
            # output name AND two distinct image records sharing one
            # file_name (a merged annotation file) — either way the second
            # label write would silently replace the first image's boxes.
            raise ValueError(
                f"images id={other[1]} ({other[0]!r}) and id={im['id']} "
                f"({im['file_name']!r}) both map to output {flat!r}; "
                f"deduplicate the annotation file")
        flat_names[flat] = (im["file_name"], im["id"])
        im["_flat_name"] = flat
    n = 0
    for im_id, im in imgs.items():
        src = os.path.join(images_dir, im["file_name"])
        if not os.path.isfile(src):
            raise FileNotFoundError(f"image listed in {ann_file!r} missing "
                                    f"on disk: {src!r}")
        dst = os.path.join(img_out, im["_flat_name"])
        if os.path.lexists(dst):  # retarget stale/moved links on rerun
            os.unlink(dst)
        os.symlink(os.path.abspath(src), dst)
        stem = os.path.splitext(im["_flat_name"])[0]
        with open(os.path.join(lbl_out, stem + ".txt"), "w",
                  encoding="utf-8") as f:
            for row in per_image[im_id]:
                f.write("%d %.6f %.6f %.6f %.6f\n" % row)
        n += 1
    with open(os.path.join(out_dir, "classes.txt"), "w",
              encoding="utf-8") as f:
        for cid in cats:
            f.write(names[cid] + "\n")
    return n, cat_map


def yolo_dir_batches(root: str, batch: int, size: int, max_boxes: int = 32,
                     num_classes: Optional[int] = None, seed: int = 0,
                     cache_mb: int = 2048
                     ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless shuffled batches from a YOLO-convention directory.

    Splits at-or-under ``cache_mb`` of letterboxed uint8 pixels are decoded
    once and held in RAM (the common case for fine-tune sets); larger splits
    re-decode per epoch from a shuffled file order. Shuffling is seeded and
    per-epoch; batches are full-size (a trailing remainder shorter than
    ``batch`` is folded into the next epoch so the train step never sees a
    new shape — shape stability is a serving-stack invariant too).
    """
    pairs = find_pairs(root)
    if len(pairs) < batch:
        raise ValueError(f"split {root!r} has {len(pairs)} images, fewer "
                         f"than batch={batch}")
    rng = np.random.default_rng(seed)
    resident = len(pairs) * size * size * 3 <= cache_mb * (1 << 20)
    cache: Optional[Tuple[np.ndarray, np.ndarray]] = None
    carry_i: List[np.ndarray] = []
    carry_t: List[np.ndarray] = []
    while True:
        order = rng.permutation(len(pairs))
        if resident and cache is None:
            cache = load_yolo_dir(root, size, max_boxes, num_classes)
        for j in order:
            if cache is not None:
                # Row views into the one resident copy — a whole-epoch
                # fancy-index copy here would peak at ~3x the cache_mb
                # bound the residency check enforces.
                img, tgt = cache[0][j], cache[1][j]
            else:
                img, tgt = load_sample(*pairs[j], size, max_boxes,
                                       num_classes)
            carry_i.append(img)
            carry_t.append(tgt)
            if len(carry_i) >= batch:
                yield (np.stack(carry_i).astype(np.float32) / 255,
                       np.stack(carry_t))
                carry_i.clear()
                carry_t.clear()
