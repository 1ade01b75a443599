"""Serve -> capture -> fine-tune -> eval -> promote, as one operator command.

The port's copy of the JAX package's `scripts/flywheel.py`. The server
records served keyframes and their detections as a YOLO-convention dataset
(`analytics.capture_dir`, `runtime/capture.py`), the train loop fine-tunes
from any artifact on such a directory, `eval_artifact` is the scorer, and
the serving engine's hot-reload watcher picks up a changed model file by its
hash. This is the loop that strings them together with an honest eval split
and a gated, atomic promote:

    python -m zero_latency_yolo_tpu_torch.flywheel --capture-dir captures/ \
        --base models/model.npz --out models/candidate.npz \
        [--promote models/model.npz]

Stages:
  1. split the capture dir into train/holdout by a hash of the image stem:
     deterministic and stable as the capture dir grows, so images that were
     ever held out never leak into a later run's training split;
  2. fine-tune from --base on the train split (same variant warm start; with
     --student-variant, train that variant from scratch and distill from
     --base instead);
  3. evaluate base and candidate on the holdout with
     `python -m zero_latency_yolo_tpu_torch.eval_artifact` (a subprocess:
     the scorer of record, isolated from the train process);
  4. if candidate - base >= --min-gain on --metric: atomically copy the
     candidate over --promote (same architecture only: the live server
     hot-swaps it; an architecture change needs a fleet roll, and the
     script refuses the copy and says so).

Capture labels are the serving model's own detections, so the eval measures
agreement with (and regression against) the deployed behavior on live-domain
frames: self-training signal, not ground truth. External --eval-data (a
labeled holdout) can replace the capture split as the judge.

The arguments, the JSON line and the exit codes are the JAX script's, except
that `--device` (default `cuda`) takes the place of `--platform`. The JAX
script forces the CPU by default, so that training does not compete with the
TPU's serving; the port trains and evaluates on the card unless the caller
asks for the CPU (`--device cpu`), and without a CUDA device and without
`--device cpu` it exits with an error.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

# 64 held-out images is the measured comparability floor: 8-image evals
# inverted the shipped-artifact ranking.
EVAL_FLOOR = 64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _split_pairs(pairs, holdout_frac: float):
    """Deterministic stem-hash split. A stem's bucket never changes, so the
    holdout stays clean across repeated runs on a growing capture dir."""
    train, hold = [], []
    cut = int(holdout_frac * 1000)
    for img, lbl in pairs:
        stem = os.path.splitext(os.path.basename(img))[0]
        h = int.from_bytes(hashlib.sha1(stem.encode()).digest()[:4], "big")
        (hold if h % 1000 < cut else train).append((img, lbl))
    return train, hold


def _link_split(pairs, out_root: str) -> str:
    """Materialize a split as a YOLO dir of symlinks (copy fallback)."""
    img_dir = os.path.join(out_root, "images")
    lbl_dir = os.path.join(out_root, "labels")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lbl_dir, exist_ok=True)
    for img, lbl in pairs:
        for src, dst_dir in ((img, img_dir), (lbl, lbl_dir)):
            if src is None:
                continue
            dst = os.path.join(dst_dir, os.path.basename(src))
            if os.path.lexists(dst):
                continue
            try:
                os.symlink(os.path.abspath(src), dst)
            except OSError:
                shutil.copy2(src, dst)
    return out_root


def _eval_artifact(weights: str, data: str, size: int, conf: float,
                   device: str, images: int = 0) -> dict:
    """Run the scorer of record in a subprocess; return its JSON line."""
    cmd = [sys.executable, "-m", "zero_latency_yolo_tpu_torch.eval_artifact",
           "--weights", weights, "--data", data, "--size", str(size),
           "--images", str(images), "--conf", str(conf), "--device", device]
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=ROOT + (os.pathsep + path if path
                                              else ""))
    out = subprocess.run(cmd, capture_output=True, text=True, check=False,
                         env=env)
    if out.returncode != 0:
        raise SystemExit(f"eval failed for {weights}:\n{out.stdout}\n"
                         f"{out.stderr}")
    for line in reversed(out.stdout.strip().splitlines()):
        try:
            return json.loads(line)
        except json.JSONDecodeError:
            continue
    raise SystemExit(f"no JSON line from eval of {weights}:\n{out.stdout}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="capture -> fine-tune -> eval -> promote loop")
    ap.add_argument("--capture-dir", required=True,
                    help="YOLO-convention dir (the server's "
                         "analytics.capture_dir, or any images/+labels/)")
    ap.add_argument("--base", required=True,
                    help="serving artifact (.npz/.pt/.onnx): warm-start + "
                         "distillation teacher + eval baseline")
    ap.add_argument("--out", required=True, help="candidate .npz to write")
    ap.add_argument("--student-variant", default="",
                    help="train THIS variant from scratch, distilled from "
                         "--base (default: fine-tune --base's own variant)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--multiscale", default="",
                    help="comma size ladder for adaptive-resolution serving")
    ap.add_argument("--no-distill", action="store_true",
                    help="same-variant fine-tune without the teacher term")
    ap.add_argument("--holdout-frac", type=float, default=0.2)
    ap.add_argument("--eval-data", default="",
                    help="external labeled eval dir; replaces the capture "
                         "holdout as the judge (holdout images then join "
                         "the training split)")
    ap.add_argument("--eval-conf", type=float, default=0.25)
    ap.add_argument("--allow-small-eval", action="store_true",
                    help=f"waive the {EVAL_FLOOR}-image eval floor (rankings "
                         "below it are measured unreliable)")
    ap.add_argument("--metric", default="mAP",
                    choices=("mAP", "mAP50_95", "recall"),
                    help="gate metric from eval_artifact's output")
    ap.add_argument("--min-gain", type=float, default=0.0,
                    help="candidate must beat base by this much on --metric "
                         "(negative allows a bounded regression, e.g. when "
                         "promoting a cheaper student)")
    ap.add_argument("--promote", default="",
                    help="on pass: atomically copy the candidate here (the "
                         "live server's model_path; its hash watcher "
                         "hot-swaps). Same architecture only.")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the training and the evals "
                         "(default cuda; cpu runs both on the CPU)")
    args = ap.parse_args(argv)

    from .utils.device import require_device
    require_device(args.device, "flywheel")

    from .models.weights import (infer_spec_from_params, load_artifact,
                                 save_params, train_params_to_numpy)
    from .models.yolov8 import fold_batchnorm
    from .train.data import find_pairs
    from .train.loop import train

    t0 = time.perf_counter()
    base_params = load_artifact(args.base)
    base_spec = infer_spec_from_params(base_params)
    student_variant = args.student_variant or base_spec.variant
    cross_variant = student_variant != base_spec.variant
    if cross_variant and args.no_distill:
        ap.error("--student-variant without distillation would train from "
                 "scratch with only self-labels; drop --no-distill")

    pairs = find_pairs(args.capture_dir)
    labeled = [(i, lb) for i, lb in pairs if lb is not None]
    if args.eval_data:
        train_pairs, hold_pairs = labeled, []
    else:
        train_pairs, hold_pairs = _split_pairs(labeled, args.holdout_frac)
        if len(hold_pairs) < EVAL_FLOOR and not args.allow_small_eval:
            raise SystemExit(
                f"holdout has {len(hold_pairs)} images; <{EVAL_FLOOR} is "
                "measured unreliable for ranking. Capture more, raise "
                "--holdout-frac, pass --eval-data, or --allow-small-eval.")
    if len(train_pairs) < args.batch:
        raise SystemExit(f"train split has {len(train_pairs)} images; "
                         f"need at least --batch={args.batch}")

    out_parent = os.path.dirname(os.path.abspath(args.out)) or "."
    # The parent must exist before mkdtemp uses it.
    os.makedirs(out_parent, exist_ok=True)
    work = tempfile.mkdtemp(prefix="flywheel-", dir=out_parent)
    try:
        train_dir = _link_split(train_pairs, os.path.join(work, "train"))
        eval_dir = (args.eval_data or
                    _link_split(hold_pairs, os.path.join(work, "holdout")))

        # Normalize the base to .npz: train()'s init_from/distill_from read
        # native artifacts; .pt/.onnx bases go through load_artifact once.
        base_npz = args.base
        if not args.base.endswith(".npz"):
            base_npz = os.path.join(work, "base.npz")
            save_params(base_params, base_npz)

        what = ("distilling " + student_variant if cross_variant
                else "fine-tuning " + base_spec.variant)
        print(f"[flywheel] {len(train_pairs)} train / "
              f"{len(hold_pairs) or 'external'} eval images; {what} from "
              f"{args.base}", flush=True)

        state = train(
            variant=student_variant, num_classes=base_spec.num_classes,
            size=args.size, batch=args.batch, steps=args.steps, lr=args.lr,
            data=train_dir,
            init_from=None if cross_variant else base_npz,
            distill_from=None if args.no_distill else base_npz,
            multiscale=([int(s) for s in args.multiscale.split(",")]
                        if args.multiscale else None),
            log_every=max(args.steps // 10, 1), device=args.device)
        candidate = fold_batchnorm(train_params_to_numpy(state.params))
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        save_params(candidate, args.out)

        base_m = _eval_artifact(args.base, eval_dir, args.size,
                                args.eval_conf, args.device)
        cand_m = _eval_artifact(args.out, eval_dir, args.size,
                                args.eval_conf, args.device)
        # The comparability floor applies to every ranking source,
        # --eval-data included.
        n_eval = int(cand_m.get("images", 0))
        if n_eval < EVAL_FLOOR and not args.allow_small_eval:
            raise SystemExit(
                f"eval set has {n_eval} images; <{EVAL_FLOOR} is measured "
                "unreliable for ranking. Use a bigger --eval-data or pass "
                "--allow-small-eval.")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    gain = cand_m[args.metric] - base_m[args.metric]
    passed = gain >= args.min_gain
    promoted = False
    note = ""
    if passed and args.promote:
        if cross_variant:
            note = (f"architecture change ({base_spec.variant} -> "
                    f"{student_variant}): the hot-swap watcher rejects it "
                    "by design — roll the fleet instead: point the config "
                    f"at {args.out} and `kill -HUP` serve_fleet")
        else:
            # Atomic same-filesystem swap: write next to the target, rename
            # over it. The serving watcher sees one consistent new hash.
            dst = os.path.abspath(args.promote)
            tmp = dst + ".flywheel.tmp"
            shutil.copy2(args.out, tmp)
            os.replace(tmp, dst)
            promoted = True

    print(json.dumps({
        "base": args.base, "candidate": args.out,
        "variant": student_variant, "mode":
            "distill" if (cross_variant or not args.no_distill) else "finetune",
        "train_images": len(train_pairs),
        "eval": {"data": eval_dir if args.eval_data else "capture-holdout",
                 "images": cand_m["images"],
                 "base": {k: base_m[k] for k in ("mAP", "mAP50_95", "recall")},
                 "candidate": {k: cand_m[k] for k in ("mAP", "mAP50_95",
                                                      "recall")}},
        "metric": args.metric, "gain": round(gain, 4),
        "min_gain": args.min_gain, "passed": passed,
        "promoted": promoted, **({"note": note} if note else {}),
        "total_s": round(time.perf_counter() - t0, 1),
    }))
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
