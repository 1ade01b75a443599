"""The floored-split serving cycle on one device: one batch cycle that
dispatches a small floored group at its rung plus the rest at the
downshifted rung, against the unsplit cycle at one rung.

    python -m zero_latency_yolo_tpu_torch.floor_split_bench [--device cuda]
    ZLT_BENCH_SMOKE=1 python -m zero_latency_yolo_tpu_torch.floor_split_bench \\
        --device cpu                                   # CPU mechanics

A capacity estimate that adds the two rungs' ladder steps (the dispatch
lane is serial) assumes what this measures: each cycle's groups go through
the cached serving step (`InferenceEngine.get_step_cached(b, bucket,
size)`) back to back, the last output read back, timed by the pipeline
method (`utils/bench_util.py`, 6 and 24 cycles). yolov8n at 416 with the
320 rung, bf16, top-K 128, over 600x800 frames: the unsplit b64@320, the
splits b2@416+b62@320, b4@416+b60@320, b8@416+b56@320, and b8@416 and
b64@416 alone.

Prints one JSON object, the JAX package's `scripts/floor_split_bench.py`
keys (`rows` of {cycle, ms, rtt_ms}, `variant`, `size`, `rung`, `device`:
the card's name and power limit). A cycle that fails is printed FAILED
and the tool exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys
from types import SimpleNamespace

import numpy as np

from .utils.device import require_device


def setup(smoke: bool, dtype: str, device) -> SimpleNamespace:
    """The engine and the cycles of the JAX script's shapes: engine,
    cycles, bucket, hw (the frames' height and width), variant, size,
    rung, config (the engine's config dict)."""
    from .config import ServerConfig
    from .runtime.engine import InferenceEngine
    from .utils.bench_util import seeded_params, serving_config_dict
    variant = "yolov8p" if smoke else "yolov8n"
    size = 64 if smoke else 416
    rung = 32 if smoke else 320
    bucket = (96, 96) if smoke else (608, 800)
    hw = (64, 96) if smoke else (600, 800)
    batches = [1, 2] if smoke else [2, 4, 8, 56, 60, 62, 64]
    cfg = serving_config_dict(variant, size, batches, bucket, dtype=dtype,
                              topk=64 if smoke else 128,
                              serve_sizes=[size, rung])
    engine = InferenceEngine(ServerConfig.from_dict(cfg),
                             params=seeded_params(variant), device=device)
    cycles = ([[(1, rung)], [(1, size), (1, rung)]] if smoke else [
        [(64, rung)],                      # unsplit full load at the rung
        [(2, size), (62, rung)],           # 2 floored
        [(4, size), (60, rung)],
        [(8, size), (56, rung)],
        [(8, size)], [(64, size)],         # single-group reference points
    ])
    return SimpleNamespace(engine=engine, cycles=cycles, bucket=bucket,
                           hw=hw, variant=variant, size=size, rung=rung,
                           config=cfg)


def cycle_runner(engine, pairs, bucket, hw, frames):
    """run_once() of one cycle: each (batch, size) group's cached step
    dispatched back to back over one frame cache, the last output
    returned (what the batcher's complete-previous policy reads)."""
    import torch
    cache = torch.from_numpy(np.ascontiguousarray(frames)).to(engine.device)
    cap = len(frames)

    def shw_for(b):
        return torch.from_numpy(np.stack([
            np.arange(b, dtype=np.int32) % cap,
            np.full((b,), hw[0], np.int32),
            np.full((b,), hw[1], np.int32)])).to(engine.device)

    steps = [(engine.get_step_cached(b, bucket, sz), shw_for(b))
             for b, sz in pairs]
    p, cw = engine._params, engine._class_weights
    conf = engine.config.confidence_threshold
    iou = engine.config.nms_threshold

    def run_once():
        out = None
        for step, shw in steps:
            out = step(p, cache, shw, cw, conf, iou)
        return out
    return run_once


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=__doc__.split("\n\n", 1)[1])
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    require_device(args.device, "floor_split_bench")

    from .utils.bench_util import (Sweep, device_label, pipeline_kw,
                                   pipeline_step_seconds, smoke)
    su = setup(smoke(), args.dtype, args.device)
    engine, bucket, hw = su.engine, su.bucket, su.hw
    cap = max(b for pairs in su.cycles for b, _ in pairs)
    frames = np.random.default_rng(0).integers(
        0, 256, (cap,) + tuple(bucket) + (3,), dtype=np.uint8)
    lengths = pipeline_kw() or dict(n1=6, n2=24)
    sweep = Sweep()
    rows = []

    def one(pairs, label):
        step_s, rtt_s = pipeline_step_seconds(
            cycle_runner(engine, pairs, bucket, hw, frames), **lengths)
        rows.append({"cycle": label, "ms": round(step_s * 1e3, 3),
                     "rtt_ms": round(rtt_s * 1e3, 1)})
        print(f"# {label}: {step_s * 1e3:.3f} ms", file=sys.stderr, flush=True)

    for pairs in su.cycles:
        label = "+".join(f"b{b}@{sz}" for b, sz in pairs)
        sweep.row(label, lambda p=pairs, lb=label: one(p, lb))
    print(json.dumps({"rows": rows, "variant": su.variant, "size": su.size,
                      "rung": su.rung, "dtype": args.dtype,
                      "device": device_label(engine.device)}), flush=True)
    return sweep.exit_code()


if __name__ == "__main__":
    sys.exit(main())
