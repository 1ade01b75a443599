"""Where the k=3 kernel's time goes: variants of `csrc/conv3x3_sm90.cu`
that each drop one part of its work, timed at the k=3 calls of a bf16
serving step. There is no `ncu` on the card's machine; this is how the
kernel's phases are timed instead.

    python -m zero_latency_yolo_tpu_torch.conv3x3_probe [--model yolov8n:416:8]

Variants (each built by nvcc from the source with one part cut out, into
`build/conv3x3_probe/`; the results of a cut variant are wrong by design):

- full: the kernel as it ships;
- no_gather: the producers issue no activation copies (the stages keep
  what they held), the weight tiles still load;
- no_weight: no weight tile loads (the TMA is not issued);
- no_silu: the epilogue adds the bias and stores, no SiLU;
- no_epilogue: no epilogue at all (no bias, SiLU, staging or store);
- no_mma: no activation copies and no wgmma: the ring's barriers, the
  weight loads and the epilogue.

Each call's shapes and tile are the plan's (`ops/conv3x3_cuda.py`), its
inputs seeded; times are CUDA events over 20 launches queued behind a
spin (`utils/bench_util.py` `event_ms`). One JSON line a distinct call
(`count` calls of that shape a step), then the last line: the totals over
the step's calls by variant, with the card's name and power limit.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

# (variant, [(text in csrc/conv3x3_sm90.cu, its replacement), ...]): each
# text must occur exactly once.
_GATHER = """          cp_async16(a_base + swizzle128(row0 + kRowStep * j, chunk), src,
                     ok ? 16u : 0u);"""
_WEIGHT = """          mbar_arrive_expect_tx(&sm.full[s], kBytesB);
          tma_load_2d(sm.b[s], &map_w, &sm.full[s], kt * kBK, n0);"""
_SILU = """          __floats2bfloat162_rn(silu_fast(d[4 * j] + b0),
                                silu_fast(d[4 * j + 1] + b1));"""
_SILU2 = """          __floats2bfloat162_rn(silu_fast(d[4 * j + 2] + b0),
                                silu_fast(d[4 * j + 3] + b1));"""
_EPILOGUE = """    // Epilogue: bias + SiLU in f32, one rounding, staged as bf16 rows."""
_MMA = """        wgmma_bf16<BN>(d, da + 2 * k, db + 2 * k);"""
VARIANTS = {
    "full": [],
    "no_gather": [(_GATHER, "          (void)src;")],
    "no_weight": [(_WEIGHT, "          mbar_arrive(&sm.full[s]);")],
    "no_silu": [(_SILU, """          __floats2bfloat162_rn(d[4 * j] + b0, d[4 * j + 1] + b1);"""),
                (_SILU2, """          __floats2bfloat162_rn(d[4 * j + 2] + b0, d[4 * j + 3] + b1);""")],
    "no_epilogue": [(_EPILOGUE, """    if (d[0] == 12345.0f) out[0] = bias[0];  // keep d live
    continue;
""" + _EPILOGUE)],
    "no_mma": [(_GATHER, "          (void)src;"),
               (_MMA, "        (void)da; (void)db;")],
}


def variant_sources(src: str) -> dict:
    """{variant: the kernel's source with its parts cut}; raises if the
    kernel no longer holds a text this tool cuts."""
    out = {}
    for name, cuts in VARIANTS.items():
        text = src
        for old, new in cuts:
            if text.count(old) != 1:
                raise ValueError(f"conv3x3_probe: {name}: the kernel source "
                                 f"holds {text.count(old)} copies of "
                                 f"{old.strip()[:60]!r}, not 1")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(csrc: Path, out_dir: Path) -> dict:
    """Each variant compiled into its own library (all nvcc started at
    once): {variant: ctypes function zlt_conv3x3_wgmma}."""
    from .ops._build import COMPILE_FLAGS, KernelError, find_nvcc
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    srcs = variant_sources((csrc / "conv3x3_sm90.cu").read_text())
    procs = {}
    for name, text in srcs.items():
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *COMPILE_FLAGS, "-I", str(csrc), "-shared", "-o",
             str(out_dir / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise KernelError(f"conv3x3_probe: nvcc failed on {name}:\n{log}")
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).zlt_conv3x3_wgmma
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def step_calls(torch, variant: str, size: int, batch: int, dev) -> list:
    """The k=3 kernel's calls of one plain bf16 forward of `variant` at
    `size` (seeded weights and input): [(x, w, b, stride)]."""
    from .models import yolov8 as ym
    from .models.weights import params_from_jax, place_params
    spec = ym.get_spec(variant, 4)
    params = place_params(params_from_jax(ym.init_params(0, spec)), dev,
                          torch.bfloat16)
    calls = []
    saved = ym.conv3x3_bias_act_plain

    def rec(x, w, b, stride=1):
        calls.append((x, w, b, stride))
        return saved(x, w, b, stride)
    ym.conv3x3_bias_act_plain = rec
    try:
        g = torch.Generator(device="cpu").manual_seed(0)
        with torch.inference_mode():
            ym.forward_raw(params, spec,
                           torch.rand(batch, size, size, 3, generator=g).to(dev),
                           dtype=torch.bfloat16, plain=True)
    finally:
        ym.conv3x3_bias_act_plain = saved
    return calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=__doc__.split("\n\n", 1)[1])
    ap.add_argument("--model", default="yolov8n:416:8",
                    help="variant:size:batch, comma-separated")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("conv3x3_probe: needs a CUDA device")
    from .ops import conv3x3_cuda
    from .ops._build import check
    from .utils.bench_util import device_label, event_ms
    pkg = Path(__file__).resolve().parent
    fns = build(pkg / "csrc", pkg.parent / "build" / "conv3x3_probe")
    dev = torch.device("cuda")
    totals = {}
    for spec in args.model.split(","):
        variant, size, batch = spec.split(":")
        calls = step_calls(torch, variant, int(size), int(batch), dev)
        shapes = {}
        for x, w, b, stride in calls:
            key = (tuple(x.shape), conv3x3_cuda.pixel_stride(x), w.shape[0],
                   stride)
            shapes.setdefault(key, [x, w, b, stride, 0])[4] += 1
        total = {name: 0.0 for name in fns}
        for (shape, ldx, cout, stride), (x, w, b, _, count) in shapes.items():
            n, h, wd, cin = shape
            plan = conv3x3_cuda.conv3x3_plan(x, w, stride)
            ho, wo = conv3x3_cuda.out_hw(h, wd, stride)
            out = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=dev)
            row = {"model": spec, "shape": list(shape), "ldx": ldx,
                   "cout": cout, "stride": stride, "count": count,
                   "tile": [plan.bm, plan.bn]}
            for name, fn in fns.items():
                def run(fn=fn):
                    check(fn(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                             out.data_ptr(), n, h, wd, cin, ldx, cout,
                             stride, plan.bm, plan.bn, plan.stages, plan.grid,
                             plan.smem,
                             torch.cuda.current_stream().cuda_stream),
                          f"conv3x3_probe {name}")
                ms = event_ms(run)
                row[f"{name}_us"] = round(1e3 * ms, 3)
                total[name] += count * ms
            print(json.dumps(row), flush=True)
        totals[spec] = {name: round(ms, 5) for name, ms in total.items()}
    print(json.dumps({"totals_ms": totals,
                      "device": device_label(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
