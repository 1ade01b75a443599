"""The harness without its look for a chip, driven on the CPU at a small
size: a sound run comes out correct, and with the timed path broken
underneath it comes out not correct, once for each fault a serving cell
can have (its state left unchanged, half of a batch served another
stream's frames, half of each batch's results left empty, suppression
skipped, an answer altered where it is produced)."""

import time

import pytest
import torch

from portbench import run
from portbench.faults import FAULTS

SEED = 2**31 + 4242


def small_run(plant=None):
    bench = run.load_json(run.REPO / "BENCHMARK.json")
    cell = run.find_cell(bench, "n416-knee80")
    cfg = run.load_json(run.ROOT / "configs" / "yolov8n-416.json")
    # f32 on the CPU, where bf16 convs are slow; batches of up to 4.
    cfg["server"]["tpu"].update(dtype="float32", batch_buckets=[1, 2, 4],
                                batch_window_ms=40.0)
    mix = run.load_mix("n416-knee80", run.ROOT)
    mix.update(streams=4, fps=15, ramp_s=0.5, pool_groups=2, sample=24)
    out = run.run_cell(bench, cell, SEED, 2.5, False, device="cpu",
                       plant=plant, cfg=cfg, mix=mix,
                       t_start=time.perf_counter())
    return out["result"]


def test_a_sound_run_is_correct():
    res = small_run()
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0
    assert set(res["metrics"]) == {"setup_s", "served_fps"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    torch.manual_seed(0)
    res = small_run(lambda e, c, b: FAULTS[fault](e, c, b, monkeypatch))
    assert not res["correct"], res["checks"]
