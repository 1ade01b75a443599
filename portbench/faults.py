"""Faults planted under a run's timed path, to show that `correct` comes
out false: the CPU test (`portbench/tests/test_portbench_faults.py`) plants each at a
small size, and `readings.py --faults` reads them on the card at a cell's
own size. Each takes the engine, cache and batcher of the run and an
object whose `setattr(obj, name, value)` installs the fault (pytest's
`monkeypatch`, or `Patch`, which `undo` takes back out)."""

from __future__ import annotations

from zero_latency_yolo_tpu_torch.ops import nms, roi


class Patch:
    """setattr that remembers what it replaced."""

    def __init__(self) -> None:
        self._saved = []

    def setattr(self, obj, name, value) -> None:
        self._saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self) -> None:
        while self._saved:
            obj, name, value = self._saved.pop()
            setattr(obj, name, value)


def state_unchanged(engine, cache, batcher, patch):
    # The cache's flush leaves every slot as it was: no region lands.
    patch.setattr(roi, "_paste_many", lambda *a, **k: None)


def half_batch(engine, cache, batcher, patch):
    # The second half of each batch's rows gathers the first half's frames.
    orig = engine.gather_from_cache

    def gather(c, slots, heights, widths):
        slots = slots.copy()
        half = len(slots) // 2
        slots[len(slots) - half:] = slots[:half]
        return orig(c, slots, heights, widths)
    patch.setattr(engine, "gather_from_cache", gather)


def half_results_empty(engine, cache, batcher, patch):
    # The second half of each batch's results comes back with no detections.
    orig = engine.complete_many

    def complete_many(pendings):
        out = orig(pendings)
        for results in out:
            for r in results[len(results) - len(results) // 2:]:
                r.detections = []
        return out
    patch.setattr(engine, "complete_many", complete_many)


def nms_skipped(engine, cache, batcher, patch):
    # Greedy suppression keeps every candidate over the threshold.
    def keep_all(boxes, classes, valid, iou_thresh):
        return valid.clone()
    patch.setattr(nms, "nms_keep", keep_all)
    patch.setattr(nms, "nms_keep_plain", keep_all)


def answer_altered(engine, cache, batcher, patch):
    # Each result's first detection moves a tenth of the frame.
    orig = engine.complete_many

    def complete_many(pendings):
        out = orig(pendings)
        for results in out:
            for r in results:
                if r.detections:
                    r.detections[0].x = (r.detections[0].x + 0.1) % 1.0
        return out
    patch.setattr(engine, "complete_many", complete_many)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "half_results_empty": half_results_empty,
          "nms_skipped": nms_skipped, "answer_altered": answer_altered}
