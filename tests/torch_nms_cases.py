"""NMS inputs shared by the port's CPU and card tests (imports neither JAX
nor the JAX package): seeded candidates, and the edge cases of the NMS
kernel (csrc/nms_sm90.cu). Each case is (boxes (B, K, 4) f32 center format,
classes (B, K) int32, valid (B, K) bool) as NumPy arrays, score-sorted by
construction (the rank is the index)."""

import numpy as np

THRESH = 0.45

# Two boxes of one class whose f32 IoU, computed as ops/nms_cuda.py
# _iou_matrix_center computes it, is exactly np.float32(THRESH): found by a
# grid search; the tests check the equality, so the pair stays one.
AT_THRESHOLD = ((64.0, 64.0, 16.0, 16.0), (59.875, 64.0, 8.0, 18.75))


def seeded(seed: int, b: int, k: int, valid_frac: float = 0.7,
           classes: int = 4):
    """Random boxes on a 416 px field, sides 20..200 px (as
    tests/test_nms_pallas.py makes them), `valid_frac` of them valid."""
    rng = np.random.default_rng(seed)
    boxes = rng.uniform(0, 416, (b, k, 4)).astype(np.float32)
    boxes[..., 2:] = rng.uniform(20, 200, (b, k, 2))
    cls = rng.integers(0, classes, (b, k)).astype(np.int32)
    valid = rng.uniform(size=(b, k)) < valid_frac
    return boxes, cls, valid


def edge_cases():
    """{name: (boxes, classes, valid)} for the decisions most likely to go
    wrong in the kernel."""
    cases = {}
    # Exactly at the threshold: not above it, so both are kept; in frame 1
    # the second box moves a little closer and is suppressed.
    at = np.array([AT_THRESHOLD, AT_THRESHOLD], np.float32)
    at[1, 1, 0] += 0.25
    cases["at_threshold"] = (at, np.zeros((2, 2), np.int32),
                             np.ones((2, 2), bool))
    # Every candidate invalid; and one class everywhere, heavily overlapped.
    boxes, cls, _ = seeded(11, 3, 84)
    cases["all_invalid"] = (boxes, cls, np.zeros((3, 84), bool))
    boxes, _, valid = seeded(12, 2, 256, valid_frac=0.9)
    cases["single_class"] = (boxes, np.zeros((2, 256), np.int32), valid)
    # K not a multiple of 32, every candidate valid: the last word's bits
    # past K must stay clear.
    boxes, cls, _ = seeded(13, 2, 45, classes=2)
    cases["ragged_all_valid"] = (boxes, cls, np.ones((2, 45), bool))
    # Non-finite and degenerate boxes: NaN in each coordinate, an infinite
    # side, zero and negative sides. torch.maximum / minimum / clamp
    # propagate NaN, so a NaN box suppresses nothing and is suppressed by
    # nothing; an infinite box's IoUs are NaN or 0.
    boxes, _, valid = seeded(14, 1, 40, valid_frac=1.0)
    boxes[0, :, :2] = 200.0  # every box over one point
    boxes[0, 1, 0] = np.nan
    boxes[0, 3, 1] = np.nan
    boxes[0, 5, 2] = np.nan
    boxes[0, 7, 3] = np.nan
    boxes[0, 9, 2] = np.inf
    boxes[0, 11, 3] = -5.0
    boxes[0, 13, 2] = 0.0
    cases["non_finite"] = (boxes, np.zeros((1, 40), np.int32), valid)
    return cases
