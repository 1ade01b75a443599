"""The PyTorch port's NMS module (ops/nms_cuda.py, ops/nms.py) against the
JAX package: the keep mask from boxes, and the suppression scan inside it,
against the JAX IoU matrix and the Pallas kernel in interpret mode, and the
whole postprocess + pack against the JAX postprocess on the same decoded
predictions. CPU only (the wrappers run their plain versions on CPU
tensors)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch_nms_cases  # noqa: E402

from zero_latency_yolo_tpu.ops import nms as jax_nms  # noqa: E402
from zero_latency_yolo_tpu.ops.nms_pallas import greedy_nms_mask_pallas  # noqa: E402
from zero_latency_yolo_tpu_torch.ops import nms as pt_nms  # noqa: E402
from zero_latency_yolo_tpu_torch.ops import nms_cuda  # noqa: E402

WEIGHTS = np.array([1.0, 1.0, 1.2, 0.8], np.float32)


def _scan_case(seed, k, b=2):
    """The inputs of tests/test_nms_pallas.py:14-31, with the JAX IoU."""
    rng = np.random.default_rng(seed)
    boxes = rng.uniform(0, 416, (b, k, 4)).astype(np.float32)
    boxes[..., 2:] = rng.uniform(20, 200, (b, k, 2))
    classes = rng.integers(0, 4, (b, k))
    valid = rng.uniform(size=(b, k)) > 0.3
    iou = np.stack([np.asarray(jax_nms._iou_matrix_center(jnp.asarray(x)))
                    for x in boxes])
    same = classes[:, :, None] == classes[:, None, :]
    return boxes, classes.astype(np.int32), iou, same, valid


def _pallas_keep(iou, same, valid):
    return np.asarray(greedy_nms_mask_pallas(
        jnp.asarray(iou), jnp.asarray(same), jnp.asarray(valid), 0.45,
        interpret=True))


@pytest.mark.parametrize("seed,k", [(0, 64), (1, 128), (2, 256)])
def test_scan_matches_pallas_kernel(seed, k):
    """Exact: the keep masks are equal, for the scan on the JAX IoU and for
    the wrapper from the boxes (which takes the plain version for CPU
    tensors)."""
    boxes, classes, iou, same, valid = _scan_case(seed, k)
    want = _pallas_keep(iou, same, valid)
    args = (torch.from_numpy(iou), torch.from_numpy(same),
            torch.from_numpy(valid), 0.45)
    np.testing.assert_array_equal(
        nms_cuda.greedy_nms_mask_plain(*args).numpy(), want)
    np.testing.assert_array_equal(nms_cuda.nms_keep(
        torch.from_numpy(boxes), torch.from_numpy(classes),
        torch.from_numpy(valid), 0.45).numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [1, 37, 84, 256])
def test_nms_keep_plain_matches_jax(seed, k):
    """nms_keep_plain from boxes, classes and valid flags against the JAX
    IoU matrix, same-class mask and Pallas scan (interpret mode): exact."""
    boxes, classes, valid = torch_nms_cases.seeded(100 + seed, 2, k)
    iou = np.stack([np.asarray(jax_nms._iou_matrix_center(jnp.asarray(x)))
                    for x in boxes])
    want = _pallas_keep(iou, classes[:, :, None] == classes[:, None, :], valid)
    got = nms_cuda.nms_keep_plain(torch.from_numpy(boxes),
                                  torch.from_numpy(classes),
                                  torch.from_numpy(valid), 0.45).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0 or not valid.any()


@pytest.mark.parametrize("seed,k", [(3, 64), (4, 256)])
def test_iou_matrix_matches_jax(seed, k):
    """Same f32 formula, same order of operations: 1 ulp at most."""
    boxes, _, want, _, _ = _scan_case(seed, k)
    got = pt_nms._iou_matrix_center(torch.from_numpy(boxes)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _pred(seed, a=400, b=2, ties=False):
    rng = np.random.default_rng(seed)
    boxes = np.stack([rng.uniform(0, 416, (b, a)), rng.uniform(0, 416, (b, a)),
                      rng.uniform(8, 150, (b, a)), rng.uniform(8, 150, (b, a))],
                     axis=-1)
    probs = rng.uniform(0, 1, (b, a, 4)) ** 3
    if ties:
        # Many exactly equal scores: the candidate order among them must be
        # the lower anchor index first, as lax.top_k orders them.
        probs = np.round(probs * 8) / 8
    return np.concatenate([boxes, probs], -1).astype(np.float32)


def _jax_packed(pred, nms_impl, topk=256):
    b = pred.shape[0]
    out = jax_nms.postprocess_batch(
        jnp.asarray(pred), jnp.asarray(WEIGHTS), jnp.float32(0.5),
        jnp.float32(0.45), jnp.asarray(np.linspace(0.5, 1.0, b), jnp.float32),
        jnp.asarray(np.tile([[3.0, 7.0]], (b, 1)), jnp.float32),
        jnp.asarray(np.tile([[800.0, 600.0]], (b, 1)), jnp.float32),
        topk, nms_impl)
    return np.asarray(jax_nms.pack_outputs(out))


def _port_packed(pred, topk=256):
    b = pred.shape[0]
    out = pt_nms.postprocess_batch(
        torch.from_numpy(pred), torch.from_numpy(WEIGHTS), 0.5, 0.45,
        torch.from_numpy(np.linspace(0.5, 1.0, b).astype(np.float32)),
        torch.from_numpy(np.tile([[3.0, 7.0]], (b, 1)).astype(np.float32)),
        torch.from_numpy(np.tile([[800.0, 600.0]], (b, 1)).astype(np.float32)),
        topk)
    return pt_nms.pack_outputs(out).numpy()


@pytest.mark.parametrize("seed,ties,topk,nms_impl", [
    (3, False, 256, "pallas_interpret"),
    (5, True, 256, "pallas_interpret"),
    (6, False, 64, "xla"),
    (7, True, 16, "xla"),   # topk < MAX_DET: compaction pads
])
def test_postprocess_and_pack_match_jax(seed, ties, topk, nms_impl):
    """Same pred -> same packed array: counts and classes equal, boxes and
    scores within f32 rounding of the same formulas."""
    pred = _pred(seed, ties=ties)
    want = _jax_packed(pred, nms_impl, topk)
    got = _port_packed(pred, topk)
    assert got.shape == want.shape == (2, 1 + 6 * pt_nms.MAX_DET)
    gu, wu = pt_nms.unpack_outputs(got), jax_nms.unpack_outputs(want)
    assert wu["count"].min() > 0, "vacuous: nothing kept"
    np.testing.assert_array_equal(gu["count"], wu["count"])
    np.testing.assert_array_equal(gu["classes"], wu["classes"])
    np.testing.assert_allclose(gu["boxes"], wu["boxes"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(gu["scores"], wu["scores"], rtol=1e-6, atol=1e-7)


def test_postprocess_matches_numpy_oracle():
    """The case of tests/test_nms_pallas.py:34 against nms_reference."""
    pred = _pred(3, b=1)
    out = pt_nms.postprocess_batch(
        torch.from_numpy(pred), torch.from_numpy(WEIGHTS), 0.5, 0.45,
        torch.ones(1), torch.zeros(1, 2), torch.tensor([[416.0, 416.0]]), 256)
    ref = pt_nms.nms_reference(pred[0], WEIGHTS, 0.5, 0.45)
    n = int(out["count"][0])
    assert n == min(len(ref), pt_nms.MAX_DET)
    for i in range(n):
        assert int(out["classes"][0, i]) == ref[i][2]
        assert float(out["scores"][0, i]) == pytest.approx(ref[i][1], abs=1e-5)


def test_scan_refuses_other_devices():
    """A tensor neither on CPU nor on CUDA is refused, not computed."""
    boxes = torch.zeros(1, 4, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        nms_cuda.nms_keep(boxes, torch.zeros(1, 4, dtype=torch.int32,
                                             device="meta"),
                          torch.zeros(1, 4, dtype=torch.bool, device="meta"),
                          0.5)
