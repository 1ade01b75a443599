"""The PyTorch port's 1x1 conv module (ops/conv1x1_cuda.py) against the JAX
package: the Pallas kernel in interpret mode at shapes its lane rule takes,
the JAX stock conv at shapes it refuses, and the port's conv dispatch
(models/yolov8.py `_conv`) against the JAX `_conv`. CPU only (the wrapper
runs its plain version on CPU tensors)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from zero_latency_yolo_tpu.models.yolov8 import _conv as jax_conv  # noqa: E402
from zero_latency_yolo_tpu.ops.conv1x1_pallas import conv1x1_bias_act as jax_mm  # noqa: E402
from zero_latency_yolo_tpu_torch.models.weights import params_from_jax  # noqa: E402
from zero_latency_yolo_tpu_torch.models.yolov8 import _conv as pt_conv  # noqa: E402
from zero_latency_yolo_tpu_torch.ops import conv1x1_cuda  # noqa: E402


def _inputs(shape, cout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(shape[-1], cout)) / np.sqrt(shape[-1])).astype(
        np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    return x, w, b


def _port(x, w, b, act, dtype=torch.float32):
    flat = torch.from_numpy(x.reshape(-1, x.shape[-1])).to(dtype)
    out = conv1x1_cuda.conv1x1_bias_act(flat, torch.from_numpy(w).to(dtype),
                                        torch.from_numpy(b), act=act)
    return out.float().numpy().reshape(x.shape[:-1] + (w.shape[1],))


@pytest.mark.parametrize("shape,cout,act", [
    ((2, 8, 8, 16), 32, True),
    ((1, 8, 8, 64), 128, True),
    ((2, 4, 4, 128), 256, True),
    ((1, 8, 8, 32), 64, False),     # bias-only epilogue (head tips)
])
def test_matches_pallas_kernel_f32(shape, cout, act):
    """f32: the same products summed in another order; 1e-5 as the JAX
    kernel's own test (tests/test_conv1x1_pallas.py:21)."""
    x, w, b = _inputs(shape, cout)
    want = np.asarray(jax_mm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             act=act, interpret=True))
    np.testing.assert_allclose(_port(x, w, b, act), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("act", [True, False])
def test_matches_pallas_kernel_bf16(act):
    """bf16 inputs, f32 accumulation and epilogue, one rounding to bf16 in
    both: the results may differ by the rounding of a differently ordered
    f32 sum, so two bf16 ulps (2**-7 relative)."""
    x, w, b = _inputs((2, 8, 8, 64), 128, seed=1)
    want = np.asarray(jax_mm(jnp.asarray(x, jnp.bfloat16),
                             jnp.asarray(w, jnp.bfloat16), jnp.asarray(b),
                             act=act, interpret=True)).astype(np.float32)
    got = _port(x, w, b, act, dtype=torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-3)


@pytest.mark.parametrize("shape,cout,act", [
    ((1, 13, 13, 16), 32, True),    # M = 169: no power-of-two row block
    ((2, 13, 13, 64), 4, False),    # Cout = 4: the cls tips of the head
    ((1, 26, 26, 48), 32, True),    # Cin = 48 (C2f cv2 of yolov8n's m2)
])
def test_matches_jax_stock_conv_where_pallas_refuses(shape, cout, act):
    """The TPU kernel returns None here; the port's kernel takes every shape.
    Against the JAX package's stock f32 conv, 1e-5."""
    x, w, b = _inputs(shape, cout, seed=2)
    assert jax_mm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                  interpret=True) is None
    want = np.asarray(jax_conv({"w": jnp.asarray(w[None, None]),
                                "b": jnp.asarray(b)}, jnp.asarray(x), act=act))
    np.testing.assert_allclose(_port(x, w, b, act), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("k,stride,act", [(1, 1, True), (1, 1, False),
                                          (3, 1, True), (3, 2, True)])
def test_conv_dispatch_matches_jax_conv(k, stride, act):
    """The port's per-shape dispatch (1x1 -> matmul kernel; others ->
    F.conv2d + bias/SiLU kernel) against the JAX `_conv`, f32, 1e-5."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (2, 12, 12, 24)).astype(np.float32)
    node = {"w": (rng.normal(size=(k, k, 24, 40)) / np.sqrt(24 * k * k))
            .astype(np.float32),
            "b": rng.normal(size=(40,)).astype(np.float32)}
    want = np.asarray(jax_conv(jax.tree.map(jnp.asarray, node), jnp.asarray(x),
                               stride=stride, act=act))
    got = pt_conv(params_from_jax({"c": node})["c"], torch.from_numpy(x),
                  stride=stride, act=act).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_refuses_other_devices_and_bad_inputs():
    x = torch.zeros(8, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv1x1_cuda.conv1x1_bias_act(x, torch.zeros(4, 2, device="meta"),
                                      torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="1x1 conv blocks run at stride 1"):
        pt_conv({"w_mm": torch.zeros(4, 2), "b": torch.zeros(2)},
                torch.zeros(1, 4, 4, 4), stride=2)
