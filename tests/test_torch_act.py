"""The PyTorch port's bias+SiLU module (ops/act_cuda.py) against the JAX
package's Pallas kernel in interpret mode. CPU only (the wrapper runs its
plain version on CPU tensors)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from zero_latency_yolo_tpu.ops.act_pallas import fused_bias_silu  # noqa: E402
from zero_latency_yolo_tpu_torch.ops import act_cuda  # noqa: E402


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32) * 3,
            rng.normal(size=(shape[-1],)).astype(np.float32))


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (1, 4, 4, 64),
                                   (2, 2, 2, 128), (1, 2, 2, 256),
                                   (1, 3, 5, 24)])
def test_matches_pallas_kernel_f32(shape):
    """f32: the same elementwise formula; 1e-6 as the JAX kernel's own test
    (tests/test_act_pallas.py:20)."""
    y, b = _inputs(shape)
    want = np.asarray(fused_bias_silu(jnp.asarray(y), jnp.asarray(b),
                                      interpret=True))
    got = act_cuda.bias_silu(torch.from_numpy(y), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_matches_pallas_kernel_bf16():
    """bf16 storage, f32 math, one rounding. The TPU kernel rounds the bias
    to bf16 before the add and the port keeps it f32, so results may differ
    by that rounding passed through SiLU: two bf16 ulps (2**-7 relative)."""
    y, b = _inputs((2, 8, 8, 32), seed=1)
    want = np.asarray(fused_bias_silu(jnp.asarray(y, jnp.bfloat16),
                                      jnp.asarray(b), interpret=True)
                      ).astype(np.float32)
    got = act_cuda.bias_silu(torch.from_numpy(y).to(torch.bfloat16),
                             torch.from_numpy(b)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=2.0 ** -7)


def test_refuses_other_devices():
    y = torch.zeros(2, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        act_cuda.bias_silu(y, torch.zeros(4, device="meta"))
