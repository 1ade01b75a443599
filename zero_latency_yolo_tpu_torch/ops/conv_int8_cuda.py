"""int8 convolution of the quantized backbone: CUDA kernel, plain PyTorch
version, launch count.

A port-side kernel. The JAX package has no Pallas kernel here: its `_conv`
(`models/yolov8.py`, the "w_q" branch) quantizes the activation per tensor,
runs `lax.conv_general_dilated` over int8 with int32 accumulation in XLA and
dequantizes into an f32 bias + SiLU tail. PyTorch has no int8 convolution on
CUDA (`F.conv2d` refuses int8; `torch._int_mm` is a 2-D product that would
need a 9x im2col copy for the k=3 convs), so the port writes it:

    q   = clip(rint(x / x_scale), -127, 127)            per-tensor, half to even
    acc = conv(q, w_q)                                  int8 x int8 -> int32
    z   = float(acc) * (x_scale * w_scale) + b         f32
    y   = z * sigmoid(z)                                 SiLU, then x's type

for k in {1, 3}, stride in {1, 2}, padding (k - 1) // 2, NHWC. The kernel
(`csrc/conv_int8_sm90.cu`) fuses the quantize into its load and the tail
into its epilogue, on the int8 tensor cores (`mma.sync` m16n8k32).
`x_scale` is a device scalar, calibrated or computed on the device
(`dynamic_scale`), never read back to the host.

The weight is laid out once (`pack_weight`, from `models/weights.py`
`place_params`) as a (Cout, Kp) int8 matrix, K-major in (ky, kx, cin)
order, K = k*k*Cin zero-padded to Kp, a multiple of the MMA's K step.

The plain version computes the conv in float64 on the int8 values and
rounds to int32: exact, since |acc| <= 127 * 127 * K < 2**31 < 2**53 for
every K of the model family (yolov8n's largest is 9 * 256), so every
summation order gives the same integers. Its tail is the kernel's f32
arithmetic in the same order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check, kernels

K_STEP = 32  # mma.sync m16n8k32: int8 K a step

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset (the count a run reads to show that
# the main path went through the kernel).
launches = 0


def padded_k(k: int, cin: int) -> int:
    """K = k*k*cin rounded up to the MMA's K step."""
    return -(-k * k * cin // K_STEP) * K_STEP


def pack_weight(w_q: torch.Tensor) -> torch.Tensor:
    """(Cout, k, k, Cin) int8 -> the kernel's (Cout, Kp) int8 matrix,
    K-major in (ky, kx, cin) order (the order of an NHWC patch), K padded
    with zero weights."""
    cout, k, _, cin = w_q.shape
    flat = w_q.reshape(cout, k * k * cin)
    return F.pad(flat, (0, padded_k(k, cin) - flat.shape[1])).contiguous()


def unpack_weight(w: torch.Tensor, k: int, cin: int) -> torch.Tensor:
    """The kernel's (Cout, Kp) matrix back to an OIHW (Cout, Cin, k, k)
    int8 kernel."""
    return w[:, :k * k * cin].reshape(w.shape[0], k, k, cin).permute(0, 3, 1, 2)


def dynamic_scale(x: torch.Tensor) -> torch.Tensor:
    """The per-tensor activation scale max(|x|) / 127 (floor 1e-8 on the
    max), as an f32 scalar on x's device: no host sync."""
    return torch.clamp(x.abs().amax().float(), min=1e-8) / 127.0


def quantize_activations(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """clip(round(x / x_scale), -127, 127) in f32 (round half to even, as
    jnp.round)."""
    return torch.clamp(torch.round(x.float() / x_scale), -127, 127)


def conv_int8_acc_plain(x: torch.Tensor, x_scale: torch.Tensor,
                        w: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Plain version of the accumulators: (B, Ho, Wo, Cout) int32, the conv
    over the quantized values in float64 (exact), rounded."""
    q = quantize_activations(x, x_scale).double()
    wt = unpack_weight(w, k, x.shape[-1]).double()
    acc = F.conv2d(q.permute(0, 3, 1, 2), wt, stride=stride,
                   padding=(k - 1) // 2)
    return torch.round(acc).to(torch.int32).permute(0, 2, 3, 1).contiguous()


def conv_int8_plain(x: torch.Tensor, x_scale: torch.Tensor, w: torch.Tensor,
                    w_scale: torch.Tensor, b: torch.Tensor, k: int,
                    stride: int, act: bool = True) -> torch.Tensor:
    """Plain PyTorch version: the exact accumulators, then
    z = float(acc) * (x_scale * w_scale) + b and z * sigmoid(z) (SiLU as
    jax.nn.silu writes it) in f32, stored in x's type."""
    acc = conv_int8_acc_plain(x, x_scale, w, k, stride)
    y = acc.float() * (x_scale.float() * w_scale) + b
    if act:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def _launch(x, x_scale, w, w_scale, b, k, stride, act, raw):
    if x.dtype not in _DTYPES or w.dtype != torch.int8:
        raise ValueError(f"conv_int8: dtypes x={x.dtype} w={w.dtype} (want x "
                         "f32 or bf16, w int8)")
    if x.dim() != 4 or w.dim() != 2 or k not in (1, 3) or stride not in (1, 2):
        raise ValueError(f"conv_int8: x {tuple(x.shape)} w {tuple(w.shape)} "
                         f"k {k} stride {stride} (want NHWC x, 2-D w, k 1 or "
                         "3, stride 1 or 2)")
    n, h, wd, cin = x.shape
    cout, kpad = w.shape
    if kpad != padded_k(k, cin):
        raise ValueError(f"conv_int8: w has K {kpad}, want {padded_k(k, cin)} "
                         f"for k {k} and Cin {cin} (pack_weight)")
    for name, t in (("w_scale", w_scale), ("b", b)):
        if t.dtype != torch.float32 or t.shape != (cout,) or not t.is_contiguous():
            raise ValueError(f"conv_int8: {name} must be contiguous f32 "
                             f"({cout},), got {t.dtype} {tuple(t.shape)}")
    if x_scale.dtype != torch.float32 or x_scale.numel() != 1:
        raise ValueError("conv_int8: x_scale must be one f32 value")
    if any(t.device != x.device for t in (x_scale, w, w_scale, b)):
        raise ValueError("conv_int8: inputs on different devices")
    if not w.is_contiguous():
        raise ValueError("conv_int8: w must be contiguous")
    # A channel slice of a wider NHWC tensor (C2f's y[..., c:]) is read in
    # place through its pixel stride; any other layout is copied.
    ldx = x.stride(2)
    if not (x.stride(3) == 1 and x.stride(1) == wd * ldx
            and x.stride(0) == h * wd * ldx and ldx >= cin):
        x = x.contiguous()
        ldx = cin
    pad = (k - 1) // 2
    ho = (h + 2 * pad - k) // stride + 1
    wo = (wd + 2 * pad - k) // stride + 1
    if max(n * h * wd * ldx, n * ho * wo * cout) >= 2 ** 31:
        raise ValueError("conv_int8: tensor exceeds 32-bit indexing")
    vec = cin % 8 == 0 and ldx % 8 == 0 and x.data_ptr() % 16 == 0
    out = torch.empty((n, ho, wo, cout), device=x.device,
                      dtype=torch.int32 if raw else x.dtype)
    index = x.get_device()
    lib = kernels().lib
    with torch.cuda.device(index):
        err = lib.zlt_conv_int8(
            x.data_ptr(), x_scale.data_ptr(), w.data_ptr(), w_scale.data_ptr(),
            b.data_ptr(), out.data_ptr(), out.data_ptr() if raw else None,
            n, h, wd, cin, ldx, ho, wo, cout, k, stride, kpad,
            _DTYPES[x.dtype], int(act), int(vec),
            torch.cuda.current_stream(index).cuda_stream)
    check(err, "conv_int8")
    global launches
    launches += 1
    return out


def conv_int8(x: torch.Tensor, x_scale: torch.Tensor, w: torch.Tensor,
              w_scale: torch.Tensor, b: torch.Tensor, k: int, stride: int,
              act: bool = True) -> torch.Tensor:
    """silu(conv_int8(quant(x), w) * (x_scale * w_scale) + b) over NHWC x
    (f32 or bf16), with x_scale an f32 scalar tensor, w the packed (Cout,
    Kp) int8 weight, w_scale and b f32 (Cout,). Returns (B, Ho, Wo, Cout)
    in x's type. A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return conv_int8_plain(x, x_scale, w, w_scale, b, k, stride, act)
        raise ValueError(f"conv_int8: unsupported device {x.device}")
    return _launch(x, x_scale, w, w_scale, b, k, stride, act, raw=False)


def conv_int8_acc(x: torch.Tensor, x_scale: torch.Tensor, w: torch.Tensor,
                  k: int, stride: int) -> torch.Tensor:
    """The kernel's int32 accumulators (B, Ho, Wo, Cout), for checking them
    against `conv_int8_acc_plain`; a CPU tensor runs the plain version."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return conv_int8_acc_plain(x, x_scale, w, k, stride)
        raise ValueError(f"conv_int8_acc: unsupported device {x.device}")
    cout = w.shape[0]
    dummy = torch.zeros(cout, dtype=torch.float32, device=x.device)
    return _launch(x, x_scale, w, dummy, dummy, k, stride, False, raw=True)
