"""PyTorch / CUDA port of zero_latency_yolo_tpu for NVIDIA Hopper (H100).

The JAX package `zero_latency_yolo_tpu` stays the reference; this package
imports nothing of it and nothing of JAX. Its serving step runs the same
function: letterbox -> YOLOv8 -> DFL decode -> class-weighted greedy NMS ->
one packed (B, 1 + 6 * 32) f32 array. The three TPU kernels of that path
are hand-written CUDA kernels here (`csrc/kernels.cu`, bound by `ops/_build.py`).

Entry points run on `cuda` unless the caller passes `device="cpu"`; on CPU
tensors every kernel wrapper runs its plain PyTorch version instead.
"""
