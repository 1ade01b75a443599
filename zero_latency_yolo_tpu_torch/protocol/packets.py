"""The `Detection` record of the ZLTY protocol (a copy of the JAX package's
`protocol/packets.py` dataclass; the wire codec is not ported yet)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Detection:
    """One detection result (reference src/common/types.h:20-26).

    Box is center-format (x, y = center) normalized to [0, 1] of the *source
    frame* dimensions, mirroring the reference postprocess
    (src/inference/onnx_engine.cpp:802-805).
    """
    x: float = 0.0
    y: float = 0.0
    width: float = 0.0
    height: float = 0.0
    confidence: float = 0.0
    class_id: int = 0
    track_id: int = 0
    timestamp: int = 0
