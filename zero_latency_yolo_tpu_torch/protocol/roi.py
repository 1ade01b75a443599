"""ROIIMG region-update header used inside FRAME_DATA payloads.

The reference client prefixes JPEG-compressed changed-region updates with a
16-byte header (reference src/client/screen_capture.cpp:505-514):

    bytes 0-5   "ROIIMG"
    u16 x, y            region origin in the full frame
    u16 width, height   region size
    u16 full_width      full frame width

The reference *server* never implemented the decode path (SURVEY §2.9 item 8);
the JAX package decodes the JPEG region on host and pastes it into the
per-client keyframe cache on device (its ops/roi.py, not ported yet: the
PyTorch server drops ROI updates).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional

ROI_MAGIC = b"ROIIMG"
ROI_HEADER_SIZE = 16
_ROI = struct.Struct("<6s5H")


@dataclass
class RoiHeader:
    x: int
    y: int
    width: int
    height: int
    full_width: int


def parse_roi_header(payload: bytes) -> Optional[RoiHeader]:
    """Return the ROI header if payload is a ROIIMG region update, else None."""
    if len(payload) < ROI_HEADER_SIZE or payload[:6] != ROI_MAGIC:
        return None
    _, x, y, w, h, fw = _ROI.unpack_from(payload)
    return RoiHeader(x=x, y=y, width=w, height=h, full_width=fw)


def build_roi_header(x: int, y: int, width: int, height: int, full_width: int) -> bytes:
    return _ROI.pack(ROI_MAGIC, x, y, width, height, full_width)
