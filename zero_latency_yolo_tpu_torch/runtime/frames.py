"""FRAME_DATA payload decoding: raw RGB, JPEG keyframes, ROIIMG region updates.

The reference server rejected everything but raw w*h*3
(src/network/network_server.cpp:191-197) while its client sent JPEG/ROI
(SURVEY §2.9 item 8); this module supplies the missing decompression path.
JPEG entropy decode uses cv2 (libjpeg-turbo), and JPEG payloads are
refused without it. A copy of the JAX package's module; the PyTorch server
hands decoded keyframes to the engine from host memory and drops ROI
regions (it has no device frame cache yet).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..protocol import ROI_HEADER_SIZE, RoiHeader, parse_roi_header

try:
    import cv2
    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False


@dataclass
class DecodedFrame:
    """Either a full frame (roi is None) or a region update."""
    pixels: np.ndarray            # (h, w, 3) uint8 RGB
    roi: Optional[RoiHeader] = None


class FrameDecodeError(ValueError):
    pass


def _jpeg_sof_dims(data: bytes) -> Tuple[int, int]:
    """(height, width) from the bitstream's SOF marker, WITHOUT decoding.

    Decode-bomb guard (review r5): a ~60 KB crafted payload whose SOF
    claims 30000x30000 makes cv2.imdecode allocate gigabytes BEFORE any
    post-decode shape check can run — on a wire-reachable path. The SOF
    scan is a few hundred bytes of marker walking; callers compare the
    claimed dims against the expected extent and reject before libjpeg
    allocates anything."""
    i = 2  # past SOI
    n = len(data)
    while i + 4 <= n:
        if data[i] != 0xFF:
            break  # corrupt marker stream — let the real decoder reject it
        marker = data[i + 1]
        if marker in (0x01,) or 0xD0 <= marker <= 0xD9:
            i += 2  # standalone markers carry no length
            continue
        seg_len = int.from_bytes(data[i + 2:i + 4], "big")
        if seg_len < 2:
            break
        # SOF0-15 except DHT(C4)/JPG(C8)/DAC(CC): height u16 @+3, width @+5.
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if i + 9 > n:
                break
            return (int.from_bytes(data[i + 5:i + 7], "big"),
                    int.from_bytes(data[i + 7:i + 9], "big"))
        i += 2 + seg_len
    raise FrameDecodeError("JPEG payload has no parseable SOF header")


def _decode_jpeg(data: bytes, max_h: int, max_w: int) -> np.ndarray:
    """Decode a JPEG whose claimed dimensions must fit (max_h, max_w)."""
    if not _HAS_CV2:
        raise FrameDecodeError("JPEG payload but cv2 unavailable")
    if len(data) < 2 or data[0] != 0xFF or data[1] != 0xD8:
        # cv2.imdecode on an empty buffer RAISES cv2.error (assertion) on
        # this cv2 instead of returning None — a wire-reachable payload
        # (ROIIMG header with no JPEG body) must stay inside the
        # FrameDecodeError contract, not traceback past the server's
        # bad-packet accounting.
        raise FrameDecodeError("not a JPEG payload")
    sh, sw = _jpeg_sof_dims(data)
    if sh > max_h or sw > max_w or sh <= 0 or sw <= 0:
        raise FrameDecodeError(
            f"JPEG claims {sw}x{sh}, exceeds the expected {max_w}x{max_h} "
            "extent (decode refused before allocation)")
    try:
        arr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    except cv2.error as e:
        raise FrameDecodeError(f"JPEG decode failed: {e}") from e
    if arr is None:
        raise FrameDecodeError("JPEG decode failed")
    return cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)


def decode_frame_payload(data: bytes, width: int, height: int) -> DecodedFrame:
    """Classify and decode a FRAME_DATA payload.

    - 'ROIIMG' prefix               -> JPEG region update at (x, y)
    - exactly width*height*3 bytes  -> raw RGB888 (reference-compatible path)
    - JPEG SOI (0xFFD8)             -> full-frame keyframe

    The ROI magic is tested BEFORE the raw-length heuristic: a region
    update whose byte length coincidentally equals width*height*3 must not
    silently decode as a full keyframe of garbage (the 6-byte magic +
    validated header + mandatory JPEG decode is a far stronger
    discriminator than a length equality). The raw path stays ahead of the
    SOI sniff, though: raw pixel data legitimately starts with 0xFFD8
    (bright content), while a JPEG keyframe landing on exactly the raw
    byte length has no realistic path.
    """
    if width <= 0 or height <= 0:
        # A zero-area "frame" would defeat the cache's (0,0) no-frame
        # sentinel downstream and serve garbage slots through inference.
        raise FrameDecodeError(f"zero-area frame header: {width}x{height}")
    roi = parse_roi_header(data)
    if roi is not None:
        # A region must fit inside its own frame: unbounded u16 ROI dims
        # would re-open the decode-bomb the SOF guard closes (a 30000²
        # roi header "licensing" a 30000² JPEG claim).
        if roi.height > height or roi.width > width:
            raise FrameDecodeError(
                f"ROI region {roi.width}x{roi.height} exceeds the frame "
                f"{width}x{height}")
        region = _decode_jpeg(data[ROI_HEADER_SIZE:], roi.height, roi.width)
        if region.shape[:2] != (roi.height, roi.width):
            raise FrameDecodeError(
                f"ROI header {roi.width}x{roi.height} != decoded "
                f"{region.shape[1]}x{region.shape[0]}")
        return DecodedFrame(pixels=region, roi=roi)
    if len(data) == width * height * 3:
        return DecodedFrame(
            pixels=np.frombuffer(data, np.uint8).reshape(height, width, 3))
    if len(data) >= 2 and data[0] == 0xFF and data[1] == 0xD8:
        pixels = _decode_jpeg(data, height, width)
        if pixels.shape[:2] != (height, width):
            raise FrameDecodeError(
                f"keyframe {pixels.shape[1]}x{pixels.shape[0]} != header "
                f"{width}x{height}")
        return DecodedFrame(pixels=pixels)
    raise FrameDecodeError(
        f"unrecognized frame payload: {len(data)} bytes for {width}x{height}")


def encode_jpeg(pixels: np.ndarray, quality: int = 85) -> bytes:
    """Test/simulator helper: RGB -> JPEG bytes."""
    if not _HAS_CV2:
        raise FrameDecodeError("cv2 unavailable")
    ok, buf = cv2.imencode(
        ".jpg", cv2.cvtColor(pixels, cv2.COLOR_RGB2BGR),
        [cv2.IMWRITE_JPEG_QUALITY, quality])
    if not ok:
        raise FrameDecodeError("JPEG encode failed")
    return buf.tobytes()
