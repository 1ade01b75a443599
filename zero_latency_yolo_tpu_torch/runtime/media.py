"""Media frame sources for the offline and streaming tools (cv2-backed).

A copy of the JAX package's `runtime/media.py`: image files, image
directories and video files for `detect.py` (offline) and
`stream_client.py` (live ZLTY streaming). Frames yield as (source_name, RGB
uint8 HxWx3); video sources name frames "<path>#frameN". cv2 is imported
when a source is read, never when this module is imported, so the port
imports without cv2.
"""

from __future__ import annotations

import os
import sys
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")


def _require_cv2():
    try:
        import cv2
        return cv2
    except ImportError as e:  # pragma: no cover
        raise ImportError("media sources need cv2 (opencv)") from e


def iter_frames(paths: Sequence[str], video_stride: int = 1,
                resize: Optional[Tuple[int, int]] = None
                ) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (source_name, rgb) over images, image directories and videos.

    Undecodable files inside a directory/video are skipped with a stderr
    note; a directly-named undecodable file raises (a typo'd path should
    fail loudly). resize=(w, h) resizes every frame (streaming needs one
    constant geometry per session: the ROI cache slot is sized once).
    """
    cv2 = _require_cv2()

    def _post(rgb: np.ndarray) -> np.ndarray:
        if resize is not None and rgb.shape[:2] != (resize[1], resize[0]):
            rgb = cv2.resize(rgb, resize, interpolation=cv2.INTER_AREA)
        return rgb

    for p in paths:
        if os.path.isdir(p):
            names = sorted(n for n in os.listdir(p)
                           if n.lower().endswith(IMAGE_EXTS))
            for n in names:
                fp = os.path.join(p, n)
                bgr = cv2.imread(fp, cv2.IMREAD_COLOR)
                if bgr is None:
                    print(f"# skipping undecodable image {fp}",
                          file=sys.stderr)
                    continue
                yield fp, _post(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
        elif p.lower().endswith(VIDEO_EXTS):
            cap = cv2.VideoCapture(p)
            if not cap.isOpened():
                # Directly-named files fail loudly (same contract as the
                # image branch below): a typo'd path must not exit 0.
                raise ValueError(f"cannot open video {p!r}")
            i = 0
            while True:
                ok, bgr = cap.read()
                if not ok:
                    break
                if i % video_stride == 0:
                    yield (f"{p}#frame{i}",
                           _post(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)))
                i += 1
            cap.release()
        else:
            bgr = cv2.imread(p, cv2.IMREAD_COLOR)
            if bgr is None:
                raise ValueError(
                    f"cannot decode {p!r} (not an image; videos need an "
                    f"extension in {VIDEO_EXTS})")
            yield p, _post(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
