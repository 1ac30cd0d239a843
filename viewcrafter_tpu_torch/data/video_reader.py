"""Host-side video decoding: the port's copy of the JAX package's
`data/video_reader.py` (numpy, PIL and imageio; no JAX there either).

The reference uses decord's native mp4 decoder (lvdm/data/webvid.py:13-202,
DL3DV_dust3r.py:115). Here: imageio/ffmpeg where its plugin exists, and
PNG/JPG frame directories always. PIL and imageio are imported where they
are used, so that importing the port needs neither (the card's machine has
no PIL).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


def list_frame_files(path: str) -> List[str]:
    exts = (".png", ".jpg", ".jpeg")
    names = sorted(n for n in os.listdir(path) if n.lower().endswith(exts))
    return [os.path.join(path, n) for n in names]


def read_video(path: str, indices: Optional[np.ndarray] = None) -> np.ndarray:
    """-> (T, H, W, 3) uint8. `path` is an mp4 (needs imageio-ffmpeg) or a
    directory of frames."""
    if os.path.isdir(path):
        from PIL import Image

        files = list_frame_files(path)
        if indices is not None:
            files = [files[i] for i in indices]
        return np.stack([np.asarray(Image.open(f).convert("RGB")) for f in files])
    import imageio.v2 as imageio

    reader = imageio.get_reader(path)
    frames = []
    if indices is None:
        for f in reader:
            frames.append(np.asarray(f))
    else:
        want = set(int(i) for i in indices)
        for i, f in enumerate(reader):
            if i in want:
                frames.append(np.asarray(f))
            if i >= max(want):
                break
    reader.close()
    return np.stack(frames)


def video_length(path: str) -> int:
    if os.path.isdir(path):
        return len(list_frame_files(path))
    import imageio.v2 as imageio

    reader = imageio.get_reader(path)
    n = reader.count_frames()
    reader.close()
    return int(n)


def resize_crop(frames: np.ndarray, height: int, width: int) -> np.ndarray:
    """Aspect-preserving resize (the short side fits) and a center crop,
    uint8 in and out (webvid.py's Resize + CenterCrop)."""
    from PIL import Image

    t, h, w, _ = frames.shape
    scale = max(height / h, width / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    out = np.stack(
        [np.asarray(Image.fromarray(f).resize((nw, nh), Image.BILINEAR)) for f in frames])
    top = (nh - height) // 2
    left = (nw - width) // 2
    return out[:, top:top + height, left:left + width]
