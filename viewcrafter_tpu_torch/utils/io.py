"""Host-side I/O: image loading, video / image / PLY writing.

The port's own copy of the JAX package's `utils/io.py`. PIL, imageio and
matplotlib are imported inside the functions that need them, so importing
the port needs none of them. Parity targets (the reference's):
  - DUSt3R image loading (resize long side -> `size`, center-crop to /16
    multiples, (0.5, 0.5) normalization, the 576x1024 `img_ori` crop):
    extern/dust3r/dust3r/utils/image.py:18-140
  - save_video (fps 8 h264): utils/pvd_utils.py:38-48
  - the generated frame -> DUSt3R resize of the iterative modes:
    utils/pvd_utils.py get_input_dict
  - ASCII PLY export with dummy normals: utils/pvd_utils.py:438-473, by the
    native writer `csrc/ply_writer.cpp` (built with g++ on first use into
    `_build/`, loaded with ctypes; a failed build raises), with the Python
    loop `save_pointcloud_ply_plain` as its plain twin

Where a writer finds neither imageio nor PIL, it writes the frames as one
`.npy` array beside the asked-for path and returns that path: a file-format
fallback, nothing else.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png")


@dataclasses.dataclass
class LoadedImage:
    """One input view: dust3r-sized array + original-resolution crop."""

    img: np.ndarray  # (H, W, 3) float32 in [-1, 1], dust3r resolution
    img_ori: np.ndarray  # (H0, W0, 3) float32 in [-1, 1], diffusion resolution
    index: int


def _resize_long_side(img, size: int):
    from PIL import Image

    w, h = img.size
    s = size / max(w, h)
    return img.resize((round(w * s), round(h * s)), Image.LANCZOS)


def center_crop_pil(img, width: int = 1024, height: int = 576):
    """Aspect-preserving resize then center crop to (width, height)
    (image.py:18-34)."""
    from PIL import Image, ImageOps

    w, h = img.size
    h_ratio, w_ratio = h / height, w / width
    if h_ratio > w_ratio:
        nh = max(int(h / w_ratio), height)
        img = img.resize((width, nh), Image.LANCZOS)
    else:
        nw = max(int(w / h_ratio), width)
        img = img.resize((nw, height), Image.LANCZOS)
    return ImageOps.fit(img, (width, height), Image.BICUBIC)


def _normalize(img) -> np.ndarray:
    arr = np.asarray(img, np.float32) / 255.0
    return arr * 2.0 - 1.0


def load_images(folder_or_list, size: int = 512, square_ok: bool = False,
                target_hw: Tuple[int, int] = (576, 1024)) -> List[LoadedImage]:
    """Load + prepare input views (image.py:88-140). `target_hw` is the
    diffusion resolution kept as img_ori (the reference's force_1024)."""
    from PIL import Image, ImageOps

    if isinstance(folder_or_list, str):
        if os.path.isdir(folder_or_list):
            names = sorted(os.listdir(folder_or_list))
            paths = [os.path.join(folder_or_list, n) for n in names
                     if n.lower().endswith(IMAGE_EXTENSIONS)]
        else:
            paths = [folder_or_list]
    else:
        paths = list(folder_or_list)

    out: List[LoadedImage] = []
    for path in paths:
        img = ImageOps.exif_transpose(Image.open(path)).convert("RGB")
        img = center_crop_pil(img, width=target_hw[1], height=target_hw[0])
        img_ori = img
        w1, h1 = img.size
        if size == 224:
            img = _resize_long_side(img, round(size * max(w1 / h1, h1 / w1)))
        else:
            img = _resize_long_side(img, size)
        w, h = img.size
        cx, cy = w // 2, h // 2
        if size == 224:
            half = min(cx, cy)
            img = img.crop((cx - half, cy - half, cx + half, cy + half))
        else:
            halfw, halfh = ((2 * cx) // 16) * 8, ((2 * cy) // 16) * 8
            if not square_ok and w == h:
                halfh = int(3 * halfw / 4)
            img = img.crop((cx - halfw, cy - halfh, cx + halfw, cy + halfh))
        out.append(LoadedImage(img=_normalize(img), img_ori=_normalize(img_ori), index=len(out)))

    if not out:
        raise FileNotFoundError(f"no images found at {folder_or_list}")
    return out


def resize_to_dust3r(frame: np.ndarray, hw: Tuple[int, int] = (288, 512),
                     device=None) -> np.ndarray:
    """Generated frame (H, W, 3) in [-1, 1] -> DUSt3R's input size (hw),
    half-pixel bilinear with `jax.image.resize`'s antialiasing when it
    shrinks (pvd_utils.py get_input_dict), computed on `device` (the card
    unless the caller asks for the CPU)."""
    import torch

    from viewcrafter_tpu_torch.models.lvdm import resolve_device
    from viewcrafter_tpu_torch.ops.resize import resize_bilinear

    x = torch.as_tensor(np.asarray(frame, np.float32), device=resolve_device(device))
    return resize_bilinear(x, hw[0], hw[1]).cpu().numpy()


# ---------------------------------------------------------------------------
# video / image / ply writers
# ---------------------------------------------------------------------------


def to_uint8(frames: np.ndarray) -> np.ndarray:
    """[-1,1] or [0,1] float frames -> uint8."""
    frames = np.asarray(frames)
    if frames.min() < -0.01:
        frames = (frames + 1.0) / 2.0
    return np.clip(frames * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _save_npy(arr: np.ndarray, path: str) -> str:
    out = path + ".npy"
    np.save(out, arr)
    return out


def save_video(frames: np.ndarray, path: str, fps: int = 8) -> str:
    """frames: (T, H, W, 3) float. Writes an mp4 through imageio / ffmpeg
    when it can, else a <path>.frames/ directory of PNGs through PIL, else
    the uint8 frames as <path>.npy. Returns what was written."""
    arr = to_uint8(frames)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        import imageio.v2 as imageio

        with imageio.get_writer(path, fps=fps, codec="h264", quality=9) as w:
            for f in arr:
                w.append_data(f)
        return path
    except Exception:
        pass
    try:
        from PIL import Image
    except ImportError:
        return _save_npy(arr, path)
    frame_dir = path + ".frames"
    os.makedirs(frame_dir, exist_ok=True)
    for i, f in enumerate(arr):
        Image.fromarray(f).save(os.path.join(frame_dir, f"{i:04d}.png"))
    return frame_dir


def save_image(img: np.ndarray, path: str) -> str:
    """One image (H, W, C) in [0, 1] or [-1, 1] to `path` through PIL, a
    single channel squeezed (the NBV candidate masks); without PIL the
    uint8 array goes to <path>.npy. Returns what was written."""
    arr = to_uint8(img)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        from PIL import Image
    except ImportError:
        return _save_npy(arr, path)
    Image.fromarray(arr).save(path)
    return path


PLY_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "ply_writer.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_PLY_LOCK = threading.Lock()
_ply_lib: Optional[ctypes.CDLL] = None


def build_ply_writer() -> Path:
    """Compile PLY_SOURCE with `g++ -O3 -shared -fPIC` into BUILD_DIR unless
    a build at least as new as the source is there; returns the library's
    path.
    The library is written under a temporary name and renamed into place, so
    processes building at once do not see each other's partial files. A
    failed build raises with the compiler's output."""
    src = PLY_SOURCE
    out = BUILD_DIR / "libvc_ply_writer.so"
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, str(src)],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"building the native PLY writer from {src} failed:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def ply_writer_lib() -> ctypes.CDLL:
    """The native PLY writer, built on first use and loaded once."""
    global _ply_lib
    with _PLY_LOCK:
        if _ply_lib is None:
            lib = ctypes.CDLL(str(build_ply_writer()))
            lib.vc_write_ply.restype = ctypes.c_int
            lib.vc_write_ply.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                         ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long]
            _ply_lib = lib
        return _ply_lib


def _ply_arrays(points, colors, path):
    points = np.ascontiguousarray(np.asarray(points, np.float32).reshape(-1, 3))
    colors = np.asarray(colors).reshape(-1, 3)
    colors = np.ascontiguousarray(to_uint8(colors) if colors.size else colors.astype(np.uint8))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return points, colors


def save_pointcloud_ply(points: np.ndarray, colors: np.ndarray, path: str) -> str:
    """ASCII PLY with dummy zero normals (pvd_utils.py:438-473 format),
    coordinates as `%.6g`, written by the native writer. Raises if the
    writer does not build or the file cannot be written."""
    points, colors = _ply_arrays(points, colors, path)
    rc = ply_writer_lib().vc_write_ply(
        os.fsencode(path), points.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        colors.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), len(points))
    if rc != 0:
        raise OSError(f"native PLY writer failed ({rc}) on {path}")
    return path


def save_pointcloud_ply_plain(points: np.ndarray, colors: np.ndarray, path: str) -> str:
    """The native writer's plain twin: the Python loop (coordinates as
    Python prints a float32, the same values to `%.6g`)."""
    points, colors = _ply_arrays(points, colors, path)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property float nx\nproperty float ny\nproperty float nz\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p, c in zip(points, colors):
            f.write(f"{p[0]} {p[1]} {p[2]} 0 0 0 {c[0]} {c[1]} {c[2]}\n")
    return path


def save_trajectory_video(c2ws: np.ndarray, path: str, fps: int = 8) -> str:
    """Matplotlib 3D scatter of camera positions per frame -> video
    (pvd_utils.py:570-640 visualizer_frame). Without matplotlib, the camera
    positions (T, 3) go to <path>.npy. Returns what was written."""
    positions = np.asarray(c2ws)[:, :3, 3]
    try:
        import matplotlib
    except ImportError:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        return _save_npy(positions, path)
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    frames = []
    lim = np.abs(positions).max() * 1.2 + 1e-6
    for i in range(len(positions)):
        fig = plt.figure(figsize=(4, 4), dpi=64)
        ax = fig.add_subplot(111, projection="3d")
        ax.scatter(*positions[: i + 1].T, c=np.linspace(0, 1, i + 1), cmap="viridis", s=12)
        ax.scatter(*positions[i], color="red", s=40)
        for axis_set in (ax.set_xlim, ax.set_ylim, ax.set_zlim):
            axis_set(-lim, lim)
        fig.canvas.draw()
        frames.append(np.asarray(fig.canvas.buffer_rgba())[..., :3].copy())
        plt.close(fig)
    return save_video(np.stack(frames) / 255.0, path, fps=fps)
