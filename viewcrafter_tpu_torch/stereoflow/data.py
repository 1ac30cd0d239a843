"""Stereo/flow data-set catalogue and file formats: the port's own copy of
the JAX package's `stereoflow/data.py`.

Parity targets:
  - extern/dust3r/croco/stereoflow/datasets_stereo.py (StereoDataset base
    :51-135, 11 data-set layouts :137-539, IO readers :541-652,
    vis_disparity :654-661, getters :664-673);
  - extern/dust3r/croco/stereoflow/datasets_flow.py (FlowDataset base
    :36-119, 7 data-set layouts :120-376, .flo/KITTI/flo5 IO :378-480,
    the Middlebury flow colour wheel :482-628).

As in the JAX package:
  - samples are channels-last numpy (H, W, C) float32, ImageNet-normalized
    by `to_model_input` (the reference emits CHW tensors); the eval CLI
    moves them onto the device;
  - split lists are built by globbing the root on first use (no pickle
    cache directory); the reference's expected-count asserts are warnings,
    so that partial local copies still load;
  - the readers use numpy, PIL and cv2, and the hdf5 formats (Spring
    .dsp5/.flo5) h5py; each is imported where it is used, so that the port
    imports on a machine that has none of them.
Invalid pixels are +inf, as in the reference.
"""

from __future__ import annotations

import os
import os.path as osp
import re
import struct
import warnings
from glob import glob
from typing import Dict, List, Optional, Tuple

import numpy as np

# roots mirror datasets_stereo.py:25-39 / datasets_flow.py:24-31, overridable
STEREOFLOW_ROOT = os.environ.get("VIEWCRAFTER_STEREOFLOW_ROOT", "./data/stereoflow")

IN1K_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IN1K_STD = np.array([0.229, 0.224, 0.225], np.float32)


def to_model_input(img: np.ndarray) -> np.ndarray:
    """uint8-range HWC -> ImageNet-normalized float32 HWC
    (img_to_tensor, datasets_stereo.py:44-47, channels-last here)."""
    return (np.asarray(img, np.float32) / 255.0 - IN1K_MEAN) / IN1K_STD


# ---------------------------------------------------------------------------
# file formats
# ---------------------------------------------------------------------------


def read_img(filename: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(filename).convert("RGB"))


def _write_png_u16(filename: str, disp: np.ndarray) -> None:
    """KITTI's disparity PNG: uint16 of disparity * 256."""
    from PIL import Image

    Image.fromarray((disp * 256).astype("uint16")).save(filename)


def read_pfm(filename: str) -> Tuple[np.ndarray, float]:
    """Portable float map (bottom-up rows, endian from the scale's sign)."""
    with open(filename, "rb") as f:
        header = f.readline().rstrip().decode("ascii")
        if header not in ("PF", "Pf"):
            raise ValueError(f"{filename}: not a PFM file")
        dims = re.match(r"^(\d+)\s(\d+)\s*$", f.readline().decode("ascii"))
        if not dims:
            raise ValueError(f"{filename}: malformed PFM header")
        width, height = map(int, dims.groups())
        scale = float(f.readline().decode("ascii").rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if header == "PF" else (height, width)
    return np.flipud(data.reshape(shape)), abs(scale)


def write_pfm(filename: str, image: np.ndarray, scale: float = 1.0) -> None:
    assert image.dtype == np.float32, "PFM stores float32"
    color = image.ndim == 3 and image.shape[2] == 3
    if not color:
        image = image.reshape(image.shape[0], image.shape[1])
    import sys as _sys

    little = image.dtype.byteorder == "<" or (
        image.dtype.byteorder == "=" and _sys.byteorder == "little"
    )
    with open(filename, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(f"{-scale if little else scale}\n".encode())
        np.flipud(image).tofile(f)


FLO_TAG = 202021.25  # Middlebury .flo sanity tag


def read_flo(filename: str) -> np.ndarray:
    with open(filename, "rb") as f:
        (tag,) = struct.unpack("f", f.read(4))
        if tag != FLO_TAG:
            raise ValueError(f"{filename}: wrong .flo tag")
        w, h = struct.unpack("ii", f.read(8))
        flow = np.fromfile(f, np.float32)
    if flow.shape != (h * w * 2,):
        raise ValueError(f"{filename}: truncated .flo")
    return flow.reshape(h, w, 2)


def write_flo(filename: str, flow: np.ndarray) -> None:
    assert flow.ndim == 3 and flow.shape[2] == 2
    with open(filename, "wb") as f:
        f.write(b"PIEH")
        f.write(struct.pack("ii", flow.shape[1], flow.shape[0]))
        flow.astype(np.float32).tofile(f)


def read_png_disp(filename: str, coef: float = 1.0) -> np.ndarray:
    from PIL import Image

    disp = np.asarray(Image.open(filename)).astype(np.float32) / coef
    disp[disp == 0.0] = np.inf
    return disp


def read_pfm_disp(filename: str) -> np.ndarray:
    disp = np.ascontiguousarray(read_pfm(filename)[0])
    disp[disp <= 0] = np.inf
    return disp


def read_pfm_flow(filename: str) -> np.ndarray:
    f, _ = read_pfm(filename)
    return np.ascontiguousarray(f[:, :, :2])


def read_npy(filename: str) -> np.ndarray:
    return np.load(filename)


def read_booster_disp(filename: str) -> np.ndarray:
    disp = np.load(filename)
    disp[disp == 0.0] = np.inf
    return disp


def read_kitti_flow(filename: str) -> np.ndarray:
    """KITTI 16-bit png: (uv*64 + 2^15, valid) channels."""
    import cv2

    raw = cv2.imread(filename, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    raw = raw[:, :, ::-1].astype(np.float32)  # BGR -> RGB channel order
    valid = raw[:, :, 2] > 0
    flow = (raw[:, :, :2] - 2**15) / 64.0
    flow[~valid] = np.inf
    return flow


def write_kitti_flow(filename: str, uv: np.ndarray) -> None:
    import cv2

    enc = 64.0 * uv + 2**15
    valid = np.ones(uv.shape[:2] + (1,), np.float32)
    cv2.imwrite(filename, np.concatenate([enc, valid], -1).astype(np.uint16)[..., ::-1])


def _h5py():
    try:
        import h5py

        return h5py
    except ImportError as e:  # pragma: no cover
        raise ImportError("Spring .dsp5/.flo5 files need h5py") from e


def read_hdf5_disp(filename: str) -> np.ndarray:
    disp = np.asarray(_h5py().File(filename)["disparity"])
    disp[np.isnan(disp)] = np.inf
    return disp.astype(np.float32)


def read_hdf5_flow(filename: str) -> np.ndarray:
    flow = np.asarray(_h5py().File(filename)["flow"])
    flow[np.isnan(flow)] = np.inf
    return flow.astype(np.float32)


def write_dsp5(filename: str, disp: np.ndarray) -> None:
    with _h5py().File(filename, "w") as f:
        f.create_dataset("disparity", data=disp, compression="gzip", compression_opts=5)


def write_flo5(filename: str, flow: np.ndarray) -> None:
    with _h5py().File(filename, "w") as f:
        f.create_dataset("flow", data=flow, compression="gzip", compression_opts=5)


def read_kitti_disp(f: str) -> np.ndarray:
    return read_png_disp(f, coef=256.0)


def read_crestereo_disp(f: str) -> np.ndarray:
    return read_png_disp(f, coef=32.0)


# ---------------------------------------------------------------------------
# visualization
# ---------------------------------------------------------------------------


def vis_disparity(disp: np.ndarray, m: Optional[float] = None,
                  M: Optional[float] = None) -> np.ndarray:
    import cv2

    m = float(disp.min()) if m is None else m
    M = float(disp.max()) if M is None else M
    u8 = ((disp - m) / max(M - m, 1e-9) * 255.0).astype(np.uint8)
    return cv2.applyColorMap(u8, cv2.COLORMAP_INFERNO)


def _flow_color_wheel() -> np.ndarray:
    """Middlebury 55-color wheel, integer ramps exactly like the reference
    (_computeColor, datasets_flow.py:565-590)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((RY + YG + GC + CB + BM + MR, 3), np.uint8)
    col = 0
    wheel[:RY, 0] = 255
    wheel[:RY, 1] = [(255 * i) // RY for i in range(RY)]
    col += RY
    wheel[col:col + YG, 0] = [255 - (255 * i) // YG for i in range(YG)]
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = [(255 * i) // GC for i in range(GC)]
    col += GC
    wheel[col:col + CB, 1] = [255 - (255 * i) // CB for i in range(CB)]
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 0] = [(255 * i) // BM for i in range(BM)]
    wheel[col:col + BM, 2] = 255
    col += BM
    wheel[col:col + MR, 0] = 255
    wheel[col:col + MR, 2] = [255 - (255 * i) // MR for i in range(MR)]
    return wheel


def flow_to_color(flow: np.ndarray, maxflow: Optional[float] = None,
                  saturate: bool = False) -> np.ndarray:
    """Middlebury flow color coding (flowToColor + _computeColor,
    datasets_flow.py:502-620): normalize by the max flow norm, look up the
    55-color wheel by angle, modulate saturation by magnitude."""
    flow = np.array(flow, np.float32, copy=True)
    unknown = np.max(np.abs(flow), axis=2) > 1e9
    flow[unknown] = 0.0
    if maxflow is None:
        maxflow = float(np.max(np.sqrt(np.sum(flow**2, axis=2))))
    flow = flow / (maxflow + np.spacing(1))
    nanidx = np.isnan(flow[:, :, 0])
    flow[nanidx] = 0.0
    wheel = _flow_color_wheel()
    ncols = wheel.shape[0]
    rad = np.sqrt(np.sum(flow**2, axis=2))
    a = np.arctan2(-flow[:, :, 1], -flow[:, :, 0]) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = k0 + 1
    k1[k1 == ncols] = 0
    f = fk - k0
    if not saturate:
        rad = np.minimum(rad, 1)
    img = np.zeros(flow.shape[:2] + (3,), np.uint8)
    keep = (1.0 - nanidx.astype(np.float32)) * (1.0 - unknown.astype(np.float32))
    for i in range(3):
        tmp = wheel[:, i].astype(np.float64)
        col = (1 - f) * tmp[k0] / 255 + f * tmp[k1] / 255
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] *= 0.75
        img[:, :, i] = (255 * col * keep).astype(np.uint8)
    return img


# ---------------------------------------------------------------------------
# dataset catalog
# ---------------------------------------------------------------------------


def _warn_count(name: str, got: int, expect: int) -> None:
    if expect and got != expect:
        warnings.warn(f"{name}: found {got} pairs, reference expects {expect} "
                      "(partial local copy?)")


class PairDataset:
    """Common base (StereoDataset/FlowDataset semantics, channels-last numpy).

    Subclass hooks: `name`, `gt_channels` (1 stereo / 2 flow),
    `_img1/_img2/_gt(pairname)` path builders, `_load_gt(path)`,
    `_pairs(split)` split listing, `pairname_to_str`.
    """

    name = ""
    gt_channels = 1
    has_constant_resolution = True

    def __init__(self, split: str, augmentor: bool = False,
                 crop_size: Optional[Tuple[int, int]] = None,
                 normalize: bool = True, root: Optional[str] = None,
                 rng: Optional[np.random.Generator] = None):
        if not augmentor:
            assert crop_size is None
        self.split = split
        self.root = root or osp.join(STEREOFLOW_ROOT, self.default_subdir)
        if not osp.isdir(self.root):
            raise FileNotFoundError(f"{self.name}: dataset root {self.root} absent")
        self.normalize = normalize
        self.rmul = 1
        if augmentor:
            from viewcrafter_tpu_torch.stereoflow.augmentor import (
                FlowAugmentor,
                StereoAugmentor,
            )

            cls = StereoAugmentor if self.gt_channels == 1 else FlowAugmentor
            self.augmentor = cls(crop_size, rng=rng)
        else:
            self.augmentor = None
        self.pairnames = self._pairs(split)

    def __len__(self) -> int:
        return len(self.pairnames)

    def __rmul__(self, v: int) -> "PairDataset":
        self.rmul *= v
        self.pairnames = v * self.pairnames
        return self

    def __str__(self):
        return f"{type(self).__name__}_{self.split}"

    def __getitem__(self, index: int):
        pairname = self.pairnames[index]
        img1 = read_img(self._img1(pairname))
        img2 = read_img(self._img2(pairname))
        gtname = self._gt(pairname)
        gt = self._load_gt(gtname) if gtname is not None else None
        if self.augmentor is not None:
            img1, img2, gt = self.augmentor(img1, img2, gt, self.name)
        if self.normalize:
            img1, img2 = to_model_input(img1), to_model_input(img2)
        if gt is not None and gt.ndim == 2:
            gt = gt[..., None]
        return img1, img2, gt, str(pairname)

    # subclass hooks ------------------------------------------------------
    default_subdir = ""

    def _img1(self, pairname):
        raise NotImplementedError

    def _img2(self, pairname):
        raise NotImplementedError

    def _gt(self, pairname):
        raise NotImplementedError

    def _load_gt(self, path):
        raise NotImplementedError

    def _pairs(self, split) -> List:
        raise NotImplementedError

    def pairname_to_str(self, pairname) -> str:
        return str(pairname)

    # benchmark submission hooks (datasets_stereo.py:344-358 etc.; only the
    # datasets with a public leaderboard implement them) -------------------
    submission_methodname = "CroCo-Stereo"

    def submission_save_pairname(self, pairname, prediction: np.ndarray,
                                  outdir: str, time: float) -> None:
        raise NotImplementedError(
            f"{self.name} has no benchmark submission format")

    def finalize_submission(self, outdir: str) -> None:
        raise NotImplementedError(
            f"{self.name} has no benchmark submission format")


def _zip_dir(outdir: str, zipname: str, subdir: str = ".") -> str:
    """`cd outdir && zip -r zipname subdir` without spawning a shell
    (the reference shells out, datasets_stereo.py:355-358)."""
    import zipfile

    base = outdir if subdir == "." else osp.join(outdir, subdir)
    zpath = osp.join(outdir, zipname)
    with zipfile.ZipFile(zpath, "w", zipfile.ZIP_DEFLATED) as zf:
        for dirpath, _, files in os.walk(base):
            for f in sorted(files):
                full = osp.join(dirpath, f)
                if osp.abspath(full) == osp.abspath(zpath):
                    continue
                zf.write(full, osp.relpath(full, outdir))
    print(f"Done. Submission file at {zpath}")
    return zpath


# ----- stereo layouts (datasets_stereo.py:137-539) -------------------------


class SceneFlowStereo(PairDataset):
    name = "SceneFlow"
    default_subdir = "SceneFlow"

    def _img1(self, p):
        return osp.join(self.root, p)

    def _img2(self, p):
        return osp.join(self.root, p).replace("/left/", "/right/")

    def _gt(self, p):
        q = p.replace("/frames_finalpass/", "/disparity/")
        q = q.replace("/frames_cleanpass/", "/disparity/")
        return osp.join(self.root, q)[:-4] + ".pfm"

    _load_gt = staticmethod(read_pfm_disp)

    def _pairs(self, split):
        m = re.match(r"(train|test|test1of100)_(final|clean|all)pass$", split)
        assert m, split
        subset, pas = m.groups()
        if pas == "all":
            return (self._pairs(f"{subset}_finalpass")
                    + self._pairs(f"{subset}_cleanpass"))
        sub = "TRAIN" if subset == "train" else "TEST"
        pats = ([f"Driving/frames_finalpass/*/*/*/left/*.png",
                 f"Monkaa/frames_finalpass/*/left/*.png",
                 f"FlyingThings/frames_finalpass/TRAIN/*/*/left/*.png"]
                if subset == "train"
                else [f"FlyingThings/frames_finalpass/{sub}/*/*/left/*.png"])
        pairs: List[str] = []
        for pat in pats:
            pairs += sorted(glob(osp.join(self.root, pat)))
        pairs = [x[len(self.root):].lstrip("/") for x in pairs]
        _warn_count(self.name, len(pairs), 35454 if subset == "train" else 4370)
        if subset == "test1of100":
            pairs = pairs[::100]
        if pas == "clean":
            pairs = [x.replace("frames_finalpass", "frames_cleanpass") for x in pairs]
        return pairs

    def pairname_to_str(self, p):
        return p[:-4]


class CREStereo(PairDataset):
    name = "CREStereo"
    default_subdir = "crenet_stereo_trainset/stereo_trainset/crestereo"

    def _img1(self, p):
        return osp.join(self.root, p + "_left.jpg")

    def _img2(self, p):
        return osp.join(self.root, p + "_right.jpg")

    def _gt(self, p):
        return osp.join(self.root, p + "_left.disp.png")

    _load_gt = staticmethod(read_crestereo_disp)

    def _pairs(self, split):
        assert split == "train", split
        pairs = [s + "/" + f[:-len("_left.jpg")]
                 for s in sorted(os.listdir(self.root))
                 for f in sorted(os.listdir(osp.join(self.root, s)))
                 if f.endswith("_left.jpg")]
        _warn_count(self.name, len(pairs), 200000)
        return pairs


class Kitti12Stereo(PairDataset):
    name = "Kitti12"
    default_subdir = "kitti-stereo-2012"

    def _img1(self, p):
        return osp.join(self.root, p + "_10.png")

    def _img2(self, p):
        return osp.join(self.root, p.replace("/colored_0/", "/colored_1/") + "_10.png")

    def _gt(self, p):
        if self.split == "test":
            return None
        return osp.join(self.root, p.replace("/colored_0/", "/disp_occ/") + "_10.png")

    _load_gt = staticmethod(read_kitti_disp)

    def _pairs(self, split):
        assert split in ("train", "test"), split
        n, sub = (194, "training") if split == "train" else (195, "testing")
        return [f"{sub}/colored_0/%06d" % i for i in range(n)]

    def pairname_to_str(self, p):
        return p.replace("/colored_0/", "/")

    def submission_save_pairname(self, p, prediction, outdir, time):
        # uint16 disparity*256 PNG (datasets_stereo.py:487-493)
        assert prediction.ndim == 2 and prediction.dtype == np.float32
        outfile = osp.join(outdir, p.split("/")[-1] + "_10.png")
        os.makedirs(osp.dirname(outfile), exist_ok=True)
        _write_png_u16(outfile, prediction)

    def finalize_submission(self, outdir):
        assert self.split == "test"
        _zip_dir(outdir, "kitti12_results.zip")


class Kitti15Stereo(PairDataset):
    name = "Kitti15"
    default_subdir = "kitti-stereo-2015"

    def _img1(self, p):
        return osp.join(self.root, p + "_10.png")

    def _img2(self, p):
        return osp.join(self.root, p.replace("/image_2/", "/image_3/") + "_10.png")

    def _gt(self, p):
        if self.split == "test":
            return None
        return osp.join(self.root, p.replace("/image_2/", "/disp_occ_0/") + "_10.png")

    _load_gt = staticmethod(read_kitti_disp)

    def _pairs(self, split):
        train = ["training/image_2/%06d" % i for i in range(200)]
        if split == "train":
            return train
        if split == "subtrain":
            return train[:-5]
        if split == "subval":
            return train[-5:]
        if split == "test":
            return ["testing/image_2/%06d" % i for i in range(200)]
        raise AssertionError(split)

    def pairname_to_str(self, p):
        return p.replace("/image_2/", "/")

    def submission_save_pairname(self, p, prediction, outdir, time):
        # disp_0/<id>_10.png uint16 disparity*256 (datasets_stereo.py:523-529)
        assert prediction.ndim == 2 and prediction.dtype == np.float32
        outfile = osp.join(outdir, "disp_0", p.split("/")[-1] + "_10.png")
        os.makedirs(osp.dirname(outfile), exist_ok=True)
        _write_png_u16(outfile, prediction)

    def finalize_submission(self, outdir):
        assert self.split == "test"
        _zip_dir(outdir, "kitti15_results.zip", "disp_0")


class ETH3DLowRes(PairDataset):
    name = "ETH3DLowRes"
    default_subdir = "eth3d_lowres"
    has_constant_resolution = False

    def _img1(self, p):
        return osp.join(self.root, p, "im0.png")

    def _img2(self, p):
        return osp.join(self.root, p, "im1.png")

    def _gt(self, p):
        if self.split == "test" or p.startswith("test/"):
            return None
        return osp.join(self.root, p.replace("train/", "train_gt/"), "disp0GT.pfm")

    _load_gt = staticmethod(read_pfm_disp)

    def _pairs(self, split):
        train = ["train/" + s for s in sorted(os.listdir(osp.join(self.root, "train")))]
        test = ["test/" + s for s in sorted(os.listdir(osp.join(self.root, "test")))]
        subval = ["train/delivery_area_3s", "train/electro_3l", "train/playground_3l"]
        return {
            "train": train, "test": test, "all": train + test,
            "subval": subval,
            "subtrain": [p for p in train if p not in subval],
        }[split]

    def submission_save_pairname(self, p, prediction, outdir, time):
        # low_res_two_view/<scene>.pfm + runtime sidecar (datasets_stereo.py:384-392)
        assert prediction.ndim == 2 and prediction.dtype == np.float32
        outfile = osp.join(outdir, "low_res_two_view", p.split("/")[1] + ".pfm")
        os.makedirs(osp.dirname(outfile), exist_ok=True)
        write_pfm(outfile, prediction)
        with open(outfile[:-4] + ".txt", "w") as fid:
            fid.write("runtime " + str(time))

    def finalize_submission(self, outdir):
        _zip_dir(outdir, "eth3d_low_res_two_view_results.zip", "low_res_two_view")


class SpringStereo(PairDataset):
    name = "Spring"
    default_subdir = "spring"

    def _img1(self, p):
        return osp.join(self.root, p + ".png")

    def _img2(self, p):
        swapped = (osp.join(self.root, p + ".png")
                   .replace("frame_right", "<tmp>")
                   .replace("frame_left", "frame_right")
                   .replace("<tmp>", "frame_left"))
        return swapped

    def _gt(self, p):
        if p.startswith("test"):
            return None
        return (osp.join(self.root, p + ".dsp5")
                .replace("frame_left", "disp1_left")
                .replace("frame_right", "disp1_right"))

    _load_gt = staticmethod(read_hdf5_disp)

    def _pairs(self, split):
        train = [osp.join("train", s, "frame_left", f[:-4])
                 for s in sorted(os.listdir(osp.join(self.root, "train")))
                 for f in sorted(os.listdir(osp.join(self.root, "train", s, "frame_left")))]
        if split in ("train", "subtrain", "subval"):
            if split == "subtrain":
                return [p for p in train if p.split("/")[1] != "0041"]
            if split == "subval":
                return [p for p in train if p.split("/")[1] == "0041"]
            return train
        assert split == "test"
        test = [osp.join("test", s, "frame_left", f[:-4])
                for s in sorted(os.listdir(osp.join(self.root, "test")))
                for f in sorted(os.listdir(osp.join(self.root, "test", s, "frame_left")))]
        return test + [p.replace("frame_left", "frame_right") for p in test]

    def submission_save_pairname(self, p, prediction, outdir, time):
        # disp1_{left,right} .dsp5 (datasets_stereo.py:449-455)
        assert prediction.ndim == 2 and prediction.dtype == np.float32
        outfile = (osp.join(outdir, p + ".dsp5")
                   .replace("frame_left", "disp1_left")
                   .replace("frame_right", "disp1_right"))
        os.makedirs(osp.dirname(outfile), exist_ok=True)
        write_dsp5(outfile, prediction)

    def finalize_submission(self, outdir):
        # the Spring benchmark requires the organizers' disp1_subsampling
        # binary (datasets_stereo.py:456-466; NB the reference's isfile check
        # never fires — the path string is missing its f-prefix)
        assert self.split == "test"
        print("Run the Spring disp1_subsampling executable to finish:")
        print(f'cd "{outdir}/test"; <disp1_subsampling_exe> .')


def _middlebury(name_, subdir, right_name, disp_builder, pair_builder,
                reader=read_pfm_disp, constant_res=True):
    """Factory for the four Middlebury generations (datasets_stereo.py:203-310)
    — same skeleton, different directory conventions."""

    class _Md(PairDataset):
        name = name_
        default_subdir = subdir
        has_constant_resolution = constant_res

        def _img1(self, p):
            return osp.join(self.root, p)

        def _img2(self, p):
            return osp.join(self.root, right_name(p))

        def _gt(self, p):
            return osp.join(self.root, disp_builder(p))

        _load_gt = staticmethod(reader)

        def _pairs(self, split):
            train, subtrain, subval = pair_builder(self.root)
            return {"train": train, "subtrain": subtrain, "subval": subval}[split]

        def pairname_to_str(self, p):
            return p[:-4]

    _Md.__name__ = name_ + "Dataset"
    return _Md


def _md21_pairs(root):
    seqs = sorted(os.listdir(root))
    train = [f"{s}/ambient/{b}/{a}"
             for s in seqs
             for b in sorted(os.listdir(osp.join(root, s, "ambient")))
             for a in sorted(os.listdir(osp.join(root, s, "ambient", b)))
             if a.startswith("im0")]
    sub = [p for p in train if any(p.startswith(s + "/") for s in seqs[:-2])]
    val = [p for p in train if any(p.startswith(s + "/") for s in seqs[-2:])]
    return train, sub, val


def _md14_pairs(root):
    seqs = sorted(os.listdir(root))
    train = [f"{s}/{im}" for s in seqs for im in ("im1.png", "im1E.png", "im1L.png")]
    valseqs = ["Umbrella-imperfect", "Vintage-perfect"]
    sub = [p for p in train if not any(p.startswith(s + "/") for s in valseqs)]
    val = [p for p in train if any(p.startswith(s + "/") for s in valseqs)]
    return train, sub, val


def _md0506_pairs(valseqs):
    def build(root):
        seqs = sorted(os.listdir(root))
        train = [osp.join(s, i, e, "view1.png") for s in seqs
                 for i in ("Illum1", "Illum2", "Illum3")
                 for e in ("Exp0", "Exp1", "Exp2")]
        sub = [p for p in train if not any(p.startswith(s + "/") for s in valseqs)]
        val = [p for p in train if any(p.startswith(s + "/") for s in valseqs)]
        return train, sub, val

    return build


Middlebury2021 = _middlebury(
    "Middlebury2021", "middlebury/2021/data",
    right_name=lambda p: p.replace("/im0", "/im1"),
    disp_builder=lambda p: osp.join(p.split("/")[0], "disp0.pfm"),
    pair_builder=_md21_pairs,
)
Middlebury2014 = _middlebury(
    "Middlebury2014", "middlebury/2014",
    right_name=lambda p: p,  # pairname IS the right image; left is im0.png
    disp_builder=lambda p: osp.join(osp.dirname(p), "disp0.pfm"),
    pair_builder=_md14_pairs, constant_res=False,
)
# Md14's left image is im0.png in the same directory:
Middlebury2014._img1 = lambda self, p: osp.join(  # type: ignore[method-assign]
    self.root, osp.dirname(p), "im0.png")
Middlebury2006 = _middlebury(
    "Middlebury2006", "middlebury/2006",
    right_name=lambda p: osp.join(osp.dirname(p), "view5.png"),
    disp_builder=lambda p: osp.join(p.split("/")[0], "disp1.png"),
    pair_builder=_md0506_pairs(["Rocks1", "Wood2"]),
    reader=lambda f: read_png_disp(f, 1.0), constant_res=False,
)
Middlebury2005 = _middlebury(
    "Middlebury2005", "middlebury/2005/train",
    right_name=lambda p: osp.join(osp.dirname(p), "view5.png"),
    disp_builder=lambda p: osp.join(p.split("/")[0], "disp1.png"),
    pair_builder=_md0506_pairs(["Reindeer"]),
    reader=lambda f: read_png_disp(f, 1.0),
)


class MdEval3(PairDataset):
    """Middlebury Eval v3 benchmark (datasets_stereo.py:311-358): splits are
    <subset>_<full|half|quarter>; full/half live in suffixed sibling roots."""

    name = "MiddleburyEval3"
    default_subdir = "middlebury/MiddEval3"
    has_constant_resolution = False

    def __init__(self, split: str, root: Optional[str] = None, **kw):
        r = root or osp.join(STEREOFLOW_ROOT, self.default_subdir)
        if split.endswith("_full"):
            r = r.replace("/MiddEval3", "/MiddEval3_F")
            self.submission_sresolution = "F"
        elif split.endswith("_half"):
            r = r.replace("/MiddEval3", "/MiddEval3_H")
            self.submission_sresolution = "H"
        else:
            assert split.endswith("_quarter"), split
            self.submission_sresolution = "Q"
        super().__init__(split, root=r, **kw)

    def _img1(self, p):
        return osp.join(self.root, p, "im0.png")

    def _img2(self, p):
        return osp.join(self.root, p, "im1.png")

    def _gt(self, p):
        return None if p.startswith("test") else osp.join(self.root, p, "disp0GT.pfm")

    _load_gt = staticmethod(read_pfm_disp)

    def _pairs(self, split):
        subset = split.rsplit("_", 1)[0]
        train = ["train/" + s for s in sorted(os.listdir(osp.join(self.root, "train")))]
        test = ["test/" + s for s in sorted(os.listdir(osp.join(self.root, "test")))]
        _warn_count(self.name, len(train) + len(test), 30)
        return {"train": train, "test": test, "all": train + test,
                "subval": train[-1:], "subtrain": train[:-1]}[subset]

    def submission_save_pairname(self, p, prediction, outdir, time):
        # training<res>/<seq>/disp0<method>.pfm + time sidecar (:344-352)
        assert prediction.ndim == 2 and prediction.dtype == np.float32
        sub, seq = p.split("/")
        d = osp.join(outdir, sub.replace("train", "training") + self.submission_sresolution, seq)
        os.makedirs(d, exist_ok=True)
        write_pfm(osp.join(d, "disp0" + self.submission_methodname + ".pfm"), prediction)
        with open(osp.join(d, "time" + self.submission_methodname + ".txt"), "w") as fid:
            fid.write(str(time))

    def finalize_submission(self, outdir):
        _zip_dir(outdir, self.submission_methodname + ".zip")


class Booster(PairDataset):
    """Booster balanced split (datasets_stereo.py:407-428): every camera_00
    image of a sequence shares one disp_00.npy ground truth."""

    name = "Booster"
    default_subdir = "booster_gt"

    def _img1(self, p):
        return osp.join(self.root, p)

    def _img2(self, p):
        return osp.join(self.root, p).replace("/camera_00/", "/camera_02/")

    def _gt(self, p):
        return osp.join(self.root, osp.dirname(p), "../disp_00.npy")

    _load_gt = staticmethod(read_booster_disp)

    def _pairs(self, split):
        assert split in ("train_balanced", "test_balanced",
                         "subtrain_balanced", "subval_balanced"), split
        sub = "test" if split.startswith("test") else "train"
        seqs = sorted(os.listdir(osp.join(self.root, sub, "balanced")))
        pairs = [f"{sub}/balanced/{s}/camera_00/{f}" for s in seqs
                 for f in sorted(os.listdir(osp.join(self.root, sub, "balanced", s, "camera_00")))]
        if split == "subtrain_balanced":
            return [p for p in pairs if any(f"/{s}/" in p for s in seqs[:-2])]
        if split == "subval_balanced":
            return [p for p in pairs if any(f"/{s}/" in p for s in seqs[-2:])]
        return pairs

    def pairname_to_str(self, p):
        return p[:-4].replace("/camera_00/", "/")


# ----- flow layouts (datasets_flow.py:120-376) ------------------------------


class FlyingChairs(PairDataset):
    name = "FlyingChairs"
    default_subdir = "FlyingChairs_release"
    gt_channels = 2

    def _img1(self, p):
        return osp.join(self.root, "data", p + "_img1.ppm")

    def _img2(self, p):
        return osp.join(self.root, "data", p + "_img2.ppm")

    def _gt(self, p):
        return osp.join(self.root, "data", p + "_flow.flo")

    _load_gt = staticmethod(read_flo)

    def _pairs(self, split):
        split_list = np.loadtxt(osp.join(self.root, "chairs_split.txt"), dtype=np.int32)
        flag = {"train": 1, "val": 2}[split]
        return ["{:05d}".format(i) for i in np.where(split_list == flag)[0] + 1]


class MPISintel(PairDataset):
    name = "MPISintel"
    default_subdir = "MPI-Sintel"
    gt_channels = 2

    def _img1(self, p):
        return osp.join(self.root, p[0], "frame_{:04d}.png".format(p[1]))

    def _img2(self, p):
        return osp.join(self.root, p[0], "frame_{:04d}.png".format(p[1] + 1))

    def _gt(self, p):
        if p[0].startswith("test/"):
            return None
        d = p[0].replace("/clean/", "/flow/").replace("/final/", "/flow/")
        return osp.join(self.root, d, "frame_{:04d}.flo".format(p[1]))

    _load_gt = staticmethod(read_flo)

    def _pairs(self, split):
        m = re.match(r"(train|test|subval|subtrain)_(clean|final|all)pass$", split)
        assert m, split
        subset, pas = m.groups()
        if pas == "all":
            return (self._pairs(f"{subset}_cleanpass")
                    + self._pairs(f"{subset}_finalpass"))
        base = "test/clean" if subset == "test" else "training/clean"
        seqs = sorted(os.listdir(osp.join(self.root, base)))
        subval = ["temple_2", "temple_3"]
        if subset == "subval":
            seqs = [s for s in seqs if s in subval]
        elif subset == "subtrain":
            seqs = [s for s in seqs if s not in subval]
        pairs = [(osp.join(base, s), i) for s in seqs
                 for i in range(1, len(os.listdir(osp.join(self.root, base, s))))]
        if pas == "final":
            pairs = [(p.replace("/clean/", "/final/"), i) for p, i in pairs]
        return pairs

    def pairname_to_str(self, p):
        return osp.join(p[0], "frame_{:04d}".format(p[1]))

    submission_methodname = "CroCo-Flow"

    def submission_save_pairname(self, p, prediction, outdir, _time):
        # submission/<test/{clean,final}/seq/frame>.flo (datasets_flow.py:234-238)
        assert prediction.shape[2] == 2
        outfile = osp.join(outdir, "submission", self.pairname_to_str(p) + ".flo")
        os.makedirs(osp.dirname(outfile), exist_ok=True)
        write_flo(outfile, prediction)

    def finalize_submission(self, outdir):
        # Sintel requires the organizers' bundler binary (datasets_flow.py:240-251)
        assert self.split == "test_allpass"
        print("Run the MPI-Sintel bundler to finish:")
        print(f'<bundle_exe> "{outdir}/submission/test/clean/" '
              f'"{outdir}/submission/test/final" "{outdir}/submission/bundled.lzma"')


class TartanAir(PairDataset):
    name = "TartanAir"
    default_subdir = "TartanAir"
    gt_channels = 2

    def _img1(self, p):
        return osp.join(self.root, p[0], "image_left/{:06d}_left.png".format(p[1]))

    def _img2(self, p):
        return osp.join(self.root, p[0], "image_left/{:06d}_left.png".format(p[2]))

    def _gt(self, p):
        return osp.join(self.root, p[0], "flow/{:06d}_{:06d}_flow.npy".format(p[1], p[2]))

    _load_gt = staticmethod(read_npy)

    def _pairs(self, split):
        assert split == "train", split
        seqs = sorted(os.listdir(self.root))
        pairs = [(osp.join(s, s, diff, P), int(a[:6]), int(a[:6]) + 1)
                 for s in seqs for diff in ("Easy", "Hard")
                 for P in sorted(os.listdir(osp.join(self.root, s, s, diff)))
                 for a in sorted(os.listdir(osp.join(self.root, s, s, diff, P, "image_left")))[:-1]]
        _warn_count(self.name, len(pairs), 306268)
        return pairs


class FlyingThingsFlow(PairDataset):
    name = "FlyingThings"
    default_subdir = "FlyingThings"
    gt_channels = 2

    def _img1(self, p):
        d = p[0].replace("into_future", "").replace("into_past", "")
        return osp.join(self.root, f"frames_{p[3]}pass", d, "{:04d}.png".format(p[1]))

    def _img2(self, p):
        d = p[0].replace("into_future", "").replace("into_past", "")
        return osp.join(self.root, f"frames_{p[3]}pass", d, "{:04d}.png".format(p[2]))

    def _gt(self, p):
        fut = "Future" if "future" in p[0] else "Past"
        cam = "L" if "left" in p[0] else "R"
        return osp.join(self.root, "optical_flow", p[0],
                        f"OpticalFlowInto{fut}_{p[1]:04d}_{cam}.pfm")

    _load_gt = staticmethod(read_pfm_flow)

    def _pairs(self, split):
        m = re.match(r"(train|test|test1024)_(clean|final|all)pass(_rightcam)?$", split)
        assert m, split
        subset, pas, camstr = m.groups()
        cam = "right" if camstr else "left"
        if pas == "all":
            return (self._pairs(f"{subset}_cleanpass{camstr or ''}")
                    + self._pairs(f"{subset}_finalpass{camstr or ''}"))
        set_ = "TRAIN" if subset == "train" else "TEST"
        sroot = osp.join(self.root, "optical_flow", set_)
        fname_to_i = lambda f: int(f[len("OpticalFlowIntoFuture_"):-len("_L.pfm")])
        pp = [(osp.join(set_, d, s, "into_future/left"), fname_to_i(fname))
              for d in sorted(os.listdir(sroot))
              for s in sorted(os.listdir(osp.join(sroot, d)))
              for fname in sorted(os.listdir(osp.join(sroot, d, s, "into_future/left")))[:-1]]
        pairs = [(a, i, i + 1) for a, i in pp]
        pairs += [(a.replace("into_future", "into_past"), i + 1, i) for a, i in pp]
        out = [(a.replace("left", cam), i, j, pas) for a, i, j in pairs]
        if subset == "test1024":
            stride = len(out) // 1024
            remove = len(out) % 1024
            out = sorted(out)[:-remove][::stride] if remove else sorted(out)[::stride]
        return out


class SpringFlow(PairDataset):
    name = "Spring"
    default_subdir = "spring"
    gt_channels = 2

    def _img1(self, p):
        return osp.join(self.root, p[0], p[1], "frame_" + p[3],
                        "frame_{:s}_{:04d}.png".format(p[3], p[4]))

    def _img2(self, p):
        step = 1 if p[2] == "FW" else -1
        return osp.join(self.root, p[0], p[1], "frame_" + p[3],
                        "frame_{:s}_{:04d}.png".format(p[3], p[4] + step))

    def _gt(self, p):
        if p[0] == "test":
            return None
        return osp.join(self.root, p[0], p[1], f"flow_{p[2]}_{p[3]}",
                        f"flow_{p[2]}_{p[3]}_{p[4]:04d}.flo5")

    _load_gt = staticmethod(read_hdf5_flow)

    def _pairs(self, split):
        if split in ("train", "subtrain", "subval"):
            seqs = sorted(os.listdir(osp.join(self.root, "train")))
            pairs = []
            for lr in ("left", "right"):
                for fwbw in ("FW", "BW"):
                    pairs += [("train", s, fwbw, lr,
                               int(f[len(f"flow_{fwbw}_{lr}_"):-len(".flo5")]))
                              for s in seqs
                              for f in sorted(os.listdir(
                                  osp.join(self.root, "train", s, f"flow_{fwbw}_{lr}")))]
            if split == "subtrain":
                return [p for p in pairs if p[1] != "0041"]
            if split == "subval":
                return [p for p in pairs if p[1] == "0041"]
            return pairs
        assert split == "test"
        seqs = sorted(os.listdir(osp.join(self.root, "test")))
        pairs = []
        for lr in ("left", "right"):
            frames = {s: sorted(os.listdir(osp.join(self.root, "test", s, f"frame_{lr}")))[:-1]
                      for s in seqs}
            pairs += [("test", s, "FW", lr, int(f[len(f"frame_{lr}_"):-len(".png")]))
                      for s in seqs for f in frames[s]]
            pairs += [("test", s, "BW", lr, int(f[len(f"frame_{lr}_"):-len(".png")]) + 1)
                      for s in seqs for f in frames[s]]
        return pairs

    def submission_save_pairname(self, p, prediction, outdir, time):
        # flow_{FW,BW}_{left,right}_NNNN.flo5 (datasets_flow.py:285-291)
        assert prediction.ndim == 3 and prediction.shape[2] == 2
        assert prediction.dtype == np.float32
        outfile = osp.join(outdir, p[0], p[1], f"flow_{p[2]}_{p[3]}",
                           f"flow_{p[2]}_{p[3]}_{p[4]:04d}.flo5")
        os.makedirs(osp.dirname(outfile), exist_ok=True)
        write_flo5(outfile, prediction)

    def finalize_submission(self, outdir):
        # Spring requires the organizers' flow_subsampling binary
        # (datasets_flow.py:293-302)
        assert self.split == "test"
        print("Run the Spring flow_subsampling executable to finish:")
        print(f'cd "{outdir}/test"; <flow_subsampling_exe> .')


class Kitti12Flow(Kitti12Stereo):
    gt_channels = 2

    def _img2(self, p):
        return osp.join(self.root, p + "_11.png")

    def _gt(self, p):
        if self.split == "test":
            return None
        return osp.join(self.root, p.replace("/colored_0/", "/flow_occ/") + "_10.png")

    _load_gt = staticmethod(read_kitti_flow)

    def submission_save_pairname(self, p, prediction, outdir, time):
        # <id>_10.png KITTI uint16 flow encoding (datasets_flow.py:326-331)
        assert prediction.ndim == 3 and prediction.shape[2] == 2
        outfile = osp.join(outdir, p.split("/")[-1] + "_10.png")
        os.makedirs(osp.dirname(outfile), exist_ok=True)
        write_kitti_flow(outfile, prediction)

    def finalize_submission(self, outdir):
        assert self.split == "test"
        _zip_dir(outdir, "kitti12_flow_results.zip")


class Kitti15Flow(Kitti15Stereo):
    gt_channels = 2

    def _img2(self, p):
        return osp.join(self.root, p + "_11.png")

    def _gt(self, p):
        if self.split == "test":
            return None
        return osp.join(self.root, p.replace("/image_2/", "/flow_occ/") + "_10.png")

    _load_gt = staticmethod(read_kitti_flow)

    def _pairs(self, split):
        train = ["training/image_2/%06d" % i for i in range(200)]
        if split == "train":
            return train
        if split == "subtrain":
            return train[:-10]  # flow variant keeps 10 for subval (:366-368)
        if split == "subval":
            return train[-10:]
        assert split == "test"
        return ["testing/image_2/%06d" % i for i in range(200)]

    def submission_save_pairname(self, p, prediction, outdir, time):
        # flow/<id>_10.png KITTI uint16 flow encoding (datasets_flow.py:363-369)
        assert prediction.ndim == 3 and prediction.shape[2] == 2
        outfile = osp.join(outdir, "flow", p.split("/")[-1] + "_10.png")
        os.makedirs(osp.dirname(outfile), exist_ok=True)
        write_kitti_flow(outfile, prediction)

    def finalize_submission(self, outdir):
        assert self.split == "test"
        _zip_dir(outdir, "kitti15_flow_results.zip", "flow")


STEREO_DATASETS: Dict[str, type] = {
    "SceneFlow": SceneFlowStereo, "CREStereo": CREStereo,
    "Middlebury2021": Middlebury2021, "Middlebury2014": Middlebury2014,
    "Middlebury2006": Middlebury2006, "Middlebury2005": Middlebury2005,
    "MiddleburyEval3": MdEval3, "Booster": Booster,
    "ETH3DLowRes": ETH3DLowRes, "Spring": SpringStereo,
    "Kitti12": Kitti12Stereo, "Kitti15": Kitti15Stereo,
}
FLOW_DATASETS: Dict[str, type] = {
    "FlyingChairs": FlyingChairs, "FlyingThings": FlyingThingsFlow,
    "MPISintel": MPISintel, "TartanAir": TartanAir, "Spring": SpringFlow,
    "Kitti12": Kitti12Flow, "Kitti15": Kitti15Flow,
}

_SPEC_RE = re.compile(r"^(?:(\d+)\*)?(\w+)\('([\w-]+)'\)$")


def _parse_dataset_str(dataset_str: str, registry: Dict[str, type],
                       augmentor: bool, crop_size) -> List[PairDataset]:
    """\"50*Md21('train')+SceneFlow('train_allpass')\"-style spec, parsed
    WITHOUT eval (the reference evals the string, datasets_stereo.py:664-673)."""
    out = []
    for part in dataset_str.split("+"):
        m = _SPEC_RE.match(part.strip())
        if not m:
            raise ValueError(f"bad dataset spec {part!r}")
        mult, name, split = m.groups()
        if name not in registry:
            raise KeyError(f"unknown dataset {name!r}; have {sorted(registry)}")
        ds = registry[name](split, augmentor=augmentor, crop_size=crop_size)
        if mult:
            ds = int(mult) * ds
        out.append(ds)
    return out


def get_train_dataset_stereo(dataset_str: str, augmentor: bool = True,
                             crop_size=None) -> List[PairDataset]:
    return _parse_dataset_str(dataset_str, STEREO_DATASETS, augmentor, crop_size)


def get_test_datasets_stereo(dataset_str: str) -> List[PairDataset]:
    return _parse_dataset_str(dataset_str, STEREO_DATASETS, False, None)


def get_train_dataset_flow(dataset_str: str, augmentor: bool = True,
                           crop_size=None) -> List[PairDataset]:
    return _parse_dataset_str(dataset_str, FLOW_DATASETS, augmentor, crop_size)


def get_test_datasets_flow(dataset_str: str) -> List[PairDataset]:
    return _parse_dataset_str(dataset_str, FLOW_DATASETS, False, None)
