"""Stereo/flow training augmentations (host-side data pipeline): the port's
own copy of the JAX package's `stereoflow/augmentor.py`.

Parity target: extern/dust3r/croco/stereoflow/augmentor.py:
  - StereoAugmentor (:25-157): random x-scale (low/high-res regimes split at
    lhth=800), random crop, vertical flip, right-image rotate/shift jitter,
    asymmetric photometric aug (contrast/gamma/brightness/hue/saturation,
    one-or-all in random order);
  - FlowAugmentor (:161-290): random scale and stretch, h/v flips (the
    flow's signs fixed up), sparse-aware flow resize (splatting the valid
    samples), ColorJitter.

Dataloader code, host-side numpy/cv2/PIL as in the reference. torchvision's
functional colour ops are written out with their documented semantics
(blend-with-mean contrast, blend-with-gray saturation, HSV hue shift, LUT
gamma). Randomness comes from an explicit np.random.Generator, so that a
pipeline is seedable per worker and draws what the JAX package's draws.
cv2 and PIL are imported where they are used: the port imports on a machine
that has neither.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _cv2():
    import cv2

    cv2.setNumThreads(0)
    return cv2


# ---------------------------------------------------------------------------
# torchvision.transforms.functional color ops on uint8 HWC numpy images
# ---------------------------------------------------------------------------


def _blend(a: np.ndarray, b: np.ndarray, f: float) -> np.ndarray:
    out = a.astype(np.float32) * f + b.astype(np.float32) * (1.0 - f)
    return np.clip(out, 0, 255).astype(np.uint8)


def _gray(img: np.ndarray) -> np.ndarray:
    # ITU-R 601-2 luma, matching PIL Image.convert("L")
    g = img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
    return g.astype(np.uint8)


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return _blend(img, np.zeros_like(img), factor)


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    mean = round(_gray(img).mean())
    return _blend(img, np.full_like(img, mean), factor)


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    return _blend(img, _gray(img)[..., None].repeat(3, axis=-1), factor)


def adjust_gamma(img: np.ndarray, gamma: float, gain: float = 1.0) -> np.ndarray:
    lut = np.clip(255.0 * gain * (np.arange(256) / 255.0) ** gamma, 0, 255)
    return lut.astype(np.uint8)[img]


def adjust_hue(img: np.ndarray, hue_factor: float) -> np.ndarray:
    """hue_factor in [-0.5, 0.5]: shift the HSV hue channel (torchvision
    semantics: uint8 H wraps mod 256)."""
    assert -0.5 <= hue_factor <= 0.5, hue_factor
    from PIL import Image

    hsv = np.array(Image.fromarray(img, "RGB").convert("HSV"))
    hsv[..., 0] = (hsv[..., 0].astype(np.int16) + int(hue_factor * 255)) % 256
    return np.array(Image.fromarray(hsv, "HSV").convert("RGB"))


class ColorJitter:
    """torchvision ColorJitter: each enabled op applied in random order with
    a uniformly-sampled factor."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0,
                 rng: Optional[np.random.Generator] = None):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.rng = rng or np.random.default_rng()

    def __call__(self, img: np.ndarray) -> np.ndarray:
        r = self.rng
        ops = []
        if self.brightness > 0:
            f = r.uniform(max(0.0, 1 - self.brightness), 1 + self.brightness)
            ops.append(lambda im: adjust_brightness(im, f))
        if self.contrast > 0:
            f2 = r.uniform(max(0.0, 1 - self.contrast), 1 + self.contrast)
            ops.append(lambda im: adjust_contrast(im, f2))
        if self.saturation > 0:
            f3 = r.uniform(max(0.0, 1 - self.saturation), 1 + self.saturation)
            ops.append(lambda im: adjust_saturation(im, f3))
        if self.hue > 0:
            f4 = r.uniform(-self.hue, self.hue)
            ops.append(lambda im: adjust_hue(im, f4))
        order = r.permutation(len(ops))
        for i in order:
            img = ops[i](img)
        return img


# ---------------------------------------------------------------------------
# Stereo
# ---------------------------------------------------------------------------


class StereoAugmentor:
    """augmentor.py:25-157. img1/img2 are HWC uint8-range float or uint8;
    disp is (H, W) float with inf at invalid pixels."""

    def __init__(self, crop_size: Tuple[int, int], scale_prob=0.5, scale_xonly=True,
                 lhth=800.0, lminscale=0.0, lmaxscale=1.0, hminscale=-0.2,
                 hmaxscale=0.4, scale_interp_nearest=True, rightjitterprob=0.5,
                 v_flip_prob=0.5, color_aug_asym=True, color_choice_prob=0.5,
                 rng: Optional[np.random.Generator] = None):
        self.crop_size = crop_size
        self.scale_prob = scale_prob
        self.scale_xonly = scale_xonly
        self.lhth = lhth
        self.lminscale, self.lmaxscale = lminscale, lmaxscale
        self.hminscale, self.hmaxscale = hminscale, hmaxscale
        self.scale_interp_nearest = scale_interp_nearest
        self.rightjitterprob = rightjitterprob
        self.v_flip_prob = v_flip_prob
        self.color_aug_asym = color_aug_asym
        self.color_choice_prob = color_choice_prob
        self.rng = rng or np.random.default_rng()

    def _scale(self, img1, img2, disp):
        ch, cw = self.crop_size
        h, w = img1.shape[:2]
        r = self.rng
        if self.scale_prob > 0 and r.random() < self.scale_prob:
            lo, hi = ((self.lminscale, self.lmaxscale) if min(h, w) < self.lhth
                      else (self.hminscale, self.hmaxscale))
            sx = float(np.clip(2.0 ** r.uniform(lo, hi), (cw + 8) / w, None))
            sy = 1.0 if self.scale_xonly else float(np.clip(sx, (ch + 8) / h, None))
        else:
            sx = (cw + 8) / w
            if sx <= 1.0:
                return img1, img2, disp
            sy = 1.0 if self.scale_xonly else sx
        cv2 = _cv2()
        interp = cv2.INTER_NEAREST if self.scale_interp_nearest else cv2.INTER_LINEAR
        img1 = cv2.resize(img1, None, fx=sx, fy=sy, interpolation=cv2.INTER_LINEAR)
        img2 = cv2.resize(img2, None, fx=sx, fy=sy, interpolation=cv2.INTER_LINEAR)
        disp = cv2.resize(disp, None, fx=sx, fy=sy, interpolation=interp) * sx
        return img1, img2, disp

    def _crop(self, img1, img2, disp):
        h, w = img1.shape[:2]
        ch, cw = self.crop_size
        assert ch <= h and cw <= w, (img1.shape, self.crop_size)
        ox = int(self.rng.integers(w - cw + 1))
        oy = int(self.rng.integers(h - ch + 1))
        return (img1[oy:oy + ch, ox:ox + cw], img2[oy:oy + ch, ox:ox + cw],
                disp[oy:oy + ch, ox:ox + cw])

    def _vflip(self, img1, img2, disp):
        if self.v_flip_prob > 0 and self.rng.random() < self.v_flip_prob:
            return (np.ascontiguousarray(img1[::-1]),
                    np.ascontiguousarray(img2[::-1]),
                    np.ascontiguousarray(disp[::-1]))
        return img1, img2, disp

    def _right_jitter(self, img2):
        """Small random rotation+vertical shift of the right image only
        (augmentor.py:86-96) — simulates imperfect rectification."""
        if self.rightjitterprob > 0 and self.rng.random() < self.rightjitterprob:
            r = self.rng
            px = r.uniform(-2.0, 2.0)
            ag = r.uniform(-0.1, 0.1)
            center = (r.uniform(0, img2.shape[0]), r.uniform(0, img2.shape[1]))
            cv2 = _cv2()
            rot = cv2.getRotationMatrix2D(center, ag, 1.0)
            img2 = cv2.warpAffine(img2, rot, img2.shape[1::-1], flags=cv2.INTER_LINEAR)
            trans = np.float32([[1, 0, 0], [0, 1, px]])
            img2 = cv2.warpAffine(img2, trans, img2.shape[1::-1], flags=cv2.INTER_LINEAR)
        return img2

    def _color_pair(self, img1, img2, op, lo, hi):
        r = self.rng
        if r.random() < 0.5:
            f = r.uniform(lo, hi)
            img1 = op(img1, f)
            if self.color_aug_asym and r.random() < 0.5:
                f = r.uniform(lo, hi)
            img2 = op(img2, f)
        return img1, img2

    def _color(self, img1, img2):
        img1 = np.clip(img1, 0, 255).astype(np.uint8)
        img2 = np.clip(img2, 0, 255).astype(np.uint8)
        trfs = [
            lambda a, b: self._color_pair(a, b, adjust_contrast, 0.8, 1.2),
            lambda a, b: self._color_pair(a, b, adjust_gamma, 0.7, 1.5),
            lambda a, b: self._color_pair(a, b, adjust_brightness, 0.5, 2.0),
            lambda a, b: self._color_pair(a, b, adjust_hue, -0.1, 0.1),
            lambda a, b: self._color_pair(a, b, adjust_saturation, 0.8, 1.2),
        ]
        if self.rng.random() < self.color_choice_prob:
            img1, img2 = trfs[int(self.rng.integers(len(trfs)))](img1, img2)
        else:
            order = self.rng.permutation(len(trfs))
            for i in order:
                img1, img2 = trfs[i](img1, img2)
        return img1.astype(np.float32), img2.astype(np.float32)

    def __call__(self, img1, img2, disp, dataset_name: str = ""):
        img1, img2, disp = self._scale(img1, img2, disp)
        img1, img2, disp = self._crop(img1, img2, disp)
        img1, img2, disp = self._vflip(img1, img2, disp)
        img2 = self._right_jitter(img2)
        img1, img2 = self._color(img1, img2)
        return img1, img2, disp


# ---------------------------------------------------------------------------
# Flow
# ---------------------------------------------------------------------------


def resize_sparse_flow(flow: np.ndarray, sx: float, sy: float,
                       factor: float = 1.0) -> np.ndarray:
    """Resize a flow map with inf-marked invalid pixels by splatting valid
    samples onto the new grid (augmentor.py:202-232)."""
    ht, wd = flow.shape[:2]
    coords = np.stack(np.meshgrid(np.arange(wd), np.arange(ht)), axis=-1)
    coords = coords.reshape(-1, 2).astype(np.float32)
    f = flow.reshape(-1, 2).astype(np.float32)
    valid = np.isfinite(f[:, 0])
    c0, f0 = coords[valid], f[valid]
    ht1 = int(round(ht * sy / factor))
    wd1 = int(round(wd * sx / factor))
    rescale = np.array([[sx, sy]], np.float32)
    c1 = c0 * rescale / factor
    f1 = f0 * rescale
    xx = np.round(c1[:, 0]).astype(np.int32)
    yy = np.round(c1[:, 1]).astype(np.int32)
    keep = (xx > 0) & (xx < wd1) & (yy > 0) & (yy < ht1)
    out = np.full((ht1, wd1, 2), np.inf, np.float32)
    out[yy[keep], xx[keep]] = f1[keep]
    return out


class FlowAugmentor:
    """augmentor.py:161-290. flow is (H, W, 2) float with inf at invalid."""

    def __init__(self, crop_size: Tuple[int, int], min_scale=-0.2, max_scale=0.5,
                 spatial_aug_prob=0.8, stretch_prob=0.8, max_stretch=0.2,
                 h_flip_prob=0.5, v_flip_prob=0.1, asymmetric_color_aug_prob=0.2,
                 rng: Optional[np.random.Generator] = None):
        self.crop_size = crop_size
        self.min_scale, self.max_scale = min_scale, max_scale
        self.spatial_aug_prob = spatial_aug_prob
        self.stretch_prob = stretch_prob
        self.max_stretch = max_stretch
        self.h_flip_prob = h_flip_prob
        self.v_flip_prob = v_flip_prob
        self.asymmetric_color_aug_prob = asymmetric_color_aug_prob
        self.rng = rng or np.random.default_rng()
        self.photo_aug = ColorJitter(0.4, 0.4, 0.4, 0.5 / 3.14, rng=self.rng)

    def _resize_flow(self, flow, sx, sy, factor=1.0):
        if np.all(np.isfinite(flow)):
            cv2 = _cv2()
            flow = cv2.resize(flow, None, fx=sx / factor, fy=sy / factor,
                              interpolation=cv2.INTER_LINEAR)
            return flow * np.array([sx, sy], np.float32)
        return resize_sparse_flow(flow, sx, sy, factor)

    def spatial_transform(self, img1, img2, flow, dname: str = ""):
        r = self.rng
        if r.random() < self.spatial_aug_prob:
            ht, wd = img1.shape[:2]
            clip_min = max((self.crop_size[0] + 8) / ht, (self.crop_size[1] + 8) / wd)
            scale = 2.0 ** r.uniform(self.min_scale, self.max_scale)
            sx = sy = scale
            if r.random() < self.stretch_prob:
                sx *= 2.0 ** r.uniform(-self.max_stretch, self.max_stretch)
                sy *= 2.0 ** r.uniform(-self.max_stretch, self.max_stretch)
            sx = float(np.clip(sx, clip_min, None))
            sy = float(np.clip(sy, clip_min, None))
            cv2 = _cv2()
            img1 = cv2.resize(img1, None, fx=sx, fy=sy, interpolation=cv2.INTER_LINEAR)
            img2 = cv2.resize(img2, None, fx=sx, fy=sy, interpolation=cv2.INTER_LINEAR)
            flow = self._resize_flow(flow, sx, sy,
                                     factor=2.0 if dname == "Spring" else 1.0)
        elif dname == "Spring":
            flow = self._resize_flow(flow, 1.0, 1.0, factor=2.0)

        if self.h_flip_prob > 0 and r.random() < self.h_flip_prob:
            img1, img2 = img1[:, ::-1], img2[:, ::-1]
            flow = flow[:, ::-1] * np.array([-1.0, 1.0], np.float32)
        if self.v_flip_prob > 0 and r.random() < self.v_flip_prob:
            img1, img2 = img1[::-1], img2[::-1]
            flow = flow[::-1] * np.array([1.0, -1.0], np.float32)

        y0 = int(r.integers(0, max(img1.shape[0] - self.crop_size[0], 0) + 1))
        x0 = int(r.integers(0, max(img1.shape[1] - self.crop_size[1], 0) + 1))
        img1 = img1[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        img2 = img2[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        flow = flow[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        return img1, img2, flow

    def color_transform(self, img1, img2):
        img1 = np.clip(img1, 0, 255).astype(np.uint8)
        img2 = np.clip(img2, 0, 255).astype(np.uint8)
        if self.rng.random() < self.asymmetric_color_aug_prob:
            img1 = self.photo_aug(img1)
            img2 = self.photo_aug(img2)
        else:
            stack = self.photo_aug(np.concatenate([img1, img2], axis=0))
            img1, img2 = np.split(stack, 2, axis=0)
        return img1, img2

    def __call__(self, img1, img2, flow, dname: str = ""):
        img1, img2, flow = self.spatial_transform(img1, img2, flow, dname)
        img1, img2 = self.color_transform(img1, img2)
        return (np.ascontiguousarray(img1, np.float32),
                np.ascontiguousarray(img2, np.float32),
                np.ascontiguousarray(flow, np.float32))
