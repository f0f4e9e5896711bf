"""Vision transforms (paddle_tpu/vision/transforms), a numpy copy of the
JAX package's: host-side, CHW float32 in and out unless a class says
otherwise, random draws from numpy's global generator (``np.random``), so
a seeded run draws what the JAX package's draws.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Compose", "ToTensor", "Normalize", "Resize", "RandomHorizontalFlip",
           "RandomVerticalFlip", "RandomCrop", "CenterCrop", "Transpose",
           "RandomResizedCrop", "BrightnessTransform", "Pad"]


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class ToTensor:
    """HWC uint8 -> CHW float32 in [0,1]."""

    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def __call__(self, img):
        arr = np.asarray(img)
        if arr.dtype == np.uint8:
            arr = arr.astype("float32") / 255.0
        if arr.ndim == 2:
            arr = arr[None]
        elif arr.ndim == 3 and self.data_format == "CHW" and arr.shape[-1] in (1, 3, 4):
            arr = arr.transpose(2, 0, 1)
        return arr.astype("float32")


class Normalize:
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        self.mean = np.asarray(mean, dtype="float32").reshape(-1, 1, 1)
        self.std = np.asarray(std, dtype="float32").reshape(-1, 1, 1)

    def __call__(self, img):
        return ((np.asarray(img, dtype="float32") - self.mean)
                / self.std).astype("float32")


def _resize_chw(img, size):
    c, h, w = img.shape
    oh, ow = size
    ri = (np.arange(oh) * h / oh).astype(int).clip(0, h - 1)
    ci = (np.arange(ow) * w / ow).astype(int).clip(0, w - 1)
    return img[:, ri][:, :, ci]


class Resize:
    def __init__(self, size, interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        return _resize_chw(np.asarray(img), self.size)


class RandomHorizontalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return np.asarray(img)[..., ::-1].copy()
        return img


class RandomVerticalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return np.asarray(img)[..., ::-1, :].copy()
        return img


class RandomCrop:
    def __init__(self, size, padding=0):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def __call__(self, img):
        img = np.asarray(img)
        if self.padding:
            p = self.padding
            img = np.pad(img, [(0, 0), (p, p), (p, p)])
        c, h, w = img.shape
        th, tw = self.size
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        return img[:, i:i + th, j:j + tw]


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        img = np.asarray(img)
        c, h, w = img.shape
        th, tw = self.size
        i = (h - th) // 2
        j = (w - tw) // 2
        return img[:, i:i + th, j:j + tw]


class RandomResizedCrop:
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio

    def __call__(self, img):
        img = np.asarray(img)
        c, h, w = img.shape
        area = h * w
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            ar = np.random.uniform(*self.ratio)
            tw = int(round(np.sqrt(target * ar)))
            th = int(round(np.sqrt(target / ar)))
            if th <= h and tw <= w:
                i = np.random.randint(0, h - th + 1)
                j = np.random.randint(0, w - tw + 1)
                return _resize_chw(img[:, i:i + th, j:j + tw], self.size)
        return _resize_chw(img, self.size)


class Transpose:
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def __call__(self, img):
        return np.asarray(img).transpose(self.order)


class BrightnessTransform:
    def __init__(self, value):
        self.value = value

    def __call__(self, img):
        if self.value == 0:
            return img
        alpha = 1 + np.random.uniform(-self.value, self.value)
        return (np.asarray(img) * alpha).astype("float32")


class Pad:
    def __init__(self, padding, fill=0):
        self.padding = padding
        self.fill = fill

    def __call__(self, img):
        p = self.padding
        return np.pad(np.asarray(img), [(0, 0), (p, p), (p, p)],
                      constant_values=self.fill)


# -- round-4 breadth: color/rotation transforms (reference
#    transforms.py ColorJitter :838, RandomRotation :1012, Grayscale
#    :1104 and the Saturation/Contrast/Hue singles) ------------------------

__all__ += ["SaturationTransform", "ContrastTransform", "HueTransform",
            "ColorJitter", "RandomRotation", "Grayscale", "BaseTransform"]

_R, _G, _B = 0.299, 0.587, 0.114   # ITU-R 601 luma


class BaseTransform:
    """reference BaseTransform: keys-aware callable base; subclasses
    implement _apply_image."""

    def __init__(self, keys=None):
        self.keys = keys

    def __call__(self, img):
        return self._apply_image(img)

    def _apply_image(self, img):
        raise NotImplementedError


def _chw(img):
    arr = np.asarray(img, "float32")
    if arr.ndim == 2:
        return arr[None], True, False
    if arr.shape[0] in (1, 3, 4):
        return arr, False, False
    return arr.transpose(2, 0, 1), False, True     # HWC in


def _un_chw(arr, was2d, was_hwc):
    if was2d:
        return arr[0]
    if was_hwc:
        return arr.transpose(1, 2, 0)
    return arr


def _grayscale(chw):
    if chw.shape[0] < 3:
        return chw[:1]
    return (_R * chw[0] + _G * chw[1] + _B * chw[2])[None]


class SaturationTransform:
    def __init__(self, value, keys=None):
        self.value = float(value)

    def __call__(self, img):
        chw, a, b = _chw(img)
        f = 1.0 + np.random.uniform(-self.value, self.value)
        gray = _grayscale(chw)
        out = gray + (chw - gray) * f
        return _un_chw(out.astype("float32"), a, b)


class ContrastTransform:
    def __init__(self, value, keys=None):
        self.value = float(value)

    def __call__(self, img):
        chw, a, b = _chw(img)
        f = 1.0 + np.random.uniform(-self.value, self.value)
        mean = _grayscale(chw).mean()
        out = mean + (chw - mean) * f
        return _un_chw(out.astype("float32"), a, b)


class HueTransform:
    """Hue rotation in YIQ space (reference adjust_hue PIL path; this is
    the standard matrix formulation, exact for small angles)."""

    def __init__(self, value, keys=None):
        if not 0 <= value <= 0.5:
            raise ValueError("hue value must be in [0, 0.5]")
        self.value = float(value)

    def __call__(self, img):
        chw, a, b = _chw(img)
        if chw.shape[0] < 3:
            return _un_chw(chw, a, b)
        theta = np.random.uniform(-self.value, self.value) * 2 * np.pi
        cos, sin = np.cos(theta), np.sin(theta)
        t_yiq = np.array([[_R, _G, _B],
                          [0.596, -0.274, -0.322],
                          [0.211, -0.523, 0.312]], "float32")
        rot = np.array([[1, 0, 0], [0, cos, -sin], [0, sin, cos]],
                       "float32")
        m = np.linalg.inv(t_yiq) @ rot @ t_yiq
        flat = chw[:3].reshape(3, -1)
        out = (m @ flat).reshape(chw[:3].shape)
        if chw.shape[0] > 3:
            out = np.concatenate([out, chw[3:]], axis=0)
        return _un_chw(out.astype("float32"), a, b)


class ColorJitter:
    """Randomly-ordered brightness/contrast/saturation/hue jitter
    (reference ColorJitter)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        self.ts = []
        if brightness:
            self.ts.append(BrightnessTransform(brightness))
        if contrast:
            self.ts.append(ContrastTransform(contrast))
        if saturation:
            self.ts.append(SaturationTransform(saturation))
        if hue:
            self.ts.append(HueTransform(hue))

    def __call__(self, img):
        for i in np.random.permutation(len(self.ts)):
            img = self.ts[int(i)](img)
        return img


class Grayscale:
    def __init__(self, num_output_channels=1, keys=None):
        self.n = int(num_output_channels)

    def __call__(self, img):
        chw, a, b = _chw(img)
        g = _grayscale(chw)
        out = np.repeat(g, self.n, axis=0) if self.n > 1 else g
        return _un_chw(out.astype("float32"), a, b)


class RandomRotation:
    """Rotate by a uniform random angle (nearest-neighbor resampling about
    the image center — reference RandomRotation's cv2/PIL rotate)."""

    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        if np.isscalar(degrees):
            if degrees < 0:
                raise ValueError("degrees must be non-negative")
            self.degrees = (-float(degrees), float(degrees))
        else:
            self.degrees = (float(degrees[0]), float(degrees[1]))
        self.fill = fill

    def __call__(self, img):
        chw, a, b = _chw(img)
        angle = np.deg2rad(np.random.uniform(*self.degrees))
        c, h, w = chw.shape
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        # inverse map: output pixel -> source pixel
        cos, sin = np.cos(angle), np.sin(angle)
        sy = cy + (yy - cy) * cos - (xx - cx) * sin
        sx = cx + (yy - cy) * sin + (xx - cx) * cos
        iy = np.round(sy).astype(int)
        ix = np.round(sx).astype(int)
        inb = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
        out = np.full_like(chw, float(self.fill))
        src = chw[:, iy.clip(0, h - 1), ix.clip(0, w - 1)]
        out = np.where(inb[None], src, out)
        return _un_chw(out.astype("float32"), a, b)
