"""Image transforms — counterpart of ``paddle_tpu/vision/transforms.py``
(python/paddle/vision/transforms/ in Paddle), the port's own copy.

Pure numpy on HWC images (uint8 or float), so they are safe inside
DataLoader worker processes. ``ToTensor`` produces CHW float32 numpy
(the DataLoader's collate makes the batch a tensor).

The random transforms draw from Python's ``random`` module in the
reference's order, so under one ``random.seed`` both packages crop and
flip alike. Each also takes ``rng``, a ``random.Random`` of its own
(PyTorch's idiom for a reproducible pipeline); without one the draw is
the module's.
"""

from __future__ import annotations

import numbers
import random as pyrandom
from typing import Sequence

import numpy as np

__all__ = ["Compose", "BaseTransform", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomCrop", "RandomHorizontalFlip",
           "RandomVerticalFlip", "RandomResizedCrop", "Transpose", "Pad",
           "BrightnessTransform", "ContrastTransform", "Grayscale",
           "to_tensor", "normalize", "resize", "center_crop", "hflip", "vflip",
           "crop", "pad"]

_IMAGE_BACKEND = "numpy"


def _hwc(img) -> np.ndarray:
    a = np.asarray(img)
    if a.ndim == 2:
        a = a[:, :, None]
    if a.ndim != 3:
        raise ValueError(f"expected HW or HWC image, got shape {a.shape}")
    return a


# -- functional --------------------------------------------------------------

def to_tensor(img, data_format: str = "CHW") -> np.ndarray:
    a = _hwc(img).astype(np.float32)
    if np.issubdtype(np.asarray(img).dtype, np.integer):
        a = a / 255.0
    if data_format.upper() == "CHW":
        a = np.transpose(a, (2, 0, 1))
    return a


def normalize(img, mean, std, data_format: str = "CHW", to_rgb: bool = False):
    a = np.asarray(img, np.float32)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if data_format.upper() == "CHW":
        return (a - mean[:, None, None]) / std[:, None, None]
    return (a - mean) / std


def _resize_bilinear(a: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    h, w, c = a.shape
    if (h, w) == (out_h, out_w):
        return a
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    af = a.astype(np.float32)
    top = af[y0][:, x0] * (1 - wx) + af[y0][:, x1] * wx
    bot = af[y1][:, x0] * (1 - wx) + af[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    return out.astype(a.dtype) if np.issubdtype(a.dtype, np.floating) \
        else np.clip(np.round(out), 0, 255).astype(a.dtype)


def resize(img, size, interpolation: str = "bilinear"):
    a = _hwc(img)
    h, w = a.shape[:2]
    if isinstance(size, numbers.Number):
        # short side -> size, keep aspect (reference semantics)
        if h <= w:
            oh, ow = int(size), max(1, int(round(w * size / h)))
        else:
            oh, ow = max(1, int(round(h * size / w))), int(size)
    else:
        oh, ow = int(size[0]), int(size[1])
    if interpolation == "nearest":
        yi = np.clip((np.arange(oh) * h / oh).astype(np.int64), 0, h - 1)
        xi = np.clip((np.arange(ow) * w / ow).astype(np.int64), 0, w - 1)
        return a[yi][:, xi]
    return _resize_bilinear(a, oh, ow)


def crop(img, top: int, left: int, height: int, width: int):
    return _hwc(img)[top:top + height, left:left + width]


def center_crop(img, output_size):
    a = _hwc(img)
    if isinstance(output_size, numbers.Number):
        output_size = (int(output_size), int(output_size))
    th, tw = output_size
    h, w = a.shape[:2]
    return crop(a, max(0, (h - th) // 2), max(0, (w - tw) // 2), th, tw)


def hflip(img):
    return _hwc(img)[:, ::-1]


def vflip(img):
    return _hwc(img)[::-1]


def pad(img, padding, fill=0, padding_mode: str = "constant"):
    a = _hwc(img)
    if isinstance(padding, numbers.Number):
        pl = pt = pr = pb = int(padding)
    elif len(padding) == 2:
        pl = pr = int(padding[0])
        pt = pb = int(padding[1])
    else:
        pl, pt, pr, pb = (int(p) for p in padding)
    if padding_mode == "constant":
        return np.pad(a, ((pt, pb), (pl, pr), (0, 0)), constant_values=fill)
    return np.pad(a, ((pt, pb), (pl, pr), (0, 0)), mode=padding_mode)


# -- transform classes -------------------------------------------------------

def _draw(t):
    """The random source of transform ``t``: its own ``random.Random``, or
    the ``random`` module (the reference's draw)."""
    return pyrandom if t.rng is None else t.rng


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(img)

    def _apply_image(self, img):
        raise NotImplementedError


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class ToTensor(BaseTransform):
    def __init__(self, data_format: str = "CHW", keys=None):
        self.data_format = data_format

    def _apply_image(self, img):
        return to_tensor(img, self.data_format)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format: str = "CHW",
                 to_rgb: bool = False, keys=None):
        if isinstance(mean, numbers.Number):
            mean = [mean] * 3
        if isinstance(std, numbers.Number):
            std = [std] * 3
        self.mean = mean
        self.std = std
        self.data_format = data_format

    def _apply_image(self, img):
        return normalize(img, self.mean, self.std, self.data_format)


class Resize(BaseTransform):
    def __init__(self, size, interpolation: str = "bilinear", keys=None):
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        return resize(img, self.size, self.interpolation)


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        self.size = size

    def _apply_image(self, img):
        return center_crop(img, self.size)


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed: bool = False,
                 fill=0, padding_mode: str = "constant", keys=None, rng=None):
        self.rng = rng
        if isinstance(size, numbers.Number):
            size = (int(size), int(size))
        self.size = size
        self.padding = padding
        self.pad_if_needed = pad_if_needed
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        a = _hwc(img)
        if self.padding is not None:
            a = pad(a, self.padding, self.fill, self.padding_mode)
        th, tw = self.size
        h, w = a.shape[:2]
        if self.pad_if_needed and (h < th or w < tw):
            a = pad(a, (0, 0, max(0, tw - w), max(0, th - h)), self.fill,
                    self.padding_mode)
            h, w = a.shape[:2]
        top = _draw(self).randint(0, max(0, h - th))
        left = _draw(self).randint(0, max(0, w - tw))
        return crop(a, top, left, th, tw)


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob: float = 0.5, keys=None, rng=None):
        self.rng = rng
        self.prob = prob

    def _apply_image(self, img):
        return hflip(img) if _draw(self).random() < self.prob else _hwc(img)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob: float = 0.5, keys=None, rng=None):
        self.rng = rng
        self.prob = prob

    def _apply_image(self, img):
        return vflip(img) if _draw(self).random() < self.prob else _hwc(img)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation: str = "bilinear", keys=None, rng=None):
        self.rng = rng
        if isinstance(size, numbers.Number):
            size = (int(size), int(size))
        self.size = size
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _apply_image(self, img):
        import math
        a = _hwc(img)
        h, w = a.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * _draw(self).uniform(*self.scale)
            ar = math.exp(_draw(self).uniform(math.log(self.ratio[0]),
                                           math.log(self.ratio[1])))
            cw = int(round(math.sqrt(target * ar)))
            ch = int(round(math.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                top = _draw(self).randint(0, h - ch)
                left = _draw(self).randint(0, w - cw)
                return resize(crop(a, top, left, ch, cw), self.size,
                              self.interpolation)
        return resize(center_crop(a, min(h, w)), self.size, self.interpolation)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        self.order = tuple(order)

    def _apply_image(self, img):
        return np.transpose(_hwc(img), self.order)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode: str = "constant",
                 keys=None):
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        return pad(img, self.padding, self.fill, self.padding_mode)


class BrightnessTransform(BaseTransform):
    def __init__(self, value: float, keys=None, rng=None):
        self.rng = rng
        self.value = float(value)

    def _apply_image(self, img):
        a = _hwc(img).astype(np.float32)
        factor = 1.0 + _draw(self).uniform(-self.value, self.value)
        out = a * factor
        if np.issubdtype(np.asarray(img).dtype, np.integer):
            return np.clip(out, 0, 255).astype(np.uint8)
        return out


class ContrastTransform(BaseTransform):
    def __init__(self, value: float, keys=None, rng=None):
        self.rng = rng
        self.value = float(value)

    def _apply_image(self, img):
        a = _hwc(img).astype(np.float32)
        factor = 1.0 + _draw(self).uniform(-self.value, self.value)
        mean = a.mean()
        out = (a - mean) * factor + mean
        if np.issubdtype(np.asarray(img).dtype, np.integer):
            return np.clip(out, 0, 255).astype(np.uint8)
        return out


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels: int = 1, keys=None):
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        a = _hwc(img).astype(np.float32)
        gray = (0.299 * a[..., 0] + 0.587 * a[..., 1] + 0.114 * a[..., 2])
        out = np.repeat(gray[..., None], self.num_output_channels, axis=-1)
        if np.issubdtype(np.asarray(img).dtype, np.integer):
            return np.clip(out, 0, 255).astype(np.uint8)
        return out


# ---------------------------------------------------------------------------
# r5: the remaining functional transform surface (ref:
# python/paddle/vision/transforms/functional.py). Host-side numpy by design
# — augmentation runs in the DataLoader workers; the card sees the batched
# result (SURVEY §2.3 vision row). All take HWC or CHW arrays and preserve
# layout/dtype conventions of the existing functionals above.
# ---------------------------------------------------------------------------

def _apply_hwc(img, fn):
    a = np.asarray(img)
    chw = a.ndim == 3 and a.shape[0] in (1, 3) and a.shape[-1] not in (1, 3)
    h = a.transpose(1, 2, 0) if chw else a
    out = fn(h.astype(np.float32))
    if chw:
        out = out.transpose(2, 0, 1)
    if np.issubdtype(a.dtype, np.integer):
        return np.clip(out, 0, 255).astype(np.uint8)
    return out.astype(a.dtype)


def adjust_brightness(img, brightness_factor: float):
    """Scale pixel intensities (ref: F.adjust_brightness)."""
    return _apply_hwc(img, lambda a: a * brightness_factor)


def adjust_contrast(img, contrast_factor: float):
    """Interpolate toward the grayscale mean (ref: F.adjust_contrast)."""
    def f(a):
        gray = 0.299 * a[..., 0] + 0.587 * a[..., 1] + 0.114 * a[..., 2]
        mean = gray.mean()
        return (a - mean) * contrast_factor + mean
    return _apply_hwc(img, f)


def adjust_saturation(img, saturation_factor: float):
    """Interpolate toward the per-pixel grayscale (ref:
    F.adjust_saturation)."""
    def f(a):
        gray = (0.299 * a[..., 0] + 0.587 * a[..., 1]
                + 0.114 * a[..., 2])[..., None]
        return (a - gray) * saturation_factor + gray
    return _apply_hwc(img, f)


def adjust_hue(img, hue_factor: float):
    """Rotate hue by ``hue_factor`` (in [-0.5, 0.5] turns; ref:
    F.adjust_hue) via RGB->HSV->RGB."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")

    def f(a):
        scale = 255.0 if a.max() > 1.5 else 1.0
        x = a / scale
        mx = x.max(-1)
        mn = x.min(-1)
        diff = mx - mn + 1e-12
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        h = np.where(mx == r, ((g - b) / diff) % 6,
                     np.where(mx == g, (b - r) / diff + 2,
                              (r - g) / diff + 4)) / 6.0
        s = np.where(mx > 0, diff / (mx + 1e-12), 0)
        v = mx
        h = (h + hue_factor) % 1.0
        i = np.floor(h * 6)
        fpart = h * 6 - i
        p = v * (1 - s)
        q = v * (1 - fpart * s)
        t = v * (1 - (1 - fpart) * s)
        i = i.astype(np.int32) % 6
        rgb = np.stack([
            np.choose(i, [v, q, p, p, t, v]),
            np.choose(i, [t, v, v, q, p, p]),
            np.choose(i, [p, p, t, v, v, q]),
        ], -1)
        return rgb * scale
    return _apply_hwc(img, f)


def to_grayscale(img, num_output_channels: int = 1):
    """Luma grayscale (ref: F.to_grayscale)."""
    def f(a):
        gray = 0.299 * a[..., 0] + 0.587 * a[..., 1] + 0.114 * a[..., 2]
        return np.repeat(gray[..., None], num_output_channels, -1)
    return _apply_hwc(img, f)


def rotate(img, angle: float, interpolation: str = "nearest",
           expand: bool = False, center=None, fill=0):
    """Rotate about the center (ref: F.rotate). Inverse-map + nearest or
    bilinear sampling, numpy only."""
    def f(a):
        H, W = a.shape[:2]
        cy, cx = ((H - 1) / 2.0, (W - 1) / 2.0) if center is None \
            else (center[1], center[0])
        th = np.deg2rad(angle)
        cos, sin = np.cos(th), np.sin(th)
        if expand:
            corners = np.array([[-cx, -cy], [W - 1 - cx, -cy],
                                [-cx, H - 1 - cy], [W - 1 - cx, H - 1 - cy]])
            rot = corners @ np.array([[cos, -sin], [sin, cos]]).T
            OW = int(np.ceil(rot[:, 0].max() - rot[:, 0].min() + 1))
            OH = int(np.ceil(rot[:, 1].max() - rot[:, 1].min() + 1))
            ocx, ocy = (OW - 1) / 2.0, (OH - 1) / 2.0
        else:
            OH, OW, ocx, ocy = H, W, cx, cy
        yy, xx = np.meshgrid(np.arange(OH), np.arange(OW), indexing="ij")
        dx = xx - ocx
        dy = yy - ocy
        sx = cos * dx + sin * dy + cx
        sy = -sin * dx + cos * dy + cy
        if interpolation == "bilinear":
            x0 = np.floor(sx).astype(int)
            y0 = np.floor(sy).astype(int)
            wx = sx - x0
            wy = sy - y0
            out = np.zeros((OH, OW, a.shape[2]), np.float32)
            for (yi, xi, w) in ((y0, x0, (1 - wy) * (1 - wx)),
                                (y0, x0 + 1, (1 - wy) * wx),
                                (y0 + 1, x0, wy * (1 - wx)),
                                (y0 + 1, x0 + 1, wy * wx)):
                ok = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
                yc = np.clip(yi, 0, H - 1)
                xc = np.clip(xi, 0, W - 1)
                out += np.where(ok[..., None],
                                a[yc, xc] * w[..., None], 0)
            ok_any = (sy >= -0.5) & (sy <= H - 0.5) & \
                (sx >= -0.5) & (sx <= W - 0.5)
            return np.where(ok_any[..., None], out, fill)
        xi = np.round(sx).astype(int)
        yi = np.round(sy).astype(int)
        ok = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        return np.where(ok[..., None],
                        a[np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)],
                        fill)
    return _apply_hwc(img, f)


def perspective(img, startpoints, endpoints, interpolation: str = "nearest",
                fill=0):
    """Perspective warp mapping ``startpoints`` -> ``endpoints`` (ref:
    F.perspective); solves the 8-dof homography then inverse-samples."""
    sp = np.asarray(startpoints, np.float64)
    ep = np.asarray(endpoints, np.float64)
    # solve homography from endpoints back to startpoints (inverse map)
    A, bvec = [], []
    for (xs, ys), (xd, yd) in zip(sp, ep):
        A.append([xd, yd, 1, 0, 0, 0, -xs * xd, -xs * yd])
        bvec.append(xs)
        A.append([0, 0, 0, xd, yd, 1, -ys * xd, -ys * yd])
        bvec.append(ys)
    hcoef = np.linalg.solve(np.asarray(A), np.asarray(bvec))
    Hm = np.append(hcoef, 1.0).reshape(3, 3)

    def f(a):
        H, W = a.shape[:2]
        yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        den = Hm[2, 0] * xx + Hm[2, 1] * yy + Hm[2, 2]
        sx = (Hm[0, 0] * xx + Hm[0, 1] * yy + Hm[0, 2]) / den
        sy = (Hm[1, 0] * xx + Hm[1, 1] * yy + Hm[1, 2]) / den
        xi = np.round(sx).astype(int)
        yi = np.round(sy).astype(int)
        ok = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        return np.where(ok[..., None],
                        a[np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)],
                        fill)
    return _apply_hwc(img, f)


def erase(img, i: int, j: int, h: int, w: int, v, inplace: bool = False):
    """Erase the rectangle [i:i+h, j:j+w] with value ``v`` (ref: F.erase).
    Follows the input's layout (CHW erases [:, i:i+h, j:j+w])."""
    a = np.asarray(img)
    out = a if inplace else a.copy()
    chw = a.ndim == 3 and a.shape[0] in (1, 3) and a.shape[-1] not in (1, 3)
    if chw:
        out[:, i:i + h, j:j + w] = v
    else:
        out[i:i + h, j:j + w] = v
    return out


def solarize(img, threshold: float = 128.0):
    """Invert pixels above ``threshold`` (ref: F.solarize)."""
    def f(a):
        top = 255.0 if a.max() > 1.5 else 1.0
        return np.where(a >= threshold, top - a, a)
    return _apply_hwc(img, f)


def posterize(img, bits: int = 4):
    """Keep the top ``bits`` bits of each (uint8-range) channel (ref:
    F.posterize)."""
    def f(a):
        mask = 256 - (1 << (8 - bits))
        return (a.astype(np.int32) & mask).astype(np.float32)
    return _apply_hwc(img, f)


def equalize(img):
    """Per-channel histogram equalization over uint8 range (ref:
    F.equalize)."""
    def f(a):
        out = np.empty_like(a)
        for c in range(a.shape[-1]):
            ch = a[..., c].astype(np.uint8)
            hist = np.bincount(ch.reshape(-1), minlength=256)
            nz = hist[hist > 0]
            if nz.size <= 1:
                out[..., c] = ch
                continue
            step = (hist.sum() - nz[-1]) // 255
            if step == 0:
                out[..., c] = ch
                continue
            lut = (np.cumsum(hist) - hist // 2) // step
            out[..., c] = np.clip(lut, 0, 255)[ch]
        return out.astype(np.float32)
    return _apply_hwc(img, f)


def autocontrast(img):
    """Stretch each channel to the full range (ref: F.autocontrast)."""
    def f(a):
        top = 255.0 if a.max() > 1.5 else 1.0
        mn = a.min((0, 1), keepdims=True)
        mx = a.max((0, 1), keepdims=True)
        scale = np.where(mx > mn, top / np.maximum(mx - mn, 1e-12), 1.0)
        return np.where(mx > mn, (a - mn) * scale, a)
    return _apply_hwc(img, f)


def gaussian_blur(img, kernel_size, sigma=None):
    """Separable gaussian blur (ref: F.gaussian_blur)."""
    kh, kw = ((kernel_size, kernel_size) if isinstance(kernel_size, int)
              else tuple(kernel_size))
    if sigma is None:
        sigma = 0.3 * ((kh - 1) * 0.5 - 1) + 0.8
    sy = sx = sigma if np.isscalar(sigma) else None
    if sy is None:
        sy, sx = sigma

    def kern(k, s):
        r = np.arange(k) - (k - 1) / 2.0
        w = np.exp(-(r ** 2) / (2 * s * s))
        return w / w.sum()

    ky = kern(kh, sy)
    kx = kern(kw, sx)

    def f(a):
        pad_y = kh // 2
        pad_x = kw // 2
        p = np.pad(a, ((pad_y, pad_y), (0, 0), (0, 0)), mode="edge")
        out = sum(p[i:i + a.shape[0]] * ky[i] for i in range(kh))
        p = np.pad(out, ((0, 0), (pad_x, pad_x), (0, 0)), mode="edge")
        return sum(p[:, i:i + a.shape[1]] * kx[i] for i in range(kw))
    return _apply_hwc(img, f)


__all__ += ["adjust_brightness", "adjust_contrast", "adjust_saturation",
            "adjust_hue", "to_grayscale", "rotate", "perspective", "erase",
            "solarize", "posterize", "equalize", "autocontrast",
            "gaussian_blur"]


def _register_transforms():
    """The functional transforms join the schema registry (they are ops in
    the reference's ops.yaml sense — host-side preprocessing kernels)."""
    from ..core.dispatch import OP_REGISTRY, register_op
    for _n in ["to_tensor", "normalize", "resize", "center_crop", "hflip",
               "vflip", "crop", "pad", "adjust_brightness", "adjust_contrast",
               "adjust_saturation", "adjust_hue", "to_grayscale", "rotate",
               "perspective", "erase", "solarize", "posterize", "equalize",
               "autocontrast", "gaussian_blur"]:
        _f = globals()[_n]
        key = _n if _n not in OP_REGISTRY else "img_" + _n
        if key not in OP_REGISTRY:
            register_op(key, _f, (_f.__doc__ or "").strip().split("\n")[0],
                        differentiable=False, category="vision_transform",
                        public=_f)


_register_transforms()
