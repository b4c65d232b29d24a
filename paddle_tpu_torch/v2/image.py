"""v2 image utilities (reference python/paddle/v2/image.py): numpy-only
crop/flip/resize/transform helpers for HWC uint8/float images — the cv2
dependency of the reference is replaced by nearest-neighbor numpy."""

from __future__ import annotations

import numpy as np

__all__ = ["resize_short", "center_crop", "random_crop", "left_right_flip",
           "to_chw", "simple_transform"]


def _resize(im, h, w):
    """Nearest-neighbor resize (HWC)."""
    H, W = im.shape[:2]
    rows = (np.arange(h) * H / h).astype(int).clip(0, H - 1)
    cols = (np.arange(w) * W / w).astype(int).clip(0, W - 1)
    return im[rows][:, cols]


def resize_short(im, size):
    """Scale so the SHORT side equals `size` (reference image.py)."""
    H, W = im.shape[:2]
    if H < W:
        return _resize(im, size, int(W * size / H))
    return _resize(im, int(H * size / W), size)


def center_crop(im, size, is_color=True):
    H, W = im.shape[:2]
    h0 = max((H - size) // 2, 0)
    w0 = max((W - size) // 2, 0)
    return im[h0:h0 + size, w0:w0 + size]


def random_crop(im, size, rng=None):
    rng = rng or np.random
    H, W = im.shape[:2]
    h0 = rng.randint(0, max(H - size, 0) + 1)
    w0 = rng.randint(0, max(W - size, 0) + 1)
    return im[h0:h0 + size, w0:w0 + size]


def left_right_flip(im):
    return im[:, ::-1]


def to_chw(im, order=(2, 0, 1)):
    return im.transpose(order)


def simple_transform(im, resize_size, crop_size, is_train,
                     mean=None, rng=None):
    """resize-short -> crop (+random flip when training) -> CHW float
    (reference image.py simple_transform)."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, rng=rng)
        if (rng or np.random).randint(0, 2):
            im = left_right_flip(im)
    else:
        im = center_crop(im, crop_size)
    im = to_chw(np.asarray(im, np.float32))
    if mean is not None:
        im -= np.asarray(mean, np.float32).reshape(-1, 1, 1)
    return im
