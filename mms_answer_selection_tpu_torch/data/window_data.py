"""WindowData layer: R-CNN window-file sampling + crop/warp batches.

Reference: src/caffe/layers/window_data_layer.cpp (the R-CNN fg/bg
window sampler).  Window file format (window_data_layer.cpp:44-51)::

    # <image_index>
    <img_path>
    <channels>
    <height>
    <width>
    <num_windows>
    <class_index> <overlap> <x1> <y1> <x2> <y2>     (repeated)

Semantics reproduced exactly:

* fg/bg partition at parse time: overlap >= fg_threshold is foreground
  (label must be > 0); overlap < bg_threshold is background with label
  AND overlap forced to 0 (:132-144).  Windows in between are dropped.
* each batch draws ``batch_size*fg_fraction`` foreground samples and the
  rest background, uniformly WITH replacement, background first
  (:320-339).
* context_pad / "square" crop_mode expansion, clipping, per-axis warp
  scales, padded placement into a zeroed crop_size x crop_size canvas
  with the pad region left at 0 (NOT mean-subtracted), mirrored padding
  on mirror (:303-392).
* mean handling: full mean image indexed at the center crop offset
  shifted by the pad, or per-channel mean values; ``(pixel - mean) *
  scale`` (:404-421).

Output is NHWC float32 (this framework's layout); interpolation is
bilinear via scipy (the reference warps with cv::INTER_LINEAR — equal up
to resampler boundary conventions, which the tests treat as approximate).
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.io import resize_image
from .pair_image import load_image

__all__ = ["parse_window_file", "WindowListDataset"]


def parse_window_file(source: str, *, root: str = "",
                      fg_threshold: float = 0.5,
                      bg_threshold: float = 0.5):
    """-> (image_db [(path, (c, h, w))], fg_windows, bg_windows); each
    window is (image_index, label, overlap, x1, y1, x2, y2)
    (window_data_layer.cpp:79-155)."""
    image_db: list = []
    fg: list = []
    bg: list = []
    with open(source) as f:
        tokens = f.read().split()
    pos = 0

    def take():
        nonlocal pos
        t = tokens[pos]
        pos += 1
        return t

    if not tokens:
        raise ValueError("Window file is empty")
    while pos < len(tokens):
        if take() != "#":
            raise ValueError("expected '#' image separator")
        image_index = int(take())
        if image_index != len(image_db):
            raise ValueError(f"non-sequential image_index {image_index}")
        path = os.path.join(root, take()) if root else take()
        c, h, w = int(take()), int(take()), int(take())
        image_db.append((path, (c, h, w)))
        n = int(take())
        for _ in range(n):
            label = int(take())
            overlap = float(take())
            x1, y1, x2, y2 = (int(take()) for _ in range(4))
            if overlap >= fg_threshold:
                if label <= 0:
                    raise ValueError(
                        f"foreground window in {path} has label {label} "
                        "(must be > 0, window_data_layer.cpp:134)")
                fg.append((image_index, label, overlap, x1, y1, x2, y2))
            elif overlap < bg_threshold:
                # background: label and overlap forced to 0 (:139-141)
                bg.append((image_index, 0, 0.0, x1, y1, x2, y2))
    return image_db, fg, bg


def _cround(x: float) -> int:
    """C's round(): half away from zero (Python's round() is banker's
    half-to-even — window_data_layer.cpp's crop math must match C)."""
    import math

    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))


class WindowListDataset:
    """Batch iterator with the reference's fg/bg sampling + crop/warp.

    Yields ``{"data": (N, crop, crop, C) f32, "label": (N,) f32}``
    (NHWC).  ``mean`` may be a per-channel sequence or a full (H, W, C)
    mean image (indexed at the crop-centered offset, like mean_file)."""

    def __init__(self, source: str, batch_size: int, *, crop_size: int,
                 root: str = "", fg_threshold: float = 0.5,
                 bg_threshold: float = 0.5, fg_fraction: float = 0.25,
                 context_pad: int = 0, crop_mode: str = "warp",
                 mirror: bool = False, mean=None, scale: float = 1.0,
                 cache_images: bool = False, seed: int = 0):
        if crop_size <= 0:
            raise ValueError("WindowData requires transform_param "
                             "crop_size > 0 (window_data_layer.cpp:171)")
        if crop_mode not in ("warp", "square"):
            raise ValueError(f"unknown crop_mode {crop_mode!r}")
        self.image_db, self.fg, self.bg = parse_window_file(
            source, root=root, fg_threshold=fg_threshold,
            bg_threshold=bg_threshold)
        if not self.fg or not self.bg:
            raise ValueError("need at least one foreground and one "
                             "background window (:326-327)")
        self.channels = self.image_db[0][1][0]  # declared in the file
        self.bs = batch_size
        self.crop_size = crop_size
        self.context_pad = context_pad
        self.use_square = crop_mode == "square"
        self.mirror = mirror
        self.scale = scale
        self.mean = None if mean is None else np.asarray(mean, np.float32)
        self.rng = np.random.default_rng(seed)
        # cache_images=True keeps every decoded image resident
        # (window_data_layer.cpp's cache_images, proto default false);
        # otherwise a small LRU bounds memory while still amortizing the
        # common repeated-image case within a batch
        self._cache_all = cache_images
        from collections import OrderedDict as _OD

        self._cache: dict = _OD()
        self.num_fg = int(batch_size * fg_fraction)

    _LRU_CAP = 128

    # ------------------------------------------------------------------
    def _image(self, idx: int):
        if idx in self._cache:
            self._cache.move_to_end(idx)
            return self._cache[idx]
        path, (c, h, w) = self.image_db[idx]
        img = load_image(path)  # f32 HWC [0, 255]
        self._cache[idx] = img
        if not self._cache_all and len(self._cache) > self._LRU_CAP:
            self._cache.popitem(last=False)
        return img

    def _crop(self, img, win, do_mirror: bool):
        """One window -> (crop_size, crop_size, C) float32 canvas
        (window_data_layer.cpp:303-430)."""
        cs = self.crop_size
        _, _, _, x1, y1, x2, y2 = win
        pad_w = pad_h = 0
        out_h = out_w = cs
        if self.context_pad > 0 or self.use_square:
            context_scale = cs / (cs - 2.0 * self.context_pad)
            half_h = (y2 - y1 + 1) / 2.0
            half_w = (x2 - x1 + 1) / 2.0
            cx = x1 + half_w
            cy = y1 + half_h
            if self.use_square:
                half_h = half_w = max(half_h, half_w)
            x1 = _cround(cx - half_w * context_scale)
            x2 = _cround(cx + half_w * context_scale)
            y1 = _cround(cy - half_h * context_scale)
            y2 = _cround(cy + half_h * context_scale)

            unclipped_h = y2 - y1 + 1
            unclipped_w = x2 - x1 + 1
            pad_x1 = max(0, -x1)
            pad_y1 = max(0, -y1)
            pad_x2 = max(0, x2 - img.shape[1] + 1)
            pad_y2 = max(0, y2 - img.shape[0] + 1)
            x1 += pad_x1
            x2 -= pad_x2
            y1 += pad_y1
            y2 -= pad_y2

            scale_x = cs / unclipped_w
            scale_y = cs / unclipped_h
            out_w = _cround((x2 - x1 + 1) * scale_x)
            out_h = _cround((y2 - y1 + 1) * scale_y)
            pad_x1 = _cround(pad_x1 * scale_x)
            pad_x2 = _cround(pad_x2 * scale_x)
            pad_y1 = _cround(pad_y1 * scale_y)
            pad_h = pad_y1
            # mirrored padding mirrors too (:376-381)
            pad_w = pad_x2 if do_mirror else pad_x1
            if pad_h + out_h > cs:
                out_h = cs - pad_h
            if pad_w + out_w > cs:
                out_w = cs - pad_w

        patch = img[y1:y2 + 1, x1:x2 + 1]
        patch = resize_image(patch, (out_h, out_w))
        if do_mirror:
            patch = patch[:, ::-1]

        canvas = np.zeros((cs, cs, img.shape[2]), np.float32)
        region = patch
        if self.mean is not None:
            if self.mean.ndim == 1:
                region = patch - self.mean
            else:
                # full mean image: center-crop offset + pad shift (:411)
                off = (self.mean.shape[1] - cs) // 2
                m = self.mean[off + pad_h: off + pad_h + out_h,
                              off + pad_w: off + pad_w + out_w]
                region = patch - m
        canvas[pad_h:pad_h + out_h, pad_w:pad_w + out_w] = \
            region * self.scale
        return canvas

    # ------------------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        cs = self.crop_size
        # channel count from the window file's DECLARED channels (the
        # parsed image_db), not a force-decode of image 0 — which may be
        # unreferenced, missing, or a different depth than the sampled
        # windows' images
        c = self.channels
        data = np.zeros((self.bs, cs, cs, c), np.float32)
        labels = np.zeros((self.bs,), np.float32)
        item = 0
        counts = (self.bs - self.num_fg, self.num_fg)  # bg first (:330)
        for is_fg in (0, 1):
            pool = self.fg if is_fg else self.bg
            for _ in range(counts[is_fg]):
                win = pool[int(self.rng.integers(0, 2**31)) % len(pool)]
                do_mirror = bool(self.mirror
                                 and self.rng.integers(0, 2**31) % 2)
                img = self._image(win[0])
                data[item] = self._crop(img, win, do_mirror)
                labels[item] = win[1]
                item += 1
        return {"data": data, "label": labels}
