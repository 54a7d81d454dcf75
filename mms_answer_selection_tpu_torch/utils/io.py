"""caffe.io equivalents: array<->proto converters and input formatting.

Reference: python/caffe/io.py (blobproto/datum converters, the
``Transformer`` input-formatting helper, load/resize/oversample image
utilities).  The converters here produce/consume raw protobuf WIRE BYTES
via the clean-room codec in ``utils.caffemodel`` — there are no
generated protobuf classes in this framework, so the natural unit of
exchange is the serialized message itself (what files and LMDB values
actually hold; the reference's ``.SerializeToString()`` round-trip
collapses to identity here).

Image IO is PIL-gated like ``data.pair_image``; interpolation uses
scipy.ndimage.zoom rather than skimage, reproducing
the reference's ndimage fallback path (io.py:334-336) for every channel
count.
"""

from __future__ import annotations

import numpy as np

from .caffemodel import _field, _iter_fields, _read_varint, _varint

__all__ = [
    "array_to_blobproto", "blobproto_to_array",
    "arraylist_to_blobprotovector_str", "blobprotovector_str_to_arraylist",
    "array_to_datum", "datum_to_array",
    "Transformer", "load_image", "resize_image", "oversample",
]


# ---------------------------------------------------------------------------
# BlobProto (caffe.proto:10-21)
# ---------------------------------------------------------------------------

def array_to_blobproto(arr, diff=None) -> bytes:
    """ndarray -> BlobProto wire bytes, with optional diff
    (io.py:36-46)."""
    arr = np.asarray(arr)
    shape = b"".join(_varint(int(d)) for d in arr.shape)
    out = _field(7, 2, _field(1, 2, shape))
    out += _field(5, 2, np.asarray(arr, "<f4").tobytes())
    if diff is not None:
        diff = np.asarray(diff)
        if diff.shape != arr.shape:
            raise ValueError("diff shape must match data shape")
        out += _field(6, 2, np.asarray(diff, "<f4").tobytes())
    return bytes(out)


def blobproto_to_array(blob: bytes, return_diff: bool = False):
    """BlobProto wire bytes -> ndarray of its data — or of its diff when
    ``return_diff`` (io.py:18-33).  Accepts modern BlobShape and legacy
    num/channels/height/width dims."""
    shape = None
    legacy = [0, 0, 0, 0]
    data = diff = None
    for field, wt, val in _iter_fields(memoryview(blob)):
        if field == 7 and wt == 2:  # BlobShape { repeated int64 dim }
            dims = []
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1 and w2 == 2:
                    pos = 0
                    while pos < len(v2):
                        d, pos = _read_varint(v2, pos)
                        dims.append(d)
                elif f2 == 1 and w2 == 0:
                    dims.append(v2)
            shape = tuple(dims)
        elif field in (1, 2, 3, 4) and wt == 0:
            legacy[field - 1] = val
        elif field == 5 and wt in (2, 5):  # packed or per-element
            part = np.frombuffer(bytes(val), "<f4")
            data = part if data is None else np.concatenate([data, part])
        elif field == 6 and wt in (2, 5):
            part = np.frombuffer(bytes(val), "<f4")
            diff = part if diff is None else np.concatenate([diff, part])
    if shape is None:
        shape = tuple(legacy)
    arr = diff if return_diff else data
    if arr is None:
        raise ValueError("blob carries no "
                         + ("diff" if return_diff else "data"))
    return arr.reshape(shape).copy()


def arraylist_to_blobprotovector_str(arraylist) -> bytes:
    """[ndarray] -> BlobProtoVector wire bytes
    (``repeated BlobProto blobs = 1``; io.py:49-55)."""
    return b"".join(_field(1, 2, array_to_blobproto(a))
                    for a in arraylist)


def blobprotovector_str_to_arraylist(s: bytes):
    """BlobProtoVector wire bytes -> [ndarray] (io.py:58-63)."""
    return [blobproto_to_array(bytes(val))
            for field, wt, val in _iter_fields(memoryview(s))
            if field == 1 and wt == 2]


# ---------------------------------------------------------------------------
# Datum (caffe.proto:30-41)
# ---------------------------------------------------------------------------

class DatumBytes(bytes):
    """Datum wire bytes that ALSO quack like the protobuf message the
    reference's ``caffe.io.array_to_datum`` returns: byte-consumers
    (LMDB values, file writes) use it directly, ported scripts call
    ``.SerializeToString()`` and read ``.label``/``.channels``/... —
    both work on the same object."""

    def SerializeToString(self) -> bytes:
        return bytes(self)

    def _msg(self):
        from .caffe_pb2_shim import Datum

        return Datum().ParseFromString(self)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._msg(), name)


def _as_datum_bytes(datum) -> bytes:
    """Wire bytes from either bytes-like or a caffe_pb2-style message."""
    if isinstance(datum, (bytes, bytearray, memoryview)):
        return bytes(datum)
    return datum.SerializeToString()


def array_to_datum(arr, label: int | None = 0) -> DatumBytes:
    """3-D (C, H, W) ndarray -> Datum wire bytes (a :class:`DatumBytes`,
    so ``.SerializeToString()`` works like the reference's message
    return).  uint8 arrays go in ``data`` (bytes), everything else in
    ``float_data`` (io.py:66-80)."""
    arr = np.asarray(arr)
    if arr.ndim != 3:
        raise ValueError("incorrect array shape: Datum holds (C, H, W)")
    c, h, w = arr.shape
    out = _field(1, 0, c) + _field(2, 0, h) + _field(3, 0, w)
    if arr.dtype == np.uint8:
        out += _field(4, 2, arr.tobytes())
    else:
        out += _field(6, 2, np.asarray(arr, "<f4").tobytes())
    if label is not None:
        out += _field(5, 0, int(label))
    return DatumBytes(out)


def datum_to_array(datum):
    """Datum (wire bytes or a caffe_pb2-style message) -> (C, H, W)
    ndarray: uint8 from ``data``, float32 from ``float_data``
    (io.py:83-94).  Label is available via :func:`datum_label`."""
    datum = _as_datum_bytes(datum)
    c = h = w = 0
    data = None
    fparts: list = []
    for field, wt, val in _iter_fields(memoryview(datum)):
        if field == 1 and wt == 0:
            c = val
        elif field == 2 and wt == 0:
            h = val
        elif field == 3 and wt == 0:
            w = val
        elif field == 4 and wt == 2:
            data = np.frombuffer(val, np.uint8)
        elif field == 6 and wt == 2:  # packed float_data
            fparts.append(np.frombuffer(val, "<f4"))
        elif field == 6 and wt == 5:
            # UNPACKED repeated float: proto2's default encoding — the
            # C++ runtime writes one wiretype-5 field per element
            fparts.append(np.frombuffer(bytes(val), "<f4"))
    src = data if data is not None \
        else (np.concatenate(fparts) if fparts else None)
    if src is None:
        raise ValueError("datum carries neither data nor float_data")
    return src.reshape(c, h, w).copy()


def datum_label(datum) -> int:
    """The Datum's label field (0 if absent, the proto default);
    negative labels decode from their sign-extended varint form."""
    datum = _as_datum_bytes(datum)
    for field, wt, val in _iter_fields(memoryview(datum)):
        if field == 5 and wt == 0:
            v = int(val)
            return v - (1 << 64) if v >= 1 << 63 else v
    return 0


# ---------------------------------------------------------------------------
# Transformer (io.py:97-275)
# ---------------------------------------------------------------------------

class Transformer:
    """Format ndarray inputs the caffe way: resize, transpose to CHW,
    channel-swap (RGB->BGR), raw-scale, mean-subtract, input-scale —
    and invert all of it with :meth:`deprocess`.

    ``inputs`` maps input blob name -> its 4-D (N, C, H, W) shape, e.g.
    ``{"data": (1, 3, 227, 227)}`` (pycaffe passes
    ``{in: net.blobs[in].data.shape}``).
    """

    def __init__(self, inputs: dict):
        self.inputs = dict(inputs)
        self.transpose: dict = {}
        self.channel_swap: dict = {}
        self.raw_scale: dict = {}
        self.mean: dict = {}
        self.input_scale: dict = {}

    def _check(self, in_):
        if in_ not in self.inputs:
            raise KeyError(f"{in_} is not one of the net inputs: "
                           f"{sorted(self.inputs)}")

    def preprocess(self, in_, data):
        """(H', W', K) float array -> the net's (K, H, W) input
        (io.py:121-161: resize, transpose, channel swap, raw_scale,
        mean subtract, input_scale — in that order)."""
        self._check(in_)
        x = np.asarray(data).astype(np.float32, copy=False)
        in_dims = tuple(self.inputs[in_][2:])
        if x.shape[:2] != in_dims:
            x = resize_image(x, in_dims)
        order = self.transpose.get(in_)
        if order is not None:
            x = x.transpose(order)
        swap = self.channel_swap.get(in_)
        if swap is not None:
            x = x[list(swap), :, :]
        x = np.array(x, dtype=np.float32)  # own the buffer for -=/*=
        raw = self.raw_scale.get(in_)
        if raw is not None:
            x *= raw
        mean = self.mean.get(in_)
        if mean is not None:
            x -= mean
        scale = self.input_scale.get(in_)
        if scale is not None:
            x *= scale
        return x

    def deprocess(self, in_, data):
        """Invert :meth:`preprocess` (io.py:163-184)."""
        self._check(in_)
        x = np.array(data, dtype=np.float32).squeeze()
        scale = self.input_scale.get(in_)
        if scale is not None:
            x /= scale
        mean = self.mean.get(in_)
        if mean is not None:
            x += mean
        raw = self.raw_scale.get(in_)
        if raw is not None:
            x /= raw
        swap = self.channel_swap.get(in_)
        if swap is not None:
            x = x[np.argsort(swap), :, :]
        order = self.transpose.get(in_)
        if order is not None:
            x = x.transpose(np.argsort(order))
        return x

    def set_transpose(self, in_, order):
        self._check(in_)
        if len(order) != len(self.inputs[in_]) - 1:
            raise ValueError("transpose order needs the same number of "
                             "dimensions as the input")
        self.transpose[in_] = tuple(order)

    def set_channel_swap(self, in_, order):
        self._check(in_)
        if len(order) != self.inputs[in_][1]:
            raise ValueError("channel swap needs one entry per input "
                             "channel")
        self.channel_swap[in_] = tuple(order)

    def set_raw_scale(self, in_, scale):
        self._check(in_)
        self.raw_scale[in_] = scale

    def set_mean(self, in_, mean):
        """Per-channel (K,) means broadcast; full means must match the
        input's (K, H, W) (io.py:235-259)."""
        self._check(in_)
        mean = np.asarray(mean, np.float32)
        if mean.ndim == 1:
            if mean.shape[0] != self.inputs[in_][1]:
                raise ValueError("mean channels incompatible with input")
            mean = mean[:, np.newaxis, np.newaxis]
        else:
            ms = mean.shape
            if len(ms) == 2:
                ms = (1,) + ms
                mean = mean.reshape(ms)
            if len(ms) != 3:
                raise ValueError("mean shape invalid")
            if ms != tuple(self.inputs[in_][1:]):
                raise ValueError("mean shape incompatible with input "
                                 "shape")
        self.mean[in_] = mean

    def set_input_scale(self, in_, scale):
        self._check(in_)
        self.input_scale[in_] = scale


# ---------------------------------------------------------------------------
# Image IO (io.py:278-380)
# ---------------------------------------------------------------------------

def load_image(filename: str, color: bool = True):
    """Image file -> float32 (H, W, 3) RGB in [0, 1] (or (H, W, 1)
    grayscale when ``color=False``); alpha dropped, grayscale tiled
    (io.py:278-302).  ``.npy`` arrays load directly (this framework's
    test/synthetic path)."""
    if filename.endswith(".npy"):
        img = np.asarray(np.load(filename), np.float32)
        if img.ndim == 2:
            img = img[:, :, np.newaxis]
    else:
        from PIL import Image  # gated: only needed for real image files

        with Image.open(filename) as im:
            if im.mode == "P":
                # palette images decode to slot INDICES; skimage's
                # imread returns true RGB — convert first
                im = im.convert("RGB")
            mode = im.mode
            raw = np.asarray(im)
        # img_as_float semantics: integer dtypes scale by their type's
        # max (uint8 -> /255) regardless of the pixel VALUES; float
        # images pass through.  Keying on values would brighten binary
        # masks / near-black uint8 images 255x.
        img = np.asarray(raw, np.float32)
        if mode.startswith("I"):
            # PIL parks 16-bit images in a 32-bit container: the data
            # range is uint16, not int32
            img = img / 65535.0
        elif np.issubdtype(raw.dtype, np.integer):
            img = img / float(np.iinfo(raw.dtype).max)
        if img.ndim == 2:
            img = img[:, :, np.newaxis]
    if img.shape[2] == 4:
        img = img[:, :, :3]
    if color and img.shape[2] == 1:
        img = np.tile(img, (1, 1, 3))
    return np.ascontiguousarray(img, np.float32)


def resize_image(im, new_dims, interp_order: int = 1):
    """(H, W, K) -> (new_H, new_W, K) with spline interpolation of the
    given order (io.py:305-337; the ndimage path, which handles any K).
    Constant images short-circuit (the reference's divide-by-zero
    guard)."""
    im = np.asarray(im)
    new_dims = tuple(int(d) for d in new_dims)
    if im.min() == im.max():
        ret = np.empty(new_dims + (im.shape[-1],), np.float32)
        ret.fill(im.min())
        return ret
    from scipy.ndimage import zoom

    scale = tuple(np.array(new_dims, float) / np.array(im.shape[:2]))
    return zoom(im, scale + (1,), order=interp_order).astype(np.float32)


def oversample(images, crop_dims):
    """Crop each image into its four corners + center and their mirrors:
    (10*N, H, W, K) (io.py:340-380, the Classifier's oversampled
    prediction input)."""
    im_shape = np.array(images[0].shape)
    crop_dims = np.array(crop_dims)
    im_center = im_shape[:2] / 2.0

    h_indices = (0, im_shape[0] - crop_dims[0])
    w_indices = (0, im_shape[1] - crop_dims[1])
    crops_ix = np.empty((5, 4), int)
    curr = 0
    for i in h_indices:
        for j in w_indices:
            crops_ix[curr] = (i, j, i + crop_dims[0], j + crop_dims[1])
            curr += 1
    crops_ix[4] = np.tile(im_center, 2) + np.concatenate(
        [-crop_dims / 2.0, crop_dims / 2.0])
    crops_ix = np.tile(crops_ix, (2, 1))

    crops = np.empty((10 * len(images), crop_dims[0], crop_dims[1],
                      im_shape[-1]), np.float32)
    ix = 0
    for im in images:
        for crop in crops_ix:
            crops[ix] = im[crop[0]:crop[2], crop[1]:crop[3], :]
            ix += 1
        crops[ix - 5:ix] = crops[ix - 5:ix, :, ::-1, :]  # flip for mirrors
    return crops
