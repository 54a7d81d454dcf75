"""Windowed detector application wrapper (python/caffe/detector.py).

R-CNN-style detection: classify a list of image windows, warping each
crop to the net input size, optionally with context padding
(detector.py:22-219; detect.py drives it).  Same layout convention as
:class:`~.classifier.Classifier`: the Transformer is reference-shaped
(CHW) and the batch is permuted to NHWC at the net boundary.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils import io as caffe_io
from .pynet import Net

__all__ = ["Detector"]


class Detector(Net):
    """``Detector(deploy_prototxt, weights, context_pad=16, ...)``.

    ``context_pad``: pixels of the net input that are surrounding
    context rather than window content, as in R-CNN feature extraction.
    """

    def __init__(self, model_file: str, pretrained_file: str | None = None,
                 mean=None, input_scale=None, raw_scale=None,
                 channel_swap=None, context_pad=None, device=None):
        super().__init__(model_file, phase="test", weights=pretrained_file,
                         device=device)
        shapes = self._net.declared_input_shapes(nhwc=False)
        in_ = self.inputs[0]
        if in_ not in shapes or len(shapes[in_]) != 4:
            raise ValueError(
                f"deploy net must declare a 4-D shape for input {in_!r}")
        self._in_shape = shapes[in_]  # caffe NCHW
        self.transformer = caffe_io.Transformer({in_: shapes[in_]})
        self.transformer.set_transpose(in_, (2, 0, 1))
        if mean is not None:
            self.transformer.set_mean(in_, mean)
        if input_scale is not None:
            self.transformer.set_input_scale(in_, input_scale)
        if raw_scale is not None:
            self.transformer.set_raw_scale(in_, raw_scale)
        if channel_swap is not None:
            self.transformer.set_channel_swap(in_, channel_swap)

        self.configure_crop(context_pad)

    # ------------------------------------------------------------------
    def detect_windows(self, images_windows):
        """[(image filename, window list)] -> [{filename, window,
        prediction}] (detector.py:56-100).  Windows are (ymin, xmin,
        ymax, xmax)."""
        images_windows = list(images_windows)  # consumed TWICE
        window_inputs = []
        for image_fname, windows in images_windows:
            image = caffe_io.load_image(image_fname).astype(np.float32)
            for window in windows:
                window_inputs.append(self.crop(image, window))

        in_ = self.inputs[0]
        caffe_in = np.zeros((len(window_inputs),
                             window_inputs[0].shape[2])
                            + tuple(self._in_shape[2:]), np.float32)
        for ix, window_in in enumerate(window_inputs):
            caffe_in[ix] = self.transformer.preprocess(in_, window_in)
        out = self.forward_all(**{in_: caffe_in.transpose(0, 2, 3, 1)})
        predictions = np.asarray(out[self.outputs[0]])
        # drop singleton spatial dims like the reference's
        # squeeze(axis=(2, 3)); fully-connected heads are already (N, C)
        if predictions.ndim == 4:
            predictions = predictions.squeeze(axis=(1, 2))  # NHWC here

        detections = []
        ix = 0
        for image_fname, windows in images_windows:
            for window in windows:
                detections.append({"window": window,
                                   "prediction": predictions[ix],
                                   "filename": image_fname})
                ix += 1
        return detections

    def detect_selective_search(self, image_fnames):
        """Selective-search proposals -> detect_windows
        (detector.py:101-123; needs the external
        selective_search_ijcv_with_python package, same as the
        reference)."""
        import selective_search_ijcv_with_python as selective_search

        image_fnames = [os.path.abspath(f) for f in image_fnames]
        windows_list = selective_search.get_windows(
            image_fnames, cmd="selective_search_rcnn")
        return self.detect_windows(zip(image_fnames, windows_list))

    # ------------------------------------------------------------------
    def crop(self, im, window):
        """Crop a window (ymin, xmin, ymax, xmax) with optional
        context padding + mean fill (detector.py:125-179)."""
        window = np.asarray(window)
        crop = im[window[0]:window[2], window[1]:window[3]]

        if self.context_pad:
            box = window.astype(float).copy()
            crop_size = self._in_shape[3]  # assumes square
            scale = crop_size / (1.0 * crop_size - self.context_pad * 2)
            half_h = (box[2] - box[0] + 1) / 2.0
            half_w = (box[3] - box[1] + 1) / 2.0
            center = (box[0] + half_h, box[1] + half_w)
            scaled_dims = scale * np.array(
                (-half_h, -half_w, half_h, half_w))
            box = np.round(np.tile(center, 2) + scaled_dims)
            full_h = box[2] - box[0] + 1
            full_w = box[3] - box[1] + 1
            scale_h = crop_size / full_h
            scale_w = crop_size / full_w
            pad_y = int(round(max(0.0, -box[0]) * scale_h))
            pad_x = int(round(max(0.0, -box[1]) * scale_w))

            im_h, im_w = im.shape[:2]
            box = np.clip(box, 0.0, [im_h, im_w, im_h, im_w])
            clip_h = box[2] - box[0] + 1
            clip_w = box[3] - box[1] + 1
            assert clip_h > 0 and clip_w > 0
            crop_h = int(round(clip_h * scale_h))
            crop_w = int(round(clip_w * scale_w))
            if pad_y + crop_h > crop_size:
                crop_h = crop_size - pad_y
            if pad_x + crop_w > crop_size:
                crop_w = crop_size - pad_x

            box = box.astype(int)
            context_crop = im[box[0]:box[2], box[1]:box[3]]
            context_crop = caffe_io.resize_image(context_crop,
                                                 (crop_h, crop_w))
            crop = (np.ones(self.crop_dims, np.float32)
                    * self.crop_mean)
            crop[pad_y:pad_y + crop_h, pad_x:pad_x + crop_w] = context_crop
        return crop

    def configure_crop(self, context_pad):
        """Fix crop dims (input-space HWC) and the unprocessed-space mean
        for context padding (detector.py:181-219)."""
        in_ = self.inputs[0]
        tpose = self.transformer.transpose[in_]
        inv_tpose = [tpose[t] for t in tpose]
        self.crop_dims = np.array(self._in_shape[1:])[inv_tpose]
        self.context_pad = context_pad
        if self.context_pad:
            transpose = self.transformer.transpose.get(in_)
            channel_order = self.transformer.channel_swap.get(in_)
            raw_scale = self.transformer.raw_scale.get(in_)
            mean = self.transformer.mean.get(in_)
            if mean is not None:
                inv_transpose = [transpose[t] for t in transpose]
                crop_mean = np.array(mean, np.float32)
                if crop_mean.ndim == 1:
                    crop_mean = crop_mean[:, None, None]
                crop_mean = np.broadcast_to(
                    crop_mean, tuple(self._in_shape[1:])).copy()
                crop_mean = crop_mean.transpose(inv_transpose)
                if channel_order is not None:
                    inverse = [channel_order.index(i)
                               for i in range(crop_mean.shape[2])]
                    crop_mean = crop_mean[:, :, inverse]
                if raw_scale is not None:
                    crop_mean /= raw_scale
                self.crop_mean = crop_mean
            else:
                self.crop_mean = np.zeros(self.crop_dims, np.float32)
