"""Normalizers ("decoders") — numpy host-side (reference
data_generator.py:338-417).  A copy of ``windtpu/data/decoders.py``, pinned
to it by ``tests/test_torch_copies.py``.

NaiveDecoder (the default everywhere) matches the reference exactly:
per-channel z-score over axes (0, 1, 2) of a single (T, H, W, C) patch
with NaN-aware statistics.

Two documented divergences in the range-clip decoders, whose reference
implementations are unusable with their own defaults:

* ``WindComponentDecoder.normalize`` uses NaN-aware ``np.nanmean`` /
  ``np.nanstd`` (the reference's plain ``np.mean``/``np.std``,
  data_generator.py:412, returns all-NaN the moment a single masked
  pixel exists — and its own ``__call__`` writes NaN for every
  zero/out-of-range value).  The global-scalar (not per-channel)
  reduction is kept as-is.
* ``WindSpeedDecoder.normalize`` anchors the affine map at
  ``value_range[0]`` when ``below_val`` is NaN (the default).  The
  reference normalizes against ``below_val`` directly
  (data_generator.py:384-389), which is NaN arithmetic for its default
  construction and returns all-NaN for every input.

A replicated quirk to be aware of: every ``denormalize`` here computes its
affine parameters FROM the (already normalized) input — exactly like the
reference (data_generator.py:355-356, 384, 413) — so it is NOT an inverse
of ``normalize``: a z-scored array has mean~0/std~1 and comes back nearly
unchanged, in normalized units.  Inverting a normalization requires the
forward pass's own statistics, which neither implementation stores; the
training pipeline never calls ``denormalize`` (the GAN predicts physical
target units directly), so this matters only to downstream users, who
should keep their forward stats.
"""

from __future__ import annotations

import numpy as np


class NaiveDecoder:
    """Per-channel z-score over (T, H, W) (reference :338-360)."""

    def __init__(self, normalize: bool = True):
        self.normalize_input = normalize

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if self.normalize_input:
            img = self.normalize(img)
        return img

    def normalize(self, img):
        mean = np.nanmean(img, axis=(0, 1, 2), keepdims=True)
        std = np.nanstd(img, axis=(0, 1, 2), keepdims=True)
        return (img - mean) / std

    def normalize_positive(self, img):
        mn = np.nanmin(img, axis=(0, 1, 2), keepdims=True)
        mx = np.nanmax(img, axis=(0, 1, 2), keepdims=True)
        return (img - mn) / (mx - mn)

    def denormalize(self, img):
        return img * np.nanstd(img) + np.nanmean(img)

    def denormalize_positive(self, img):
        return np.nanmin(img) + img * (np.nanmax(img) - np.nanmin(img))


class _RangeClipDecoder:
    """Shared zero-masking + range clipping (reference :363-417)."""

    def __init__(self, value_range, below_val=np.nan, normalize=False):
        self.value_range = value_range
        self.below_val = below_val
        self.normalize_output = normalize

    def __call__(self, img: np.ndarray) -> np.ndarray:
        valid = img != 0
        img_dec = np.full(img.shape, np.nan, dtype=np.float32)
        img_dec[valid] = img[valid]
        img_dec[img_dec < self.value_range[0]] = self.below_val
        img_dec.clip(max=self.value_range[1], out=img_dec)
        if self.normalize_output:
            img_dec = self.normalize(img_dec)
        return img_dec

    @property
    def _floor(self):
        """Finite lower anchor: below_val when finite, else the range
        minimum (divergence note in the module docstring)."""
        return (self.value_range[0] if np.isnan(self.below_val)
                else self.below_val)


class WindSpeedDecoder(_RangeClipDecoder):
    """Log-range clip decoder for wind speed (reference :363-389)."""

    def __init__(self, value_range=(np.log10(0.1), np.log10(100)),
                 below_val=np.nan, normalize=False):
        super().__init__(value_range, below_val, normalize)

    def normalize(self, img):
        return (img - self._floor) / (self.value_range[1] - self._floor)

    def denormalize(self, img, set_nan=True):
        img = img * (self.value_range[1] - self._floor) + self._floor
        img[img < self.value_range[0]] = self.below_val
        if set_nan:
            img[img == self.below_val] = np.nan
        return img


class WindComponentDecoder(_RangeClipDecoder):
    """Range-clip + z-score decoder for wind components (reference
    :392-417)."""

    def __init__(self, value_range=(-10, 10), below_val=np.nan,
                 normalize=True):
        super().__init__(value_range, below_val, normalize)

    def normalize(self, img):
        return (img - np.nanmean(img)) / np.nanstd(img)

    def denormalize(self, img, set_nan=True):
        img = img * np.nanstd(img) + np.nanmean(img)
        img[img < self.value_range[0]] = self.below_val
        if set_nan:
            img[img == self.below_val] = np.nan
        return img
