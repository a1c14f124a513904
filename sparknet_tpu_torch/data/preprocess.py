"""Schema-driven preprocessing: the reference's Preprocessor framework
(`libs/Preprocessor.scala`) rebuilt batch-vectorized.

A copy of `sparknet_tpu/data/preprocess.py` for the port. Its bfloat16
output is a CPU `torch.bfloat16` tensor: the native plane writes one, and
the numpy route ends in torch's cast (round to nearest even, bit-identical
to the JAX package's `ml_dtypes` cast). The route each call takes —
the native plane when it loads, numpy otherwise — is `route()`.

Reference impls being matched:
  - DefaultPreprocessor (lines 22-52): per-cell dtype dispatch -> here a
    schema-driven batch cast (`DefaultPreprocessor.convert_batch`).
  - ImageNetPreprocessor (54-83): mean-image subtraction + random 256->227
    crop as a strided view -> `ImagePreprocessor` (vectorized crops via
    sliding-window views, no copies until the final gather).
  - ImageNetTensorFlowPreprocessor (150-178): adds CHW->HWC transpose for the
    accelerator layout -> `to_nhwc` (TPU wants NHWC too).

Parity notes: crop offsets are uniform-random per image per epoch; the
reference used one random offset per image conversion. No flip augmentation
(the reference has none).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..schema import Schema


def to_nhwc(batch: np.ndarray) -> np.ndarray:
    """NCHW -> NHWC (device layout)."""
    assert batch.ndim == 4, batch.shape
    return np.ascontiguousarray(np.transpose(batch, (0, 2, 3, 1)))


def random_crop_nchw(images: np.ndarray, crop: int,
                     rng: np.random.Generator) -> np.ndarray:
    """Vectorized random spatial crop on an NCHW batch (view-gather, matching
    the reference's subarray-view crop at Preprocessor.scala:75-77)."""
    n, c, h, w = images.shape
    if h == crop and w == crop:
        return images
    assert h >= crop and w >= crop, (images.shape, crop)
    ys = rng.integers(0, h - crop + 1, n)
    xs = rng.integers(0, w - crop + 1, n)
    out = np.empty((n, c, crop, crop), dtype=images.dtype)
    for i in range(n):  # slice-views; copies only into the output buffer
        out[i] = images[i, :, ys[i]:ys[i] + crop, xs[i]:xs[i] + crop]
    return out


def center_crop_nchw(images: np.ndarray, crop: int) -> np.ndarray:
    n, c, h, w = images.shape
    y, x = (h - crop) // 2, (w - crop) // 2
    return images[:, :, y:y + crop, x:x + crop]


class DefaultPreprocessor:
    """Casts raw batch fields to the schema dtypes (reference lines 22-52:
    Float/Double/Int/Long/Binary -> float32 NDArray)."""

    def __init__(self, schema: Schema):
        self.schema = schema

    def convert_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = {}
        for f in self.schema.fields:
            arr = np.asarray(batch[f.name]).astype(f.dtype, copy=False)
            out[f.name] = arr.reshape((arr.shape[0],) + f.shape)
        return out


class ImagePreprocessor(DefaultPreprocessor):
    """Mean-subtract + random/center crop (+ NHWC) for image fields.

    mean_image: CHW float32 (full pre-crop size), or None.
    train mode crops randomly (reference ImageNetPreprocessor), eval mode
    center-crops (deterministic eval — an upgrade over the reference, which
    random-cropped eval batches too; set eval_random_crop=True for strict
    behavioral parity).
    """

    def __init__(self, schema: Schema, image_field: str = "data",
                 mean_image: Optional[np.ndarray] = None,
                 crop: Optional[int] = None, seed: int = 0,
                 nhwc: bool = True, eval_random_crop: bool = False,
                 out_dtype: str = "float32"):
        super().__init__(schema)
        self.image_field = image_field
        self.mean_image = (None if mean_image is None
                           else mean_image.astype(np.float32))
        self.crop = crop
        self.nhwc = nhwc
        self.eval_random_crop = eval_random_crop
        # emit the COMPUTE dtype directly ("bfloat16"): the native plane
        # writes it from its OpenMP loop, so the training loop's host-side
        # cast becomes a no-op instead of a single-threaded ml_dtypes pass
        # over the whole round (~19% of ingest, bench.py --e2e r3)
        assert out_dtype in ("float32", "bfloat16"), out_dtype
        self.out_dtype = out_dtype
        self._rng = np.random.default_rng(seed)

    def convert_batch(self, batch: Dict[str, np.ndarray], *,
                      train: bool = True,
                      rng: Optional[np.random.Generator] = None
                      ) -> Dict[str, np.ndarray]:
        """`rng` overrides the internal stream — pass a round-keyed generator
        for checkpoint-resume-exact crop schedules."""
        rng = rng if rng is not None else self._rng
        out = dict(batch)
        raw = np.asarray(out[self.image_field])
        img = self._try_native_fused(raw, train, rng)
        if img is None:
            img = raw.astype(np.float32)
            if self.mean_image is not None:
                img = img - self.mean_image  # pre-crop, per reference (line 70)
            if self.crop is not None:
                if train or self.eval_random_crop:
                    img = random_crop_nchw(img, self.crop, rng)
                else:
                    img = center_crop_nchw(img, self.crop)
            if self.nhwc:
                img = to_nhwc(img)
            if self.out_dtype != "float32":
                img = torch.from_numpy(img).to(torch.bfloat16)
        out[self.image_field] = img
        for f in self.schema.fields:
            if f.name != self.image_field and f.name in out:
                arr = np.asarray(out[f.name]).astype(f.dtype, copy=False)
                # apply the schema's per-example shape, like the base class:
                # e.g. label Field shape (1,) -> (B,1), () -> (B,) flat
                out[f.name] = arr.reshape((arr.shape[0],) + f.shape)
        return out

    def route(self, raw: np.ndarray) -> str:
        """"native" when `convert_batch` takes the fused C++ plane for
        `raw`, else "numpy"."""
        return "native" if self._native_ok(raw) else "numpy"

    def _native_ok(self, raw: np.ndarray) -> bool:
        if not (self.nhwc and self.crop is not None and raw.ndim == 4
                and raw.dtype == np.uint8):
            return False
        from . import jpeg_plane
        return jpeg_plane.available()

    def _try_native_fused(self, raw: np.ndarray, train: bool,
                          rng: np.random.Generator) -> Optional[np.ndarray]:
        """Fused C++ mean-subtract+crop+NHWC for uint8 CHW batches
        (native/jpeg_plane.cpp jp_crop_mean_nhwc). None -> numpy fallback."""
        if not self._native_ok(raw):
            return None
        from . import jpeg_plane
        n, _, h, w = raw.shape
        if train or self.eval_random_crop:
            ys = rng.integers(0, h - self.crop + 1, n).astype(np.int32)
            xs = rng.integers(0, w - self.crop + 1, n).astype(np.int32)
        else:
            ys = np.full(n, (h - self.crop) // 2, np.int32)
            xs = np.full(n, (w - self.crop) // 2, np.int32)
        dt = self.out_dtype
        if dt == "bfloat16" and not jpeg_plane.supports_bf16_out():
            dt = "float32"  # stale .so: fall back, cast later in the loop
        return jpeg_plane.crop_mean_nhwc(raw, self.mean_image, ys, xs,
                                         self.crop, out_dtype=dt)


def compute_mean_image(images_chw: np.ndarray) -> np.ndarray:
    """Mean image over the dataset (reference ImageNetApp.scala:66-69 did this
    as a distributed long-sum reduce; single vectorized pass here)."""
    return images_chw.astype(np.float64).mean(axis=0).astype(np.float32)
