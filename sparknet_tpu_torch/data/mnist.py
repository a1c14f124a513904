"""MNIST IDX-format loader.

Parity with reference `loaders/MnistLoader.scala`: parses the IDX format with
magic-number / count / shape validation (reference lines 18-29, 45-50),
normalizes pixels to [-0.5, 0.5] (line 35), labels as ints (line 54).

A copy of `sparknet_tpu/data/mnist.py` (pure Python): the port imports
nothing of the JAX package.
"""
from __future__ import annotations

import gzip
import os
import struct
from typing import Dict, Tuple

import numpy as np

from ..schema import Field, Schema

IMAGES_MAGIC = 2051
LABELS_MAGIC = 2049

SCHEMA = Schema(Field("data", "float32", (1, 28, 28)),
                Field("label", "int32", (1,)))


def _open(path: str):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def read_idx_images(path: str) -> np.ndarray:
    with _open(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != IMAGES_MAGIC:
            raise ValueError(f"{path}: bad magic {magic}, expected "
                             f"{IMAGES_MAGIC} (IDX image file)")
        data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
    if data.size != n * rows * cols:
        raise ValueError(f"{path}: truncated ({data.size} pixels, header "
                         f"promised {n}x{rows}x{cols})")
    return data.reshape(n, rows, cols)


def read_idx_labels(path: str) -> np.ndarray:
    with _open(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != LABELS_MAGIC:
            raise ValueError(f"{path}: bad magic {magic}, expected "
                             f"{LABELS_MAGIC} (IDX label file)")
        data = np.frombuffer(f.read(n), dtype=np.uint8)
    if data.size != n:
        raise ValueError(f"{path}: truncated labels")
    return data.astype(np.int32)


class MnistLoader:
    """Loads train/test splits from a directory with the standard filenames
    (train-images-idx3-ubyte[.gz], etc.)."""

    FILES = {
        "train_images": "train-images-idx3-ubyte",
        "train_labels": "train-labels-idx1-ubyte",
        "test_images": "t10k-images-idx3-ubyte",
        "test_labels": "t10k-labels-idx1-ubyte",
    }

    def __init__(self, path: str):
        resolved = {}
        for key, base in self.FILES.items():
            for cand in (os.path.join(path, base), os.path.join(path, base + ".gz")):
                if os.path.exists(cand):
                    resolved[key] = cand
                    break
            else:
                raise FileNotFoundError(f"MNIST file missing: {path}/{base}[.gz]")
        self.train_images = self._norm(read_idx_images(resolved["train_images"]))
        self.train_labels = read_idx_labels(resolved["train_labels"])
        self.test_images = self._norm(read_idx_images(resolved["test_images"]))
        self.test_labels = read_idx_labels(resolved["test_labels"])
        if len(self.train_images) != len(self.train_labels):
            raise ValueError("train images/labels count mismatch")

    @staticmethod
    def _norm(images: np.ndarray) -> np.ndarray:
        # [-0.5, 0.5] normalization (reference MnistLoader.scala:35)
        return (images.astype(np.float32) / 255.0 - 0.5)[:, None, :, :]

    def train_batch_dict(self) -> Dict[str, np.ndarray]:
        return {"data": self.train_images, "label": self.train_labels[:, None]}

    def test_batch_dict(self) -> Dict[str, np.ndarray]:
        return {"data": self.test_images, "label": self.test_labels[:, None]}


def write_synthetic(path: str, n_train: int = 256, n_test: int = 64,
                    seed: int = 0) -> None:
    """Write tiny synthetic IDX files (exact format, for tests)."""
    os.makedirs(path, exist_ok=True)
    r = np.random.default_rng(seed)

    def w_images(name, n):
        with open(os.path.join(path, name), "wb") as f:
            f.write(struct.pack(">IIII", IMAGES_MAGIC, n, 28, 28))
            f.write(r.integers(0, 256, n * 28 * 28, dtype=np.uint8).tobytes())

    def w_labels(name, n):
        with open(os.path.join(path, name), "wb") as f:
            f.write(struct.pack(">II", LABELS_MAGIC, n))
            f.write(r.integers(0, 10, n, dtype=np.uint8).tobytes())

    w_images("train-images-idx3-ubyte", n_train)
    w_labels("train-labels-idx1-ubyte", n_train)
    w_images("t10k-images-idx3-ubyte", n_test)
    w_labels("t10k-labels-idx1-ubyte", n_test)
