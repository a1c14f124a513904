"""CIFAR-10 binary-format loader.

A copy of `sparknet_tpu/data/cifar.py` (pure numpy): the port imports
nothing of the JAX package.

Parity with reference `loaders/CifarLoader.scala`: reads the 6 binary batch
files (data_batch_{1..5}.bin, test_batch.bin; 1 label byte + 3072 CHW image
bytes per record), validates file presence, shuffles the train set with a
seeded permutation, and computes the train mean image. Vectorized with numpy
instead of the reference's per-byte loops.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from ..schema import Field, Schema

TRAIN_FILES = [f"data_batch_{i}.bin" for i in range(1, 6)]
TEST_FILES = ["test_batch.bin"]
RECORD_BYTES = 1 + 3072
IMAGE_SHAPE = (3, 32, 32)  # CHW, as stored

SCHEMA = Schema(Field("data", "float32", (3, 32, 32)),
                Field("label", "int32", (1,)))


def _read_batch_file(path: str) -> Tuple[np.ndarray, np.ndarray]:
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size % RECORD_BYTES != 0:
        raise ValueError(f"{path}: size {raw.size} not a multiple of "
                         f"{RECORD_BYTES}-byte records")
    records = raw.reshape(-1, RECORD_BYTES)
    labels = records[:, 0].astype(np.int32)
    images = records[:, 1:].reshape(-1, *IMAGE_SHAPE).astype(np.float32)
    return images, labels


class CifarLoader:
    """Loads CIFAR-10 from `path` (dir containing the .bin files).

    Attributes (reference parity): train_images/train_labels (shuffled),
    test_images/test_labels, mean_image (train mean, CHW float32).
    """

    def __init__(self, path: str, seed: int = 0):
        for f in TRAIN_FILES + TEST_FILES:
            fp = os.path.join(path, f)
            if not os.path.exists(fp):
                raise FileNotFoundError(
                    f"CIFAR-10 file missing: {fp} (download with "
                    f"scripts/get_cifar10.sh)")
        train = [_read_batch_file(os.path.join(path, f)) for f in TRAIN_FILES]
        test = [_read_batch_file(os.path.join(path, f)) for f in TEST_FILES]
        images = np.concatenate([t[0] for t in train])
        labels = np.concatenate([t[1] for t in train])
        # seeded shuffle (reference: random permutation at CifarLoader.scala:31-35)
        perm = np.random.default_rng(seed).permutation(len(images))
        self.train_images = images[perm]
        self.train_labels = labels[perm]
        self.test_images = np.concatenate([t[0] for t in test])
        self.test_labels = np.concatenate([t[1] for t in test])
        self.mean_image = self.train_images.mean(axis=0)

    def train_batch_dict(self, subtract_mean: bool = True) -> Dict[str, np.ndarray]:
        data = self.train_images
        if subtract_mean:
            data = data - self.mean_image
        return {"data": data, "label": self.train_labels[:, None]}

    def test_batch_dict(self, subtract_mean: bool = True) -> Dict[str, np.ndarray]:
        data = self.test_images
        if subtract_mean:
            data = data - self.mean_image
        return {"data": data, "label": self.test_labels[:, None]}


def write_synthetic(path: str, n_per_file: int = 100, seed: int = 0) -> None:
    """Write tiny synthetic files in the exact binary format (for tests)."""
    os.makedirs(path, exist_ok=True)
    r = np.random.default_rng(seed)
    for f in TRAIN_FILES + TEST_FILES:
        labels = r.integers(0, 10, (n_per_file, 1), dtype=np.uint8)
        images = r.integers(0, 256, (n_per_file, 3072), dtype=np.uint8)
        np.concatenate([labels, images], axis=1).tofile(os.path.join(path, f))
