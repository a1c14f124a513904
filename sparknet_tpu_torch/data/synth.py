"""Deterministic synthetic CIFAR-like dataset (r4: offline accuracy proxy).

Real CIFAR-10 is unreachable in this environment (PARITY.md), so the
recipe-scale accuracy evidence runs on a synthetic stand-in with the same
tensor statistics the reference pipeline feeds the net: 3x32x32, raw
[0, 255] pixel scale, mean-image subtraction downstream (reference
`loaders/CifarLoader.scala:60-66`), 10 balanced classes. Class-conditional
and LEARNABLE but not trivial: each class is a smooth random template,
each example a randomly shifted copy + pixel noise, so cifar10_quick must
learn translation-tolerant features, not a lookup table.

Fully deterministic in (seed, index): example i is the same bytes on every
host, every run, every chunk size — the property the parity artifacts and
the numpy-oracle trajectory test rely on.

A copy of `sparknet_tpu/data/synth.py` (pure Python): the port imports
nothing of the JAX package.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

N_CLASSES = 10
SHAPE = (3, 32, 32)
_SHIFT = 6        # max |dx|, |dy| translation
_NOISE = 75.0     # pixel noise std
_AMP = 40.0       # template amplitude around mid-gray
# calibration (r4): with shift 6 / noise 75 / amp 40, cifar10_quick reaches
# ~0.5 test accuracy at 500 iters and keeps climbing through the 4000-iter
# recipe — hard enough that the full run is informative, far above the 0.1
# chance floor (the earlier 25/60 setting saturated at 0.99 by iter 100)


def class_templates(seed: int = 0) -> np.ndarray:
    """[10, 3, 32, 32] smooth random templates: 8x8 gaussian fields
    bilinearly upsampled to 32x32, scaled to mid-gray +- _AMP."""
    r = np.random.default_rng((seed, 0xC1A55))
    low = r.standard_normal((N_CLASSES, 3, 8, 8))
    # bilinear 8 -> 32 upsample via separable linear interpolation
    xs = np.linspace(0, 7, 32)
    i0 = np.clip(np.floor(xs).astype(int), 0, 6)
    frac = xs - i0
    up = low[..., i0, :] * (1 - frac)[None, None, :, None] + \
        low[..., i0 + 1, :] * frac[None, None, :, None]
    up = up[..., i0] * (1 - frac) + up[..., i0 + 1] * frac
    return (128.0 + _AMP * up / np.abs(up).max()).astype(np.float32)


def synthetic_cifar(n: int, seed: int = 0, start: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Examples [start, start+n): (images [n,3,32,32] float32 in [0,255],
    labels [n] int32). Label of example i is i % 10 (balanced)."""
    tmpl = class_templates(seed)
    pad = np.pad(tmpl, ((0, 0), (0, 0), (_SHIFT, _SHIFT), (_SHIFT, _SHIFT)),
                 mode="edge")
    images = np.empty((n,) + SHAPE, np.float32)
    labels = np.empty((n,), np.int32)
    for j in range(n):
        i = start + j
        r = np.random.default_rng((seed, 1, i))
        c = i % N_CLASSES
        dy, dx = r.integers(-_SHIFT, _SHIFT + 1, 2)
        base = pad[c, :, _SHIFT + dy:_SHIFT + dy + 32,
                   _SHIFT + dx:_SHIFT + dx + 32]
        # NO clipping: clip-saturated pixels create masses of repeated
        # values, whose conv outputs near-tie in max-pool windows — and a
        # near-tie's argmax flips under 1-ulp implementation differences,
        # injecting gradient-routing chaos that swamps trajectory
        # comparisons (measured: conv1 L2 drift 6.6% by iter 10 with
        # clipping, 100x less without). Float pixels are fine: the scale
        # is still CIFAR-like and the mean subtraction downstream centers
        # them either way.
        images[j] = base + _NOISE * r.standard_normal(SHAPE, np.float32)
        labels[j] = c
    return images, labels


def mean_image(seed: int = 0, n: int = 2000) -> np.ndarray:
    """Deterministic mean image over the first n examples (the CifarLoader
    computed the train-set mean; n=2000 is statistically equivalent here
    and keeps artifact generation fast)."""
    images, _ = synthetic_cifar(n, seed=seed)
    return images.mean(axis=0)


# -- ImageNet-shaped corpus (r5: CaffeNet-scale convergence evidence) --------

IMAGENET_SIZE = 256
IMAGENET_CLASSES = 64
_IN_SHIFT = 24     # max |dx|, |dy| translation (vs the 227/256 crop's 29)
_IN_NOISE = 35.0   # pixel noise std (survives JPEG q=90: smooth template
                   # carries the class signal, noise is the nuisance)
_IN_AMP = 45.0     # template amplitude around mid-gray
_IN_BRIGHT = 20.0  # per-image brightness jitter


def imagenet_templates(seed: int = 0,
                       n_classes: int = IMAGENET_CLASSES) -> np.ndarray:
    """[C, 3, 256, 256] smooth random templates: 16x16 gaussian fields
    bilinearly upsampled (same construction as the CIFAR stand-in at 4x
    the spatial detail — enough structure that conv1 11x11/4 features,
    LRN and the grouped tail all see realistic activation ranges)."""
    r = np.random.default_rng((seed, 0x1A6E7))
    low = r.standard_normal((n_classes, 3, 16, 16))
    size = IMAGENET_SIZE
    xs = np.linspace(0, 15, size)
    i0 = np.clip(np.floor(xs).astype(int), 0, 14)
    frac = xs - i0
    up = low[..., i0, :] * (1 - frac)[None, None, :, None] + \
        low[..., i0 + 1, :] * frac[None, None, :, None]
    up = up[..., i0] * (1 - frac) + up[..., i0 + 1] * frac
    return (128.0 + _IN_AMP * up / np.abs(up).max()).astype(np.float32)


def synthetic_imagenet(n: int, seed: int = 0, start: int = 0,
                       n_classes: int = IMAGENET_CLASSES,
                       noise: float = _IN_NOISE, shift: int = _IN_SHIFT):
    """Examples [start, start+n): (images [n, 256, 256, 3] uint8 HWC —
    JPEG-encodable, unlike the float CIFAR stand-in; labels [n] int32,
    balanced i % n_classes). Each example is its class template randomly
    shifted (edge-padded) + brightness jitter + pixel noise, clipped to
    uint8. Deterministic in (seed, index, noise, shift).

    The defaults give an easy corpus (CaffeNet saturates ~100% by iter
    600 — useful for breakout-timing comparisons); `noise=85, shift=48`
    matches the CIFAR stand-in's calibrated mid-difficulty ratios
    (noise/amp ~1.9, shift ~19% of the frame) for studies that need a
    non-saturating asymptote."""
    tmpl = imagenet_templates(seed, n_classes)
    s = int(shift)
    pad = np.pad(tmpl, ((0, 0), (0, 0), (s, s), (s, s)), mode="edge")
    size = IMAGENET_SIZE
    images = np.empty((n, size, size, 3), np.uint8)
    labels = np.empty((n,), np.int32)
    for j in range(n):
        i = start + j
        r = np.random.default_rng((seed, 2, i))
        c = i % n_classes
        dy, dx = r.integers(-s, s + 1, 2)
        base = pad[c, :, s + dy:s + dy + size, s + dx:s + dx + size]
        img = (base + r.uniform(-_IN_BRIGHT, _IN_BRIGHT)
               + noise * r.standard_normal((3, size, size),
                                           np.float32))
        images[j] = np.clip(img, 0, 255).astype(np.uint8).transpose(1, 2, 0)
        labels[j] = c
    return images, labels


def write_synthetic_ilsvrc_tar(path: str, n: int, seed: int = 0,
                               n_classes: int = IMAGENET_CLASSES,
                               quality: int = 90,
                               noise: float = _IN_NOISE,
                               shift: int = _IN_SHIFT) -> None:
    """Write an ILSVRC2012-layout training tar-of-tars (outer tar of
    per-synset `nXXXXXXXX.tar` members, each holding that class's JPEGs)
    from the synthetic corpus — so `scripts/shard_imagenet.py` ingests it
    through EXACTLY the path real ImageNet takes (synset discovery,
    sorted-synset labels, shuffle, re-shard). Synset c is named
    f"n{c:08d}", so sorted order == label order == template index."""
    import io
    import tarfile

    from PIL import Image

    members = {c: io.BytesIO() for c in range(n_classes)}
    inner = {c: tarfile.open(fileobj=members[c], mode="w")
             for c in range(n_classes)}
    chunk = 512
    for s0 in range(0, n, chunk):
        images, labels = synthetic_imagenet(min(chunk, n - s0), seed=seed,
                                            start=s0, n_classes=n_classes,
                                            noise=noise, shift=shift)
        for k in range(len(labels)):
            c = int(labels[k])
            buf = io.BytesIO()
            Image.fromarray(images[k]).save(buf, format="JPEG",
                                            quality=quality)
            data = buf.getvalue()
            info = tarfile.TarInfo(name=f"n{c:08d}_{s0 + k}.JPEG")
            info.size = len(data)
            inner[c].addfile(info, io.BytesIO(data))
    with tarfile.open(path, "w") as outer:
        for c in range(n_classes):
            inner[c].close()
            blob = members[c].getvalue()
            info = tarfile.TarInfo(name=f"n{c:08d}.tar")
            info.size = len(blob)
            outer.addfile(info, io.BytesIO(blob))
