"""ImageNet training app — the counterpart of `sparknet_tpu/apps/imagenet_app.py`
(reference `apps/ImageNetApp.scala`), in its cached corpus mode.

Reference defaults preserved: batch 256, τ=5, eval every 10 rounds, 256×256
input with 227×227 random crop + mean-image subtraction, CaffeNet solver
lr 0.01 step(0.1 @100k) / momentum 0.9 / wd 0.0005
(`ImageNetApp.scala:24-30,127,107`; `models/bvlc_reference_caffenet/
solver.prototxt`), bfloat16.

Ingest: the tar shards are decoded once into RAM (the native C++ JPEG plane
when it loads, else PIL), the global mean image is computed over them (the
reference did a full-image RDD reduce, `ImageNetApp.scala:66-69`) or read
from the `mean_image.npz` sidecar under `checkpoint_dir` (the JAX package
reads and writes the same file), and rounds draw random windows of the
decoded corpus. `ImagePreprocessor` (crop, mean, cast to the compute dtype)
runs as the loop's `batch_transform` on each τ-slice, on the round-prep
thread, with round-keyed crops; the eval split stays uint8 and is
converted per eval batch. The preprocessing route (native or numpy) is
logged.

Every rank on a machine reads every shard (as the CIFAR app does) and the
loop's sampler gives each rank its block. Not ported yet, and refused with
NotImplementedError: streaming ingest (`--stream always`, or `auto` above
`--ram-budget-mb`), a world spread over several machines (the multi-host
shard split and mean combine), and bucket data dirs (gs://, s3://).

Usage (one process per card; a plain launch is a world of one):

    python -m sparknet_tpu_torch.apps.imagenet_app --data-dir DIR \\
        [--device cpu] [--config run.json] [key=value ...]
    torchrun --nproc-per-node 4 -m sparknet_tpu_torch.apps.imagenet_app ...
"""
from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time
from typing import Tuple

import numpy as np

from ..data import imagenet
from ..data.dataset import ArrayDataset
from ..data.preprocess import ImagePreprocessor, compute_mean_image
from ..schema import Field, Schema
from ..solver import SolverConfig
from ..utils.config import RunConfig
from .train_loop import resolve_spec, train


def default_config() -> RunConfig:
    return RunConfig(
        model="caffenet", n_classes=1000,
        solver=SolverConfig(base_lr=0.01, momentum=0.9, weight_decay=0.0005,
                            lr_policy="step", gamma=0.1, stepsize=100000,
                            max_iter=450000),
        data_dir="data/imagenet", crop=227, tau=5, local_batch=256,
        eval_every=10, max_rounds=1000, precision="bfloat16")


def host_loader(cfg: RunConfig, split_prefix: str, label_file: str
                ) -> imagenet.ShardedTarLoader:
    shards = imagenet.list_shards(cfg.data_dir, prefix=split_prefix)
    labels = imagenet.load_label_map(f"{cfg.data_dir}/{label_file}")
    return imagenet.ShardedTarLoader(shards, labels, height=256, width=256)


def load_corpus(cfg: RunConfig, split_prefix: str, label_file: str,
                limit: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    return host_loader(cfg, split_prefix, label_file).load_all(
        limit or None)


def _should_stream(mode: str, n_host_images: float, budget_mb: int,
                   height: int = 256, width: int = 256) -> bool:
    """auto: estimate the decoded corpus's peak RAM. Force-resize makes
    every decoded image exactly height*width*3 bytes regardless of its
    JPEG size, and load_all's list-then-stack doubles the peak."""
    if mode in ("always", "never"):
        return mode == "always"
    decoded = n_host_images * (height * width * 3) * 2
    return decoded > budget_mb * (1 << 20)


def _corpus_id(cfg: RunConfig, prefix: str, train_loader) -> str:
    """Identity of the train corpus a mean sidecar was computed from: the
    label count + the shard listing (name:size per shard) — the JAX
    package's `_corpus_id`, so the two packages' sidecars agree."""
    try:
        shards = imagenet.list_shards(cfg.data_dir, prefix=prefix)
    except OSError:
        shards = train_loader.shard_paths
    sig = ";".join(
        f"{os.path.basename(p)}:{imagenet.path_size(p)}" for p in shards)
    return hashlib.sha1(
        f"{len(train_loader.label_map)}|{sig}".encode()).hexdigest()


def _load_or_compute_mean(cfg: RunConfig, train_loader, images: np.ndarray,
                          app_name: str, prefix: str = "train.",
                          rank: int = 0) -> np.ndarray:
    """The corpus's mean image, persisted as `mean_image.npz` next to the
    checkpoints with the corpus identity (the JAX package's sidecar
    format; either package reads the other's). A sidecar of this corpus
    is loaded; one of another corpus is recomputed loudly. Computed from
    the decoded `images` (`compute_mean_image`) and written atomically by
    rank 0. No checkpoint_dir -> no persistence."""
    side = (os.path.join(cfg.checkpoint_dir, "mean_image.npz")
            if cfg.checkpoint_dir else None)
    corpus = _corpus_id(cfg, prefix, train_loader)
    if side and os.path.exists(side):
        with np.load(side) as z:
            saved = str(z["corpus_id"]) if "corpus_id" in z else None
            mean = z["mean"]
        if saved == corpus:
            print(f"{app_name}: mean image loaded from {side} "
                  f"(skipping the corpus pass)", file=sys.stderr)
            return mean.astype(np.float32)
        print(f"{app_name}: {side} was computed from a DIFFERENT corpus "
              f"(saved id {saved} != {corpus}) — recomputing the mean",
              file=sys.stderr)
    mean = compute_mean_image(images)
    if side and rank == 0:
        os.makedirs(cfg.checkpoint_dir, exist_ok=True)
        tmp = f"{side}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, mean=mean, corpus_id=np.array(corpus))
        os.replace(tmp, side)
    return mean


def _check_one_machine() -> int:
    """This rank's index; raises when the world spans several machines
    (torchrun's WORLD_SIZE above LOCAL_WORLD_SIZE)."""
    world = int(os.environ.get("WORLD_SIZE", 1))
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world != local:
        raise NotImplementedError(
            f"a world of {world} ranks over several machines ({local} on "
            f"this one) needs the multi-host shard split and mean combine, "
            f"which are not ported to the PyTorch port yet; run on one "
            f"machine")
    return int(os.environ.get("RANK", 0))


def add_data_args(p: argparse.ArgumentParser) -> None:
    """The ImageNet corpus CLI surface (the JAX app's)."""
    p.add_argument("--config", help="RunConfig JSON path")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--train-prefix", default="train.")
    p.add_argument("--val-prefix", default="val.")
    p.add_argument("--train-labels", default="train.txt")
    p.add_argument("--val-labels", default="val.txt")
    p.add_argument("--stream", choices=("auto", "always", "never"),
                   default="auto", help="corpus mode: stream shards vs "
                   "cache decoded pixels in RAM (auto: by --ram-budget-mb; "
                   "streaming is not ported yet)")
    p.add_argument("--ram-budget-mb", type=int, default=8192,
                   help="decoded-corpus RAM budget for --stream=auto")
    p.add_argument("--val-limit", type=int, default=0,
                   help="cap resident val examples (0 = all); the val "
                   "split is held as uint8, ~192 KiB per image")
    p.add_argument("overrides", nargs="*")


def prepare_data(cfg: RunConfig, args, label_shape: Tuple[int, ...] = (1,),
                 app_name: str = "imagenet_app"):
    """Everything between the parsed CLI and the training loop: the
    decoded train corpus, its mean image, the preprocessors and the val
    dataset. Returns (train_ds, test_ds or None, pp_train, pp_eval, info)
    with info = {"decode_s", "mean_s", "skipped", "route"}."""
    rank = _check_one_machine()
    train_loader = host_loader(cfg, args.train_prefix, args.train_labels)
    if _should_stream(args.stream, float(len(train_loader.label_map)),
                      args.ram_budget_mb):
        raise NotImplementedError(
            f"streaming ingest (--stream {args.stream}"
            + (f", a corpus above --ram-budget-mb {args.ram_budget_mb}"
               if args.stream == "auto" else "")
            + ") is not ported to the PyTorch port yet; use --stream never "
            "to decode the corpus into RAM")
    t0 = time.perf_counter()
    images, labels = train_loader.load_all()
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mean = (_load_or_compute_mean(cfg, train_loader, images, app_name,
                                  prefix=args.train_prefix, rank=rank)
            if cfg.subtract_mean else None)
    mean_s = time.perf_counter() - t0
    crop = cfg.crop or 227
    # schema describes the preprocessor OUTPUT: NHWC device layout
    schema = Schema(Field("data", "float32", (crop, crop, 3)),
                    Field("label", "int32", label_shape))
    out_dt = "bfloat16" if cfg.precision == "bfloat16" else "float32"
    pp_train = ImagePreprocessor(schema, mean_image=mean, crop=crop,
                                 seed=cfg.seed, out_dtype=out_dt)
    pp_eval = ImagePreprocessor(schema, mean_image=mean, crop=crop,
                                seed=cfg.seed, out_dtype=out_dt)
    train_ds = ArrayDataset({"data": images, "label": labels[:, None]})
    try:
        # --val-limit caps DECODING, not just the slice
        val_images, val_labels = load_corpus(cfg, args.val_prefix,
                                             args.val_labels,
                                             limit=args.val_limit)
        # RAW uint8: pp_eval runs per eval batch inside the loop
        test_ds = ArrayDataset({"data": val_images,
                                "label": val_labels[:, None]})
    except (FileNotFoundError, ValueError) as e:
        print(f"{app_name}: eval disabled: {type(e).__name__}: {e}",
              file=sys.stderr)
        test_ds = None
    from ..data import jpeg_plane
    route = pp_train.route(images[:1])
    why = jpeg_plane.unavailable_reason()
    print(f"{app_name}: {len(images)} train images decoded in "
          f"{decode_s:.2f}s ({train_loader.skipped} skipped, decoder "
          f"{'native' if jpeg_plane.available() else 'PIL'}); mean image "
          f"in {mean_s:.2f}s; preprocessing route: {route}"
          + (f" ({why})" if why else ""), file=sys.stderr)
    return train_ds, test_ds, pp_train, pp_eval, {
        "decode_s": decode_s, "mean_s": mean_s,
        "skipped": train_loader.skipped, "route": route}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    add_data_args(p)
    p.add_argument("--device", default=None,
                   help="cuda (default: this rank's card) or cpu")
    args = p.parse_args(argv)
    cfg = (RunConfig.from_json(args.config) if args.config
           else default_config())
    if args.data_dir:
        cfg.data_dir = args.data_dir
    cfg = cfg.with_overrides(*args.overrides)
    train_ds, test_ds, pp_train, pp_eval, _ = prepare_data(cfg, args)
    crop = cfg.crop = cfg.crop or 227
    spec = resolve_spec(cfg, data=(cfg.local_batch, 3, crop, crop),
                        label=(cfg.local_batch, 1))
    train(cfg, spec, train_ds, test_ds, batch_transform=pp_train,
          eval_transform=pp_eval, device=args.device)


if __name__ == "__main__":
    main()
