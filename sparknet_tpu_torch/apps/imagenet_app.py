"""ImageNet training app — the counterpart of `sparknet_tpu/apps/imagenet_app.py`
(reference `apps/ImageNetApp.scala`).

Reference defaults preserved: batch 256, τ=5, eval every 10 rounds, 256×256
input with 227×227 random crop + mean-image subtraction, CaffeNet solver
lr 0.01 step(0.1 @100k) / momentum 0.9 / wd 0.0005
(`ImageNetApp.scala:24-30,127,107`; `models/bvlc_reference_caffenet/
solver.prototxt`), bfloat16.

Two corpus modes, chosen by `--stream {auto,always,never}` against
`--ram-budget-mb` (a budget per machine):
  - cached: decode the machine's shards once into RAM (the native C++
    JPEG plane when it loads, else PIL); rounds draw random windows of
    the decoded corpus. Every rank of a machine holds a copy, so `auto`
    weighs local_size × the machine's decoded estimate against the budget.
  - streaming: never materialize — background threads decode the shard
    stream round by round (`data/streaming.py`), so host RAM holds a few
    rounds of pixels whatever the corpus size. Each checkpoint carries
    the stream cursor, and a resume seeks to it.
`--data-dir` (and `checkpoint_dir`) may be local or a `gs://` / `s3://`
prefix (the port's own clients, `data/gcs.py`, `data/s3.py`).

The mean image is computed over the train corpus (the reference did a
full-image RDD reduce, `ImageNetApp.scala:66-69`) — in streaming mode in
one streamed pass, summed in float64 and all-reduced — or read from the
`mean_image.npz` sidecar under `checkpoint_dir` (the JAX package reads
and writes the same file). `ImagePreprocessor` (crop, mean, cast to the
compute dtype) runs as the loop's `batch_transform` on each τ-slice, on
the round-prep thread, with round-keyed crops; the eval split stays uint8
and is converted per eval batch. The preprocessing route (native or
numpy) is logged.

The topology. A JAX process drives every device of its host and reads
`host_shards(shards, host, n_hosts)` (shards i::k); a port process drives
one card. Rank r is local rank l of the local_size ranks of machine m
(`parallel/mesh.py:machine_topology`, from torchrun's environment), the
JAX package's device l of host m:
  - cached: every rank of machine m decodes `host_shards(shards, m,
    n_machines)`; the loop's `RoundSampler` has local_size workers over
    it and the rank takes block l. That is a JAX world of n_machines
    hosts × local_size devices.
  - streaming: a rank never decodes its siblings' data. With the port's
    `ingest_sources = N`, rank (m, l) runs the readers
    `_split_loaders(host_shards(shards, m, n_machines), N × local_size)
    [l·N:(l+1)·N]` as a one-worker `ParallelStreamingSource` (a
    `StreamingRoundSource` when N = 1). Its round is block l of JAX host
    m's `ParallelStreamingSource` with N × local_size readers, bit for
    bit, and the machine's cursor rows in local-rank order are that
    host's rows. The JAX-equivalent setting is therefore
    `ingest_sources = N × local_size` (the same number at a world of
    one). The JAX app's clamp (at most the shards a machine holds, and a
    divisor of the machine's round) must land on a multiple of
    local_size, or the app raises naming the shard count.
  - the mean: streaming, each rank sums its own readers' shards (disjoint
    over the world) and one float64 all-reduce of (sum, count) gives the
    mean; cached, only local rank 0 of each machine adds its sums (its
    siblings hold the same images).
  - eval: each machine reads `host_shards(val, m, n_machines)`; every rank
    truncates to the smallest val set in the world, and eval is off
    everywhere when any rank has none (`evaluate` is a collective).

Usage (one process per card; a plain launch is a world of one):

    python -m sparknet_tpu_torch.apps.imagenet_app --data-dir DIR \\
        [--device cpu] [--stream auto|always|never] [--config run.json] \\
        [key=value ...]
    torchrun --nproc-per-node 4 -m sparknet_tpu_torch.apps.imagenet_app ...
    torchrun --nnodes 2 --nproc-per-node 4 --node-rank R \\
        --master-addr HOST --master-port PORT \\
        -m sparknet_tpu_torch.apps.imagenet_app --data-dir gs://B/imagenet \\
        --stream always checkpoint_dir=s3://B/ck ...

Exit code 75 is an elastic membership change (`ElasticRelaunch`, a
SystemExit the loop raises at the τ boundary): relaunch at the new
world size with `resume=true` — `python -m sparknet_tpu_torch.parallel.
supervise --nproc 4 -- python -m sparknet_tpu_torch.apps.imagenet_app
...` does so by itself.
"""
from __future__ import annotations

import argparse
import hashlib
import io
import os
import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..data import imagenet
from ..data.dataset import ArrayDataset
from ..data.preprocess import ImagePreprocessor, compute_mean_image
from ..data.streaming import (ParallelStreamingSource, StreamingRoundSource,
                              _split_loaders, streaming_sum_count)
from ..parallel.mesh import DataGroup, init_data_group, machine_topology
from ..schema import Field, Schema
from ..solver import SolverConfig
from ..utils import checkpoint as ckpt
from ..utils.config import RunConfig
from .train_loop import resolve_spec, train

#: a world of one on one machine: (machine, n_machines, local_rank,
#: local_size)
ONE = (0, 1, 0, 1)


def default_config() -> RunConfig:
    return RunConfig(
        model="caffenet", n_classes=1000,
        solver=SolverConfig(base_lr=0.01, momentum=0.9, weight_decay=0.0005,
                            lr_policy="step", gamma=0.1, stepsize=100000,
                            max_iter=450000),
        data_dir="data/imagenet", crop=227, tau=5, local_batch=256,
        eval_every=10, max_rounds=1000, precision="bfloat16")


def host_loader(cfg: RunConfig, split_prefix: str, label_file: str,
                host_id: int = 0, host_count: int = 1
                ) -> imagenet.ShardedTarLoader:
    """Machine `host_id`'s loader: shards i::k of the split."""
    shards = imagenet.host_shards(
        imagenet.list_shards(cfg.data_dir, prefix=split_prefix),
        host_id, host_count)
    labels = imagenet.load_label_map(f"{cfg.data_dir}/{label_file}")
    return imagenet.ShardedTarLoader(shards, labels, height=256, width=256)


def load_corpus(cfg: RunConfig, split_prefix: str, label_file: str,
                host_id: int = 0, host_count: int = 1,
                limit: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    return host_loader(cfg, split_prefix, label_file,
                       host_id, host_count).load_all(limit or None)


def _should_stream(mode: str, n_host_images: float, budget_mb: int,
                   height: int = 256, width: int = 256) -> bool:
    """auto: estimate the decoded corpus's peak RAM on this machine.
    Force-resize makes every decoded image exactly height*width*3 bytes
    regardless of its JPEG size, and load_all's list-then-stack doubles
    the peak. `n_host_images` counts every copy the machine would hold."""
    if mode in ("always", "never"):
        return mode == "always"
    decoded = n_host_images * (height * width * 3) * 2
    return decoded > budget_mb * (1 << 20)


def _host_image_estimate(loader, cfg: RunConfig, prefix: str,
                         pc: int) -> float:
    """This machine's share of the labeled images, weighted by its shards'
    BYTE share rather than 1/n_machines: i::k shard assignment can be
    uneven, and the label map counts images in other machines' tars."""
    n_total = len(loader.label_map)
    if pc == 1:
        return float(n_total)
    try:
        all_bytes = sum(imagenet.path_size(p) for p in
                        imagenet.list_shards(cfg.data_dir, prefix=prefix))
        mine = sum(imagenet.path_size(p) for p in loader.shard_paths)
    except OSError:
        return n_total / pc
    if all_bytes <= 0:
        return n_total / pc
    return n_total * (mine / all_bytes)


def _corpus_id(cfg: RunConfig, prefix: str, train_loader,
               pc: int = 1) -> str:
    """Identity of the train corpus a mean sidecar was computed from: the
    label count + the GLOBAL shard listing (name:size per shard) — the JAX
    package's `_corpus_id`, so the two packages' sidecars agree. Only a
    world of one machine may fall back to the loader's own shards; over
    several machines the listing must succeed, or the machines would hash
    different subsets and disagree on the sidecar."""
    try:
        shards = imagenet.list_shards(cfg.data_dir, prefix=prefix)
    except OSError:
        if pc > 1:
            raise
        shards = train_loader.shard_paths
    sig = ";".join(
        f"{os.path.basename(p)}:{imagenet.path_size(p)}" for p in shards)
    return hashlib.sha1(
        f"{len(train_loader.label_map)}|{sig}".encode()).hexdigest()


def _combine_mean(local_sum: np.ndarray, local_count: float,
                  group: Optional[DataGroup] = None) -> np.ndarray:
    """The global mean image from every rank's float64 (sum, count): one
    all-reduce over the group (the JAX package allgathers per host and
    sums; the order differs, so the two agree within 1 float32 ulp)."""
    if group is None or group.size == 1:
        return (local_sum / local_count).astype(np.float32)
    flat = np.concatenate([np.asarray(local_sum, np.float64).ravel(),
                           [float(local_count)]])
    t = group.all_reduce_sum_(torch.from_numpy(flat).to(group.device))
    t = t.cpu().numpy()
    return (t[:-1] / t[-1]).reshape(local_sum.shape).astype(np.float32)


def _global_mean_image(images: np.ndarray, group: Optional[DataGroup] = None,
                       topo=ONE) -> np.ndarray:
    """The mean over every machine's decoded corpus. The ranks of a
    machine hold the same images, so only local rank 0 adds its sums."""
    if group is None or group.size == 1:
        return compute_mean_image(images)
    if topo[2] == 0:
        return _combine_mean(images.sum(axis=0, dtype=np.float64),
                             float(len(images)), group)
    return _combine_mean(np.zeros(images.shape[1:], np.float64), 0.0, group)


def _load_or_compute_mean(cfg: RunConfig, train_loader,
                          images: Optional[np.ndarray], app_name: str,
                          prefix: str = "train.",
                          group: Optional[DataGroup] = None, topo=ONE,
                          sum_loader=None, workers: int = 1) -> np.ndarray:
    """The corpus's mean image, persisted as `mean_image.npz` under
    `checkpoint_dir` (local or a bucket) with the corpus identity (the
    JAX package's sidecar format; either package reads the other's). A
    sidecar of this corpus is loaded; one of another corpus is recomputed
    loudly. Computed from the decoded `images` (cached), or, when
    `images` is None, in one streamed pass over `sum_loader` (this rank's
    shards, `workers` threads) and all-reduced; written by rank 0. No
    checkpoint_dir -> no persistence. The ranks load the sidecar only
    when every one of them can; otherwise all compute (collectively)."""
    side_dir = cfg.checkpoint_dir or None
    corpus = _corpus_id(cfg, prefix, train_loader, topo[1])
    raw = (ckpt.read_file(side_dir, "mean_image.npz") if side_dir
           else None)
    side = f"{side_dir}/mean_image.npz"
    loaded = None
    if raw is not None:
        with np.load(io.BytesIO(raw)) as z:
            saved = str(z["corpus_id"]) if "corpus_id" in z else None
            mean = z["mean"]
        if saved == corpus:
            loaded = mean.astype(np.float32)
        else:
            print(f"{app_name}: {side} was computed from a DIFFERENT corpus "
                  f"(saved id {saved} != {corpus}) — recomputing the mean",
                  file=sys.stderr)
    if group is not None and group.size > 1:
        # the compute below is collective: load only when every rank can,
        # or a store that shows the sidecar to some ranks first would
        # strand the others in the all-reduce
        seen = torch.tensor([loaded is not None], dtype=torch.int64,
                            device=group.device)
        if not bool(group.all_gather(seen).all()):
            loaded = None
    if loaded is not None:
        print(f"{app_name}: mean image loaded from {side} "
              f"(skipping the corpus pass)", file=sys.stderr)
        return loaded
    if images is not None:
        mean = _global_mean_image(images, group, topo)
    else:
        s, n = streaming_sum_count(sum_loader or train_loader,
                                   workers=workers)
        mean = _combine_mean(s, float(n), group)
    if side_dir and (group is None or group.rank == 0):
        buf = io.BytesIO()
        np.savez(buf, mean=mean, corpus_id=np.array(corpus))
        ckpt.write_file(side_dir, "mean_image.npz", buf.getvalue())
    return mean


def _agree_eval_dataset(test_ds: Optional[ArrayDataset],
                        group: Optional[DataGroup] = None
                        ) -> Optional[ArrayDataset]:
    """Make every rank agree on the eval workload: `evaluate` is a
    collective, so ranks holding different val sizes (uneven tar shards
    over the machines) would run different numbers of eval calls and
    deadlock. All truncate to the smallest size in the world; if any rank
    has nothing, eval is off everywhere."""
    if group is None or group.size == 1:
        return test_ds
    mine = torch.tensor([len(test_ds) if test_ds is not None else 0],
                        dtype=torch.int64, device=group.device)
    m = int(group.all_gather(mine).min())
    if m == 0:
        return None
    return ArrayDataset({k: v[:m] for k, v in test_ds.arrays.items()})


def _rank_readers(cfg: RunConfig, train_loader, total: int, topo,
                  app_name: str) -> list:
    """This rank's shard readers (module docstring, the topology): the
    JAX app's clamp of `ingest_sources` × local_size to the shards every
    machine holds and to a divisor of the machine's round, landing on a
    multiple of local_size; raises when it cannot."""
    _, pc, lr, ls = topo
    want = max(1, cfg.ingest_sources) * ls
    eff = max(1, min(want, total // pc))
    round_examples = ls * cfg.local_batch * cfg.tau
    while eff >= ls and (round_examples % eff or eff % ls):
        eff -= 1
    if eff < ls:
        raise ValueError(
            f"streaming ingest needs at least one shard reader per rank: "
            f"{total} train shards over {pc} machines give at most "
            f"{total // pc} readers a machine, fewer than its {ls} ranks "
            f"(or no multiple of {ls} divides the machine's round of "
            f"{round_examples} examples); write more shards")
    if eff != want:
        print(f"{app_name}: ingest_sources reduced {want} -> {eff} "
              f"(shards={total}, hosts={pc}, round={round_examples}; "
              f"{eff // ls} a rank)", file=sys.stderr)
    per = eff // ls
    readers = _split_loaders(train_loader.shard_paths,
                             train_loader.label_map, eff,
                             256, 256)[lr * per:(lr + 1) * per]
    if len(readers) != per or not all(r.shard_paths for r in readers):
        raise ValueError(
            f"rank {lr} of its machine holds fewer shards than its {per} "
            f"readers ({len(train_loader.shard_paths)} shards a machine)")
    return readers


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
                   "cache decoded pixels in RAM (auto: by --ram-budget-mb)")
    p.add_argument("--ram-budget-mb", type=int, default=8192,
                   help="decoded-corpus RAM budget per machine for "
                   "--stream=auto (every rank of a machine holds a copy)")
    p.add_argument("--val-limit", type=int, default=0,
                   help="cap resident val examples per machine (0 = all); "
                   "the val "
                   "split is held as uint8, ~192 KiB per image")
    p.add_argument("overrides", nargs="*")


def prepare_data(cfg: RunConfig, args, label_shape: Tuple[int, ...] = (1,),
                 app_name: str = "imagenet_app",
                 group: Optional[DataGroup] = None):
    """Everything between the parsed CLI and the training loop: the
    machine's loaders, the cache-vs-stream decision, the global mean
    image, the preprocessors, the train source and the val dataset.
    `group` is the data group (None: a world of one); the mean image and
    the eval agreement are collective over it. Returns (train source —
    a decoded ArrayDataset or a streaming round source —, test_ds or
    None, pp_train, pp_eval, info) with info = {"decode_s", "mean_s",
    "skipped", "route", "streaming"}."""
    topo = machine_topology(group)
    machine, pc, local_rank, local_size = topo
    if group is None and pc * local_size > 1:
        raise ValueError(f"a world of {pc * local_size} ranks needs the "
                         f"data group: pass group=")
    train_loader = host_loader(cfg, args.train_prefix, args.train_labels,
                               host_id=machine, host_count=pc)
    streaming = _should_stream(
        args.stream, local_size * _host_image_estimate(
            train_loader, cfg, args.train_prefix, pc), args.ram_budget_mb)
    t0 = time.perf_counter()
    mine, workers = None, 1
    if streaming:
        images = labels = None
        total = len(imagenet.list_shards(cfg.data_dir,
                                         prefix=args.train_prefix))
        readers = _rank_readers(cfg, train_loader, total, topo, app_name)
        decode_s = 0.0
        # the mean pass walks this rank's shards; a one-reader rank shares
        # its loader (and its member-index cache) with the training stream
        mine = (readers[0] if len(readers) == 1 else
                imagenet.ShardedTarLoader(
                    sorted(p for r in readers for p in r.shard_paths),
                    train_loader.label_map, height=256, width=256))
        workers = max(len(readers),
                      min(8, (os.cpu_count() or 1) // local_size))
    else:
        images, labels = train_loader.load_all()
        decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mean = None
    if cfg.subtract_mean:
        mean = _load_or_compute_mean(cfg, train_loader, images, app_name,
                                     prefix=args.train_prefix, group=group,
                                     topo=topo, sum_loader=mine,
                                     workers=workers)
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
    if streaming:
        # one worker: this rank's batch (the loop takes block 0)
        train_raw = (ParallelStreamingSource(readers, 1, cfg.local_batch,
                                             cfg.tau)
                     if len(readers) > 1 else
                     StreamingRoundSource(readers[0], 1, cfg.local_batch,
                                          cfg.tau))
        skipped = mine.skipped
        print(f"{app_name}: streaming corpus on machine {machine} of {pc}, "
              f"local rank {local_rank} of {local_size}: "
              f"{len(readers)} shard reader(s) over "
              f"{sum(len(r.shard_paths) for r in readers)} of the "
              f"machine's {len(train_loader.shard_paths)} shards",
              file=sys.stderr)
    else:
        train_raw = ArrayDataset({"data": images, "label": labels[:, None]})
        skipped = train_loader.skipped
    try:
        # --val-limit caps DECODING, not just the slice
        val_images, val_labels = load_corpus(cfg, args.val_prefix,
                                             args.val_labels,
                                             host_id=machine, host_count=pc,
                                             limit=args.val_limit)
        # RAW uint8: pp_eval runs per eval batch inside the loop
        test_ds = ArrayDataset({"data": val_images,
                                "label": val_labels[:, None]})
    except (FileNotFoundError, ValueError) as e:
        print(f"{app_name}: eval disabled on machine {machine}: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        test_ds = None
    test_ds = _agree_eval_dataset(test_ds, group)
    from ..data import jpeg_plane
    route = pp_train.route(np.zeros((1, 3, 256, 256), np.uint8))
    why = jpeg_plane.unavailable_reason()
    decoder = "native" if jpeg_plane.available() else "PIL"
    if streaming:
        what = (f"streaming (decoder {decoder}, on the stream's "
                f"thread{'s' if len(readers) > 1 else ''})")
    else:
        what = (f"{len(images)} train images decoded in {decode_s:.2f}s "
                f"({skipped} skipped, decoder {decoder})")
    print(f"{app_name}: {what}; mean image in {mean_s:.2f}s; "
          f"preprocessing route: {route}" + (f" ({why})" if why else ""),
          file=sys.stderr)
    return train_raw, test_ds, pp_train, pp_eval, {
        "decode_s": decode_s, "mean_s": mean_s, "skipped": skipped,
        "route": route, "streaming": streaming}


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
    # the group comes first: the mean image and the eval agreement are
    # collective (train() joins the same group)
    group = init_data_group(args.device, workdir=cfg.workdir)
    try:
        train_raw, test_ds, pp_train, pp_eval, _ = prepare_data(
            cfg, args, group=group)
        try:
            crop = cfg.crop = cfg.crop or 227
            spec = resolve_spec(cfg, data=(cfg.local_batch, 3, crop, crop),
                                label=(cfg.local_batch, 1))
            train(cfg, spec, train_raw, test_ds, batch_transform=pp_train,
                  eval_transform=pp_eval, device=args.device)
        finally:
            if hasattr(train_raw, "close"):
                train_raw.close()
    finally:
        group.close()


if __name__ == "__main__":
    main()
