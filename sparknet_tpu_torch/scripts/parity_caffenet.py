"""CaffeNet-shape convergence evidence.

The port's counterpart of the JAX package's `scripts/parity_caffenet.py`.
It runs the bvlc_reference_caffenet recipe — base_lr 0.01, momentum 0.9,
weight_decay 0.0005, lr step/100k (`models/bvlc_reference_caffenet/
solver.prototxt:4-11`), batch 256 per worker, τ=5 sync interval, random
round windows inside per-worker partitions, full-size mean subtract then
random 227 crop, no mirror (`apps/ImageNetApp.scala:100-144`,
`libs/Preprocessor.scala:54-83`) — on a class-conditional learnable
synthetic 256x256 JPEG corpus of 64 classes, once per entry of
`--workers-runs` (default: 1 worker, serial SGD, and 8 workers with τ=5
parameter averaging), all under the bfloat16 policy on the card. The net
is full-width `caffenet(batch=256, crop=227, n_classes=1000)`, the head
the JAX script builds (the corpus's labels fill 64 of its classes): its
step runs the port's LRN kernels (`lrn_fwd`, `lrn_bwd` in its recompute
route) and `maxpool_bwd` in a real trajectory, with dropout across
workers and grouped convolutions. `--n-classes 64` builds a head of the
corpus's width instead; on the H100 neither its serial nor its averaged
runs leave the ln(64) plateau within 1500 iterations, in bfloat16 or
float32, where the 1000-way head's do.

The corpus takes the real data path: `data/synth.py:
write_synthetic_ilsvrc_tar` emits an ILSVRC2012-layout tar-of-tars,
`scripts/shard_imagenet.py` re-shards it as it would real ImageNet, the
mean image comes from the multi-reader streaming pass
(`streaming_sum_count`), and every training pixel is decoded by
`ShardedTarLoader`. The decoded uint8 corpus is staged on the card once;
the per-example mean subtraction and random crop run there (`prep`) with
the reference's semantics (subtract the full-size mean, then crop;
offsets uniform per image per draw, drawn on the host), then the cast to
the compute dtype.

The round is `study.WorkerRounds`: the W workers run one after another
(the JAX script scans them to hold one worker's activations at a time),
each with its own momentum and its own dropout generators
(`seeded_generator((1000 + seed, round, w, t))`: a one-worker round is
`ParallelTrainer.train_round` at one rank with the round key (1000 +
seed, round)), then the params' mean. The initial weights come from a
seeded torch generator (the port's own curves).

Run: python -m sparknet_tpu_torch.scripts.parity_caffenet [--iters 1500]
         [--workers-runs 1,8] [--hard] [--out PARITY_CAFFENET_torch.json]
         [--device cpu]
(the card by default; without one it raises unless `--device cpu`).
"""
from __future__ import annotations

import argparse
import glob
import io
import json
import os
import sys
import tarfile
import time
from typing import Optional

import numpy as np
import torch

from .. import precision
from ..data import imagenet, synth
from ..data.streaming import streaming_sum_count
from ..device import resolve_device
from ..model.net import CompiledNet
from ..obs.meta import run_metadata
from ..solver import SolverConfig
from ..zoo import caffenet
from . import shard_imagenet
from .study import WorkerRounds, card_line, cross_iter, losses_summary

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

BATCH = 256          # per worker (solver.prototxt net batch)
TAU = 5              # syncInterval = 5 (ImageNetApp.scala:128)
SIZE, CROP = 256, 227
N_TRAIN = 16384      # 64 classes x 256 examples
N_VAL = 2048
N_CLASSES = 1000     # fc8's width: the zoo's head, as the JAX script
                     # builds it (the labels fill synth.IMAGENET_CLASSES)
EVAL_ITERS = 50      # evaluate at (the first round boundary at/after)
                     # every 50 ITERATIONS — an iteration grid, not a
                     # round grid, so runs at different tau produce
                     # comparable curves (quantization <= tau-1 iters)


def solver_config() -> SolverConfig:
    """models/bvlc_reference_caffenet/solver.prototxt:4-11 verbatim."""
    return SolverConfig(base_lr=0.01, momentum=0.9, weight_decay=0.0005,
                        lr_policy="step", gamma=0.1, stepsize=100000)


#: CIFAR-stand-in-calibrated mid-difficulty corpus (noise/amp ~1.9,
#: shift ~19% of frame): non-saturating asymptote for gap studies
HARD = {"noise": 85.0, "shift": 48}
EASY = {"noise": synth._IN_NOISE, "shift": synth._IN_SHIFT}


# -- dataset: synth -> ILSVRC tar-of-tars -> shard_imagenet ------------------

def ensure_dataset(data_dir: str, n_train: int, seed: int = 0,
                   gen=EASY) -> None:
    """Idempotent: build the sharded synthetic corpus if absent. The
    completeness marker encodes the generator params — a directory built
    with different noise/shift is never silently reused."""
    marker = os.path.join(
        data_dir, f".complete_{n_train}_{seed}"
                  f"_n{gen['noise']:g}_s{gen['shift']}")
    if os.path.exists(marker):
        return
    os.makedirs(data_dir, exist_ok=True)
    for stale in glob.glob(os.path.join(data_dir, ".complete_*")):
        os.remove(stale)  # an in-place rebuild must invalidate OTHER
        #                   generators' markers, or a later call with the
        #                   old params would silently reuse this corpus
    t0 = time.time()
    train_tot = os.path.join(data_dir, "_synth_ilsvrc_train.tar")
    print(f"building synthetic ILSVRC tar-of-tars ({n_train} train, "
          f"{gen})...", file=sys.stderr)
    synth.write_synthetic_ilsvrc_tar(train_tot, n_train, seed=seed, **gen)
    shard_imagenet.shard_train(train_tot, data_dir, shards=32, size=SIZE,
                               seed=seed)
    os.remove(train_tot)

    # val: flat JPEG tar + "filename label" truth file -> shard_val
    from PIL import Image
    val_tar = os.path.join(data_dir, "_synth_val_flat.tar")
    truth = os.path.join(data_dir, "_synth_val_truth.txt")
    images, labels = synth.synthetic_imagenet(N_VAL, seed=seed,
                                              start=n_train, **gen)
    with tarfile.open(val_tar, "w") as tar, open(truth, "w") as tf:
        for k in range(N_VAL):
            buf = io.BytesIO()
            Image.fromarray(images[k]).save(buf, format="JPEG", quality=90)
            data = buf.getvalue()
            info = tarfile.TarInfo(name=f"synth_val_{k:08d}.JPEG")
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
            tf.write(f"synth_val_{k:08d}.JPEG {int(labels[k])}\n")
    shard_imagenet.shard_val(val_tar, truth, data_dir, shards=4, size=SIZE,
                             seed=seed)
    os.remove(val_tar)
    open(marker, "w").close()
    print(f"dataset ready under {data_dir} "
          f"({time.time() - t0:.0f}s)", file=sys.stderr)


def load_split(data_dir: str, prefix: str, labels_file: str):
    """Decode a whole split through `ShardedTarLoader` -> (uint8 NHWC
    [n,256,256,3], int32 [n], the loader)."""
    label_map = imagenet.load_label_map(os.path.join(data_dir, labels_file))
    loader = imagenet.ShardedTarLoader(
        imagenet.list_shards(data_dir, prefix=prefix), label_map,
        height=SIZE, width=SIZE)
    images, labels = loader.load_all()
    return (np.ascontiguousarray(images.transpose(0, 2, 3, 1)),
            labels.astype(np.int32), loader)


# -- the round: reference preprocessing + ParallelTrainer math, on the card --

def prep(corpus: torch.Tensor, mean_hwc: torch.Tensor, ix: torch.Tensor,
         offs: torch.Tensor, crop: int, dtype: torch.dtype) -> torch.Tensor:
    """Images `ix` of the uint8 NHWC corpus, minus the full-size mean,
    cropped to crop x crop at the per-example (y, x) `offs` ([b, 2]), cast
    to `dtype`: the reference's subtract-then-crop
    (`Preprocessor.scala:54-83`), gathered on the corpus's device. Only
    the cropped pixels are read; the subtraction is elementwise, so the
    values are those of a crop of the whole mean-subtracted image."""
    ar = torch.arange(crop, device=corpus.device)
    rows = (offs[:, 0:1].long() + ar)[:, :, None]     # [b, crop, 1]
    cols = (offs[:, 1:2].long() + ar)[:, None, :]     # [b, 1, crop]
    pix = corpus[ix[:, None, None], rows, cols]       # [b, crop, crop, 3]
    return (pix.float() - mean_hwc[rows, cols]).to(dtype)


def make_round_fn(workers: WorkerRounds, crop: int = CROP):
    """`round_fn(idx, offs, keys, corpus, labels, mean_hwc) -> mean loss`:
    one round of `workers`; worker w's step t takes images `idx[w, t]`
    ([W, tau, b], on the corpus's device) prepared at offsets `offs[w, t]`
    ([W, tau, b, 2]) in the compute dtype the caller's policy gives; the
    round key `keys` seeds the dropout generators."""
    cdt = precision.compute_dtype()

    def round_fn(idx, offs, keys, corpus, labels, mean_hwc):
        def batch_at(w, t):
            return {"data": prep(corpus, mean_hwc, idx[w, t], offs[w, t],
                                 crop, cdt),
                    "label": labels[idx[w, t]][:, None]}
        return workers.round(batch_at, keys)

    return round_fn


def make_eval_fn(net: CompiledNet, batch: int, n_val: int,
                 crop: int = CROP):
    """`eval_all(params, corpus, labels, offs, mean_hwc) -> float`: top-1
    from the fc8 argmax over the first n_val // batch full batches, the
    SAME random-crop preprocessing the reference's test path ran
    (`ImageNetApp.scala` testDF mapPartitions -> forward), offsets `offs`
    ([n_val, 2]); one host sync at the end."""
    n_batches = n_val // batch
    cdt = precision.compute_dtype()

    def eval_all(params, corpus, labels, offs, mean_hwc) -> float:
        accs = []
        with torch.no_grad():
            for i in range(n_batches):
                ix = torch.arange(i * batch, (i + 1) * batch,
                                  device=corpus.device)
                x = prep(corpus, mean_hwc, ix, offs[ix], crop, cdt)
                lab = labels[ix]
                blobs = net.apply(params, {"data": x, "label": lab[:, None]},
                                  train=False)
                accs.append((blobs["fc8"].argmax(-1) == lab).float().mean())
        return float(torch.stack(accs).mean())

    return eval_all


def build_net(batch: int = BATCH, crop: int = CROP,
              n_classes: int = N_CLASSES) -> CompiledNet:
    return CompiledNet.compile(caffenet(batch=batch, crop=crop,
                                        n_classes=n_classes))


def run(n_workers: int, iters: int, data, seed: int = 0, tau: int = TAU,
        batch: int = BATCH, crop: int = CROP,
        size: int = SIZE, n_classes: int = N_CLASSES,
        policy: str = "bfloat16") -> dict:
    """One curve. `data` = (corpus uint8 NHWC size x size, labels int32,
    mean HWC float32, val corpus, val labels, n_train), tensors on the
    device the run uses; the eval runs over the val set's full batches.
    The shapes are the recipe's unless a caller cuts them (the tests)."""
    (corpus, labels, mean_hwc, val, val_labels, n_train) = data
    dev = corpus.device
    precision.set_policy(policy)
    net = build_net(batch=batch, crop=crop, n_classes=n_classes)
    rounds = -(-iters // tau)  # ceil: tau runs compare at >= iters, and
    #                            the artifact records the actual count
    t0 = time.time()

    params0 = net.init_params(torch.Generator().manual_seed(seed), dev)
    workers = WorkerRounds(net, solver_config(), n_workers, tau, params0)
    round_fn = make_round_fn(workers, crop=crop)
    n_val = len(val)
    eval_fn = make_eval_fn(net, batch, n_val, crop=crop)

    part = n_train // n_workers
    if part < tau * batch:
        raise ValueError(f"{n_workers} workers' partitions of {part} "
                         f"images are smaller than one round window "
                         f"({tau} x {batch}): more --n-train or fewer "
                         f"workers")
    r = np.random.default_rng((seed, n_workers))

    def round_inputs():
        idx = np.empty((n_workers, tau, batch), np.int32)
        for w in range(n_workers):
            start = w * part + r.integers(0, part - tau * batch + 1)
            idx[w] = np.arange(start, start + tau * batch).reshape(tau,
                                                                   batch)
        offs = r.integers(0, size - crop + 1,
                          (n_workers, tau, batch, 2)).astype(np.int32)
        return (torch.from_numpy(idx).to(dev, torch.int64),
                torch.from_numpy(offs).to(dev))

    ev_r = np.random.default_rng((seed, 0xE7A1))

    def evaluate():
        offs = ev_r.integers(0, size - crop + 1, (n_val, 2)).astype(np.int32)
        return eval_fn(workers.params, val, val_labels,
                       torch.from_numpy(offs).to(dev), mean_hwc)

    curve, losses, pending = [], [], []

    def collect():
        if pending:
            losses.extend(torch.stack(pending).tolist())
            pending.clear()

    for rnd in range(rounds):
        if (rnd * tau) % EVAL_ITERS < tau:  # first round at/after each
            collect()                       # 50-iteration boundary
            acc = evaluate()
            curve.append({"iter": rnd * tau, "val_accuracy": round(acc, 4)})
            print(f"[{n_workers}w] iter {rnd * tau}: val acc {acc:.4f} "
                  f"({time.time() - t0:.0f}s)", file=sys.stderr)
        idx, offs = round_inputs()
        pending.append(round_fn(idx, offs, (1000 + seed, rnd), corpus,
                                labels, mean_hwc))
    collect()
    final = evaluate()
    curve.append({"iter": rounds * tau, "val_accuracy": round(final, 4)})
    wall = time.time() - t0
    print(f"[{n_workers}w] FINAL iter {rounds * tau}: val acc {final:.4f} "
          f"({wall:.0f}s)", file=sys.stderr)
    return {"workers": n_workers, "tau": tau if n_workers > 1 else 1,
            "iters_actual": rounds * tau,
            "final_val_accuracy": round(final, 4), "curve": curve,
            "cross_50pct_iter": cross_iter(curve, "val_accuracy"),
            "final_mean_round_loss": losses[-1] if losses else None,
            "losses": losses_summary(losses), "round_losses": losses,
            "wall_s": round(wall, 1)}


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--iters", type=int, default=1500)
    p.add_argument("--n-train", type=int, default=N_TRAIN)
    p.add_argument("--workers-runs", default="1,8",
                   help="comma list of runs: N workers at the recipe "
                   "tau, or N@T for an explicit sync interval "
                   "(e.g. '1,8,8@1' adds a sync-every-step control)")
    p.add_argument("--data-dir", default=os.path.join(_ROOT, ".cache",
                                                      "synth_imagenet"))
    p.add_argument("--out", default="PARITY_CAFFENET_torch.json")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--hard", action="store_true",
                   help="mid-difficulty corpus (noise 85 / shift 48 — "
                   "the CIFAR stand-in's calibrated ratios): the "
                   "asymptote stays below saturation so the serial-vs-"
                   "averaged gap is measured on a sloped curve")
    p.add_argument("--n-classes", type=int, default=N_CLASSES,
                   help="fc8's width: the zoo's 1000 (default), as the "
                   "JAX script builds it, or the corpus's 64")
    p.add_argument("--precision", default="bfloat16",
                   choices=("bfloat16", "float32"),
                   help="the compute policy (the recipe's bfloat16, or "
                   "float32 for a bf16-vs-f32 trajectory)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; without a card it raises "
                   "unless cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)  # no card: raise before any work

    gen = HARD if args.hard else EASY
    if args.hard:
        args.data_dir = args.data_dir.rstrip("/") + "_hard"
        if args.out == p.get_default("out"):
            args.out = "PARITY_CAFFENET_HARD_torch.json"
    ensure_dataset(args.data_dir, args.n_train, seed=args.seed, gen=gen)
    t0 = time.time()
    print("mean image via the multi-reader streaming pass...",
          file=sys.stderr)
    label_map = imagenet.load_label_map(
        os.path.join(args.data_dir, "train.txt"))
    mean_loader = imagenet.ShardedTarLoader(
        imagenet.list_shards(args.data_dir, prefix="train."), label_map,
        height=SIZE, width=SIZE)
    total, count = streaming_sum_count(mean_loader, workers=2)
    mean_hwc = (total / count).astype(np.float32).transpose(1, 2, 0)
    print(f"mean over {count} images ({time.time() - t0:.0f}s); decoding "
          f"the corpus...", file=sys.stderr)
    train_x, train_y, train_loader = load_split(args.data_dir, "train.",
                                                "train.txt")
    val_x, val_y, _ = load_split(args.data_dir, "val.", "val.txt")
    if len(train_x) != args.n_train:
        raise ValueError(f"{args.data_dir} decoded {len(train_x)} train "
                         f"images, --n-train is {args.n_train}")
    print(f"decoded {len(train_x)} train / {len(val_x)} val "
          f"(skipped={train_loader.skipped}) ({time.time() - t0:.0f}s); "
          f"staging on {dev}...", file=sys.stderr)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    data = (put(train_x), put(train_y), put(mean_hwc), put(val_x),
            put(val_y), len(train_x))
    del train_x, val_x
    print(f"corpus on {dev} ({time.time() - t0:.0f}s)", file=sys.stderr)

    runs = []
    for spec in args.workers_runs.split(","):
        w, _, t = spec.partition("@")  # "8@1" = 8 workers at tau=1
        runs.append(run(int(w), args.iters, data, seed=args.seed,
                        tau=int(t) if t else TAU,
                        n_classes=args.n_classes, policy=args.precision))
    results = {
        "recipe": {"model": "bvlc_reference_caffenet", "base_lr": 0.01,
                   "momentum": 0.9, "weight_decay": 0.0005,
                   "lr_policy": "step", "gamma": 0.1, "stepsize": 100000,
                   "batch_per_worker": BATCH, "tau": TAU,
                   "max_iter": args.iters, "precision": args.precision,
                   "n_classes": args.n_classes,
                   "source": "models/bvlc_reference_caffenet/"
                             "solver.prototxt + ImageNetApp.scala"},
        "dataset": {"kind": "synthetic_imagenet "
                            "(sparknet_tpu_torch.data.synth, JPEG q90, "
                            "sharded by sparknet_tpu_torch.scripts."
                            "shard_imagenet)",
                    "n_train": args.n_train, "n_val": N_VAL,
                    "n_classes": synth.IMAGENET_CLASSES,
                    "seed": args.seed,
                    "difficulty": ("hard" if args.hard else "easy"),
                    "generator": gen},
        "platform": str(dev),
        "card": card_line(dev),
        "runs": runs,
    }
    serial = next((r for r in runs if r["workers"] == 1), None)
    multi = next((r for r in runs if r["workers"] > 1), None)
    if serial and multi:
        results["summary"] = {
            "serial_final": serial["final_val_accuracy"],
            f"avg{multi['workers']}_tau{multi['tau']}_final":
                multi["final_val_accuracy"],
            "gap": round(serial["final_val_accuracy"]
                         - multi["final_val_accuracy"], 4)}
    results.setdefault("summary", {}).update({
        "cross_50pct_iter": {f"{r['workers']}@{r['tau']}":
                             r["cross_50pct_iter"] for r in runs},
        "all_losses_finite": all(r["losses"]["all_finite"] for r in runs),
        "card": results["card"]})
    results["meta"] = run_metadata()
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results["summary"]))
    return results


if __name__ == "__main__":
    main()
