"""Recipe-scale accuracy evidence on synthetic CIFAR.

The port's counterpart of the JAX package's `scripts/parity_synth.py`.
Real CIFAR-10 is unreachable offline, so this runs the FULL cifar10_quick
recipe — lr 0.001 fixed, momentum 0.9, weight decay 0.004, batch 100,
4000 iterations (reference `models/cifar10/cifar10_quick_solver.prototxt:
12-22`, `apps/CifarApp.scala:20,127`) — on the deterministic synthetic
CIFAR stand-in (`data/synth.py`), twice:

  - 1 worker  (plain serial SGD — the reference's single-worker baseline)
  - 8 workers, tau=10 local-SGD parameter averaging (the paper's scheme;
    per-worker data partitions, random round windows per reference
    `apps/CifarApp.scala:131-133`, momentum worker-local)

and writes both accuracy curves, every round's loss, the iteration at
which each curve first reaches 0.5 and the card's name and power limit
to `--out`. The claim: the τ-averaging dynamics converge at recipe scale
— the 8-worker curve tracks the serial curve to comparable final
accuracy.

The round is `study.WorkerRounds`: `ParallelTrainer._round` with the
data group replaced by a loop over the workers on one card. The corpus,
labels and test set live on the card; the index stream comes from the
JAX script's `np.random.default_rng((seed, n_workers))` draws; the
initial weights from a seeded torch generator (the port's own curves).

Run: python -m sparknet_tpu_torch.scripts.parity_synth [--iters 4000]
         [--out PARITY_SYNTH_torch.json] [--seed 0] [--device cpu]
(the card by default; without one it raises unless `--device cpu`).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..data import synth
from ..device import resolve_device
from ..model.net import CompiledNet
from ..obs.meta import run_metadata
from ..solver import SolverConfig
from ..zoo import cifar10_quick
from .study import WorkerRounds, card_line, cross_iter, losses_summary

BATCH = 100
TAU = 10
N_TRAIN = 50_000
N_TEST = 10_000
EVAL_EVERY = 50  # rounds (= 500 iters; reference logged every 5 rounds)


def build(batch: int = BATCH):
    """(the compiled net, the recipe's solver config)."""
    net = CompiledNet.compile(cifar10_quick(batch=batch))
    cfg = SolverConfig(base_lr=0.001, momentum=0.9, weight_decay=0.004,
                       lr_policy="fixed")
    return net, cfg


def make_round_fn(workers: WorkerRounds):
    """`round_fn(idx, corpus, labels, keys=(0, 0)) -> mean loss`: one
    round in which worker w's step t gathers rows `idx[w, t]` ([W, tau,
    batch] int, on the corpus's device) of the device-resident corpus and
    labels, then the params' mean."""

    def round_fn(idx, corpus, labels, keys=(0, 0)):
        def batch_at(w, t):
            ix = idx[w, t]
            return {"data": corpus[ix], "label": labels[ix]}
        return workers.round(batch_at, keys)

    return round_fn


def make_eval_fn(net: CompiledNet, batch: int, n_test: int):
    """`eval_all(params, data, labels) -> float`: the mean of the
    per-batch accuracies over the first n_test // batch full batches of
    the test set, one host sync at the end."""
    n_batches = n_test // batch

    def eval_all(params, data, labels) -> float:
        accs = []
        with torch.no_grad():
            for i in range(n_batches):
                sl = slice(i * batch, (i + 1) * batch)
                blobs = net.apply(params, {"data": data[sl],
                                           "label": labels[sl]},
                                  train=False)
                accs.append(blobs["accuracy"].float())
        return float(torch.stack(accs).mean())

    return eval_all


def run(n_workers: int, iters: int, seed: int = 0, device=None,
        n_train: int = N_TRAIN, n_test: int = N_TEST,
        tau: int = TAU) -> dict:
    """One curve: `n_workers` workers for iters // tau rounds. The
    sizes are the recipe's unless a caller cuts them (the smoke)."""
    dev = resolve_device(device)
    net, cfg = build()
    rounds = iters // tau
    t0 = time.time()

    print(f"[{n_workers}w] generating synthetic corpus...", file=sys.stderr)
    train_x, train_y = synth.synthetic_cifar(n_train, seed=seed)
    test_x, test_y = synth.synthetic_cifar(n_test, seed=seed, start=n_train)
    mean = train_x.mean(axis=0)

    def nhwc(a):
        return torch.from_numpy(np.ascontiguousarray(
            (a - mean).transpose(0, 2, 3, 1)).astype(np.float32)).to(dev)

    corpus, test_corpus = nhwc(train_x), nhwc(test_x)
    labels = torch.from_numpy(train_y[:, None]).to(dev)
    test_labels = torch.from_numpy(test_y[:, None]).to(dev)
    print(f"[{n_workers}w] corpus on {dev} "
          f"({time.time() - t0:.0f}s)", file=sys.stderr)

    params0 = net.init_params(torch.Generator().manual_seed(seed), dev)
    workers = WorkerRounds(net, cfg, n_workers, tau, params0)
    round_fn = make_round_fn(workers)
    eval_fn = make_eval_fn(net, BATCH, n_test)

    # per-worker contiguous data partitions (reference repartition.cache);
    # each round draws a RANDOM WINDOW inside the partition
    # (CifarApp.scala:131-133)
    part = n_train // n_workers
    r = np.random.default_rng((seed, n_workers))

    def round_indices():
        idx = np.empty((n_workers, tau, BATCH), np.int32)
        for w in range(n_workers):
            start = w * part + r.integers(0, part - tau * BATCH + 1)
            idx[w] = np.arange(start, start + tau * BATCH).reshape(tau, BATCH)
        return torch.from_numpy(idx).to(dev, torch.int64)

    curve, losses, pending = [], [], []

    def collect():
        # one host sync per evaluation, not per round
        if pending:
            losses.extend(torch.stack(pending).tolist())
            pending.clear()

    for rnd in range(rounds):
        if rnd % EVAL_EVERY == 0:
            collect()
            acc = eval_fn(workers.params, test_corpus, test_labels)
            curve.append({"iter": rnd * tau, "test_accuracy": round(acc, 4)})
            print(f"[{n_workers}w] iter {rnd * tau}: acc {acc:.4f} "
                  f"({time.time() - t0:.0f}s)", file=sys.stderr)
        pending.append(round_fn(round_indices(), corpus, labels,
                                keys=(seed, rnd)))
    collect()
    final = eval_fn(workers.params, test_corpus, test_labels)
    curve.append({"iter": rounds * tau, "test_accuracy": round(final, 4)})
    wall = time.time() - t0
    print(f"[{n_workers}w] FINAL iter {rounds * tau}: acc {final:.4f} "
          f"({wall:.0f}s)", file=sys.stderr)
    return {"workers": n_workers, "tau": tau if n_workers > 1 else 1,
            "final_test_accuracy": round(final, 4), "curve": curve,
            "cross_50pct_iter": cross_iter(curve, "test_accuracy"),
            "wall_s": round(wall, 1),
            "final_loss": losses[-1] if losses else None,
            "losses": losses_summary(losses), "round_losses": losses}


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--iters", type=int, default=4000)
    p.add_argument("--out", default="PARITY_SYNTH_torch.json")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; without a card it raises "
                   "unless cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)  # no card: raise before any work

    results = {
        "recipe": {"model": "cifar10_quick", "base_lr": 0.001,
                   "momentum": 0.9, "weight_decay": 0.004,
                   "lr_policy": "fixed", "batch": BATCH,
                   "max_iter": args.iters,
                   "source": "models/cifar10/cifar10_quick_solver.prototxt"},
        "dataset": {"kind": "synthetic_cifar (sparknet_tpu_torch.data."
                            "synth)",
                    "n_train": N_TRAIN, "n_test": N_TEST,
                    "seed": args.seed},
        "platform": str(dev),
        "card": card_line(dev),
        "runs": [run(1, args.iters, seed=args.seed, device=dev),
                 run(8, args.iters, seed=args.seed, device=dev)],
    }
    s, m = results["runs"]
    results["summary"] = {
        "serial_final": s["final_test_accuracy"],
        "avg8_tau10_final": m["final_test_accuracy"],
        "gap": round(s["final_test_accuracy"]
                     - m["final_test_accuracy"], 4),
        "serial_cross_50pct_iter": s["cross_50pct_iter"],
        "avg8_cross_50pct_iter": m["cross_50pct_iter"],
        "all_losses_finite": (s["losses"]["all_finite"]
                              and m["losses"]["all_finite"]),
        "card": results["card"],
    }
    results["meta"] = run_metadata()
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results["summary"]))
    return results


if __name__ == "__main__":
    main()
