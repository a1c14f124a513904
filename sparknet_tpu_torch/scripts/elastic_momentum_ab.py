"""A/B/C the elastic-resume momentum policy on gloo CPU ranks.

The port's counterpart of the JAX package's `scripts/elastic_momentum_ab.py`.
`ParallelTrainer.adapt_state` must produce SOME momentum for the new
topology out of the old per-rank velocities. This harness runs the
trajectory-band experiment for the three candidate policies over several
seeds:

  average       mean of the old ranks' velocities
  zero          fresh zeros (momentum restarts after the resume)
  norm_rescale  mean, rescaled back to the average per-rank norm
                (averaging k decorrelated vectors shrinks the norm
                ~1/sqrt(k); this undoes the shrink) — the port's default
                (`utils/config.py`, `ElasticConfig.momentum_policy`)

TINY_MLP (6 -> 16 -> 4) trains τ = 3 rounds of 8 examples a rank on 8
gloo CPU ranks (spawned processes, as the port's elastic tests spawn
them), saves a replica-layout step through `utils/checkpoint.py`, runs on
uninterrupted, and resumes the step at 4 and at 2 ranks (subgroups of the
same world) through `adapt_state` under each policy.

Metric per (policy, new rank count, seed): the largest relative deviation
of the post-resume round losses from the uninterrupted 8-rank
continuation, and the mean of the last 3 losses (did it keep learning).
Writes `results`, `summary` and `winner` as the JAX script does. The
initial weights come from a seeded torch generator (the port's own).

Run: python -m sparknet_tpu_torch.scripts.elastic_momentum_ab   (CPU)
     python -m sparknet_tpu_torch.scripts.elastic_momentum_ab --seeds 1 \\
         --rounds-pre 2 --rounds-post 3 --out ab.json   (the smoke shape)
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import tempfile
import time
import warnings
from typing import Optional

import numpy as np

TINY_MLP = """
name: "tiny_mlp"
input: "data"
input_shape { dim: 8 dim: 6 }
input: "label"
input_shape { dim: 8 dim: 1 }
layer { name: "ip1" type: "InnerProduct" bottom: "data" top: "ip1"
        inner_product_param { num_output: 16
          weight_filler { type: "gaussian" std: 0.3 } } }
layer { name: "relu1" type: "ReLU" bottom: "ip1" top: "ip1" }
layer { name: "ip2" type: "InnerProduct" bottom: "ip1" top: "ip2"
        inner_product_param { num_output: 4
          weight_filler { type: "gaussian" std: 0.3 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip2" bottom: "label" top: "loss" }
layer { name: "acc" type: "Accuracy" bottom: "ip2" bottom: "label" top: "acc" }
"""

TAU, B, ROUNDS_PRE, ROUNDS_POST = 3, 8, 4, 8
WORLD, NEW_SIZES = 8, (4, 2)
POLICIES = ("average", "zero", "norm_rescale")
SEEDS = (0, 1, 2)
SOLVER = dict(base_lr=0.05, momentum=0.9, weight_decay=0.001,
              lr_policy="fixed")
SPAWN_TIMEOUT_S = 600


def batches(seed: int, n_dev: int) -> dict:
    r = np.random.default_rng(seed)
    data = r.standard_normal((TAU, 8 * B, 6)).astype(np.float32)
    label = (data.sum(-1, keepdims=True) > 0).astype(np.int32) + \
        (data[..., :1] > 0.5).astype(np.int32)
    return {"data": data[:, :n_dev * B], "label": label[:, :n_dev * B]}


def run(trainer, state, rounds: int, n_dev: int, start: int = 0,
        stream: int = 0):
    """`rounds` rounds on this rank's block of each round's batches."""
    rank = trainer.group.rank
    losses = []
    for r in range(start, start + rounds):
        b = batches(1000 * stream + r, n_dev)
        mine = {k: v[:, rank * B:(rank + 1) * B] for k, v in b.items()}
        state, loss = trainer.train_round(state, mine, 7000 * stream + r)
        losses.append(float(loss))
    return state, losses


def _rank(rank: int, store_path: str, work: str, seeds, rounds_pre: int,
          rounds_post: int) -> None:
    """One of the WORLD gloo ranks: every seed's 8-rank run, its step, its
    continuation, and (ranks below n) each 8 -> n resume; rank 0 pickles
    the results to `work`/results.pkl."""
    import torch
    import torch.distributed as dist

    from ..model.net import CompiledNet
    from ..model.prototxt import net_from_prototxt
    from ..parallel.mesh import DataGroup, init_data_group
    from ..parallel.trainer import ParallelTrainer
    from ..solver import SolverConfig
    from ..utils import checkpoint as ck

    torch.set_num_threads(1)
    cpu = torch.device("cpu")
    group = init_data_group("cpu", store_path=store_path, rank=rank,
                            world_size=WORLD)
    try:
        # collective over the world: every rank forms every subgroup
        subs = {nd: dist.new_group(list(range(nd))) for nd in NEW_SIZES}
        net = CompiledNet.compile(net_from_prototxt(TINY_MLP))
        scfg = SolverConfig(**SOLVER)
        results = {p_: {nd: [] for nd in NEW_SIZES} for p_ in POLICIES}
        for seed in seeds:
            t8 = ParallelTrainer(net, scfg, group, tau=TAU)
            s, _ = run(t8, t8.init_state(seed), rounds_pre, WORLD,
                       stream=seed)
            tree = t8.checkpoint_tree(s)
            ck_dir = os.path.join(work, f"ck-{seed}")
            if rank == 0:
                ck.save(ck_dir, tree, step=rounds_pre,
                        extra={"n_devices": WORLD, "tp": 1})
            group.barrier()
            flat, _, _ = ck.restore_flat(ck_dir)
            _, base = run(t8, s, rounds_post, WORLD, start=rounds_pre,
                          stream=seed)
            for nd in NEW_SIZES:
                if rank >= nd:
                    continue
                sub = DataGroup(rank, nd, cpu, pg=subs[nd])
                for pol in POLICIES:
                    t = ParallelTrainer(net, scfg, sub, tau=TAU)
                    st = t.adapt_state(flat, momentum_policy=pol)
                    _, losses = run(t, st, rounds_post, nd,
                                    start=rounds_pre, stream=seed)
                    if rank:
                        continue
                    rel = [abs(a - c) / c for a, c in zip(losses, base)]
                    results[pol][nd].append({
                        "seed": seed,
                        "max_rel_dev": round(max(rel), 4),
                        "final3_mean": round(float(np.mean(losses[-3:])),
                                             5),
                        "base_final3_mean": round(
                            float(np.mean(base[-3:])), 5),
                        "descending": bool(np.mean(losses[-3:])
                                           < losses[0]),
                    })
                    print(f"seed {seed} {WORLD}->{nd} {pol:12s} "
                          f"max_rel={max(rel):.3f} "
                          f"final3={np.mean(losses[-3:]):.4f} "
                          f"(base {np.mean(base[-3:]):.4f})", flush=True)
            group.barrier()
        if rank == 0:
            with open(os.path.join(work, "results.pkl"), "wb") as f:
                pickle.dump(results, f)
    finally:
        group.close()


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seeds", type=int, default=len(SEEDS),
                   help="number of seeds (default 3 — the full A/B)")
    p.add_argument("--rounds-pre", type=int, default=ROUNDS_PRE,
                   help="rounds before the checkpoint/resume")
    p.add_argument("--rounds-post", type=int, default=ROUNDS_POST,
                   help="rounds after the elastic resume (>= 3: the "
                        "final3 mean needs them)")
    p.add_argument("--out", default="ELASTIC_AB_torch.json",
                   help="output JSON path")
    args = p.parse_args(argv)
    seeds = tuple(range(args.seeds))
    rounds_pre, rounds_post = args.rounds_pre, max(3, args.rounds_post)

    import importlib

    import torch.multiprocessing as mp

    from ..obs.meta import run_metadata

    # the ranks import this module by its name (also when it runs as
    # `python -m`, where this copy is __main__)
    rank_fn = importlib.import_module(
        __spec__.name if __name__ == "__main__" else __name__)._rank
    with tempfile.TemporaryDirectory(prefix="elastic_ab_") as work:
        ctx = mp.spawn(rank_fn, args=(os.path.join(work, "store"), work,
                                    seeds, rounds_pre, rounds_post),
                       nprocs=WORLD, join=False)
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                raise RuntimeError(f"the {WORLD} ranks did not finish in "
                                   f"{SPAWN_TIMEOUT_S} s (a rank hangs)")
        with open(os.path.join(work, "results.pkl"), "rb") as f:
            results = pickle.load(f)

    summary = {}
    for pol in POLICIES:
        rows = [r for nd in NEW_SIZES for r in results[pol][nd]]
        summary[pol] = {
            "worst_max_rel_dev": max(r["max_rel_dev"] for r in rows),
            "per_nd": {str(nd): round(max(r["max_rel_dev"]
                                          for r in results[pol][nd]), 4)
                       for nd in NEW_SIZES},
            "all_descending": all(r["descending"] for r in rows)}
    descending = [p_ for p_ in POLICIES if summary[p_]["all_descending"]]
    if not descending:
        # the fallback exists for the smoke shape (1 seed, a few rounds —
        # too short for a reliable descending check). On a full A/B an
        # empty `descending` means NO policy is validated: say so rather
        # than silently crown the least-bad loser
        warnings.warn(
            "no momentum policy kept the final-3 loss descending; winner "
            "falls back to least worst_max_rel_dev — trustworthy only in "
            "the short smoke configuration, NOT as a policy validation",
            RuntimeWarning)
    winner = min(descending or POLICIES,
                 key=lambda p_: summary[p_]["worst_max_rel_dev"])
    out = {"task": f"TINY_MLP trajectory-band, {len(seeds)} seed(s), "
                   f"{WORLD}->4 and {WORLD}->2 resumes on gloo CPU ranks, "
                   f"{rounds_post} post-resume rounds",
           "results": results, "summary": summary, "winner": winner,
           "winner_descending": bool(descending),
           "meta": run_metadata()}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"\nwinner: {winner}  (summary: {json.dumps(summary)})")
    return out


if __name__ == "__main__":
    main()
