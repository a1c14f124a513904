"""The multi-rank dry run: every distributed path of the port, once.

The counterpart of `__graft_entry__.py:dryrun_multichip`. The JAX package
forces a mesh of n virtual CPU devices in one process; the port spawns n
ranks, one process per card (NCCL), or n gloo ranks on the CPU with
`device="cpu"`. Each rank, in the JAX order and on the same
`np.random.default_rng(0)` draws in the same sequence:

  1. one τ = 2 `ParallelTrainer` round of `caffenet(batch=2, crop=67,
     n_classes=16)` on its block of the round's batches, then `evaluate`;
  2. the DP×TP (n/2, 2) round: `ParallelTrainer(tp=2)` on `make_grid`'s
     process grid, data group d taking block d of the first n/2 blocks;
  3. the value and the gradients of mean(ring_attention(q, k, v)**2) over
     the world at B = 2, L = 4n, H = 2, D = 8: each rank differentiates its
     own block's share of the mean, and the ring's permutes carry the k and
     v gradients back to their owners;
  4. one `GraphTrainer` round of `build_mnist_graph(batch=2)`, after which
     every float variable must be the same on every rank.

Rank 0 prints the JAX dry run's summary line, with the port's provenance
(`obs/meta.py:run_metadata`: torch version, backend, device kind, git rev)
in place of the JAX fields, and `dryrun_multichip` returns its numbers,
the attention gradients gathered to global [B, L, H, D] arrays.

    python -m sparknet_tpu_torch.dryrun --ranks N [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from .device import resolve_device

LOCAL_B, TAU = 2, 2
SOLVER = dict(base_lr=0.01, momentum=0.9, weight_decay=5e-4,
              lr_policy="step", gamma=0.1, stepsize=100000)
META_KEYS = ("torch_version", "backend", "device_kind", "git_rev")


def _block(batches: Dict[str, np.ndarray], i: int, size: int
           ) -> Dict[str, np.ndarray]:
    """Block i (of `size` rows) of each [tau, global, ...] array."""
    return {k: v[:, i * size:(i + 1) * size] for k, v in batches.items()}


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun: {msg}")


def _rank(rank: int, n: int, device_type: str, store_path: str,
          out_path: str) -> None:
    """One rank of the dry run (module docstring); rank 0 writes the
    numbers to `out_path` (npz) and prints the summary line."""
    from .backend import GraphNet
    from .backend.builder import build_mnist_graph
    from .model.net import CompiledNet
    from .obs.meta import run_metadata
    from .parallel.graph_trainer import GraphTrainer
    from .parallel.mesh import init_data_group
    from .parallel.ring_attention import (gather_sequence, ring_attention,
                                          shard_sequence)
    from .parallel.trainer import ParallelTrainer
    from .solver import SolverConfig
    from .zoo import caffenet

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n))
    dev = "cpu" if device_type == "cpu" else f"cuda:{rank}"
    group = init_data_group(dev, store_path=store_path, rank=rank,
                            world_size=n)
    try:
        net = CompiledNet.compile(caffenet(batch=LOCAL_B, crop=67,
                                           n_classes=16))
        trainer = ParallelTrainer(net, SolverConfig(**SOLVER), group,
                                  tau=TAU)
        state = trainer.init_state(0)
        rng = np.random.default_rng(0)
        batches = {
            "data": rng.standard_normal(
                (TAU, n * LOCAL_B, 67, 67, 3)).astype(np.float32),
            "label": rng.integers(
                0, 16, (TAU, n * LOCAL_B, 1)).astype(np.int32)}
        state, loss = trainer.train_round(
            state, _block(batches, rank, LOCAL_B), 1)
        loss = float(loss)
        _check(np.isfinite(loss), f"non-finite loss {loss}")
        acc = trainer.evaluate(state, {
            k: v[0, rank * LOCAL_B:(rank + 1) * LOCAL_B]
            for k, v in batches.items()})
        _check(0.0 <= acc <= 1.0, f"accuracy {acc} outside [0, 1]")

        # DP x TP: the same round over the (n/2, 2) process grid, the
        # InnerProducts column-sharded over the model subgroups
        tp_trainer = ParallelTrainer(net, SolverConfig(**SOLVER), group,
                                     tau=TAU, tp=2)
        _check(tp_trainer.tp == 2 and bool(tp_trainer._tp_sharded_layers()),
               "the TP trainer shards no layer")
        tp_state = tp_trainer.init_state(0)
        tp_batches = _block(batches, 0, n // 2 * LOCAL_B)
        tp_state, tp_loss = tp_trainer.train_round(
            tp_state, _block(tp_batches, tp_trainer.data.rank, LOCAL_B), 1)
        tp_loss = float(tp_loss)
        _check(np.isfinite(tp_loss), f"non-finite TP loss {tp_loss}")

        # the sequence-parallel axis: value and gradients of ring attention
        B, L, H, D = 2, 4 * n, 2, 8
        qkv = [torch.from_numpy(rng.standard_normal((B, L, H, D)).astype(
            np.float32)).to(group.device) for _ in range(3)]
        shards = [shard_sequence(x, group).requires_grad_() for x in qkv]
        out = ring_attention(*shards, group=group)
        part = torch.sum(out ** 2) / (B * L * H * D)
        part.backward()
        sp_val = float(group.all_reduce_sum_(part.detach().reshape(1))[0])
        sp_grads = [gather_sequence(s.grad, group).cpu().numpy()
                    for s in shards]
        _check(np.isfinite(sp_val), f"non-finite attention loss {sp_val}")
        _check(all(np.isfinite(g).all() for g in sp_grads),
               "non-finite attention gradients")

        # the second backend: one GraphTrainer round on the same ranks
        gnet = GraphNet(build_mnist_graph(batch=LOCAL_B), seed=0,
                        device=group.device)
        gtrainer = GraphTrainer(gnet, group, tau=TAU)
        gstate = gtrainer.init_state()
        gbatches = {
            "data": rng.standard_normal(
                (TAU, n * LOCAL_B, 28, 28, 1)).astype(np.float32),
            "label": rng.integers(
                0, 10, (TAU, n * LOCAL_B)).astype(np.int32)}
        gstate, gloss = gtrainer.train_round(
            gstate, _block(gbatches, rank, LOCAL_B))
        gloss = float(gloss)
        _check(np.isfinite(gloss), f"non-finite graph loss {gloss}")
        # replica sync: after the round every rank's float variables are
        # the group's mean
        spread = 0.0
        for name, var in sorted(gstate["variables"].items()):
            if var.is_floating_point():
                rows = group.all_gather(var.detach()).float().cpu().numpy()
                _check(np.allclose(rows, rows[0], atol=1e-5),
                       f"graph variable {name} replicas diverged after "
                       f"averaging")
                spread = max(spread, float(np.abs(rows - rows[0]).max()))
        if rank == 0:
            meta = run_metadata()
            if group.device.type == "cpu":
                meta.update(backend="cpu", device_kind="cpu")
            meta = {k: meta.get(k) for k in META_KEYS}
            line = (f"dryrun_multichip({n}): round loss={loss:.4f} "
                    f"acc={acc:.3f} tp_loss={tp_loss:.4f} "
                    f"sp_loss={sp_val:.4f} graph_loss={gloss:.4f} OK "
                    f"meta={json.dumps(meta)}")
            print(line, flush=True)
            np.savez(out_path, loss=loss, acc=acc, tp_loss=tp_loss,
                     sp_loss=sp_val, graph_loss=gloss,
                     graph_replica_spread=spread, dq=sp_grads[0],
                     dk=sp_grads[1], dv=sp_grads[2], meta=json.dumps(meta),
                     line=line)
    finally:
        group.close()


def dryrun_multichip(n_ranks: int, device: Optional[str] = None
                     ) -> Dict[str, Any]:
    """Spawn `n_ranks` ranks (one per card by default; gloo CPU ranks with
    device="cpu"), run the dry run on each, and return rank 0's numbers:
    {"loss", "acc", "tp_loss", "sp_loss", "graph_loss", "sp_grads": (dq,
    dk, dv), "graph_replica_spread" (the largest difference of a float
    graph variable between ranks after the round), "meta", "line" (the
    summary line)}. Raises RuntimeError without a card (unless
    device="cpu") or with fewer visible cards than ranks: it never falls
    back to the CPU; ValueError for an odd count or one below 2 (the
    (n/2, 2) grid needs it)."""
    dev = resolve_device(device)
    if n_ranks < 2 or n_ranks % 2:
        raise ValueError(f"the dry run needs an even n_ranks >= 2 for the "
                         f"(n/2, 2) TP grid, got {n_ranks}")
    if dev.type == "cuda" and torch.cuda.device_count() < n_ranks:
        raise RuntimeError(f"the dry run needs {n_ranks} CUDA cards, one a "
                           f"rank; {torch.cuda.device_count()} are visible")
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="sparknet_dryrun_") as d:
        out = os.path.join(d, "rank0.npz")
        mp.spawn(_rank, args=(n_ranks, dev.type, os.path.join(d, "store"),
                              out), nprocs=n_ranks, join=True)
        with np.load(out) as z:
            res = {k: z[k] for k in z.files}
    out = {k: float(res[k]) for k in ("loss", "acc", "tp_loss", "sp_loss",
                                      "graph_loss", "graph_replica_spread")}
    out.update(sp_grads=(res["dq"], res["dk"], res["dv"]),
               meta=json.loads(str(res["meta"])), line=str(res["line"]))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m sparknet_tpu_torch.dryrun",
        description="Run every distributed path of the port once over N "
                    "ranks: the DP round, the DP x TP round, ring "
                    "attention with gradients and the graph backend's "
                    "round.")
    ap.add_argument("--ranks", type=int, required=True,
                    help="number of ranks (even, >= 2); one card each")
    ap.add_argument("--device", default=None,
                    help="cpu for gloo ranks on the CPU (default: the cards)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.ranks, args.device)


if __name__ == "__main__":
    main()
