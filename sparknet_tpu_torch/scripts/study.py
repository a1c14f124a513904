"""W workers' τ-rounds on one card: what the parity studies share.

`WorkerRounds` is `ParallelTrainer._round` (`parallel/trainer.py`) with
the data group replaced by a loop over W workers on one device, as the
JAX studies vmap or scan their worker axis on one chip. A round:

  - each worker w starts from the shared params, takes τ TRAIN-phase
    steps (autograd, then `SgdSolver.update` in place) on the batches
    `batch_at(w, t)` gives it, with its own momentum, which is never
    averaged; step t draws its dropout masks from
    `seeded_generator(keys + (w, t))`, the trainer's generator at rank w;
  - the workers' params are summed in worker order and divided by W;
  - the loss is the sum over workers of each one's τ-mean, divided by W
    (the trainer's group mean).

The params live in flat buffers whose views are the param trees, as the
trainer keeps them, so a one-worker round computes what a one-rank
`ParallelTrainer.train_round` computes from the same params, batches and
round key, bit for bit.
"""
from __future__ import annotations

import subprocess
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import precision
from ..model.layers import seeded_generator
from ..model.net import CompiledNet, ParamTree
from ..parallel.trainer import _flat_tree
from ..solver import SgdSolver, SolverConfig, SolverState, value_and_grad


class WorkerRounds:
    """τ-rounds of `n_workers` workers over one set of shared params (a
    tree on the device the rounds run on, copied in)."""

    def __init__(self, net: CompiledNet, solver_cfg: SolverConfig,
                 n_workers: int, tau: int, params: ParamTree,
                 loss_blob: str = "loss"):
        if n_workers < 1 or tau < 1:
            raise ValueError(f"n_workers {n_workers} and tau {tau} must be "
                             f">= 1")
        self.n_workers = int(n_workers)
        self.tau = int(tau)
        self.solver = SgdSolver(net, solver_cfg, loss_blob=loss_blob)
        self.loss_fn = net.loss_fn(loss_blob)
        dev = next(iter(next(iter(params.values())).values())).device
        #: the shared (averaged) params: what every worker starts a round
        #: from and what evaluation reads
        self.flat, self.params = _flat_tree(params, torch.float32, dev)
        # the worker being stepped: autograd leaves, views of work_flat
        self.work_flat, self.work = _flat_tree(params, torch.float32, dev)
        for lp in self.work.values():
            for v in lp.values():
                v.requires_grad_(True)
        self._acc = torch.empty_like(self.flat)
        vdt = precision.DTYPES[solver_cfg.velocity_dtype]
        #: worker w's momentum tree (views of its own flat buffer)
        self.momentum: List[ParamTree] = [
            _flat_tree(params, vdt, dev, zeros=True)[1]
            for _ in range(self.n_workers)]
        self.it = 0

    def round(self, batch_at: Callable[[int, int], Dict[str, torch.Tensor]],
              keys: Sequence[int]) -> torch.Tensor:
        """One round; `batch_at(w, t)` is worker w's batch for step t (net
        inputs on the device), `keys` the round's key. Returns the mean
        loss as a 0-d device tensor (no host sync)."""
        keys = tuple(int(k) for k in keys)
        it0 = self.it
        means = []
        for w in range(self.n_workers):
            with torch.no_grad():
                self.work_flat.copy_(self.flat)
            st = SolverState(momentum=self.momentum[w], it=it0)
            losses = []
            for t in range(self.tau):
                gen = seeded_generator(keys + (w, t))
                loss, grads = value_and_grad(self.loss_fn, self.work,
                                             batch_at(w, t), gen)
                self.solver.update(self.work, st, grads)
                losses.append(loss.float())
            means.append(torch.stack(losses).mean())
            with torch.no_grad():
                if w == 0:
                    self._acc.copy_(self.work_flat)
                else:
                    self._acc.add_(self.work_flat)
        with torch.no_grad():
            self.flat.copy_(self._acc).div_(self.n_workers)
        self.it = it0 + self.tau
        return torch.stack(means).sum() / self.n_workers


def cross_iter(curve: List[dict], key: str, level: float = 0.5
               ) -> Optional[int]:
    """The first logged iteration whose `key` reaches `level`: where a run
    leaves the symmetry plateau (the JAX τ study's `cross_50pct_iter`);
    None if it never does."""
    for point in curve:
        if point[key] >= level:
            return int(point["iter"])
    return None


def losses_summary(losses: List[float]) -> dict:
    """n, first, last and whether every round loss is finite."""
    arr = np.asarray(losses, np.float64)
    return {"n": len(losses),
            "first": float(arr[0]) if len(arr) else None,
            "last": float(arr[-1]) if len(arr) else None,
            "all_finite": bool(np.isfinite(arr).all())}


def card_line(device: torch.device) -> Optional[str]:
    """The card's name and power limit as `nvidia-smi` gives them, for
    every figure a study writes down; None on the CPU."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        idx = device.index or 0
        lines = out.stdout.strip().splitlines()
        return lines[idx].strip() if len(lines) > idx else \
            torch.cuda.get_device_name(idx)
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(device.index or 0)
