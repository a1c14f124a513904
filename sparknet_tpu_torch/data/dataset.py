"""In-memory dataset partitioning + τ-round batch sampling.

A copy of `sparknet_tpu/data/dataset.py` (pure numpy): the port imports
nothing of the JAX package.

Reproduces the reference's data motion semantics on a mesh:
  - `repartition(numWorkers).cache()` (reference `apps/CifarApp.scala:65-66`)
    -> `ArrayDataset.partitions(n_workers)`: contiguous equal splits.
  - per-round random window per worker (`apps/CifarApp.scala:131-133`:
    startIdx = Random.nextInt(len - τ·batch); it.drop(startIdx)) ->
    `RoundSampler.next_round()` draws an independent random window per worker
    and lays out [tau, n_workers*local_b, ...] arrays whose batch axis is
    blocked by worker — exactly the trainer's P(None, 'data') sharding, so
    each device reads its own partition's window.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


class ArrayDataset:
    """Dict of aligned numpy arrays (leading dim = examples)."""

    def __init__(self, arrays: Dict[str, np.ndarray]):
        sizes = {k: len(v) for k, v in arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"misaligned fields: {sizes}")
        self.arrays = arrays
        self.size = next(iter(sizes.values()))

    def __len__(self) -> int:
        return self.size

    def shuffled(self, seed: int) -> "ArrayDataset":
        perm = np.random.default_rng(seed).permutation(self.size)
        return ArrayDataset({k: v[perm] for k, v in self.arrays.items()})

    def partition_bounds(self, n_workers: int):
        per = self.size // n_workers
        if per == 0:
            raise ValueError(f"{self.size} examples < {n_workers} workers")
        return [(w * per, (w + 1) * per) for w in range(n_workers)]

    def host_shard(self, host_id: int, host_count: int) -> "ArrayDataset":
        """This host's contiguous slice of an (identically loaded) dataset —
        the multi-host analogue of the reference's
        `repartition(numWorkers)` + per-executor caching
        (`apps/CifarApp.scala:65-66`): each host then trains only on its own
        disjoint examples. No-op for a single-host world."""
        if host_count == 1:
            return self
        if not (0 <= host_id < host_count):
            raise ValueError(f"host_id {host_id} not in [0, {host_count})")
        lo, hi = self.partition_bounds(host_count)[host_id]
        return ArrayDataset({k: v[lo:hi] for k, v in self.arrays.items()})


class RoundSampler:
    """Per-round τ-window sampler over worker partitions."""

    def __init__(self, dataset: ArrayDataset, n_workers: int, local_batch: int,
                 tau: int, seed: int = 0):
        self.ds = dataset
        self.n_workers = n_workers
        self.local_batch = local_batch
        self.tau = tau
        self.bounds = dataset.partition_bounds(n_workers)
        window = tau * local_batch
        part = self.bounds[0][1] - self.bounds[0][0]
        if window > part:
            raise ValueError(
                f"τ·batch = {window} exceeds partition size {part} "
                f"({dataset.size} examples / {n_workers} workers)")
        self.seed = seed
        self._rng = np.random.default_rng(seed)

    def reshard(self, n_workers: int) -> "RoundSampler":
        """A NEW sampler over the same dataset/seed with the partitions
        re-cut for `n_workers` — the elastic-resize data path: survivors
        (and joiners) re-partition the corpus instead of training on the
        dead worker's orphaned shard forever. Round-keyed draws stay
        deterministic in (seed, round_index) for the new layout."""
        return RoundSampler(self.ds, n_workers, self.local_batch, self.tau,
                            seed=self.seed)

    def next_round(self, round_index: Optional[int] = None
                   ) -> Dict[str, np.ndarray]:
        """[tau, n_workers*local_b, ...] arrays, batch axis blocked by worker.

        Pass round_index for a round-keyed rng: sampling then depends only on
        (seed, round_index), making checkpoint-resume draw identical windows.
        """
        rng = (np.random.default_rng((self.seed, round_index))
               if round_index is not None else self._rng)
        window = self.tau * self.local_batch
        idx = np.empty((self.tau, self.n_workers * self.local_batch), np.int64)
        for w, (lo, hi) in enumerate(self.bounds):
            start = lo + rng.integers(0, hi - lo - window + 1)
            span = np.arange(start, start + window).reshape(
                self.tau, self.local_batch)
            idx[:, w * self.local_batch:(w + 1) * self.local_batch] = span
        flat = idx.reshape(-1)
        return {
            k: v[flat].reshape((self.tau, idx.shape[1]) + v.shape[1:])
            for k, v in self.ds.arrays.items()}

    def eval_batches(self, batch: int) -> Iterator[Dict[str, np.ndarray]]:
        """Sequential full-coverage eval batches (global batch size)."""
        n = (self.ds.size // batch) * batch
        for i in range(0, n, batch):
            yield {k: v[i:i + batch] for k, v in self.ds.arrays.items()}
