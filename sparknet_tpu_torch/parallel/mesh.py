"""The data group: the port's data-parallel axis over torch.distributed.

The counterpart of `sparknet_tpu/parallel/mesh.py`. The JAX package runs
one process per host over a device mesh; the port runs one process per
card, which is torch's idiom, and the data axis is a process group: NCCL
for CUDA tensors, gloo for CPU tensors.

`init_data_group` forms it from the environment torchrun sets (`RANK`,
`WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`/`MASTER_PORT`). A plain launch is
a world of one, formed through a FileStore in the workdir — the
counterpart of `initialize_multihost` returning False. A caller that forms
several ranks without torchrun (the tests) passes `store_path`, `rank` and
`world_size`, so no port is fixed.

`machine_topology` places this rank among the machines: the JAX package's
`host_id_count` (one process per host) in the port's terms.

`make_grid` forms the 2-D (data, model) process grid of a world of
n_data x tp ranks, one per card: rank r sits at data index r // tp and
model index r % tp, the JAX package's device order for a ("data", "model")
mesh. Its data subgroup (the ranks of one model index) averages params;
its model subgroup (the ranks of one data index) gathers a column-parallel
InnerProduct's features. At tp = 1 the data subgroup is the world.

`plan_state_shards` is stage 1 of a per-shard checkpoint, the counterpart
of the JAX package's `fetch_state_shards` for the port's replica layout
and for the logical ZeRO layout of `parallel/sharded.py`: no gather, each
rank holds only the pieces it owns.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclasses.dataclass
class DataGroup:
    """This process's place on the data axis: the world, or (`pg` set) a
    subgroup of it, where `rank` and `size` are this process's place in
    the subgroup."""

    rank: int
    size: int
    device: torch.device
    #: this module formed the process group (and `close` ends it)
    owned: bool = False
    store_path: Optional[str] = None
    #: the subgroup's process group; None is the default (world) group
    pg: Any = None

    def all_reduce_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place sum over the data axis."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.pg)
        return t

    def all_reduce_mean_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place mean over the data axis: the sum, then a division by
        the world size — `lax.pmean`'s order (gloo has no AVG)."""
        return self.all_reduce_sum_(t).div_(self.size)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[size, *t.shape]: every rank's `t`, in rank order (a checkpoint
        gathers each rank's own momentum this way)."""
        out = torch.empty((self.size,) + tuple(t.shape), dtype=t.dtype,
                          device=t.device)
        if self.size == 1:
            return out.copy_(t[None])
        dist.all_gather(list(out.unbind(0)), t.contiguous(), group=self.pg)
        return out

    def all_gather_flat(self, t: torch.Tensor) -> torch.Tensor:
        """[size * t.numel()]: every rank's flat `t`, concatenated in rank
        order — one collective."""
        t = t.reshape(-1)
        out = torch.empty(self.size * t.numel(), dtype=t.dtype,
                          device=t.device)
        if self.size == 1:
            return out.copy_(t)
        dist.all_gather_into_tensor(out, t.contiguous(), group=self.pg)
        return out

    def reduce_scatter_sum(self, t: torch.Tensor) -> torch.Tensor:
        """[t.numel() / size]: block `rank` of the sum over the ranks of the
        flat `t` (packed rank-major) — one collective."""
        t = t.reshape(-1)
        if t.numel() % self.size:
            raise ValueError(f"reduce_scatter of {t.numel()} elements over "
                             f"{self.size} ranks")
        out = torch.empty(t.numel() // self.size, dtype=t.dtype,
                          device=t.device)
        if self.size == 1:
            return out.copy_(t)
        dist.reduce_scatter_tensor(out, t.contiguous(), op=dist.ReduceOp.SUM,
                                   group=self.pg)
        return out

    def barrier(self) -> None:
        """Every rank waits here for the others (a world of one returns)."""
        if self.size > 1:
            dist.barrier(group=self.pg)

    def close(self) -> None:
        if self.owned and dist.is_initialized():
            dist.destroy_process_group()
            self.owned = False
        if self.store_path and os.path.exists(self.store_path):
            os.remove(self.store_path)


def init_data_group(device=None, *, workdir: Optional[str] = None,
                    store_path: Optional[str] = None,
                    rank: Optional[int] = None,
                    world_size: Optional[int] = None) -> DataGroup:
    """Join (or form) the data group. `device` is resolved as every entry
    point resolves it (default cuda); a bare "cuda" becomes this rank's
    card, cuda:$LOCAL_RANK. An existing default process group is reused as
    it is."""
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
             else world_size)
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (rank, world):
            raise ValueError(
                f"the process group is rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, asked for rank {rank} of {world}")
        return DataGroup(rank, world, dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    own_store = None
    if store_path is None and "MASTER_ADDR" not in os.environ:
        if world != 1:
            raise ValueError(
                f"a world of {world} needs MASTER_ADDR/MASTER_PORT (launch "
                f"with torchrun) or a store_path shared by the ranks")
        base = workdir or os.environ.get("SPARKNET_TPU_HOME", ".")
        os.makedirs(base, exist_ok=True)
        store_path = own_store = os.path.join(
            base, f".dist_store_{os.getpid()}_{time.time_ns()}")
    kw = {}
    if store_path is not None:
        kw["store"] = dist.FileStore(store_path, world)
    else:
        kw["init_method"] = "env://"
    kw["device_id"] = dev if dev.type == "cuda" else None
    dist.init_process_group(backend, rank=rank, world_size=world, **kw)
    return DataGroup(rank, world, dev, owned=True, store_path=own_store)


@dataclasses.dataclass
class ProcessGrid:
    """The (data, model) grid of a world of n_data x tp ranks (module
    docstring). `data` holds the ranks of this rank's model index (the
    param average and the ZeRO collectives), `model` those of its data
    index (the column-parallel gather; None at tp = 1)."""

    world: DataGroup
    tp: int
    data: DataGroup
    model: Optional[DataGroup]

    @property
    def n_data(self) -> int:
        return self.data.size


def make_grid(group: DataGroup, tp: int = 1) -> ProcessGrid:
    """The process grid of `group` (the world) at `tp` model ranks per data
    group. Above tp = 1 it forms a data subgroup for each model index,
    then a model subgroup for each data index, in that order on every
    rank (`dist.new_group` is collective over the world: ranks that
    formed them in another order would hang). A collective: every rank
    calls it."""
    if tp < 1 or group.size % tp:
        raise ValueError(f"tp={tp} does not divide the world of "
                         f"{group.size} ranks")
    if tp == 1:
        return ProcessGrid(group, 1, group, None)
    n_data = group.size // tp
    d, m = divmod(group.rank, tp)
    data_pg = model_pg = None
    for j in range(tp):
        pg = dist.new_group([i * tp + j for i in range(n_data)])
        if j == m:
            data_pg = pg
    for i in range(n_data):
        pg = dist.new_group([i * tp + j for j in range(tp)])
        if i == d:
            model_pg = pg
    return ProcessGrid(group, tp,
                       DataGroup(d, n_data, group.device, pg=data_pg),
                       DataGroup(m, tp, group.device, pg=model_pg))


def machine_topology(group: Optional[DataGroup] = None
                     ) -> Tuple[int, int, int, int]:
    """(machine, n_machines, local_rank, local_size) of this rank — the
    port's counterpart of the JAX package's `host_id_count`. A JAX process
    drives every device of its host; a port process drives one card, so
    machine m of the JAX package's `process_index` is the ranks
    m * local_size ... (m + 1) * local_size - 1 here (torchrun numbers
    ranks machine by machine). Read from torchrun's `RANK`, `WORLD_SIZE`,
    `LOCAL_RANK` and `LOCAL_WORLD_SIZE` (or the group's rank and size);
    without `LOCAL_WORLD_SIZE` the world is one machine. Every split
    decision of the ImageNet app and the loop goes through here.

    Raises ValueError on a world whose machines hold different numbers of
    ranks (the JAX package's hosts each drive the same device count); with
    a `group` of several ranks the check is collective, so every rank
    raises together."""
    rank = group.rank if group is not None else int(
        os.environ.get("RANK", 0))
    world = group.size if group is not None else int(
        os.environ.get("WORLD_SIZE", 1))
    local_size = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    local_rank = int(os.environ.get("LOCAL_RANK", rank % max(local_size, 1)))
    ok = (1 <= local_size <= world and world % local_size == 0
          and local_rank == rank % local_size)
    if group is not None and group.size > 1:
        mine = torch.tensor([local_size, int(ok)], dtype=torch.int64,
                            device=group.device)
        rows = group.all_gather(mine).cpu()
        ok = bool(rows[:, 1].all()) and bool((rows[:, 0] == local_size).all())
        sizes = rows[:, 0].tolist()
    else:
        sizes = [local_size]
    if not ok:
        raise ValueError(
            f"a world of {world} ranks whose machines hold different "
            f"numbers of ranks (LOCAL_WORLD_SIZE by rank: {sizes}; rank "
            f"{rank} has LOCAL_RANK {local_rank}): every machine must run "
            f"the same number of ranks, numbered machine by machine")
    return rank // local_size, world // local_size, local_rank, local_size


def plan_state_shards(rows: Optional[Mapping[str, Any]] = None,
                      replicated: Optional[Mapping[str, Any]] = None, *,
                      rank: int, world: int,
                      zero: Optional[Mapping[str, Tuple[tuple, int, Any]]]
                      = None) -> Dict[str, Any]:
    """The piece plan of a per-shard checkpoint: the snapshot dict the
    JAX package's `fetch_state_shards` returns for the same state on a
    `world`-device mesh, with file f owned by rank f:
    {"n_shards", "owners": {file: rank}, "process_index",
    "process_count", "leaves": {key: {"shape", "dtype", "pieces":
    [(file_id, offsets, shape, arr | None), ...]}}}.

    - `rows`: {key: this rank's row of a [world, ...] leaf} (numpy, or a
      CPU tensor for bfloat16, which keeps its bits). Row r lives on rank
      r, so file r holds it at offset r: the JAX plan of a leaf sharded
      along its leading axis over the data axis.
    - `replicated`: {key: the whole value, which every rank holds}. Its
      leading axis is cut into min(world, len) contiguous chunks whose
      sizes differ by at most one, chunk j in file j; a scalar, an empty
      leaf or a world of one is one piece in file 0 — the JAX plan of a
      fully replicated leaf.
    - `zero`: {key: (global shape, dim, this rank's piece)} of a leaf
      split evenly along `dim` over the ranks (the logical ZeRO layout):
      file f holds block f at offset f * shape[dim] / world along `dim` —
      the JAX plan of a leaf sharded over the data axis on that dim.

    This rank's pieces carry their arrays; the others' carry None. No
    collective: every rank knows the whole plan."""
    leaves: Dict[str, Dict[str, Any]] = {}

    def dtype_of(a):
        if isinstance(a, torch.Tensor):
            return ("bfloat16" if a.dtype == torch.bfloat16 else
                    np.dtype(str(a.dtype).replace("torch.", "")))
        return np.asarray(a).dtype

    for key, row in (rows or {}).items():
        if tuple(row.shape[:1]) != (1,):
            raise ValueError(f"{key}: a row has leading dim 1, got "
                             f"{tuple(row.shape)}")
        rest = tuple(row.shape[1:])
        leaves[key] = {"shape": (world,) + rest, "dtype": dtype_of(row),
                       "pieces": [(f, (f,) + (0,) * len(rest), (1,) + rest,
                                   row if f == rank else None)
                                  for f in range(world)]}
    for key, full in (replicated or {}).items():
        shape = tuple(full.shape)
        if shape == () or shape[0] == 0 or world == 1:
            pieces = [(0, (0,) * len(shape), shape,
                       full if rank == 0 else None)]
        else:
            pieces, lo = [], 0
            for j, chunk in enumerate(np.array_split(
                    np.arange(shape[0]), min(world, shape[0]))):
                size = len(chunk)
                pieces.append((j, (lo,) + (0,) * (len(shape) - 1),
                               (size,) + shape[1:],
                               full[lo:lo + size] if j == rank else None))
                lo += size
        leaves[key] = {"shape": shape, "dtype": dtype_of(full),
                       "pieces": pieces}
    for key, (shape, dim, piece) in (zero or {}).items():
        shape = tuple(shape)
        size = shape[dim] // world
        pshape = shape[:dim] + (size,) + shape[dim + 1:]
        if tuple(piece.shape) != pshape:
            raise ValueError(f"{key}: a piece of {shape} split on dim {dim} "
                             f"over {world} ranks is {pshape}, got "
                             f"{tuple(piece.shape)}")
        leaves[key] = {"shape": shape, "dtype": dtype_of(piece),
                       "pieces": [(f, tuple(f * size if i == dim else 0
                                            for i in range(len(shape))),
                                   pshape, piece if f == rank else None)
                                  for f in range(world)]}
    return {"n_shards": int(world), "owners": {f: f for f in range(world)},
            "process_index": int(rank), "process_count": int(world),
            "leaves": leaves}
