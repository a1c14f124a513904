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
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclasses.dataclass
class DataGroup:
    """This process's place on the data axis."""

    rank: int
    size: int
    device: torch.device
    #: this module formed the process group (and `close` ends it)
    owned: bool = False
    store_path: Optional[str] = None

    def all_reduce_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place sum over the data axis."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
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
        dist.all_gather(list(out.unbind(0)), t.contiguous())
        return out

    def barrier(self) -> None:
        """Every rank waits here for the others (a world of one returns)."""
        if self.size > 1:
            dist.barrier()

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
