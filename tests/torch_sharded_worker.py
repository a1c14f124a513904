"""One rank of the port's per-shard checkpoint tests
(tests/test_torch_sharded_checkpoint.py). It imports torch and the port
only: the test spawns it with torch.multiprocessing; it joins a group
through a FileStore (gloo on the CPU, NCCL on the card: rank r drives
card r).

- `save_ranks`: restore a replica step (any package's, any layout) at
  this world size and write it back through the loop's
  `_save_checkpoint` with the default `checkpoint_sharded="auto"`, to
  every directory given (local or bucket).
- `train_runs`: cifar10_quick runs of `train()`, each a dict of settings
  in order in one group; each run's final state goes to
  `<out>/<name>_rank<r>.npz` and its log lines to `<out>/<name>_rank<r>.txt`.
- `time_saves`: a zoo net's full state (CaffeNet's by default) at this
  world size, saved in both
  layouts in turns over one step (each save overwrites the last); rank 0
  writes each save's stage-1 and total seconds (the slowest rank's) and
  bytes to `<out>/saves.json`.
"""
import json
import os
import time

import numpy as np
import torch

from sparknet_tpu_torch import zoo
from sparknet_tpu_torch.apps import cifar_app, train_loop
from sparknet_tpu_torch.apps.train_loop import resolve_spec, train
from sparknet_tpu_torch.model.net import CompiledNet
from sparknet_tpu_torch.parallel.mesh import init_data_group
from sparknet_tpu_torch.parallel.trainer import ParallelTrainer
from sparknet_tpu_torch.solver import SolverConfig
from sparknet_tpu_torch.utils import checkpoint as ckpt
from sparknet_tpu_torch.utils.config import RunConfig
from sparknet_tpu_torch.utils.logger import Logger


def _group(rank, world, store_path, device="cpu"):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    return init_data_group(device, store_path=store_path, rank=rank,
                           world_size=world)


def save_ranks(rank, world, store_path, src_dir, dst_dirs, step, velocity):
    group = _group(rank, world, store_path)
    try:
        net = CompiledNet.compile(zoo.cifar10_quick(batch=2))
        tr = ParallelTrainer(net, SolverConfig(velocity_dtype=velocity),
                             group, tau=1)
        flat, _, extra = ckpt.restore_flat(src_dir)
        state = tr.state_from_checkpoint(flat, extra)
        for d in dst_dirs:
            train_loop._save_checkpoint(RunConfig(checkpoint_dir=d), tr,
                                        state, step, retain=False)
            group.barrier()
    finally:
        group.close()


def train_runs(rank, world, store_path, cifar_dir, out_dir, device, runs):
    group = _group(rank, world, store_path, device)
    try:
        for run in runs:
            cfg = cifar_app.default_config().with_overrides(
                *run["overrides"], f"data_dir={cifar_dir}",
                f"workdir={out_dir}/{run['name']}_w{rank}")
            spec = resolve_spec(cfg, data=(cfg.local_batch, 3, 32, 32),
                                label=(cfg.local_batch, 1))
            log = Logger(f"{out_dir}/{run['name']}_rank{rank}.txt",
                         echo=False)
            try:
                state = train(cfg, spec, *cifar_app.build_datasets(cfg),
                              device=device, logger=log)
            finally:
                log.close()
            np.savez(f"{out_dir}/{run['name']}_rank{rank}.npz",
                     it=np.asarray(state.it),
                     flat_params=state.flat_params.detach().cpu().numpy(),
                     flat_momentum=state.flat_momentum.cpu().numpy())
    finally:
        group.close()


def time_saves(rank, world, store_path, out_dir, device, reps,
               model="caffenet"):
    group = _group(rank, world, store_path, device)
    try:
        net = CompiledNet.compile(getattr(zoo, model)(batch=2))
        tr = ParallelTrainer(net, SolverConfig(), group, tau=1)
        state = tr.init_state(0)
        with torch.no_grad():
            state.flat_momentum.normal_(
                generator=torch.Generator(state.flat_momentum.device)
                .manual_seed(rank))
        stage1 = {"off": tr.checkpoint_tree, "auto": tr.checkpoint_shards}
        rows = []
        for i in range(reps):
            for layout in ("off", "auto", "auto", "off"):
                d = f"{out_dir}/ck_{layout}"
                group.barrier()
                t0 = time.perf_counter()
                stage1[layout](state)
                t1 = time.perf_counter() - t0
                group.barrier()
                t0 = time.perf_counter()
                train_loop._save_checkpoint(
                    RunConfig(checkpoint_dir=d, checkpoint_sharded=layout),
                    tr, state, 1, retain=False)
                group.barrier()  # rank 0's commit is the save's end
                total = time.perf_counter() - t0
                got = group.all_gather(torch.tensor(
                    [t1, total], dtype=torch.float64,
                    device=group.device)).cpu().max(0).values.tolist()
                rows.append({"layout": layout, "rep": i, "stage1_s": got[0],
                             "save_s": got[1],
                             "bytes": sum(os.path.getsize(os.path.join(
                                 f"{d}/step-1", f)) for f in
                                 os.listdir(f"{d}/step-1"))
                             if rank == 0 else None})
        if rank == 0:
            with open(f"{out_dir}/saves.json", "w") as f:
                json.dump(rows, f)
    finally:
        group.close()
