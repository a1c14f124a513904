"""One rank of the port's ImageNet app, for the two-rank test in
tests/test_torch_imagenet.py. It imports torch and the port only: the test
spawns it with torch.multiprocessing; it joins a gloo group through a
FileStore, starts from the given params (the JAX package's init) and runs
the app's `main()` with its metrics in `<workdir>_w<rank>`. It marks
each phase it reaches (start, group joined, trained, group closed) with
the wall time in `<workdir>_w<rank>.phases`, so that a failing test can
say where a rank was held."""
import json
import os
import time

import torch

from sparknet_tpu_torch.apps import imagenet_app
from sparknet_tpu_torch.parallel.mesh import init_data_group
from sparknet_tpu_torch.parallel.trainer import ParallelTrainer


def _mark(workdir, rank, phase):
    with open(f"{workdir}_w{rank}.phases", "a") as f:
        f.write(json.dumps({"phase": phase, "t": time.time()}) + "\n")


def run(rank, world, store_path, params, argv, workdir):
    _mark(workdir, rank, "start")
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_WORLD_SIZE=str(world))
    start = {l: {p: torch.from_numpy(v) for p, v in lp.items()}
             for l, lp in params.items()}
    ParallelTrainer.init_state = \
        lambda self, seed=0: self.state_from_params(start)
    group = init_data_group("cpu", store_path=store_path, rank=rank,
                            world_size=world)
    _mark(workdir, rank, "group joined")
    try:
        imagenet_app.main([*argv, f"workdir={workdir}_w{rank}"])
        _mark(workdir, rank, "trained")
    finally:
        group.close()
    _mark(workdir, rank, "group closed")
