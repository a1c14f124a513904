"""One rank of the port's ImageNet app, for the two-rank test in
tests/test_torch_imagenet.py. It imports torch and the port only: the test
spawns it with torch.multiprocessing; it joins a gloo group through a
FileStore, starts from the given params (the JAX package's init) and runs
the app's `main()` with its metrics in `<workdir>_w<rank>`."""
import os

import torch

from sparknet_tpu_torch.apps import imagenet_app
from sparknet_tpu_torch.parallel.mesh import init_data_group
from sparknet_tpu_torch.parallel.trainer import ParallelTrainer


def run(rank, world, store_path, params, argv, workdir):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_WORLD_SIZE=str(world))
    start = {l: {p: torch.from_numpy(v) for p, v in lp.items()}
             for l, lp in params.items()}
    ParallelTrainer.init_state = \
        lambda self, seed=0: self.state_from_params(start)
    group = init_data_group("cpu", store_path=store_path, rank=rank,
                            world_size=world)
    try:
        imagenet_app.main([*argv, f"workdir={workdir}_w{rank}"])
    finally:
        group.close()
