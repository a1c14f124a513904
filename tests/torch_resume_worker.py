"""One rank of the port's training loop, for the multi-rank resume test in
tests/test_torch_resume.py. It imports torch and the port only: the test
spawns it with torch.multiprocessing; it joins a gloo group through a
FileStore, trains cifar10_quick 4 rounds uninterrupted, then 2 rounds and
a resume to round 4 in another checkpoint directory, and writes each
run's final state (and its state after round 2) to an npz file."""
import os

import numpy as np
import torch

from sparknet_tpu_torch.apps import cifar_app
from sparknet_tpu_torch.apps.train_loop import resolve_spec, train
from sparknet_tpu_torch.parallel.mesh import init_data_group
from sparknet_tpu_torch.utils.logger import Logger


def run(rank, world, store_path, cifar_dir, out_dir, overrides):
    torch.set_num_threads(1)
    os.environ["RANK"], os.environ["WORLD_SIZE"] = str(rank), str(world)
    group = init_data_group("cpu", store_path=store_path, rank=rank,
                            world_size=world)
    try:
        def go(name, rounds):
            cfg = cifar_app.default_config().with_overrides(
                *overrides, f"max_rounds={rounds}",
                f"data_dir={cifar_dir}",
                f"workdir={out_dir}/{name}_w{rank}",
                f"checkpoint_dir={out_dir}/{name}_ck",
                "checkpoint_sharded=off")
            spec = resolve_spec(cfg, data=(cfg.local_batch, 3, 32, 32),
                                label=(cfg.local_batch, 1))
            return train(cfg, spec, *cifar_app.build_datasets(cfg),
                         device="cpu", logger=Logger(echo=False))

        out = {}
        for tag, state in (("full", go("full", 4)), ("half", go("half", 2)),
                           ("resumed", go("half", 4))):
            out[f"{tag}/it"] = np.asarray(state.it)
            out[f"{tag}/flat_params"] = state.flat_params.detach().numpy()
            out[f"{tag}/flat_momentum"] = state.flat_momentum.numpy()
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        group.close()
