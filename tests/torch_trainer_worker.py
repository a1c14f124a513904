"""One rank of the port's ParallelTrainer, for the multi-rank tests in
tests/test_torch_trainer.py. It imports torch and the port only: the test
spawns it with torch.multiprocessing, joins a gloo group through a
FileStore, trains, and writes what it saw to an npz file the parent holds
against the JAX package."""
import numpy as np
import torch

from sparknet_tpu_torch.model.net import CompiledNet
from sparknet_tpu_torch.parallel.mesh import init_data_group
from sparknet_tpu_torch.parallel.trainer import ParallelTrainer
from sparknet_tpu_torch.solver import SolverConfig


def run(rank, world, store_path, spec, params, rounds, eval_batch, mode,
        solver_kw, out_dir):
    """Train len(rounds) rounds on this rank's block of each round's
    [tau, world * local_b, ...] batches, evaluating this rank's block of
    `eval_batch` before each; save params, momentum, losses, health and
    accuracies to out_dir/rank<rank>.npz."""
    torch.set_num_threads(1)
    group = init_data_group("cpu", store_path=store_path, rank=rank,
                            world_size=world)
    try:
        net = CompiledNet.compile(spec)
        tau = next(iter(rounds[0].values())).shape[0]
        trainer = ParallelTrainer(net, SolverConfig(**solver_kw), group,
                                  tau=tau, mode=mode)
        state = trainer.state_from_params(
            {l: {p: torch.from_numpy(v) for p, v in lp.items()}
             for l, lp in params.items()})
        out = {}
        n = next(iter(eval_batch.values())).shape[0] // world
        mine_eval = {k: v[rank * n:(rank + 1) * n]
                     for k, v in eval_batch.items()}
        for r, batches in enumerate(rounds):
            out[f"acc/{r}"] = trainer.evaluate(state, mine_eval)
            lb = next(iter(batches.values())).shape[1] // world
            mine = {k: v[:, rank * lb:(rank + 1) * lb]
                    for k, v in batches.items()}
            state, loss = trainer.train_round(state, mine, (0, r))
            out[f"loss/{r}"] = float(loss)
            for k, v in trainer.last_health.items():
                out[f"{k}/{r}"] = v.numpy()
        for kind, tree in (("params", state.params),
                           ("momentum", state.momentum)):
            for l, lp in tree.items():
                for p, t in lp.items():
                    out[f"{kind}/{l}/{p}"] = t.detach().numpy()
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        group.close()
