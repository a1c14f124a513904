"""One rank of the port's GraphTrainer, for the multi-rank tests in
tests/test_torch_graph_trainer.py. It imports torch and the port only: the
test spawns it with torch.multiprocessing, joins a gloo group through a
FileStore, trains, and writes what it saw to an npz file the parent holds
against the JAX package."""
import numpy as np
import torch

from sparknet_tpu_torch.backend import GraphDef, GraphNet
from sparknet_tpu_torch.parallel.graph_trainer import GraphTrainer
from sparknet_tpu_torch.parallel.mesh import init_data_group


def run(rank, world, store_path, graph_json, init_vars, rounds, eval_batch,
        out_dir):
    """Train len(rounds) rounds on this rank's block of each round's
    [tau, world * local_b, ...] batches, evaluating this rank's block of
    `eval_batch` before each, from the variables `init_vars`; save the
    losses, health, accuracies, the final state and (rank 0) the
    checkpoint tree to out_dir/rank<rank>.npz."""
    torch.set_num_threads(1)
    group = init_data_group("cpu", store_path=store_path, rank=rank,
                            world_size=world)
    try:
        net = GraphNet(GraphDef.from_json(graph_json), device="cpu")
        for k, v in init_vars.items():
            net.variables[k] = torch.from_numpy(np.array(v))
        tau = next(iter(rounds[0].values())).shape[0]
        trainer = GraphTrainer(net, group, tau=tau)
        state = trainer.init_state()
        out = {}
        n = next(iter(eval_batch.values())).shape[0] // world
        mine_eval = {k: v[rank * n:(rank + 1) * n]
                     for k, v in eval_batch.items()}
        for r, batches in enumerate(rounds):
            out[f"acc/{r}"] = trainer.evaluate(state, mine_eval)
            lb = next(iter(batches.values())).shape[1] // world
            mine = {k: v[:, rank * lb:(rank + 1) * lb]
                    for k, v in batches.items()}
            state, loss = trainer.train_round(state, mine)
            out[f"loss/{r}"] = float(loss)
            for k, v in trainer.last_health.items():
                out[f"{k}/{r}"] = v.numpy()
        for kind in ("variables", "slots"):
            for k, v in state[kind].items():
                out[f"{kind}/{k}"] = v.numpy()
        out["it"] = np.asarray(state["it"])
        tree = trainer.checkpoint_tree(state)  # a collective
        if rank == 0:
            for kind in ("variables", "slots"):
                for k, v in tree[kind].items():
                    out[f"ckpt/{kind}/{k}"] = np.asarray(v)
            out["ckpt/it"] = tree["it"]
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        group.close()
