"""One rank of the port's sharded and tensor-parallel trainers, for
tests/test_torch_sharded.py and tests/test_torch_tp.py. It imports torch
and the port only: the test spawns it with torch.multiprocessing (or calls
it in-process for a world of one), it joins a gloo group through a
FileStore (NCCL on the card: rank r drives card r), trains, and writes
what it saw to `<out>/rank<r>.npz` for the parent to hold against the JAX
package.

`setup` picks the trainer: {"impl": "shard_map" | "named", "tp",
"state_sharding", "mode", "solver", "device", "velocity"}. Each rank
trains on its data group's block of every round's [tau, global, ...]
batches (a model group shares one block) and evaluates its block of the
eval batch before each round. Saved: per round the loss, the health
scalars and the accuracy; the at-rest numel of the params and momentum
buffers (`at_rest/params`, `at_rest/momentum`) and, on a card,
`torch.cuda.memory_allocated` at rest; at the end the logical params and
momentum (PyTorch layouts), and the flat map of `checkpoint_tree`
(`ckpt/...`). With `ckpt_dirs` ({"on"|"off": dir}) the final state is
also written through the train loop's save at step `len(rounds)`, in
each layout. With `restore` ({"dir", "policy"}) the state starts from
that directory's newest step instead of the params.
"""
import os

import numpy as np
import torch

from sparknet_tpu_torch.apps import train_loop
from sparknet_tpu_torch.model.net import CompiledNet
from sparknet_tpu_torch.parallel.mesh import init_data_group
from sparknet_tpu_torch.parallel.sharded import ShardedTrainer
from sparknet_tpu_torch.parallel.trainer import ParallelTrainer
from sparknet_tpu_torch.solver import SolverConfig
from sparknet_tpu_torch.utils import checkpoint as ckpt
from sparknet_tpu_torch.utils.config import RunConfig


def make_trainer(net, group, tau, setup):
    kw = dict(tau=tau, mode=setup.get("mode", "local_sgd"),
              tp=setup.get("tp", 1))
    cfg = SolverConfig(**setup.get("solver", {}))
    if setup.get("impl", "shard_map") == "named":
        return ShardedTrainer(net, cfg, group,
                              state_sharding=setup.get("state_sharding",
                                                       "replicated"), **kw)
    return ParallelTrainer(net, cfg, group, **kw)


def logical(trainer, state):
    """(params, momentum) as logical PyTorch-layout trees; momentum is this
    rank's own (its column shards gathered) or the ZeRO one."""
    params = trainer.averaged_params(state)
    if isinstance(trainer, ShardedTrainer):
        mom = trainer.logical_momentum(state)
    else:
        mom = trainer._gather_tp({l: dict(lp)
                                  for l, lp in state.momentum.items()})
    return params, mom


def _numpy(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def run(rank, world, store_path, spec, params, rounds, eval_batch, setup,
        out_dir, ckpt_dirs=None, restore=None):
    torch.set_num_threads(1)
    device = setup.get("device", "cpu")
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    group = init_data_group(device, store_path=store_path, rank=rank,
                            world_size=world)
    try:
        net = CompiledNet.compile(spec)
        tau = next(iter(rounds[0].values())).shape[0] if rounds else 1
        tr = make_trainer(net, group, tau, setup)
        if restore is not None:
            flat, _, extra = ckpt.restore_flat(restore["dir"])
            state = tr.state_from_checkpoint(
                flat, extra, restore.get("policy", "norm_rescale"))
        else:
            state = tr.state_from_params(
                {l: {p: torch.from_numpy(np.array(v)) for p, v in lp.items()}
                 for l, lp in params.items()})
        d, n_data = tr.data.rank, tr.n_data
        out = {}
        if eval_batch is not None:
            n = next(iter(eval_batch.values())).shape[0] // n_data
            mine_eval = {k: v[d * n:(d + 1) * n]
                         for k, v in eval_batch.items()}
        for r, batches in enumerate(rounds):
            if eval_batch is not None:
                out[f"acc/{r}"] = tr.evaluate(state, mine_eval)
            lb = next(iter(batches.values())).shape[1] // n_data
            mine = {k: v[:, d * lb:(d + 1) * lb] for k, v in batches.items()}
            state, loss = tr.train_round(state, mine, (0, r))
            out[f"loss/{r}"] = float(loss)
            for k, v in (tr.last_health or {}).items():
                out[f"{k}/{r}"] = v.detach().cpu().numpy()
        out["at_rest/params"] = state.flat_params.numel()
        out["at_rest/momentum"] = state.flat_momentum.numel()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
            out["memory_allocated"] = torch.cuda.memory_allocated()
        out["it"] = state.it
        p, m = logical(tr, state)
        for kind, tree in (("params", p), ("momentum", m)):
            for l, lp in tree.items():
                for q, t in lp.items():
                    out[f"{kind}/{l}/{q}"] = _numpy(t)
        tree = tr.checkpoint_tree(state)
        for key, a in ckpt._flatten(tree).items():
            out[f"ckpt/{key}"] = (_numpy(a) if isinstance(a, torch.Tensor)
                                  else np.asarray(a))
        for fmt, dst in (ckpt_dirs or {}).items():
            train_loop._save_checkpoint(
                RunConfig(checkpoint_dir=dst, checkpoint_sharded=fmt), tr,
                state, len(rounds), retain=False)
            group.barrier()
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        group.close()


def grads(rank, world, store_path, spec, params, batch, tp, out_dir):
    """One step's gradients under tensor parallelism at `tp` model ranks:
    the raw autograd gradients (the gather's backward reduce-scatters the
    cotangent) and the fixed ones (`_fix_tp_grads`), each put back
    together over the model group, to `<out>/grads<r>.npz`."""
    from sparknet_tpu_torch.solver import value_and_grad
    torch.set_num_threads(1)
    group = init_data_group("cpu", store_path=store_path, rank=rank,
                            world_size=world)
    try:
        net = CompiledNet.compile(spec)
        tr = ParallelTrainer(net, SolverConfig(), group, tau=1, tp=tp)
        state = tr.state_from_params(
            {l: {p: torch.from_numpy(np.array(v)) for p, v in lp.items()}
             for l, lp in params.items()})
        lb = next(iter(batch.values())).shape[0] // tr.n_data
        d = tr.data.rank
        mine = {k: torch.from_numpy(v[d * lb:(d + 1) * lb])
                for k, v in batch.items()}
        loss_fn = net.loss_fn(tp_group=tr.model, tp_size=tp)
        loss, raw = value_and_grad(loss_fn, state.params, mine)
        fixed = tr._fix_tp_grads(raw)
        out = {"loss": float(loss)}
        for kind, tree in (("raw", raw), ("fixed", fixed)):
            for l, lp in tr._gather_tp(tree).items():
                for p, t in lp.items():
                    out[f"{kind}/{l}/{p}"] = t.numpy()
        np.savez(f"{out_dir}/grads{rank}.npz", **out)
    finally:
        group.close()
