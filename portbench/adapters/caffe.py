"""The `caffe` backend's program: `sparknet_tpu_torch.apps.train_loop.train`
over the zoo's net of the configuration's `zoo` name, the ParallelTrainer
inside it. `train` has no way to be given weights, so while it runs the
trainer's `init_state` hands it the benchmark's weights through
`state_from_params`, and puts the first-step observer on its solver's
`update` (`programs.py`)."""
from __future__ import annotations

from typing import Dict

import torch

from ..programs import FirstStep, _as_is, _host_tree, _replaced, _run_config


class Program:
    def __init__(self, config: dict, traffic: dict):
        if config["batch"] != traffic["local_batch"]:
            raise ValueError("the traffic's batch is not the config's")
        self.config, self.traffic = config, traffic

    def run(self, seed: int, weights: Dict[str, torch.Tensor], source,
            logger, hook, device, workdir: str, cache_dir: str,
            trace_out=None):
        from sparknet_tpu_torch import zoo
        from sparknet_tpu_torch.apps.train_loop import train
        from sparknet_tpu_torch.parallel.trainer import ParallelTrainer
        from sparknet_tpu_torch.solver import SolverConfig

        c = self.config
        spec = getattr(zoo, c["zoo"])(batch=c["batch"], crop=c["crop"],
                                      n_classes=c["n_classes"])
        cfg = _run_config(c, self.traffic, seed, workdir, cache_dir,
                          trace_out, solver=SolverConfig(**c["solver"]))
        hook.cfg = cfg
        handed = []

        def init_state(trainer, seed=0):
            tree: Dict[str, Dict[str, torch.Tensor]] = {}
            for key in list(weights):
                layer, leaf = key.split("/")
                tree.setdefault(layer, {})[leaf] = weights.pop(key)
            # update(params, state, grads, ...): the state's momentum
            handed.append(FirstStep(
                trainer.solver, "update",
                lambda out, args: _host_tree(args[1].momentum, "/")))
            return trainer.state_from_params(tree)

        with _replaced(ParallelTrainer, "init_state", init_state):
            state = train(cfg, spec, source, logger=logger, round_hook=hook,
                          batch_transform=_as_is(), device=device)
        if not handed or handed[0].value is None:
            raise RuntimeError("train() did not start from the benchmark's "
                               "weights: ParallelTrainer.init_state was not "
                               "called, or no update followed")
        hook.first = handed[0].value
        return state

    @staticmethod
    def momentum(state) -> Dict[str, torch.Tensor]:
        return _host_tree(state.momentum, "/")

    @staticmethod
    def params(state) -> Dict[str, torch.Tensor]:
        return _host_tree(state.params, "/")
