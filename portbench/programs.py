"""The system under test: the port's training entry points, one adapter per
configuration backend.

  caffe  `sparknet_tpu_torch.apps.train_loop.train` over the zoo's net of
         the configuration's name, the ParallelTrainer inside it;
  graph  `sparknet_tpu_torch.apps.graph_common.train_graph` over a
         GraphDef that the port's GraphBuilder builds from the
         configuration's layer list, the GraphTrainer inside it.

Both run the port's own `run_loop` with its defaults (round prep thread,
H2D prefetch, donated slots, the deferred collect, telemetry) and no eval,
checkpoint or elastic membership. The rows come from a
`inputs.RoundSource`. The initial weights are the benchmark's: a graph
carries them as its variables' initial values; `train` has no way to be
given weights, so while it runs the trainer's `init_state` hands it the
benchmark's weights through `state_from_params`.

The trainer's `init_state` (replaced while the entry point runs, and
checked to have been called) also puts a first-step observer on that
trainer: its optimizer's first update (`solver.update`; a graph's train
step) runs as before, then the optimizer state it left, the first
gradient as the optimizer took it, is copied to the host and the
observer takes itself off, so the window's steps call the program
directly.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch


def _run_config(config: dict, traffic: dict, seed: int, workdir: str,
                cache_dir: str, trace_out, **kw):
    from sparknet_tpu_torch.utils.config import RunConfig
    return RunConfig(model=config.get("zoo", config["name"]),
                     n_classes=config["n_classes"], crop=config["crop"],
                     tau=traffic["tau"], local_batch=traffic["local_batch"],
                     max_rounds=1 << 30, eval_every=0,
                     precision=config["precision"], seed=int(seed),
                     workdir=workdir, checkpoint_dir=None,
                     compile_cache_dir=cache_dir, trace_out=trace_out, **kw)


class FirstStep:
    """Wraps an instance's callable attribute for its first call: the call
    runs, then `read(result, args)` is kept in `.value` and the attribute
    is what it was before."""

    def __init__(self, owner, name: str, read):
        self.owner, self.name, self.read = owner, name, read
        self.own = name in vars(owner)
        self.inner = getattr(owner, name)
        self.value = None
        setattr(owner, name, self)

    def __call__(self, *args, **kw):
        out = self.inner(*args, **kw)
        self.value = self.read(out, args)
        if self.own:
            setattr(self.owner, self.name, self.inner)
        else:
            delattr(self.owner, self.name)
        return out


class CaffeProgram:
    backend = "caffe"

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


class GraphProgram:
    backend = "graph"

    def __init__(self, config: dict, traffic: dict):
        if config["batch"] != traffic["local_batch"]:
            raise ValueError("the traffic's batch is not the config's")
        self.config, self.traffic = config, traffic

    def graph(self, weights: Dict[str, np.ndarray]):
        """The GraphDef of the configuration's layer list, node for node
        as `backend/builder.py:build_alexnet_graph` names them, with
        `weights` as the variables' initial values."""
        from sparknet_tpu_torch.backend.builder import GraphBuilder
        c = self.config
        g = GraphBuilder(c["name"])
        g.placeholder("data", (c["batch"], c["crop"], c["crop"],
                               c["channels"]))
        g.placeholder("label", (c["batch"],) + tuple(c["label_shape"]),
                      dtype="int32")
        x, logits = "data", None
        for layer in c["layers"]:
            op, name = layer["op"], layer["name"]
            if op == "Conv2D":
                g.variable(f"{name}_w", weights[f"{name}_w"])
                g.variable(f"{name}_b", weights[f"{name}_b"])
                x = g.conv2d(name, x, f"{name}_w", stride=layer["stride"],
                             padding=layer["padding"])
                x = g.bias_add(f"{name}_biased", x, f"{name}_b")
                if layer.get("relu"):
                    x = g.relu(f"relu{name[len('conv'):]}", x)
                pool = layer.get("pool")
                if pool:
                    x = g.max_pool(f"pool{name[len('conv'):]}", x,
                                   ksize=pool["ksize"],
                                   strides=pool["strides"],
                                   padding=pool["padding"])
            elif op == "Flatten":
                x = g.flatten(name, x)
            elif op == "MatMul":
                g.variable(f"{name}_w", weights[f"{name}_w"])
                g.variable(f"{name}_b", weights[f"{name}_b"])
                y = g.matmul(name, x, f"{name}_w")
                if layer.get("relu"):
                    x = g.relu(f"relu{name[len('fc'):]}",
                               g.add(f"{name}_biased", y, f"{name}_b"))
                else:
                    x = logits = g.add("logits", y, f"{name}_b")
            elif op == "SparseSoftmaxCrossEntropy":
                g.softmax("prob", logits)
                g.accuracy("accuracy", logits, "label")
                loss = g.sparse_softmax_ce(name, logits, "label")
            else:
                raise ValueError(f"{name}: op {op!r} has no builder call")
        opt = c["optimizer"]
        return g.finalize(loss=loss, learning_rate=opt["learning_rate"],
                          momentum=opt["momentum"],
                          lr_policy=opt.get("lr_policy", "fixed"))

    def run(self, seed: int, weights: Dict[str, torch.Tensor], source,
            logger, hook, device, workdir: str, cache_dir: str,
            trace_out=None):
        from sparknet_tpu_torch.apps.graph_common import train_graph
        from sparknet_tpu_torch.parallel.graph_trainer import GraphTrainer

        host = {k: weights.pop(k).cpu().numpy() for k in list(weights)}
        graph = self.graph(host)
        del host
        cfg = _run_config(self.config, self.traffic, seed, workdir,
                          cache_dir, trace_out)
        hook.cfg = cfg
        observed = []
        saved = GraphTrainer.__dict__["init_state"]

        def init_state(trainer, seed=0):
            # _step(state, batch) -> (state, loss): the slots it left
            observed.append(FirstStep(
                trainer, "_step",
                lambda out, args: {k: v.detach().to("cpu", torch.float32)
                                   for k, v in out[0]["slots"].items()}))
            return saved(trainer, seed)

        with _replaced(GraphTrainer, "init_state", init_state):
            state = train_graph(cfg, graph, source, logger=logger,
                                batch_transform=_as_is(), device=device,
                                round_hook=hook)
        if not observed or observed[0].value is None:
            raise RuntimeError("the graph trainer took no first step through "
                               "GraphTrainer._step")
        hook.first = observed[0].value
        return state

    @staticmethod
    def momentum(state) -> Dict[str, torch.Tensor]:
        return {k: v.detach().to("cpu", torch.float32, copy=True)
                for k, v in state["slots"].items()}

    @staticmethod
    def params(state) -> Dict[str, torch.Tensor]:
        return {k: v.detach().to("cpu", torch.float32, copy=True)
                for k, v in state["variables"].items()
                if v.is_floating_point()}


PROGRAMS = {"caffe": CaffeProgram, "graph": GraphProgram}


def program_for(config: dict, traffic: dict):
    return PROGRAMS[config["backend"]](config, traffic)


def _host_tree(tree, sep: str) -> Dict[str, torch.Tensor]:
    """{layer: {leaf: tensor}} -> {"<layer><sep><leaf>": float32 copy on
    the host}."""
    return {f"{l}{sep}{p}": v.detach().to("cpu", torch.float32, copy=True)
            for l, lp in tree.items() for p, v in lp.items()}


def _as_is():
    from .inputs import AsIs
    return AsIs()


@contextlib.contextmanager
def _replaced(cls, name: str, fn):
    saved = cls.__dict__[name]
    setattr(cls, name, fn)
    try:
        yield
    finally:
        setattr(cls, name, saved)
