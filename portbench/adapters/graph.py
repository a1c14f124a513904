"""The `graph` backend's program: `sparknet_tpu_torch.apps.graph_common.
train_graph` over a GraphDef that the port's GraphBuilder builds from the
configuration's layer list, with the benchmark's weights as its variables'
initial values, the GraphTrainer inside it; the first-step observer sits
on the trainer's `_step` (`programs.py`)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..programs import FirstStep, _as_is, _replaced, _run_config


class Program:
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
