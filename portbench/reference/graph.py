"""The `graph` backend: a serialized graph's loss and its in-graph
Momentum, in plain PyTorch, from the layer list of a configuration file;
its layers' shapes, its learned leaves and its FLOPs (the backend's
contract: `reference/__init__.py`).

Layers (NHWC activations, HWIO and (in, out) weights, TensorFlow's
semantics): Conv2D with SAME padding (the output is ceil(in / stride);
the padding's odd pixel goes after) or VALID, a bias, ReLU, MaxPool
(VALID, or SAME padded with -inf), Flatten (NHWC order), MatMul plus a
bias, SparseSoftmaxCrossEntropy (the batch mean in float32).

Momentum (TensorFlow's MomentumOptimizer, every float variable
trainable): accum = momentum * accum + grad; var -= lr * accum, with a
fixed float32 learning rate.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .precision import operand, output


def tf_out_size(size: int, kernel: int, stride: int, padding: str) -> int:
    if padding == "SAME":
        return -(-size // stride)
    return (size - kernel) // stride + 1


def shapes(config: dict) -> Dict[str, Tuple[int, ...]]:
    """Every layer's NHWC output (N, D after the flatten), and its input
    under `<name>:in`; a pooled conv layer's pool output under
    `<name>:pool`."""
    n, c = config["batch"], config["channels"]
    x: Tuple[int, ...] = (n, config["crop"], config["crop"], c)
    out = {}
    for layer in config["layers"]:
        out[f"{layer['name']}:in"] = x
        op = layer["op"]
        if op == "Conv2D":
            k, s = layer["kernel"], layer["stride"]
            h = tf_out_size(x[1], k, s, layer["padding"])
            w = tf_out_size(x[2], k, s, layer["padding"])
            x = (n, h, w, layer["out"])
            out[layer["name"]] = x
            pool = layer.get("pool")
            if pool:
                x = (n, tf_out_size(h, pool["ksize"], pool["strides"],
                                    pool["padding"]),
                     tf_out_size(w, pool["ksize"], pool["strides"],
                                 pool["padding"]), layer["out"])
                out[f"{layer['name']}:pool"] = x
        elif op == "Flatten":
            x = (n, math.prod(x[1:]))
            out[layer["name"]] = x
        elif op == "MatMul":
            if x[1] != layer["in"]:
                raise ValueError(f"{layer['name']}: input width {x[1]} != "
                                 f"the layer's {layer['in']}")
            x = (n, layer["out"])
            out[layer["name"]] = x
        else:
            out[layer["name"]] = ()
    return out


def weight_leaves(config: dict) -> List[Tuple[str, Tuple[int, ...], dict]]:
    """(key, shape, filler) of every learned leaf, in the program's layout
    and order: `<layer>_w` HWIO or (in, out), then `<layer>_b`."""
    leaves = []
    for layer in config["layers"]:
        if layer["op"] == "Conv2D":
            k = layer["kernel"]
            w = (k, k, layer["in"], layer["out"])
        elif layer["op"] == "MatMul":
            w = (layer["in"], layer["out"])
        else:
            continue
        leaves.append((f"{layer['name']}_w", w,
                       {"type": "gaussian", "std": layer["std"]}))
        leaves.append((f"{layer['name']}_b", (layer["out"],),
                       {"type": "constant", "value": layer["bias"]}))
    return leaves


def unit_axis(config: dict, key: str) -> int:
    """A leaf's output axis: the last of HWIO and (in, out)."""
    return -1


def forward_flops_per_sample(config: dict) -> float:
    """Every Conv2D 2·OH·OW·k²·Cin·Cout and every MatMul 2·in·out, for
    one image."""
    total = 0.0
    layer_shapes = shapes(config)
    for layer in config["layers"]:
        name = layer["name"]
        if layer["op"] == "Conv2D":
            _, h, w, cout = layer_shapes[name]
            total += 2.0 * h * w * layer["kernel"] ** 2 * layer["in"] * cout
        elif layer["op"] == "MatMul":
            total += 2.0 * layer["in"] * layer["out"]
    return total


def same_padding(size: int, kernel: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pool(x: torch.Tensor, pool: dict) -> torch.Tensor:
    k, s = pool["ksize"], pool["strides"]
    xc = x.permute(0, 3, 1, 2)
    if pool["padding"] == "SAME":
        t, b = same_padding(x.shape[1], k, s)
        l, r = same_padding(x.shape[2], k, s)
        xc = F.pad(xc, (l, r, t, b), value=float("-inf"))
    return F.max_pool2d(xc, k, s).permute(0, 2, 3, 1)


def loss(config: dict, variables: Dict[str, torch.Tensor],
         rows: Dict[str, torch.Tensor], mode: str,
         step_keys) -> torch.Tensor:
    """The loss of one batch: `rows["data"]` [b, H, W, C] int8 pixels,
    `rows["label"]` [b] int32, `variables` {"<layer>_w", "<layer>_b"}; a
    graph draws nothing, so `step_keys` goes unused."""
    x = rows["data"].float()
    label = rows["label"]
    out = None
    for layer in config["layers"]:
        op, name = layer["op"], layer["name"]
        if op == "Conv2D":
            k, s = layer["kernel"], layer["stride"]
            xc = x.permute(0, 3, 1, 2)
            if layer["padding"] == "SAME":
                t, b = same_padding(x.shape[1], k, s)
                l, r = same_padding(x.shape[2], k, s)
                xc = F.pad(xc, (l, r, t, b))
            w = variables[f"{name}_w"].permute(3, 2, 0, 1)
            y = F.conv2d(operand(xc, mode), operand(w, mode), None,
                         stride=s)
            x = output(y, mode).permute(0, 2, 3, 1)
            x = x + variables[f"{name}_b"].to(x.dtype)
            if layer.get("relu"):
                x = F.relu(x)
            if layer.get("pool"):
                x = _pool(x, layer["pool"])
        elif op == "Flatten":
            x = x.reshape(x.shape[0], -1)
        elif op == "MatMul":
            y = torch.matmul(operand(x, mode),
                             operand(variables[f"{name}_w"], mode))
            x = output(y, mode) + variables[f"{name}_b"]
            if layer.get("relu"):
                x = F.relu(x)
        elif op == "SparseSoftmaxCrossEntropy":
            logp = F.log_softmax(x.float(), dim=-1)
            out = -logp.gather(-1, label.reshape(-1).long()[:, None])[
                :, 0].mean()
        else:
            raise ValueError(f"{name}: op {op!r} is not in the reference")
    if out is None:
        raise ValueError("the configuration has no SparseSoftmaxCrossEntropy")
    return out


def optimizer(config: dict) -> "Momentum":
    return Momentum(config)


class Momentum:
    """accum = m * accum + g; var -= lr * accum."""

    def __init__(self, config: dict):
        opt = config["optimizer"]
        if opt.get("lr_policy", "fixed") != "fixed":
            raise ValueError("the reference's Momentum has a fixed rate")
        self.lr = float(opt["learning_rate"])
        self.momentum = float(opt["momentum"])

    def zeros(self, params):
        return {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def update(self, params, accum, grads, it: int) -> None:
        lr = torch.tensor(self.lr, dtype=torch.float32,
                          device=next(iter(params.values())).device)
        for k, w in params.items():
            a = self.momentum * accum[k] + grads[k]
            w.sub_(lr * a)
            accum[k] = a
