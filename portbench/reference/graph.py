"""A serialized graph's loss and its in-graph Momentum, in plain PyTorch,
from the layer list of a configuration file.

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

from typing import Dict

import torch
import torch.nn.functional as F

from .precision import operand, output


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
         data: torch.Tensor, label: torch.Tensor, mode: str) -> torch.Tensor:
    """The loss of one batch: `data` [b, H, W, C] int8 pixels, `label`
    [b] int32, `variables` {"<layer>_w", "<layer>_b"}."""
    x = data.float()
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
