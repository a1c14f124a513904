"""The `caffe` backend: a Caffe net's TRAIN-phase loss and Caffe SGD, in
plain PyTorch, from the layer list of a configuration file; its blobs'
shapes, its learned leaves and its FLOPs (the backend's contract:
`reference/__init__.py`).

Layers: Convolution, ReLU, Pooling (MAX, or AVE over a window clipped to
the padded input, as Caffe divides; Caffe's ceil rule for both), LRN (across
channels: y = x * (k + alpha/n * sum of x^2 over the clipped channel
window)^-beta, in float32), InnerProduct (Caffe's NCHW flatten), Dropout
(keep with probability 1 - ratio and scale by 1/keep) and SoftmaxWithLoss
(the batch mean of the float32 negative log-likelihood). Autograd gives
the gradients. Tensors are NCHW-contiguous; weights OIHW and (out, in).

Dropout masks: the configuration states no generator, so the reference
draws them as the training loop keys them, from (seed, round, rank,
step) and the crc32 of the layer's name, each through numpy's
SeedSequence into a `torch.Generator` on the device, and `torch.rand`
of the blob's shape below 1 - ratio. That is the one recipe the
reference shares with the program.
"""
from __future__ import annotations

import math
import zlib
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .precision import operand, output


def caffe_pool_size(size: int, kernel: int, stride: int, pad: int) -> int:
    """Caffe's pooled size: ceil division, then the last window dropped
    when it would start in the padding."""
    out = -(-(size + 2 * pad - kernel) // stride) + 1
    if pad > 0 and (out - 1) * stride >= size + pad:
        out -= 1
    return out


def shapes(config: dict) -> Dict[str, Tuple[int, ...]]:
    """Every blob's NCHW shape (N, D for inner products) at the
    configuration's batch, by layer top name (a layer's own name maps to
    its output too)."""
    n = config["batch"]
    blobs = {"data": (n, config["channels"], config["crop"], config["crop"])}
    out = {}
    for layer in config["layers"]:
        t = layer["type"]
        x = blobs[layer["bottom"][0]]
        if t == "Convolution":
            p = layer["convolution_param"]
            k, s, pad = p["kernel_size"], p.get("stride", 1), p.get("pad", 0)
            h = (x[2] + 2 * pad - k) // s + 1
            w = (x[3] + 2 * pad - k) // s + 1
            y = (n, p["num_output"], h, w)
        elif t == "Pooling":
            p = layer["pooling_param"]
            k, s, pad = p["kernel_size"], p.get("stride", 1), p.get("pad", 0)
            y = (n, x[1], caffe_pool_size(x[2], k, s, pad),
                 caffe_pool_size(x[3], k, s, pad))
        elif t == "InnerProduct":
            y = (n, layer["inner_product_param"]["num_output"])
        elif t == "SoftmaxWithLoss":
            y = ()
        else:
            y = x
        blobs[layer["top"][0]] = y
        out[layer["name"]] = y
        out.setdefault(f"{layer['name']}:in", x)
    return out


def weight_leaves(config: dict) -> List[Tuple[str, Tuple[int, ...], dict]]:
    """(key, shape, filler) of every learned leaf, in the program's layout
    and order: `<layer>/w` OIHW or (out, in), then `<layer>/b`."""
    leaves = []
    blob_shapes = shapes(config)
    for layer in config["layers"]:
        t = layer["type"]
        if t == "Convolution":
            p = layer["convolution_param"]
            cin = blob_shapes[f"{layer['name']}:in"][1] // p.get("group", 1)
            k = p["kernel_size"]
            w = (p["num_output"], cin, k, k)
        elif t == "InnerProduct":
            p = layer["inner_product_param"]
            w = (p["num_output"],
                 math.prod(blob_shapes[f"{layer['name']}:in"][1:]))
        else:
            continue
        leaves.append((f"{layer['name']}/w", w, p["weight_filler"]))
        leaves.append((f"{layer['name']}/b", (p["num_output"],),
                       p["bias_filler"]))
    return leaves


def unit_axis(config: dict, key: str) -> int:
    """A leaf's output axis: 0 of OIHW and (out, in)."""
    return 0


def forward_flops_per_sample(config: dict) -> float:
    """Every convolution 2·OH·OW·k²·(Cin/group)·Cout and every inner
    product 2·in·out, for one image."""
    total = 0.0
    blob_shapes = shapes(config)
    for layer in config["layers"]:
        name = layer["name"]
        if layer["type"] == "Convolution":
            p = layer["convolution_param"]
            _, cout, h, w = blob_shapes[name]
            cin = blob_shapes[f"{name}:in"][1] // p.get("group", 1)
            total += 2.0 * h * w * p["kernel_size"] ** 2 * cin * cout
        elif layer["type"] == "InnerProduct":
            fan_in = math.prod(blob_shapes[f"{name}:in"][1:])
            total += 2.0 * fan_in * blob_shapes[name][1]
    return total


def _seed(*keys: int) -> int:
    seq = np.random.SeedSequence([int(k) for k in keys])
    return int(seq.generate_state(1, np.uint64)[0])


def dropout_generator(step_keys, name: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        _seed(_seed(*step_keys), zlib.crc32(name.encode())))


def lrn(x: torch.Tensor, n: int, alpha: float, beta: float,
        k: float) -> torch.Tensor:
    xf = x.float()
    half = (n - 1) // 2
    c = xf.shape[1]
    sq = F.pad(xf * xf, (0, 0, 0, 0, half, half))
    window = sum(sq[:, j:j + c] for j in range(n))
    return (xf * torch.pow(k + (alpha / n) * window, -beta)).to(x.dtype)


def pool(x: torch.Tensor, kind: str, kernel: int, stride: int, pad: int,
         want_hw) -> torch.Tensor:
    """MAX or AVE pooling with Caffe's output size. AVE divides by the
    window clipped to the padded input (padding counts, the ceil rule's
    overhang does not): `count_include_pad` with `ceil_mode` does so."""
    if kind == "MAX":
        y = F.max_pool2d(x, kernel, stride, padding=pad, ceil_mode=True)
    elif kind == "AVE":
        y = F.avg_pool2d(x, kernel, stride, padding=pad, ceil_mode=True,
                         count_include_pad=True)
    else:
        raise ValueError(f"pool {kind!r} is not in the reference")
    if tuple(y.shape[2:]) != tuple(want_hw):
        raise ValueError(f"pooled to {tuple(y.shape[2:])}, Caffe's rule "
                         f"gives {tuple(want_hw)}")
    return y


def loss(config: dict, params: Dict[str, torch.Tensor],
         rows: Dict[str, torch.Tensor], mode: str,
         step_keys) -> torch.Tensor:
    """The TRAIN-phase loss of one batch: `rows["data"]` [b, H, W, C] int8
    pixels, `rows["label"]` [b, 1] int32, `params` {"<layer>/w",
    "<layer>/b"}; `step_keys` = (seed, round, rank, step) for the dropout
    masks."""
    blobs = {"data": rows["data"].permute(0, 3, 1, 2).contiguous().float(),
             "label": rows["label"].reshape(-1).long()}
    out = None
    for layer in config["layers"]:
        t, name = layer["type"], layer["name"]
        x = blobs[layer["bottom"][0]]
        if t == "Convolution":
            p = layer["convolution_param"]
            y = F.conv2d(operand(x, mode), operand(params[f"{name}/w"], mode),
                         operand(params[f"{name}/b"], mode),
                         stride=p.get("stride", 1), padding=p.get("pad", 0),
                         groups=p.get("group", 1))
            y = output(y, mode)
        elif t == "ReLU":
            y = F.relu(x)
        elif t == "Pooling":
            p = layer["pooling_param"]
            k, s, pad = p["kernel_size"], p.get("stride", 1), p.get("pad", 0)
            y = pool(x, p.get("pool", "MAX"), k, s, pad,
                     [caffe_pool_size(d, k, s, pad) for d in x.shape[2:]])
        elif t == "LRN":
            p = layer["lrn_param"]
            y = lrn(x, p.get("local_size", 5), p.get("alpha", 1.0),
                    p.get("beta", 0.75), p.get("k", 1.0))
        elif t == "InnerProduct":
            y = F.linear(operand(x.reshape(x.shape[0], -1), mode),
                         operand(params[f"{name}/w"], mode),
                         operand(params[f"{name}/b"], mode))
            y = output(y, mode)
        elif t == "Dropout":
            keep = 1.0 - layer.get("dropout_param", {}).get(
                "dropout_ratio", 0.5)
            g = dropout_generator(step_keys, name, x.device)
            mask = torch.rand(x.shape, generator=g, device=x.device) < keep
            y = torch.where(mask, x / keep, 0.0).to(x.dtype)
        elif t == "SoftmaxWithLoss":
            logp = F.log_softmax(x.float(), dim=-1)
            lab = blobs[layer["bottom"][1]]
            out = -logp.gather(-1, lab[:, None])[:, 0].mean()
            y = out
        else:
            raise ValueError(f"{name}: layer type {t!r} is not in the "
                             f"reference")
        blobs[layer["top"][0]] = y
    if out is None:
        raise ValueError("the configuration has no SoftmaxWithLoss layer")
    return out


def multipliers(config: dict):
    """{key: (lr_mult, decay_mult)} of every learned leaf (Caffe's param
    blocks; missing entries are 1)."""
    out = {}
    for layer in config["layers"]:
        if layer["type"] not in ("Convolution", "InnerProduct"):
            continue
        specs = list(layer.get("param", [])) + [{}, {}]
        for i, p in enumerate(("w", "b")):
            out[f"{layer['name']}/{p}"] = (float(specs[i].get("lr_mult", 1)),
                                           float(specs[i].get("decay_mult",
                                                              1)))
    return out


def learning_rate(solver: dict, it: int) -> torch.Tensor:
    """Caffe's rate at iteration `it` for the "fixed" and "step" policies,
    in float32."""
    base = torch.tensor(solver["base_lr"], dtype=torch.float32)
    policy = solver.get("lr_policy", "fixed")
    if policy == "fixed":
        return base
    if policy == "step":
        k = float(np.floor(it / solver["stepsize"]))
        return base * torch.pow(torch.tensor(solver["gamma"],
                                             dtype=torch.float32), k)
    raise ValueError(f"lr_policy {policy!r} is not in the reference")


def optimizer(config: dict) -> "Sgd":
    return Sgd(config)


class Sgd:
    """Caffe SGD with momentum: V = m V + rate * lr_mult * (g + wd *
    decay_mult * W); W -= V."""

    def __init__(self, config: dict):
        self.solver = config["solver"]
        self.mults = multipliers(config)

    def zeros(self, params):
        return {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def update(self, params, momentum, grads, it: int) -> None:
        rate = learning_rate(self.solver, it)
        m, wd = self.solver.get("momentum", 0.0), self.solver.get(
            "weight_decay", 0.0)
        for k, w in params.items():
            lr_mult, decay_mult = self.mults[k]
            v = m * momentum[k] + (rate * lr_mult).item() * (
                grads[k] + (wd * decay_mult) * w)
            w.sub_(v)
            momentum[k] = v
