"""What the benchmark makes from `--seed` and hands to both sides.

The traffic is one general generator over a traffic file's parameters
(`kind: train_rounds`): round r of rank k holds tau x local_batch int8
NHWC pixels in [pixel_low, pixel_high] and int32 labels over the
configuration's classes, drawn on the device by a generator keyed
(seed, "data", k, r). The program is fed `rounds_held` such rounds per
rank from host memory, cycled in round order; the reference draws the
rounds it follows again from the same keys.

The initial weights follow the configuration's fillers (gaussian std and
constant values), drawn on the device in one `randn` over every gaussian
leaf from a generator keyed (seed, "weights"), in float32.

Nothing here imports the program: the reference uses this module too.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

#: generator domains, so that data and weights never share a stream
DATA, WEIGHTS = 1, 2


def generator(device, *keys: int) -> torch.Generator:
    """A torch.Generator on `device` seeded from non-negative ints through
    numpy's SeedSequence."""
    seq = np.random.SeedSequence([int(k) for k in keys])
    return torch.Generator(device=device).manual_seed(
        int(seq.generate_state(1, np.uint64)[0]))


# -- shapes ----------------------------------------------------------------


def caffe_pool_size(size: int, kernel: int, stride: int, pad: int) -> int:
    """Caffe's pooled size: ceil division, then the last window dropped
    when it would start in the padding."""
    out = -(-(size + 2 * pad - kernel) // stride) + 1
    if pad > 0 and (out - 1) * stride >= size + pad:
        out -= 1
    return out


def tf_out_size(size: int, kernel: int, stride: int, padding: str) -> int:
    if padding == "SAME":
        return -(-size // stride)
    return (size - kernel) // stride + 1


def caffe_shapes(config: dict) -> Dict[str, Tuple[int, ...]]:
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


def graph_shapes(config: dict) -> Dict[str, Tuple[int, ...]]:
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


# -- weights -----------------------------------------------------------------


def weight_leaves(config: dict) -> List[Tuple[str, Tuple[int, ...], dict]]:
    """(key, shape, filler) of every learned leaf, in the program's layout
    and order: Caffe `<layer>/w` OIHW or (out, in) then `<layer>/b`; a
    graph's `<layer>_w` HWIO or (in, out) then `<layer>_b`."""
    leaves = []
    if config["backend"] == "caffe":
        shapes = caffe_shapes(config)
        for layer in config["layers"]:
            t = layer["type"]
            if t == "Convolution":
                p = layer["convolution_param"]
                cin = shapes[f"{layer['name']}:in"][1] // p.get("group", 1)
                k = p["kernel_size"]
                w = (p["num_output"], cin, k, k)
            elif t == "InnerProduct":
                p = layer["inner_product_param"]
                w = (p["num_output"],
                     math.prod(shapes[f"{layer['name']}:in"][1:]))
            else:
                continue
            leaves.append((f"{layer['name']}/w", w, p["weight_filler"]))
            leaves.append((f"{layer['name']}/b", (p["num_output"],),
                           p["bias_filler"]))
        return leaves
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


def make_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The initial weights {key: float32 tensor on `device`}: one `randn`
    for every gaussian leaf together, constants filled."""
    leaves = weight_leaves(config)
    gauss = [(k, s, f) for k, s, f in leaves if f.get("type") == "gaussian"]
    total = sum(math.prod(s) for _, s, _ in gauss)
    flat = torch.randn(total, generator=generator(device, seed, WEIGHTS),
                       device=device, dtype=torch.float32)
    out, off = {}, 0
    for key, shape, filler in leaves:
        kind = filler.get("type", "constant")
        if kind == "gaussian":
            n = math.prod(shape)
            t = flat[off:off + n].view(shape)
            off += n
            t.mul_(float(filler["std"]))
            if filler.get("mean", 0.0):
                t.add_(float(filler["mean"]))
        elif kind == "constant":
            t = torch.full(shape, float(filler.get("value", 0.0)),
                           dtype=torch.float32, device=device)
        else:
            raise ValueError(f"{key}: filler {kind!r} is not one the "
                             f"benchmark draws")
        out[key] = t
    return out


# -- traffic -----------------------------------------------------------------


def check_traffic(traffic: dict) -> None:
    if traffic.get("kind") != "train_rounds":
        raise ValueError(f"traffic kind {traffic.get('kind')!r}: the "
                         f"generator makes 'train_rounds'")
    lo, hi = traffic["pixel_low"], traffic["pixel_high"]
    if not -128 <= lo <= hi <= 127:
        raise ValueError(f"pixels [{lo}, {hi}] do not fit int8")


def make_round(config: dict, traffic: dict, seed: int, rank: int, rnd: int,
               device) -> Dict[str, torch.Tensor]:
    """Round `rnd` of rank `rank`: {"data": [tau, b, H, W, C] int8,
    "label": [tau, b, *label_shape] int32} on `device`."""
    check_traffic(traffic)
    tau, b = traffic["tau"], traffic["local_batch"]
    g = generator(device, seed, DATA, rank, rnd)
    side = config["crop"]
    data = torch.randint(traffic["pixel_low"], traffic["pixel_high"] + 1,
                         (tau, b, side, side, config["channels"]),
                         generator=g, device=device, dtype=torch.int8)
    label = torch.randint(0, config["n_classes"],
                          (tau, b) + tuple(config["label_shape"]),
                          generator=g, device=device, dtype=torch.int32)
    return {"data": data, "label": label}


class RoundSource:
    """The program's feed: `rounds_held` rounds of one rank in host memory,
    served as round r % rounds_held (the loop's round-source interface,
    one worker: this rank's batch)."""

    n_workers = 1

    def __init__(self, config: dict, traffic: dict, seed: int, rank: int,
                 device):
        held = int(traffic["rounds_held"])
        first = make_round(config, traffic, seed, rank, 0, device)
        self.arrays = {k: np.empty((held,) + tuple(v.shape),
                                   dtype=v.cpu().numpy().dtype)
                       for k, v in first.items()}
        for r in range(held):
            rnd = first if r == 0 else make_round(config, traffic, seed,
                                                  rank, r, device)
            for k, v in rnd.items():
                self.arrays[k][r] = v.cpu().numpy()
        self.held = held

    def next_round(self, round_index: int = 0) -> Dict[str, np.ndarray]:
        r = int(round_index) % self.held
        return {k: v[r] for k, v in self.arrays.items()}


class AsIs:
    """The loop's batch transform for traffic that arrives as net inputs:
    each tau-slice passes through unchanged."""

    def convert_batch(self, batch, train: bool = True, rng=None):
        return dict(batch)
