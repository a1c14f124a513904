"""What the metric readers share: the guard that keeps a device metric off
a run without a card, and the kernel rooflines' timing through the port's
public ops. The LRN and MAX-pool rooflines read a Caffe layer list, with
the `caffe` backend's shapes (`reference/caffe.py`).

A kernel's roofline share is the least time its work needs on the card
(the larger of its bytes over HBM bandwidth and its operations over the
f32 peak, `flops.bound_ms`) over its device time, both summed over the
layers that run it. The device time is `devtime.device_ms` of calls
through the public op with autograd, at the layer's shape and the
configuration's dtype, so the share reads the same work whatever
implements it; the inputs cycle through copies that together exceed the
L2 cache 2.5 times.
"""
from __future__ import annotations

import math

from . import devtime, flops

L2_BYTES = 50 * 2 ** 20


def require_card(ctx, name: str) -> None:
    if ctx.device.type != "cuda":
        raise RuntimeError(f"{name} is a device metric: this run has no "
                           f"card ({ctx.device})")


def _dtype(config):
    import torch
    return torch.bfloat16 if config["precision"] == "bfloat16" \
        else torch.float32


def _copies(shape, itemsize: int) -> int:
    return max(2, math.ceil(2.5 * L2_BYTES / (math.prod(shape) * itemsize)))


def lrn_roofline(ctx):
    """Σ bound / Σ device time of every LRN layer's forward and backward,
    as a percentage; None where the configuration has no LRN layer."""
    import torch

    from sparknet_tpu_torch.ops.lrn import lrn
    layers = [l for l in ctx.config.get("layers", [])
              if l.get("type") == "LRN"]
    if not layers:
        return None
    require_card(ctx, "an LRN roofline")
    pk = flops.peaks(ctx.device_name)
    if pk is None:
        return None
    from .reference.caffe import shapes as caffe_shapes
    shapes = caffe_shapes(ctx.config)
    dt = _dtype(ctx.config)
    itemsize = torch.finfo(dt).bits // 8
    gen = torch.Generator(device=ctx.device).manual_seed(0)
    bound = spent = 0.0
    for layer in layers:
        p = layer["lrn_param"]
        size = p.get("local_size", 5)
        kw = dict(alpha=p.get("alpha", 1.0), beta=p.get("beta", 0.75),
                  k=p.get("k", 1.0))
        n, c, h, w = shapes[f"{layer['name']}:in"]
        shape = (n, h, w, c)
        nbuf = _copies(shape, itemsize)
        xs = [(50.0 * torch.randn(shape, generator=gen, device=ctx.device)
               ).to(dt).requires_grad_(True) for _ in range(nbuf)]
        dys = [torch.randn(shape, generator=gen, device=ctx.device).to(dt)
               for _ in range(nbuf)]
        fwd = devtime.device_ms(lambda i: lrn(xs[i], size, **kw), nbuf)
        ys = [lrn(x, size, **kw) for x in xs]
        bwd = devtime.device_ms(lambda i: torch.autograd.grad(
            ys[i], xs[i], dys[i], retain_graph=True), nbuf)
        work = flops.lrn_work(shape, itemsize, size)
        bound += (flops.bound_ms(work["fwd_bytes"], work["fwd_ops"], pk)
                  + flops.bound_ms(work["bwd_bytes"], work["bwd_ops"], pk))
        spent += fwd + bwd
        del xs, dys, ys
    return 100.0 * bound / spent


def maxpool_bwd_roofline(ctx):
    """Σ bound / Σ device time of every MAX pool layer's backward, as a
    percentage; None where the configuration has none. The inputs are
    ReLU outputs (half of them 0, so windows tie as the net's do)."""
    import torch

    from sparknet_tpu_torch.ops.pooling import pool2d
    layers = [l for l in ctx.config.get("layers", [])
              if l.get("type") == "Pooling"
              and l["pooling_param"].get("pool", "MAX") == "MAX"]
    if not layers:
        return None
    require_card(ctx, "a MAX-pool roofline")
    pk = flops.peaks(ctx.device_name)
    if pk is None:
        return None
    from .reference.caffe import shapes as caffe_shapes
    shapes = caffe_shapes(ctx.config)
    dt = _dtype(ctx.config)
    itemsize = torch.finfo(dt).bits // 8
    gen = torch.Generator(device=ctx.device).manual_seed(0)
    bound = spent = 0.0
    for layer in layers:
        p = layer["pooling_param"]
        k, s, pad = p["kernel_size"], p.get("stride", 1), p.get("pad", 0)
        n, c, h, w = shapes[f"{layer['name']}:in"]
        _, _, oh, ow = shapes[layer["name"]]
        nbuf = _copies((n, h, w, c), itemsize)
        leaves = [torch.relu(torch.randn((n, h, w, c), generator=gen,
                                         device=ctx.device)).to(dt)
                  .requires_grad_(True) for _ in range(nbuf)]
        ys = [pool2d(x.permute(0, 3, 1, 2), "MAX", k, s, pad)
              for x in leaves]
        dys = [torch.randn((n, oh, ow, c), generator=gen,
                           device=ctx.device).to(dt).permute(0, 3, 1, 2)
               for _ in range(nbuf)]
        bwd = devtime.device_ms(lambda i: torch.autograd.grad(
            ys[i], leaves[i], dys[i], retain_graph=True), nbuf)
        work = flops.maxpool_bwd_work((n, h, w, c), (n, oh, ow, c), k,
                                      itemsize)
        bound += flops.bound_ms(work["bytes"], work["ops"], pk)
        spent += bwd
        del leaves, ys, dys
    return 100.0 * bound / spent
