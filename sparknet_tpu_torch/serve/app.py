"""The serve CLI of the PyTorch port: one model behind the inference server.

The counterpart of the single-model path of `sparknet_tpu/serve/app.py`.
Builds a zoo net or a `.prototxt` net on the device (the CUDA card unless
`--device cpu`) with `--weights` (`.npz` or `.caffemodel`) or seeded
random ones, starts the dynamic-batching server, and either self-drives
`--demo N` synthetic requests through submit -> batch -> forward -> de-pad
and prints the status JSON, or serves until interrupted. The router, the network
frontends and the fleet come with later slices.

Examples:
    python -m sparknet_tpu_torch.serve.app --model caffenet --max-batch 128 \
        --outputs prob --demo 256
    python -m sparknet_tpu_torch.serve.app --model lenet --device cpu --demo 8
    python -m sparknet_tpu_torch.serve.app --model deploy.prototxt \
        --weights trained.caffemodel --device cpu --demo 8
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np

from .. import zoo
from ..net_api import TorchNet
from ..utils.logger import default_logger
from .server import InferenceServer, ServeConfig, net_input_specs


def resolve_spec(model: str, max_batch: int, n_classes: int,
                 crop: Optional[int]):
    """A `.prototxt` path (at its own input shapes) or a zoo builder name
    at batch max_batch -> NetSpec (the same table as
    `sparknet_tpu/apps/train_loop.py:resolve_spec`)."""
    if model.endswith(".prototxt"):
        from ..model.prototxt import net_from_prototxt_file
        return net_from_prototxt_file(model)
    builders = {
        "cifar10_quick": lambda: zoo.cifar10_quick(batch=max_batch),
        "caffenet": lambda: zoo.caffenet(batch=max_batch, crop=crop or 227,
                                         n_classes=n_classes),
        "lenet": lambda: zoo.lenet(batch=max_batch),
        "adult_mlp": lambda: zoo.adult_mlp(batch=max_batch),
    }
    if model not in builders:
        raise ValueError(f"unknown model {model!r}: expected a .prototxt "
                         f"path or one of {sorted(builders)}")
    return builders[model]()


def _demo_payload(net, seed: int = 0) -> dict:
    r = np.random.default_rng(seed)
    name, (shape, dtype) = next(
        (k, v) for k, v in net_input_specs(net).items()
        if np.issubdtype(np.dtype(v[1]), np.floating))
    return {name: r.standard_normal(shape).astype(dtype)}


def run_demo(server: InferenceServer, n: int, seed: int = 0) -> dict:
    """Drive n synthetic requests (random inputs in the net's own schema)
    through the live server and return its status dict."""
    futures = [server.submit(_demo_payload(server.net, seed + i))
               for i in range(n)]
    for f in futures:
        f.result(timeout=120.0)
    return server.status()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--model", default="lenet",
                   help="zoo builder name or a .prototxt path")
    p.add_argument("--weights", default=None,
                   help="weights to load: .npz (WeightCollection) or "
                   ".caffemodel (default: seeded random)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' to run there)")
    p.add_argument("--seed", type=int, default=0,
                   help="weight-init generator seed")
    p.add_argument("--n-classes", type=int, default=10)
    p.add_argument("--crop", type=int, default=None)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--buckets", default=None,
                   help="comma-separated batch buckets (default: powers "
                   "of 2 up to max-batch)")
    p.add_argument("--outputs", default=None,
                   help="comma-separated blob names to return "
                   "(default: the net's per-row outputs)")
    p.add_argument("--workdir", default=None,
                   help="log/JSONL directory (default $SPARKNET_TPU_HOME)")
    p.add_argument("--demo", type=int, default=None, metavar="N",
                   help="self-drive N synthetic requests, print status "
                   "JSON, exit")
    args = p.parse_args(argv)

    log = default_logger(args.workdir, name="serving")
    net = TorchNet(resolve_spec(args.model, args.max_batch, args.n_classes,
                                args.crop),
                   seed=args.seed, device=args.device)
    if args.weights:
        net.load_weights(args.weights)
    cfg = ServeConfig(
        model_name=args.model, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        buckets=(tuple(int(b) for b in args.buckets.split(","))
                 if args.buckets else None),
        outputs=tuple(args.outputs.split(",")) if args.outputs else None)
    with InferenceServer(net, cfg, logger=log) as server:
        if args.demo is not None:
            print(json.dumps(run_demo(server, args.demo)))
            return
        log.log("serving; Ctrl-C to stop")
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            log.log("interrupted; draining")


if __name__ == "__main__":
    main()
