"""Feature-extraction app — the counterpart of
`sparknet_tpu/apps/featurizer_app.py` (reference `apps/FeaturizerApp.scala`).

The reference's inference-shaped workload: build a net (no solver), set
weights once, then map the dataset through `forward(..., List("ip1"))`
extracting a hidden blob per example (`FeaturizerApp.scala:75-98`). Here:
a `TorchNet` of cifar10_quick, weights from an npz or a .caffemodel
(`TorchNet.load_weights`), batched TEST-phase forwards, features written
to an npz. `--graph` (.pb / .json) featurizes a serialized graph instead
(the second backend, `backend/graph_net.py:GraphNet`): its hidden nodes are
fetched by name through the same NetInterface spelling, and `--weights`
is then a `WeightCollection` npz assigned by variable name.

Usage:
    python -m sparknet_tpu_torch.apps.featurizer_app --data-dir data/cifar10 \\
        --weights w.caffemodel --blob ip1 --out features.npz [--device cpu]
    python -m sparknet_tpu_torch.apps.featurizer_app --data-dir data/cifar10 \\
        --graph model.json --blob relu3 [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from ..data.cifar import CifarLoader
from ..net_api import TorchNet
from ..zoo import cifar10_quick


def featurize(net, batch_dict, blob: str, batch_size: int) -> np.ndarray:
    """`net` is either backend (TorchNet or GraphNet). `blob` of every full
    batch of `batch_dict`, concatenated (a tail
    shorter than `batch_size` is left out, as in the reference)."""
    n = len(next(iter(batch_dict.values())))
    feats = []
    usable = (n // batch_size) * batch_size
    for i in range(0, usable, batch_size):
        batch = {k: v[i:i + batch_size] for k, v in batch_dict.items()}
        out = net.forward(batch, blob_names=[blob])
        feats.append(np.asarray(out[blob]))
    return np.concatenate(feats) if feats else np.empty((0,))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--weights", help="weights file (.npz / .caffemodel)")
    p.add_argument("--graph", help="serialized graph (.pb / .json) to "
                   "featurize instead of the layer-IR net")
    p.add_argument("--blob", default="ip1")
    p.add_argument("--batch", type=int, default=100)
    p.add_argument("--out", default="features.npz")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    batch_dict = CifarLoader(args.data_dir).train_batch_dict()
    if args.graph:
        from ..backend import GraphNet
        from ..model.weights import WeightCollection
        from .graph_common import load_graph
        net = GraphNet(load_graph(args.graph, None), device=args.device)
        if args.weights:
            # assigns by VARIABLE name (the //assign protocol); a
            # collection whose names don't match fails loudly there
            net.set_weights(WeightCollection.load(args.weights))
        missing = [i for i in net.input_names if i not in batch_dict]
        if missing:
            raise ValueError(
                f"graph inputs {missing} not provided by the loader "
                f"(has {sorted(batch_dict)}) — this app feeds "
                f"data/label-shaped graphs")
        # fail fast on a dataset/graph size mismatch (layouts may be
        # transposed by the net, so compare element counts per example)
        shapes = net.input_shapes()
        for iname in net.input_names:
            want = shapes[iname]
            got = batch_dict[iname].shape
            if want and int(np.prod(want[1:])) != int(np.prod(got[1:])):
                raise ValueError(
                    f"graph input {iname!r} expects per-example shape "
                    f"{tuple(want[1:])} but the dataset provides "
                    f"{tuple(got[1:])}")
        batch_dict = {k: v for k, v in batch_dict.items()
                      if k in net.input_names}
    else:
        net = TorchNet(cifar10_quick(batch=args.batch), device=args.device)
        if args.weights:
            net.load_weights(args.weights)
    feats = featurize(net, batch_dict, args.blob, args.batch)
    np.savez(args.out, features=feats)
    print(f"wrote {feats.shape} features to {args.out}")


if __name__ == "__main__":
    main()
