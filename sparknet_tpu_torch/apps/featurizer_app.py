"""Feature-extraction app — the counterpart of
`sparknet_tpu/apps/featurizer_app.py` (reference `apps/FeaturizerApp.scala`).

The reference's inference-shaped workload: build a net (no solver), set
weights once, then map the dataset through `forward(..., List("ip1"))`
extracting a hidden blob per example (`FeaturizerApp.scala:75-98`). Here:
a `TorchNet` of cifar10_quick, weights from an npz or a .caffemodel
(`TorchNet.load_weights`), batched TEST-phase forwards, features written
to an npz. `--graph` (a serialized graph) is the second backend, which is
not ported yet (ROADMAP A12) and raises NotImplementedError.

Usage:
    python -m sparknet_tpu_torch.apps.featurizer_app --data-dir data/cifar10 \\
        --weights w.caffemodel --blob ip1 --out features.npz [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from ..data.cifar import CifarLoader
from ..net_api import TorchNet
from ..zoo import cifar10_quick


def featurize(net: TorchNet, batch_dict, blob: str,
              batch_size: int) -> np.ndarray:
    """`blob` of every full batch of `batch_dict`, concatenated (a tail
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
    p.add_argument("--graph", help="serialized graph (.pb / .json): the "
                   "second backend, not ported yet")
    p.add_argument("--blob", default="ip1")
    p.add_argument("--batch", type=int, default=100)
    p.add_argument("--out", default="features.npz")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.graph:
        raise NotImplementedError(
            "--graph: the serialized-graph backend (GraphNet) is not "
            "ported to the PyTorch port yet (ROADMAP A12)")
    batch_dict = CifarLoader(args.data_dir).train_batch_dict()
    net = TorchNet(cifar10_quick(batch=args.batch), device=args.device)
    if args.weights:
        net.load_weights(args.weights)
    feats = featurize(net, batch_dict, args.blob, args.batch)
    np.savez(args.out, features=feats)
    print(f"wrote {feats.shape} features to {args.out}")


if __name__ == "__main__":
    main()
