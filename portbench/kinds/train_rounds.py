"""`kind: train_rounds`: rounds of seeded int8 NHWC pixels and labels.

Round r of rank k holds tau x local_batch int8 NHWC pixels of the
configuration's crop and channels in [pixel_low, pixel_high], and int32
labels over the configuration's classes in its `label_shape`, drawn on the
device by a generator keyed (seed, DATA, k, r).
"""
from __future__ import annotations

from typing import Dict

import torch

from ..inputs import DATA, generator


def check(traffic: dict) -> None:
    lo, hi = traffic["pixel_low"], traffic["pixel_high"]
    if not -128 <= lo <= hi <= 127:
        raise ValueError(f"pixels [{lo}, {hi}] do not fit int8")


def make_round(config: dict, traffic: dict, seed: int, rank: int, rnd: int,
               device) -> Dict[str, torch.Tensor]:
    """Round `rnd` of rank `rank`: {"data": [tau, b, H, W, C] int8,
    "label": [tau, b, *label_shape] int32} on `device`."""
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
