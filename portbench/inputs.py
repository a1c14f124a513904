"""What the benchmark makes from `--seed` and hands to both sides.

The traffic is a traffic file's parameters, read by the general generator
of its `kind`, kinds/<kind>.py (`load.kind`):

  check(traffic)          raises ValueError on parameters it cannot draw
  make_round(config, traffic, seed, rank, rnd, device)
                          round `rnd` of rank `rank`: {name: tensor on
                          `device`} of the τ steps' net inputs, each
                          [tau, local_batch, ...], drawn by a generator
                          keyed (seed, DATA, rank, rnd) (`generator`)

Every kind's file gives `tau`, `local_batch` (samples a step) and
`rounds_held`. The program is fed `rounds_held` such rounds per rank from
host memory, cycled in round order; the reference draws the rounds it
follows again from the same keys.

The initial weights follow the fillers of the configuration backend's
`weight_leaves` (reference/<backend>.py: gaussian std and mean, constant
values), drawn on the device in one `randn` over every gaussian leaf from
a generator keyed (seed, "weights"), in float32.

Nothing here imports the program: the reference uses this module too.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from . import load

#: generator domains, so that data and weights never share a stream
DATA, WEIGHTS = 1, 2


def generator(device, *keys: int) -> torch.Generator:
    """A torch.Generator on `device` seeded from non-negative ints through
    numpy's SeedSequence."""
    seq = np.random.SeedSequence([int(k) for k in keys])
    return torch.Generator(device=device).manual_seed(
        int(seq.generate_state(1, np.uint64)[0]))


# -- weights -----------------------------------------------------------------


def make_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The initial weights {key: float32 tensor on `device`}: one `randn`
    for every gaussian leaf together, constants filled."""
    leaves = load.reference(config).weight_leaves(config)
    gauss = [(k, s, f) for k, s, f in leaves if f.get("type") == "gaussian"]
    total = sum(math.prod(s) for _, s, _ in gauss)
    flat = torch.randn(total, generator=generator(device, seed, WEIGHTS),
                       device=device, dtype=torch.float32)
    out, off = {}, 0
    for key, shape, filler in leaves:
        fill = filler.get("type", "constant")
        if fill == "gaussian":
            n = math.prod(shape)
            t = flat[off:off + n].view(shape)
            off += n
            t.mul_(float(filler["std"]))
            if filler.get("mean", 0.0):
                t.add_(float(filler["mean"]))
        elif fill == "constant":
            t = torch.full(shape, float(filler.get("value", 0.0)),
                           dtype=torch.float32, device=device)
        else:
            raise ValueError(f"{key}: filler {fill!r} is not one the "
                             f"benchmark draws")
        out[key] = t
    return out


# -- traffic -----------------------------------------------------------------


def make_round(config: dict, traffic: dict, seed: int, rank: int, rnd: int,
               device) -> Dict[str, torch.Tensor]:
    """Round `rnd` of rank `rank`, from kinds/<kind>.py: {name: [tau,
    local_batch, ...] tensor on `device`}."""
    kind = load.kind(traffic)
    kind.check(traffic)
    return kind.make_round(config, traffic, seed, rank, rnd, device)


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
