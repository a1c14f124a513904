"""The comparison that decides `correct`.

Four numbers, each between the program's first rounds and the
reference's (`reference/train.py`), both from the same weights and rows:

  loss_gap      the largest |program - reference| / |reference| of the
                first rounds' losses (the loop's round loss: the workers'
                mean of their tau-step means);
  grad_gap      the optimizer's state after the first step (momentum or
                accumulator: the first gradient as the optimizer took
                it): by the worst leaf, | |m_prog| - |m_ref| | over the
                larger of |m_ref| of that leaf and of the median leaf;
  grad_unit_gap the same first gradient by output unit (a weight's
                slice along its output axis, which the configuration's
                backend names; a 1-D leaf such as a bias whole):
                the median over every unit of the kept leaves of
                | |m_prog| - |m_ref| | over the larger of the unit's |m_ref|
                and the median unit's of its leaf. A gap of norms is of
                the second order in rounding that does not lean one way,
                and vanishes by chance for a whole leaf on some seeds; over
                ten thousand units its median is steady from seed to seed
                (PERF.md gives both readings);
  momentum_gap  the optimizer's state after round 1, at the τ boundary:
                by the worst leaf, as above;
  change_gap    the weights' change from the start over the first rounds,
                as the state the next round starts from keeps it: by the
                worst leaf, as above.

A leaf whose reference first gradient is under a thousandth of the median
leaf's is nought to rounding: it moves by round-off alone, and the leaf
numbers leave it out.

`limits` come from `limits/<workload>.json`; a number over its limit, or
one that is not finite, makes the run not correct. A limit of null marks
a number the cell does not compare: neither its control nor any fault
moves it clear of the program's own spread (PERF.md gives its readings).
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping

import torch

from . import load

#: the numbers, in the order they are printed
NAMES = ("loss_gap", "grad_gap", "grad_unit_gap", "momentum_gap",
         "change_gap")
#: a leaf under this share of the median reference momentum is left out
NOUGHT = 1e-3


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    return s[len(s) // 2] if len(s) % 2 else 0.5 * (s[len(s) // 2 - 1]
                                                    + s[len(s) // 2])


def kept_leaves(ref_momentum: Dict[str, torch.Tensor]) -> List[str]:
    norms = {k: _norm(v) for k, v in ref_momentum.items()}
    med = _median(list(norms.values()))
    return [k for k, n in norms.items() if n >= NOUGHT * med]


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keys: List[str]) -> List[float]:
    """| |prog| - |ref| | over the larger of |ref| of the leaf and of the
    median leaf, for each leaf of `keys`."""
    pn = {k: _norm(prog[k]) for k in keys}
    rn = {k: _norm(ref[k]) for k in keys}
    med = _median(list(rn.values()))
    return [abs(pn[k] - rn[k]) / max(rn[k], med, 1e-300) for k in keys]


def unit_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keys: List[str], axes: Mapping[str, int]) -> torch.Tensor:
    """Every output unit's norm gap (module docstring), of all `keys`;
    `axes[k]` is leaf k's output axis, and a 1-D leaf is one unit."""
    out = []
    for k in keys:
        a, b = prog[k].double(), ref[k].double()
        if b.ndim == 1:
            a, b = a[None], b[None]
        else:
            ax = axes[k]
            a, b = (a.movedim(ax, 0).reshape(a.shape[ax], -1),
                    b.movedim(ax, 0).reshape(b.shape[ax], -1))
        na, nb = a.norm(dim=1), b.norm(dim=1)
        floor = torch.clamp(nb.median(), min=1e-300)
        out.append((na - nb).abs() / torch.maximum(nb, floor))
    return torch.cat(out)


def numbers(prog: dict, ref: dict,
            axes: Mapping[str, int]) -> Dict[str, float]:
    """`prog` and `ref`: {"loss": [floats], "first", "momentum",
    "params": {leaf: tensor}}; `ref` also holds "init". `axes`: each
    leaf's output axis (`unit_axes`)."""
    if len(prog["loss"]) != len(ref["loss"]):
        raise ValueError(f"{len(prog['loss'])} program losses, "
                         f"{len(ref['loss'])} reference losses")
    missing = set(ref["params"]) ^ set(prog["params"])
    missing |= set(ref["momentum"]) ^ set(prog["momentum"])
    missing |= set(ref["first"]) ^ set(prog["first"])
    if missing:
        raise ValueError(f"leaves not on both sides: {sorted(missing)}")
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                       ref["loss"]))
    keys = kept_leaves(ref["first"])
    init = ref["init"]
    change_p = {k: prog["params"][k] - init[k] for k in keys}
    change_r = {k: ref["params"][k] - init[k] for k in keys}
    first = leaf_gaps(prog["first"], ref["first"], keys)
    return {"loss_gap": loss_gap, "grad_gap": max(first),
            "grad_unit_gap": float(unit_gaps(prog["first"], ref["first"],
                                             keys, axes).median()),
            "momentum_gap": max(leaf_gaps(prog["momentum"], ref["momentum"],
                                          keys)),
            "change_gap": max(leaf_gaps(change_p, change_r, keys))}


def unit_axes(config: dict, keys) -> Dict[str, int]:
    """{key: the output axis of leaf `key`}, from the configuration
    backend's `unit_axis` (reference/<backend>.py)."""
    backend = load.reference(config)
    return {k: backend.unit_axis(config, k) for k in keys}


def decide(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(math.isfinite(nums[k]) and nums[k] <= limits[k]
               for k in NAMES if limits[k] is not None)


def report(nums: Dict[str, float], limits: Dict[str, float]) -> dict:
    """The result line's last key: each number beside its limit."""
    return {k: {"value": nums[k], "limit": limits[k]} for k in NAMES}
