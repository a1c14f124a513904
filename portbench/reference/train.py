"""The τ-averaging loop's first rounds, in plain PyTorch.

Round r: every worker k starts from the averaged weights, runs tau steps
of its own rows (round r of rank k, drawn again from the seed by
`portbench.inputs`), each a loss, autograd and the configuration's
optimizer, keeping its own momentum; then the weights are averaged over
the workers (a sum, then a division). The round's loss is the workers'
mean of their tau-step means.

The loss, the optimizer and the weights are those of the configuration's
backend, reference/<backend>.py (`reference/__init__.py`).

`fault` plants one of the faults the check must catch, in the reference
put in the program's place: "unchanged" (a round that returns its state
as it found it), "half_batch" (each step's loss is the mean over the
first half of its rows: every array of the step's rows halved on axis 0)
and "no_exchange" (no average: each worker keeps its own weights).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .. import load
from ..inputs import make_round, make_weights
from .precision import MODES, exact_float32

FAULTS = ("unchanged", "half_batch", "no_exchange")


def follow(config: dict, traffic: dict, seed: int, world: int, rounds: int,
           device, mode: Optional[str] = None,
           fault: Optional[str] = None) -> Dict[str, object]:
    """Follow `rounds` rounds of `world` workers. Returns {"loss": [one
    float a round], "first": worker 0's optimizer state after its first
    step, "momentum": worker 0's after round 0, "params": worker 0's
    weights after the last round, "init": the initial weights}, tensors
    on the CPU in float32."""
    mode = mode or config["precision"]
    if mode not in MODES:
        raise ValueError(f"unknown reference precision {mode!r}")
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    backend = load.reference(config)
    opt = backend.optimizer(config)
    tau = traffic["tau"]
    init = make_weights(config, seed, device)
    params = {k: v.clone() for k, v in init.items()}
    moms = [opt.zeros(params) for _ in range(world)]
    mine = [params] * world
    losses: List[float] = []
    out: Dict[str, object] = {"init": _host(init)}
    with exact_float32():
        for rnd in range(rounds):
            ends, round_loss = [], 0.0
            for k in range(world):
                w = {n: v.clone().requires_grad_(True)
                     for n, v in mine[k].items()}
                rows = make_round(config, traffic, seed, k, rnd, device)
                step_losses = []
                for t in range(tau):
                    step = {name: v[t] for name, v in rows.items()}
                    if fault == "half_batch":
                        step = {name: v[:v.shape[0] // 2]
                                for name, v in step.items()}
                    lv = backend.loss(config, w, step, mode,
                                      (seed, rnd, k, t))
                    names = list(w)
                    grads = torch.autograd.grad(lv, [w[n] for n in names])
                    step_losses.append(float(lv.detach()))
                    if fault != "unchanged":
                        opt.update(w, moms[k], dict(zip(names, grads)),
                                   rnd * tau + t)
                    if rnd == 0 and k == 0 and t == 0:
                        out["first"] = _host(moms[0])
                round_loss += sum(step_losses) / tau
                ends.append({n: v.detach() for n, v in w.items()})
            losses.append(round_loss / world)
            if fault == "no_exchange":
                mine = ends
            else:
                avg = {n: sum(e[n] for e in ends) / world for n in ends[0]}
                mine = [avg] * world
            if rnd == 0:
                out["momentum"] = _host(moms[0])
            del ends
    out["loss"] = losses
    out["params"] = _host(mine[0])
    return out


def _host(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", torch.float32) for k, v in tree.items()}
