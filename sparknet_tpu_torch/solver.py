"""Caffe-semantics SGD solver on PyTorch tensors.

The counterpart of `sparknet_tpu/solver.py`. Caffe SGD update rule
(SGDSolver<Dtype>::ComputeUpdateValue semantics):

    local_rate  = rate(iter) * lr_mult
    local_decay = weight_decay * decay_mult
    V <- momentum * V + local_rate * (grad + local_decay * W)
    W <- W - V

LR policies (Caffe `GetLearningRate`): fixed, step, exp, inv, multistep,
poly, sigmoid — computed in float32 tensors as the JAX package computes
them (a Python-double rate would differ from it in the last bits).

Where the JAX package returns new params and state, `update` writes them
in place under `torch.no_grad()` — params keep their storage (the trainer's
flat buffer) and autograd never sees the update.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from . import precision
from .model.layers import LAYER_IMPLS, seeded_generator
from .model.net import CompiledNet, ParamTree
from .model.spec import ParamSpec
from .obs import trace as obs_trace


@dataclass(frozen=True)
class SolverConfig:
    base_lr: float = 0.01
    lr_policy: str = "fixed"
    gamma: float = 0.1
    stepsize: int = 100000
    stepvalue: Tuple[int, ...] = ()
    power: float = 1.0
    max_iter: int = 10000
    momentum: float = 0.9
    weight_decay: float = 0.0
    iter_size: int = 1
    # Storage dtype for the velocity (momentum history). "float32" is
    # Caffe-exact. "bfloat16" is an opt-in: each step still computes the
    # update in f32 and applies the unrounded velocity to the weights —
    # only the stored history is rounded.
    velocity_dtype: str = "float32"

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "SolverConfig":
        solver_type = d.get("type", "SGD")
        if solver_type not in ("SGD",):
            raise ValueError(
                f"unsupported solver type {solver_type!r} (only SGD with "
                f"momentum is implemented — fail loudly rather than silently "
                f"training with different dynamics)")
        fields = {f.name for f in dataclasses.fields(SolverConfig)}
        kw = {k: v for k, v in d.items() if k in fields}
        if "stepvalue" in kw:
            kw["stepvalue"] = tuple(kw["stepvalue"])
        return SolverConfig(**kw)


def learning_rate(cfg: SolverConfig, it: int) -> torch.Tensor:
    """rate(iter) for every Caffe lr_policy, a 0-d float32 CPU tensor; the
    ops and their order are `sparknet_tpu/solver.py:learning_rate`'s."""
    f32 = torch.float32
    it = torch.tensor(it, dtype=f32)
    p = cfg.lr_policy
    if p == "fixed":
        return torch.tensor(cfg.base_lr, dtype=f32)
    if p == "step":
        current = torch.floor(it / cfg.stepsize)
        return cfg.base_lr * torch.pow(cfg.gamma, current)
    if p == "exp":
        return cfg.base_lr * torch.pow(cfg.gamma, it)
    if p == "inv":
        return cfg.base_lr * torch.pow(1.0 + cfg.gamma * it, -cfg.power)
    if p == "multistep":
        if not cfg.stepvalue:
            return torch.tensor(cfg.base_lr, dtype=f32)
        steps = torch.tensor(cfg.stepvalue, dtype=f32)
        current = torch.sum(it[None] >= steps).to(f32)
        return cfg.base_lr * torch.pow(cfg.gamma, current)
    if p == "poly":
        return cfg.base_lr * torch.pow(1.0 - it / cfg.max_iter, cfg.power)
    if p == "sigmoid":
        return cfg.base_lr / (1.0 + torch.exp(-cfg.gamma
                                              * (it - cfg.stepsize)))
    raise ValueError(f"unknown lr_policy {p!r}")


@dataclass
class SolverState:
    """Optimizer state: momentum history + iteration counter. Momentum is
    worker-local and never averaged (the reference averaged only net
    blobs)."""

    momentum: ParamTree
    it: int


def value_and_grad(loss_fn, params: ParamTree, batch, generator=None
                   ) -> Tuple[torch.Tensor, ParamTree]:
    """(loss, grads) of `loss_fn(params, batch, generator)` by autograd;
    every param must require grad. grads has params' tree shape. The
    forward and the backward are the tracer's card-timed "forward" and
    "backward" spans."""
    leaves = [(l, p, w) for l, lp in params.items() for p, w in lp.items()]
    with obs_trace.card_span("forward"):
        loss, _ = loss_fn(params, batch, generator)
    with obs_trace.card_span("backward"):
        gs = torch.autograd.grad(loss, [w for _, _, w in leaves])
    grads: ParamTree = {}
    for (l, p, _), g in zip(leaves, gs):
        grads.setdefault(l, {})[p] = g
    return loss.detach(), grads


class SgdSolver:
    """SGD solver bound to a CompiledNet: `update` applies one Caffe-SGD
    step from given grads; `step` is forward + backward + update (with
    iter_size accumulation), the reference's `Solver.step`."""

    def __init__(self, net: CompiledNet, cfg: SolverConfig,
                 loss_blob: str = "loss", ops=None):
        if cfg.velocity_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"velocity_dtype {cfg.velocity_dtype!r}: expected 'float32' "
                f"(Caffe-exact) or 'bfloat16' (opt-in, see SolverConfig)")
        self.net = net
        self.cfg = cfg
        self.loss_blob = loss_blob
        self.ops = ops
        self._lr_mults, self._decay_mults = _param_multipliers(net)

    def init_state(self, params: ParamTree) -> SolverState:
        vdt = precision.DTYPES[self.cfg.velocity_dtype]
        return SolverState(
            momentum={l: {p: torch.zeros(w.shape, dtype=vdt, device=w.device)
                          for p, w in lp.items()}
                      for l, lp in params.items()},
            it=0)

    def update(self, params: ParamTree, state: SolverState,
               grads: ParamTree, lr_scale: float = 1.0
               ) -> Tuple[ParamTree, SolverState]:
        """Apply one Caffe-SGD update given grads, in place (params and
        momentum keep their storage); returns (params, state). `lr_scale`
        multiplies the policy rate (the health supervisor's backoff)."""
        rate = learning_rate(self.cfg, state.it) * lr_scale
        with torch.no_grad():
            for lname, lparams in params.items():
                for pname, w in lparams.items():
                    v = state.momentum[lname][pname]
                    local_rate = rate * self._lr_mults[lname][pname]
                    local_decay = (self.cfg.weight_decay
                                   * self._decay_mults[lname][pname])
                    # in the weight dtype (f32); only the STORED history
                    # is in velocity_dtype — the weight sees the unrounded
                    # velocity (the JAX package's op order)
                    v_new = (self.cfg.momentum * v.to(w.dtype)
                             + local_rate * (grads[lname][pname]
                                             + local_decay * w))
                    w.sub_(v_new)
                    v.copy_(v_new)
        state.it += 1
        return params, state

    def step(self, params: ParamTree, state: SolverState, batch,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[ParamTree, SolverState, torch.Tensor]:
        """One update: with iter_size = k the batch holds k x net-batch
        examples, accumulated as k micro-batches whose grads and losses are
        averaged (Caffe's SGDSolver::Step). Returns (params, state, loss)."""
        if generator is None:
            generator = seeded_generator((0, state.it))
        loss_fn = self.net.loss_fn(self.loss_blob, ops=self.ops)
        k = self.cfg.iter_size
        if k == 1:
            loss, grads = value_and_grad(loss_fn, params, batch, generator)
        else:
            for name, v in batch.items():
                if v.shape[0] % k:
                    raise ValueError(
                        f"{name}: batch dim {v.shape[0]} not divisible by "
                        f"iter_size {k} (pass iter_size x net-batch "
                        f"examples per step)")
            loss = torch.zeros((), dtype=torch.float32)
            grads = None
            for i in range(k):
                micro = {name: v.reshape((k, v.shape[0] // k) + v.shape[1:])[i]
                         for name, v in batch.items()}
                l, g = value_and_grad(
                    loss_fn, params, micro,
                    seeded_generator((generator.initial_seed(), i)))
                loss = loss.to(l.device) + l / k
                if grads is None:
                    grads = {ln: {pn: torch.zeros_like(t)
                                  for pn, t in lp.items()}
                             for ln, lp in g.items()}
                grads = {ln: {pn: grads[ln][pn] + t / k
                              for pn, t in lp.items()}
                         for ln, lp in g.items()}
        params, state = self.update(params, state, grads)
        return params, state, loss


def _param_multipliers(net: CompiledNet):
    """Per-blob lr_mult/decay_mult from LayerSpec.params: the first
    ParamSpec is the weight, the second the bias; missing specs are 1.0
    (`sparknet_tpu/solver.py:_param_multipliers`)."""
    lr: Dict[str, Dict[str, float]] = {}
    decay: Dict[str, Dict[str, float]] = {}
    for layer in net.spec.layers:
        if LAYER_IMPLS[layer.type][0] is None:
            continue
        specs = list(layer.params) + [ParamSpec()] * (2 - len(layer.params))
        lr[layer.name] = {"w": specs[0].lr_mult, "b": specs[1].lr_mult}
        decay[layer.name] = {"w": specs[0].decay_mult,
                             "b": specs[1].decay_mult}
    return lr, decay
