"""The system under test: the port's training entry points, one adapter per
configuration backend, `Program` of adapters/<backend>.py (`load.adapter`):

    Program(config, traffic)
    .run(seed, weights, source, logger, hook, device, workdir, cache_dir,
         trace_out=None) -> the program's final state; sets `hook.cfg` to
         the loop's RunConfig before the loop starts and `hook.first` to
         the optimizer state after the first step (host float32 leaves)
    .momentum(state), .params(state) -> {leaf key: host float32 tensor},
         keyed as reference/<backend>.py's `weight_leaves`

Each runs the port's own `run_loop` with its defaults (round prep thread,
H2D prefetch, donated slots, the deferred collect, telemetry) and no eval,
checkpoint or elastic membership. The rows come from a
`inputs.RoundSource`, the initial weights are the benchmark's, and the
round hook is `cell.Rounds`.

An adapter finds the trainer's first step by replacing its `init_state`
while the entry point runs (`_replaced`, checked to have been called):
that puts a first-step observer (`FirstStep`) on the trainer: its
optimizer's first update runs as before, then the optimizer state it
left, the first gradient as the optimizer took it, is copied to the host
and the observer takes itself off, so the window's steps call the program
directly. The helpers below are the adapters' shared parts.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch


def _run_config(config: dict, traffic: dict, seed: int, workdir: str,
                cache_dir: str, trace_out, **kw):
    from sparknet_tpu_torch.utils.config import RunConfig
    return RunConfig(model=config.get("zoo", config["name"]),
                     n_classes=config["n_classes"], crop=config["crop"],
                     tau=traffic["tau"], local_batch=traffic["local_batch"],
                     max_rounds=1 << 30, eval_every=0,
                     precision=config["precision"], seed=int(seed),
                     workdir=workdir, checkpoint_dir=None,
                     compile_cache_dir=cache_dir, trace_out=trace_out, **kw)


class FirstStep:
    """Wraps an instance's callable attribute for its first call: the call
    runs, then `read(result, args)` is kept in `.value` and the attribute
    is what it was before."""

    def __init__(self, owner, name: str, read):
        self.owner, self.name, self.read = owner, name, read
        self.own = name in vars(owner)
        self.inner = getattr(owner, name)
        self.value = None
        setattr(owner, name, self)

    def __call__(self, *args, **kw):
        out = self.inner(*args, **kw)
        self.value = self.read(out, args)
        if self.own:
            setattr(self.owner, self.name, self.inner)
        else:
            delattr(self.owner, self.name)
        return out


def program_for(config: dict, traffic: dict):
    """`Program(config, traffic)` of adapters/<backend>.py."""
    from . import load
    return load.adapter(config).Program(config, traffic)


def _host_tree(tree, sep: str) -> Dict[str, torch.Tensor]:
    """{layer: {leaf: tensor}} -> {"<layer><sep><leaf>": float32 copy on
    the host}."""
    return {f"{l}{sep}{p}": v.detach().to("cpu", torch.float32, copy=True)
            for l, lp in tree.items() for p, v in lp.items()}


def _as_is():
    from .inputs import AsIs
    return AsIs()


@contextlib.contextmanager
def _replaced(cls, name: str, fn):
    saved = cls.__dict__[name]
    setattr(cls, name, fn)
    try:
        yield
    finally:
        setattr(cls, name, saved)
