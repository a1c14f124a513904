"""The port's host trace (`obs/trace.py`, the loop's `trace_out`) and device
profiler (`utils/profiling.py`, the loop's `profile_dir`) against the JAX
package's, on the CPU.

- `Tracer.instant` and `active_tracer` make the events the JAX package's
  make (name, phase, scope, category, args; the clock and ids aside).
- `trace_out` on a tiny cifar10_quick run (local batch 4, τ = 2, 4
  rounds, an eval and an async checkpoint every 2): the port's trace has
  the JAX loop's spans and instants, each as many times, on the same
  thread lanes; the `flush` instants carry rounds 0-3 and their losses,
  round 0's within rtol 1e-4 of JAX's from the JAX package's init
  weights (convolution sums run in another order). A loop that aborts
  still writes its trace.
- `profile_dir`: round start_round + 1 is profiled on the CPU (CPU
  activity only: there is no card) into `round-<R>.pt.trace.json`, at a
  fresh start and after a resume.
"""
import collections
import json
import os

import numpy as np
import pytest
import torch

from sparknet_tpu.apps import cifar_app as jax_cifar_app
from sparknet_tpu.apps.train_loop import resolve_spec as jax_resolve_spec
from sparknet_tpu.apps.train_loop import train as jax_train
from sparknet_tpu.model.net import CompiledNet as JaxCompiledNet
from sparknet_tpu.obs import trace as jax_trace

from sparknet_tpu_torch.apps import cifar_app
from sparknet_tpu_torch.apps.train_loop import resolve_spec, train
from sparknet_tpu_torch.data.cifar import write_synthetic
from sparknet_tpu_torch.model.net import CompiledNet, params_from_jax
from sparknet_tpu_torch.obs import trace
from sparknet_tpu_torch.parallel.trainer import ParallelTrainer
from sparknet_tpu_torch.utils.logger import Logger
from test_torch_train import jax_params

torch.set_num_threads(2)
OVERRIDES = ("tau=2", "local_batch=4", "max_rounds=4", "eval_every=2",
             "eval_batch=20", "checkpoint_every=2")
SHAPES = dict(data=(4, 3, 32, 32), label=(4, 1))


@pytest.fixture(scope="module")
def cifar_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cifar")
    write_synthetic(str(d), n_per_file=100)
    return d


def test_instant_and_active_tracer_are_the_jax_packages():
    events = []
    for mod in (trace, jax_trace):
        assert mod.active_tracer() is None
        tr = mod.start_tracing()
        try:
            assert mod.active_tracer() is tr
            tr.instant("flush", round=3, loss=1.5)
            tr.instant("mark")
        finally:
            assert mod.stop_tracing() is tr
        assert mod.active_tracer() is None
        events.append([{k: v for k, v in e.items()
                        if k not in ("ts", "pid", "tid")}
                       for e in tr.events() if e["ph"] == "i"])
    assert events[0] == events[1] == [
        {"name": "flush", "ph": "i", "s": "t", "cat": "host",
         "args": {"round": 3, "loss": 1.5}},
        {"name": "mark", "ph": "i", "s": "t", "cat": "host"}]


def _trace(path):
    evs = json.load(open(path))["traceEvents"]
    lanes = sorted(e["args"]["name"] for e in evs
                   if e["name"] == "thread_name")
    kinds = collections.Counter((e["ph"], e["name"]) for e in evs
                                if e["ph"] != "M")
    flushes = [e["args"] for e in evs if e["name"] == "flush"]
    return lanes, kinds, flushes


def test_trace_out_has_the_jax_loops_spans_and_instants(cifar_dir,
                                                        tmp_path,
                                                        monkeypatch):
    common = (*OVERRIDES, f"data_dir={cifar_dir}")
    jcfg = jax_cifar_app.default_config().with_overrides(
        *common, f"workdir={tmp_path / 'jw'}",
        f"checkpoint_dir={tmp_path / 'jck'}",
        f"trace_out={tmp_path / 'jax.json'}", "n_devices=1",
        "trainer_impl=shard_map")
    jspec = jax_resolve_spec(jcfg, **SHAPES)
    jax_train(jcfg, jspec, *jax_cifar_app.build_datasets(jcfg))
    cfg = cifar_app.default_config().with_overrides(
        *common, f"workdir={tmp_path / 'pw'}",
        f"checkpoint_dir={tmp_path / 'pck'}",
        f"trace_out={tmp_path / 'port.json'}")
    # the JAX package's init weights (the port draws its own otherwise)
    start = params_from_jax(CompiledNet.compile(resolve_spec(cfg, **SHAPES)),
                            jax_params(JaxCompiledNet.compile(jspec)),
                            torch.device("cpu"))
    monkeypatch.setattr(ParallelTrainer, "init_state",
                        lambda self, seed=0: self.state_from_params(start))
    log = Logger(str(tmp_path / "l.txt"), echo=False)
    train(cfg, resolve_spec(cfg, **SHAPES), *cifar_app.build_datasets(cfg),
          device="cpu", logger=log)
    log.close()
    assert f"host trace written to {tmp_path / 'port.json'}" in \
        open(tmp_path / "l.txt").read()
    assert trace.active_tracer() is None
    (jl, jk, jf), (pl, pk, pf) = (_trace(tmp_path / "jax.json"),
                                  _trace(tmp_path / "port.json"))
    assert pl == jl == ["MainThread", "ckpt-write_0", "collect_0",
                        "round-prep_0"]
    # the JAX loop's spans and instants, and the port's trainer spans
    # inside dispatch: per step a step, forward, backward and solver span,
    # per round an exchange span (4 rounds of tau 2)
    own = {"step": 8, "forward": 8, "backward": 8, "solver": 8,
           "exchange": 4}
    assert {k: v for k, v in pk.items() if k[1] not in own} == jk
    assert {k[1]: v for k, v in pk.items() if k[1] in own} == own
    for name in ("round_prep", "h2d_prefetch", "train_round",
                 "checkpoint_write"):
        assert pk[("X", name)] > 0, name
    assert [f["round"] for f in pf] == [f["round"] for f in jf] == \
        [0, 1, 2, 3]
    # round 0 runs from the same weights; later rounds drift apart as
    # the packages' float sums do (test_torch_train holds the numerics)
    np.testing.assert_allclose(pf[0]["loss"], jf[0]["loss"], rtol=1e-4)
    assert all(np.isfinite(f["loss"]) for f in pf)


def test_an_aborted_loop_still_writes_its_trace(cifar_dir, tmp_path):
    cfg = cifar_app.default_config().with_overrides(
        *OVERRIDES, f"data_dir={cifar_dir}", f"workdir={tmp_path}",
        f"trace_out={tmp_path / 't.json'}")

    def hook(rnd, state):
        if rnd == 1:
            raise RuntimeError("stop here")

    with pytest.raises(RuntimeError, match="stop here"):
        train(cfg, resolve_spec(cfg, **SHAPES),
              *cifar_app.build_datasets(cfg), device="cpu", round_hook=hook)
    assert trace.active_tracer() is None
    _, kinds, flushes = _trace(tmp_path / "t.json")
    assert kinds[("X", "train_round")] == 2
    assert [f["round"] for f in flushes] == [0, 1]


def test_profile_dir_profiles_the_round_after_the_start(cifar_dir,
                                                        tmp_path):
    prof = tmp_path / "prof"
    for rounds, want in ((2, "round-1.pt.trace.json"),
                         (4, "round-3.pt.trace.json")):
        cfg = cifar_app.default_config().with_overrides(
            *OVERRIDES, f"max_rounds={rounds}", "eval_every=0",
            f"data_dir={cifar_dir}", f"workdir={tmp_path}",
            f"checkpoint_dir={tmp_path / 'ck'}", f"profile_dir={prof}")
        log = Logger(str(tmp_path / f"l{rounds}.txt"), echo=False)
        train(cfg, resolve_spec(cfg, **SHAPES),
              *cifar_app.build_datasets(cfg), device="cpu", logger=log)
        log.close()
        assert want in os.listdir(prof)
        text = open(tmp_path / f"l{rounds}.txt").read()
        assert f"profiler trace written to {prof}, iteration = " \
               f"{rounds - 1}" in text
        evs = json.load(open(prof / want))["traceEvents"]
        cats = {e.get("cat") for e in evs}
        assert "cpu_op" in cats and "kernel" not in cats
        ops = {e["name"] for e in evs if e.get("cat") == "cpu_op"}
        assert {"aten::convolution", "aten::max_pool2d_with_indices"} & ops
    assert sorted(os.listdir(prof)) == ["round-1.pt.trace.json",
                                        "round-3.pt.trace.json"]
