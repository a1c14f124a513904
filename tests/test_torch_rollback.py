"""The health supervisor's rollback in the port's loop, against the JAX
package's loop.

cifar10_quick at local batch 10, τ = 2, checkpoints every 2 rounds, on
`cifar.write_synthetic` data; the port starts from the JAX package's init
(as in `tests/test_torch_apps.py`, whose batch and loss tolerance these
are). At local batch 4 the two packages' loss trajectories on this data
part by more than 1e-4 from round 2 on, with or without the supervisor,
while their gradients at one set of params agree to 1e-6: a MAX-pool
near-tie routes differently after the first step (ROADMAP.md C;
`test_torch_trainer.py::test_batch4_cifar_trajectories_part_at_a_max_pool_near_tie`).

A NaN injected at round 3 must give, in both packages, one `rollback` event with the same reason, target step,
retry, rollbacks and lr_scale; the retried rounds draw the same data
window (`prepare_round_batches`, held exactly); the losses of every round,
the retried ones included, agree within rtol 1e-4 (convolution sums run
in another order); and the final step carries the same health state. The
refusals raise TrainingHealthError with the reference's message.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from sparknet_tpu import precision as jax_precision
from sparknet_tpu.apps import cifar_app as jax_cifar_app
from sparknet_tpu.apps.train_loop import \
    prepare_round_batches as jax_prepare_round_batches
from sparknet_tpu.apps.train_loop import resolve_spec as jax_resolve_spec
from sparknet_tpu.apps.train_loop import train as jax_train
from sparknet_tpu.data.dataset import ArrayDataset as JaxArrayDataset
from sparknet_tpu.data.dataset import RoundSampler as JaxRoundSampler
from sparknet_tpu.model.net import CompiledNet as JaxCompiledNet
from sparknet_tpu.utils import checkpoint as jck
from sparknet_tpu.utils.health import HealthConfig as JaxHealthConfig
from sparknet_tpu.utils.health import TrainingHealthError as JaxHealthError

from sparknet_tpu_torch.apps import cifar_app
from sparknet_tpu_torch.apps.train_loop import (prepare_round_batches,
                                                resolve_spec, train)
from sparknet_tpu_torch.data.cifar import write_synthetic
from sparknet_tpu_torch.data.dataset import ArrayDataset, RoundSampler
from sparknet_tpu_torch.model.net import CompiledNet, params_from_jax
from sparknet_tpu_torch.parallel.trainer import ParallelTrainer
from sparknet_tpu_torch.utils import checkpoint as ckpt
from sparknet_tpu_torch.utils.health import HealthConfig, TrainingHealthError
from test_torch_train import jax_params

torch.set_num_threads(2)
OVERRIDES = ("tau=2", "local_batch=10", "eval_every=0",
             "checkpoint_every=2", "checkpoint_async=false")
SHAPES = dict(data=(10, 3, 32, 32), label=(10, 1))


@pytest.fixture(scope="module")
def cifar_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cifar")
    write_synthetic(str(d), n_per_file=100)
    return d


def _records(workdir):
    (path,) = Path(workdir).glob("training_metrics_*.jsonl")
    return [json.loads(line) for line in path.read_text().splitlines()]


def _run_both(cifar_dir, tmp_path, monkeypatch, rounds, health, *extra):
    """The JAX package's train() and the port's on the same data, config
    and init; returns each side's records, or the exception it raised."""
    common = (*OVERRIDES, f"max_rounds={rounds}", f"data_dir={cifar_dir}",
              *extra)
    jcfg = jax_cifar_app.default_config().with_overrides(
        *common, f"workdir={tmp_path / 'jw'}", "n_devices=1",
        "trainer_impl=shard_map",
        *(() if "checkpoint_dir=" in "".join(extra)
          else (f"checkpoint_dir={tmp_path / 'jck'}",)))
    jcfg.health = JaxHealthConfig(**health)
    tcfg = cifar_app.default_config().with_overrides(
        *common, f"workdir={tmp_path / 'tw'}",
        *(() if "checkpoint_dir=" in "".join(extra)
          else (f"checkpoint_dir={tmp_path / 'tck'}",)))
    tcfg.health = HealthConfig(**health)
    jspec = jax_resolve_spec(jcfg, **SHAPES)
    tspec = resolve_spec(tcfg, **SHAPES)
    out = {}
    try:
        jax_train(jcfg, jspec, *jax_cifar_app.build_datasets(jcfg))
        out["jax"] = _records(tmp_path / "jw")
    except JaxHealthError as e:
        out["jax"] = e
    start = params_from_jax(CompiledNet.compile(tspec),
                            jax_params(JaxCompiledNet.compile(jspec)),
                            torch.device("cpu"))
    monkeypatch.setattr(ParallelTrainer, "init_state",
                        lambda self, seed=0: self.state_from_params(start))
    try:
        out["port"] = train(tcfg, tspec, *cifar_app.build_datasets(tcfg),
                            device="cpu")
        out["port"] = _records(tmp_path / "tw")
    except TrainingHealthError as e:
        out["port"] = e
    return out


def test_a_nan_round_rolls_back_as_in_the_jax_package(cifar_dir, tmp_path,
                                                      monkeypatch):
    res = _run_both(cifar_dir, tmp_path, monkeypatch, 6,
                    dict(inject_nan_rounds=(3,), min_history=2))
    want, got = res["jax"], res["port"]

    def events(recs):
        return [{k: v for k, v in r.items() if k not in ("t", "ts")}
                for r in recs if r.get("event") == "rollback"]

    (ev,) = events(got)
    assert events(want) == [ev]
    assert ev == {"step": 2, "event": "rollback", "reason": "nonfinite",
                  "target_step": 2, "rollbacks": 1, "retry": 1,
                  "lr_scale": 0.5}
    # one record per round pass, the poisoned one (null loss) included
    wl = [(r["step"], r["loss"]) for r in want if "loss" in r]
    gl = [(r["step"], r["loss"]) for r in got if "loss" in r]
    assert [s for s, _ in gl] == [s for s, _ in wl] == \
        [0, 1, 2, 3, 2, 3, 4, 5]
    assert gl[3][1] is None and wl[3][1] is None
    for (_, g), (_, w) in zip(gl, wl):
        if w is not None:
            assert abs(g - w) <= 1e-4 * abs(w), (gl, wl)
    assert [r.get("health") for r in got if "loss" in r] == \
        [r.get("health") for r in want if "loss" in r] == \
        [None] * 3 + ["nonfinite"] + [None] * 4
    # the final step: finite, not anomalous, the health state resumed
    flat, step, extra = ckpt.restore_flat(str(tmp_path / "tck"))
    _, jstep, jextra = jck.restore_flat(str(tmp_path / "jck"))
    assert step == jstep == 6
    assert all(np.isfinite(np.asarray(
        a.float() if isinstance(a, torch.Tensor) else a)).all()
        for a in flat.values())
    assert "anomalous" not in extra and "anomalous" not in jextra
    assert extra["health"] == jextra["health"] == \
        {"retry": 1, "lr_scale": 0.5, "rollbacks": 1}


class _Scale:
    """A transform that draws from the round-keyed generator it is given."""

    def convert_batch(self, batch, *, train=True, rng=None):
        return {"data": batch["data"] * rng.uniform(0.5, 2.0,
                                                    (1, 1, 1, 3)).astype(
            np.float32), "label": batch["label"]}


@pytest.mark.parametrize("retry,rnd,transform", [
    pytest.param(0, 3, False, id="0-3"), pytest.param(1, 3, False, id="1-3"),
    pytest.param(1, 2, False, id="1-2"), pytest.param(2, 5, False, id="2-5"),
    pytest.param(1, 3, True, id="1-3-transform")])
def test_the_retried_data_window_is_the_jax_packages(retry, rnd, transform):
    r = np.random.default_rng(0)
    arrays = {"data": r.standard_normal((40, 4, 4, 3)).astype(np.float32),
              "label": r.integers(0, 10, (40, 1)).astype(np.int32)}
    mine = RoundSampler(ArrayDataset(arrays), 2, 3, 2, seed=7)
    theirs = JaxRoundSampler(JaxArrayDataset(arrays), 2, 3, 2, seed=7)
    tf = _Scale() if transform else None
    for first_pass in (True, False):
        got = prepare_round_batches(
            mine, rnd, 2, 7, tf, torch.float32, retry,
            HealthConfig(inject_nan_rounds=(3,)), first_pass=first_pass)
        want = jax_prepare_round_batches(
            theirs, rnd, 2, 7, tf, jax_precision.compute_dtype(), retry,
            JaxHealthConfig(inject_nan_rounds=(3,)), first_pass=first_pass)
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))


@pytest.mark.parametrize("case", ["no checkpoint_dir", "budget spent",
                                  "no verified step"])
def test_refusals_raise_the_reference_message(cifar_dir, tmp_path,
                                              monkeypatch, case):
    health = dict(inject_nan_rounds=(1,), min_history=2)
    extra = ()
    if case == "no checkpoint_dir":
        extra = ("checkpoint_dir=null",)
    elif case == "budget spent":
        health["max_rollbacks"] = 0
    else:
        extra = ("checkpoint_every=10",)
    res = _run_both(cifar_dir, tmp_path, monkeypatch, 3, health, *extra)
    assert isinstance(res["jax"], JaxHealthError)
    assert isinstance(res["port"], TrainingHealthError)
    want = str(res["jax"]).replace(str(tmp_path / "jck"), "DIR")
    assert str(res["port"]).replace(str(tmp_path / "tck"), "DIR") == want
