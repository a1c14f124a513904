"""The port's training entry points: the CIFAR app's command line, `train()`
against the JAX package's `train()`, the settings the port refuses, and
the ones it took up since it refused them (the sharded trainer's since
ROADMAP A11).

`cifar.write_synthetic` makes the CIFAR-10 binary files both apps read.
The two `train()`s get the same data and the same config (n_devices = 1
on the JAX side, a world of one on the port's) and log their per-round
losses, held within rtol 1e-4 (convolution sums run in another order),
and their test accuracies, held exactly.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from sparknet_tpu.apps import cifar_app as jax_cifar_app
from sparknet_tpu.apps.train_loop import resolve_spec as jax_resolve_spec
from sparknet_tpu.apps.train_loop import train as jax_train
from sparknet_tpu.model.net import CompiledNet as JaxCompiledNet
from sparknet_tpu.utils.config import RunConfig as JaxRunConfig

from sparknet_tpu_torch import zoo
from sparknet_tpu_torch.apps import cifar_app
from sparknet_tpu_torch.apps.train_loop import resolve_spec, train
from sparknet_tpu_torch.data.cifar import write_synthetic
from sparknet_tpu_torch.data.dataset import ArrayDataset
from sparknet_tpu_torch.model.net import CompiledNet, params_from_jax
from sparknet_tpu_torch.parallel.trainer import ParallelTrainer
from sparknet_tpu_torch.utils import checkpoint as ckpt
from sparknet_tpu_torch.utils.config import ElasticConfig, RunConfig
from sparknet_tpu_torch.utils.logger import Logger
from test_torch_train import jax_params

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
OVERRIDES = ("max_rounds=3", "tau=2", "local_batch=10", "eval_every=2",
             "eval_batch=100")


def _records(workdir):
    (path,) = Path(workdir).glob("training_metrics_*.jsonl")
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.fixture(scope="module")
def cifar_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cifar")
    write_synthetic(str(d), n_per_file=100)
    return d


def test_cifar_app_cli_trains_on_the_cpu(cifar_dir, tmp_path):
    env = dict(os.environ, SPARKNET_TPU_HOME=str(tmp_path))
    r = subprocess.run(
        [sys.executable, "-m", "sparknet_tpu_torch.apps.cifar_app",
         "--device", "cpu", "--data-dir", str(cifar_dir), "max_rounds=2",
         "tau=2", "local_batch=10", "eval_every=1", "eval_batch=50",
         f"workdir={tmp_path}"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    recs = _records(tmp_path)
    losses = [x for x in recs if "loss" in x]
    assert [x["step"] for x in losses] == [0, 1]
    assert all(0 < x["loss"] < 10 and x["nonfinite"] == 0 for x in losses)
    assert len([x for x in recs if "test_accuracy" in x]) == 2
    assert "accepted, not yet ported" in r.stderr


def test_train_matches_the_jax_train(cifar_dir, tmp_path, monkeypatch):
    jcfg = jax_cifar_app.default_config().with_overrides(
        *OVERRIDES, f"data_dir={cifar_dir}", f"workdir={tmp_path / 'jax'}",
        "n_devices=1", "trainer_impl=shard_map")
    tcfg = cifar_app.default_config().with_overrides(
        *OVERRIDES, f"data_dir={cifar_dir}",
        f"workdir={tmp_path / 'torch'}")
    shapes = dict(data=(10, 3, 32, 32), label=(10, 1))
    jspec = jax_resolve_spec(jcfg, **shapes)
    jax_train(jcfg, jspec, *jax_cifar_app.build_datasets(jcfg))
    # the same weights: the port's train() draws its own init (torch's
    # generator), so it starts from the JAX package's instead
    tspec = resolve_spec(tcfg, **shapes)
    start = params_from_jax(CompiledNet.compile(tspec),
                            jax_params(JaxCompiledNet.compile(jspec)),
                            torch.device("cpu"))
    monkeypatch.setattr(ParallelTrainer, "init_state",
                        lambda self, seed=0: self.state_from_params(start))
    train(tcfg, tspec, *cifar_app.build_datasets(tcfg), device="cpu")
    want, got = _records(tmp_path / "jax"), _records(tmp_path / "torch")
    wl = [x["loss"] for x in want if "loss" in x]
    gl = [x["loss"] for x in got if "loss" in x]
    assert len(gl) == len(wl) == 3
    assert all(abs(g - w) <= 1e-4 * abs(w) for g, w in zip(gl, wl)), (gl, wl)
    assert [x["test_accuracy"] for x in got if "test_accuracy" in x] == \
        [x["test_accuracy"] for x in want if "test_accuracy" in x]


#: settings the port refused until the sharded trainer was ported: each
#: now trains (ROADMAP A11), and a ZeRO state sharding without the named
#: trainer raises ValueError, as the JAX loop's `resolve_trainer_impl` does
PORTED = {
    "trainer_impl": dict(trainer_impl="named"),
    "state_sharding": dict(state_sharding="momentum"),
}


@pytest.mark.parametrize("what", sorted(PORTED))
def test_unported_settings_that_change_results_raise(what, tmp_path):
    """Kept under its name from when these settings were refused: they
    train now (ROADMAP A11), and a ZeRO state sharding without the named
    trainer raises ValueError, as the JAX loop does."""
    import numpy as np
    r = np.random.default_rng(0)
    ds = ArrayDataset({
        "data": r.standard_normal((8, 3, 32, 32)).astype(np.float32),
        "label": r.integers(0, 10, (8, 1)).astype(np.int32)})
    kw = dict(workdir=str(tmp_path), tau=1, local_batch=2, max_rounds=2,
              eval_every=0, **PORTED[what])
    if kw.get("trainer_impl") != "named":
        with pytest.raises(ValueError, match="trainer_impl='named'"):
            train(RunConfig(**kw), zoo.cifar10_quick(batch=2), ds,
                  device="cpu", logger=Logger(echo=False))
        assert not torch.distributed.is_initialized()
        kw["trainer_impl"] = "named"
    state = train(RunConfig(**kw), zoo.cifar10_quick(batch=2), ds,
                  device="cpu", logger=Logger(echo=False))
    assert state.it == 2
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("what", ["elastic", "heartbeat_path",
                                  "checkpoint_sharded=on"])
def test_settings_ported_since_the_refusals_act(what, tmp_path):
    """`elastic`, `heartbeat_path` and `checkpoint_sharded="on"` were
    refused until the port had membership, heartbeats and the per-shard
    layout: now a run with them trains and writes them."""
    kw = dict(heartbeat_path=str(tmp_path / "hb.json"))
    if what == "elastic":
        kw = dict(elastic=ElasticConfig(enabled=True, poll_interval_s=0.0),
                  pod_dir=str(tmp_path / "pod"),
                  checkpoint_dir=str(tmp_path / "ck"))
    if what == "checkpoint_sharded=on":
        kw.update(checkpoint_dir=str(tmp_path / "ck"),
                  checkpoint_sharded="on")
    cfg = RunConfig(workdir=str(tmp_path), max_rounds=2, tau=1,
                    local_batch=2, eval_every=0, **kw)
    ds = ArrayDataset({"data": torch.zeros(8, 3, 32, 32).numpy(),
                       "label": torch.zeros(8, 1, dtype=torch.int32).numpy()})
    log = Logger(str(tmp_path / "l.txt"), echo=False)
    train(cfg, zoo.cifar10_quick(batch=2), ds, device="cpu", logger=log)
    log.close()
    assert not torch.distributed.is_initialized()
    path = (str(tmp_path / "pod" / "worker-000.heartbeat.json")
            if what == "elastic" else str(tmp_path / "hb.json"))
    beat = json.load(open(path))
    assert (beat["role"], beat["status"], beat["step"]) == \
        ("train", "done", 2)
    if what == "elastic":
        assert beat["membership_epoch"] == 0 and beat["n_members"] == 1
        assert "elastic membership: ['0']" in open(tmp_path / "l.txt").read()
    if what == "checkpoint_sharded=on":
        step = tmp_path / "ck" / "step-2"
        meta = json.load(open(step / "meta.json"))
        assert meta["format"] == "sharded"
        assert [s["file"] for s in meta["shards"]] == \
            ["shard-00000-of-00001.npz"]
        assert ckpt.verify(str(step))


@pytest.mark.parametrize("knob,value", [("lrn_impl", "fused"),
                                        ("lrn_impl", "window"),
                                        ("pool_impl", "xla"),
                                        ("pool_impl", "pallas")])
def test_jax_only_kernel_routes_raise_naming_the_ports(knob, value):
    with pytest.raises(ValueError, match=r"\('auto', 'plain'\)"):
        RunConfig(**{knob: value})
    with pytest.raises(ValueError, match="auto"):
        RunConfig().with_overrides(f"{knob}={value}")
    assert getattr(JaxRunConfig(**{knob: value}), knob) == value


def test_prototxt_models_resolve_like_the_jax_packages(tmp_path):
    from test_prototxt import ADULT
    path = tmp_path / "adult.prototxt"
    path.write_text(ADULT)
    shapes = dict(C0=(8, 1))
    got = resolve_spec(RunConfig(model=str(path)), **shapes)
    want = jax_resolve_spec(JaxRunConfig(model=str(path)), **shapes)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.inputs[0].shape == (8, 1)
