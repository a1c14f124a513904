"""The port's training loop with checkpoints: resume, and the refusals.

cifar10_quick at local batch 4, τ = 2, on `cifar.write_synthetic` data.
- Resume is exact: 2 rounds, then a resume to round 4, equals 4 rounds
  without a break, tensor for tensor (`torch.equal`), in a world of one
  (f32 and bf16 momentum) and in two gloo ranks, where each rank's
  momentum row of the step goes out and comes back to that rank.
- The port resumes a step the JAX package wrote and runs on to round 4; it
  matches the JAX package's uninterrupted 4-round run at the tolerances of
  `tests/test_torch_trainer.py` (max |port - JAX| <= 1e-4 * max |JAX| +
  1e-6 per tensor; losses within rtol 1e-4: convolution sums run in
  another order), and the counter `it` exactly.
- The per-shard layout: "on" writes a one-shard step at one rank and
  resumes from it exactly; "auto" at two gloo ranks writes a shard file
  per rank, which restores each rank's own state.
"""
import dataclasses
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from sparknet_tpu.apps import cifar_app as jax_cifar_app
from sparknet_tpu.apps.train_loop import resolve_spec as jax_resolve_spec
from sparknet_tpu.apps.train_loop import train as jax_train
from sparknet_tpu.utils import checkpoint as jck

import torch_resume_worker
import torch_sharded_worker
from sparknet_tpu_torch import zoo
from sparknet_tpu_torch.apps import cifar_app
from sparknet_tpu_torch.apps.train_loop import resolve_spec, train
from sparknet_tpu_torch.data.cifar import write_synthetic
from sparknet_tpu_torch.model.net import CompiledNet
from sparknet_tpu_torch.parallel.mesh import DataGroup
from sparknet_tpu_torch.parallel.trainer import ParallelTrainer
from sparknet_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(2)
OVERRIDES = ("tau=2", "local_batch=4", "eval_every=0", "checkpoint_every=2")
SHAPES = dict(data=(4, 3, 32, 32), label=(4, 1))
SPAWN_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def cifar_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cifar")
    write_synthetic(str(d), n_per_file=100)
    return d


def _records(workdir):
    """Every train() call's records in `workdir`, in call order (each call
    writes its own timestamped file)."""
    paths = sorted(Path(workdir).glob("training_metrics_*.jsonl"),
                   key=lambda p: int(p.stem.rsplit("_", 1)[1]))
    return [json.loads(line) for p in paths
            for line in p.read_text().splitlines()]


def _port(cifar_dir, workdir, ckdir, rounds, *extra, velocity="float32"):
    cfg = cifar_app.default_config().with_overrides(
        *OVERRIDES, f"max_rounds={rounds}", f"data_dir={cifar_dir}",
        f"workdir={workdir}", f"checkpoint_dir={ckdir}", *extra)
    cfg.solver = dataclasses.replace(cfg.solver, velocity_dtype=velocity)
    return train(cfg, resolve_spec(cfg, **SHAPES),
                 *cifar_app.build_datasets(cfg), device="cpu")


@pytest.mark.parametrize("velocity", ["float32", "bfloat16"])
def test_resume_is_exact_in_a_world_of_one(cifar_dir, tmp_path, velocity):
    full = _port(cifar_dir, tmp_path / "wa", tmp_path / "a", 4,
                 "checkpoint_async=false", velocity=velocity)
    _port(cifar_dir, tmp_path / "wb", tmp_path / "b", 2, velocity=velocity)
    resumed = _port(cifar_dir, tmp_path / "wb", tmp_path / "b", 4,
                    velocity=velocity)
    assert resumed.it == full.it == 8
    assert torch.equal(resumed.flat_params, full.flat_params)
    assert resumed.flat_momentum.dtype == getattr(torch, velocity)
    assert torch.equal(resumed.flat_momentum, full.flat_momentum)
    for d in ("a", "b"):
        assert sorted(p.name for p in (tmp_path / d).iterdir()) == \
            ["step-2", "step-4"]
        assert all(ckpt.verify(str(p)) for p in (tmp_path / d).iterdir())
    ma, mb = (json.load(open(tmp_path / d / "step-4" / "meta.json"))
              for d in ("a", "b"))
    assert ma["digests"] == mb["digests"]
    # the resumed run logged rounds 2 and 3 only
    assert [r["step"] for r in _records(tmp_path / "wb") if "loss" in r] \
        == [0, 1, 2, 3]


def test_resume_is_exact_in_two_gloo_ranks(cifar_dir, tmp_path):
    ctx = mp.spawn(torch_resume_worker.run,
                   args=(2, str(tmp_path / "store"), str(cifar_dir),
                         str(tmp_path), OVERRIDES),
                   nprocs=2, join=False)
    deadline = SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        deadline -= 5
        if deadline <= 0:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the two ranks did not finish in "
                        f"{SPAWN_TIMEOUT_S} s")
    res = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    flat, step, extra = ckpt.restore_flat(str(tmp_path / "half_ck"), step=2)
    assert extra["n_devices"] == 2 and flat["it"].tolist() == [4, 4]
    for rank, got in enumerate(res):
        for k in ("it", "flat_params", "flat_momentum"):
            np.testing.assert_array_equal(got[f"resumed/{k}"],
                                          got[f"full/{k}"])
        # the step's momentum row `rank` is the state rank had after
        # round 2, and the resume gave it back to that rank
        tr = _tiny_trainer(rank)
        back = tr.state_from_checkpoint(flat, extra)
        np.testing.assert_array_equal(back.flat_momentum.numpy(),
                                      got["half/flat_momentum"])
    assert not np.array_equal(res[0]["half/flat_momentum"],
                              res[1]["half/flat_momentum"])
    np.testing.assert_array_equal(res[0]["full/flat_params"],
                                  res[1]["full/flat_params"])


def _tiny_trainer(rank, world=2):
    cfg = cifar_app.default_config()
    return ParallelTrainer(CompiledNet.compile(zoo.cifar10_quick(batch=4)),
                           cfg.solver,
                           DataGroup(rank, world, torch.device("cpu")),
                           tau=2)


def _jax(cifar_dir, workdir, ckdir, rounds):
    cfg = jax_cifar_app.default_config().with_overrides(
        *OVERRIDES, f"max_rounds={rounds}", f"data_dir={cifar_dir}",
        f"workdir={workdir}", f"checkpoint_dir={ckdir}", "n_devices=1",
        "trainer_impl=shard_map", "checkpoint_async=false")
    jax_train(cfg, jax_resolve_spec(cfg, **SHAPES),
              *jax_cifar_app.build_datasets(cfg))


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max() + 1e-6


def test_the_port_resumes_a_jax_step(cifar_dir, tmp_path):
    _jax(cifar_dir, tmp_path / "jw4", tmp_path / "j4", 4)
    _jax(cifar_dir, tmp_path / "jw2", tmp_path / "j2", 2)
    shutil.copytree(tmp_path / "j2", tmp_path / "p")
    _port(cifar_dir, tmp_path / "pw", tmp_path / "p", 4)
    want, _, _ = jck.restore_flat(str(tmp_path / "j4"), step=4)
    got, _, extra = ckpt.restore_flat(str(tmp_path / "p"), step=4)
    assert extra["n_devices"] == 1
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["it"], want["it"])
    for k in want:
        if k != "it":
            assert got[k].shape == want[k].shape and \
                got[k].dtype == want[k].dtype, k
            _close(got[k], want[k])
    wl = [r["loss"] for r in _records(tmp_path / "jw4") if "loss" in r]
    gl = [r["loss"] for r in _records(tmp_path / "pw") if "loss" in r]
    assert len(wl) == 4 and len(gl) == 2
    np.testing.assert_allclose(gl, wl[2:], rtol=1e-4)


def test_resume_at_max_rounds_runs_nothing_and_keeps_the_step(cifar_dir,
                                                               tmp_path):
    _port(cifar_dir, tmp_path / "w", tmp_path / "ck", 2)
    before = json.load(open(tmp_path / "ck" / "step-2" / "meta.json"))
    state = _port(cifar_dir, tmp_path / "w", tmp_path / "ck", 2)
    assert state.it == 4
    after = json.load(open(tmp_path / "ck" / "step-2" / "meta.json"))
    assert before == after  # not rewritten


def test_checkpoint_sharded_on_writes_a_one_shard_step(cifar_dir, tmp_path):
    """"on" is the per-shard layout at any world size: at one rank, one
    shard file under a manifest; a resume from it is exact."""
    full = _port(cifar_dir, tmp_path / "wa", tmp_path / "a", 4,
                 "checkpoint_sharded=on")
    _port(cifar_dir, tmp_path / "wb", tmp_path / "b", 2,
          "checkpoint_sharded=on")
    for step in ("step-2", "step-4"):
        meta = json.load(open(tmp_path / "a" / step / "meta.json"))
        assert meta["format"] == "sharded"
        assert [s["file"] for s in meta["shards"]] == \
            ["shard-00000-of-00001.npz"]
        assert len(meta["shards"][0]["digest"]) == 64
        assert ckpt.verify(str(tmp_path / "a" / step))
    resumed = _port(cifar_dir, tmp_path / "wb", tmp_path / "b", 4,
                    "checkpoint_sharded=on")
    assert torch.equal(resumed.flat_params, full.flat_params)
    assert torch.equal(resumed.flat_momentum, full.flat_momentum)


def test_sharded_auto_at_two_ranks_writes_per_shard_steps(cifar_dir,
                                                          tmp_path):
    """"auto" at more than one rank is the reference's per-shard layout:
    two gloo ranks each write their own shard file of every step."""
    out = str(tmp_path)
    ctx = mp.spawn(torch_sharded_worker.train_runs,
                   args=(2, str(tmp_path / "store"), str(cifar_dir), out,
                         "cpu", [{"name": "auto", "overrides": (
                             *OVERRIDES, "max_rounds=2",
                             f"checkpoint_dir={out}/ck")}]),
                   nprocs=2, join=False)
    deadline = SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        deadline -= 5
        if deadline <= 0:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the two ranks did not finish in "
                        f"{SPAWN_TIMEOUT_S} s")
    meta = json.load(open(tmp_path / "ck" / "step-2" / "meta.json"))
    assert meta["format"] == "sharded"
    assert [s["file"] for s in meta["shards"]] == \
        [f"shard-0000{r}-of-00002.npz" for r in range(2)]
    assert meta["extra"]["n_devices"] == 2
    flat, _, extra = ckpt.restore_flat(str(tmp_path / "ck"), step=2)
    assert flat["it"].tolist() == [4, 4]
    for rank in range(2):
        got = np.load(tmp_path / f"auto_rank{rank}.npz")
        back = _tiny_trainer(rank).state_from_checkpoint(flat, extra)
        np.testing.assert_array_equal(back.flat_params.numpy(),
                                      got["flat_params"])
        np.testing.assert_array_equal(back.flat_momentum.numpy(),
                                      got["flat_momentum"])


def test_bad_checkpoint_sharded_value_raises(cifar_dir, tmp_path):
    with pytest.raises(ValueError, match="'auto', 'on', or 'off'"):
        _port(cifar_dir, tmp_path / "w", tmp_path / "ck", 2,
              "checkpoint_sharded=sometimes")


def test_cifar_cli_trains_with_checkpoints_and_resumes(cifar_dir, tmp_path):
    ck = tmp_path / "ck"
    args = ["--device", "cpu", "--data-dir", str(cifar_dir),
            *OVERRIDES, f"workdir={tmp_path}", f"checkpoint_dir={ck}"]
    cifar_app.main(args + ["max_rounds=2"])
    assert ckpt.latest_step(str(ck)) == 2
    cifar_app.main(args + ["max_rounds=4", "resume=true"])
    assert ckpt.latest_step(str(ck)) == 4
    steps = [r["step"] for r in _records(tmp_path) if "loss" in r]
    assert steps == [0, 1, 2, 3]


def test_checkpoint_keys_pass_through_the_cli_overrides():
    cfg = cifar_app.default_config().with_overrides(
        "checkpoint_dir=/x/ck", "checkpoint_every=3",
        "checkpoint_async=false", "checkpoint_sharded=off", "resume=false")
    assert (cfg.checkpoint_dir, cfg.checkpoint_every, cfg.checkpoint_async,
            cfg.checkpoint_sharded, cfg.resume) == \
        ("/x/ck", 3, False, "off", False)
