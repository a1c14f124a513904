"""The port's round pipeline against the JAX package's and against its own
synchronous loop.

- `precision.cast_host_inputs` (the host cast of the round-prep thread):
  bfloat16 bits equal to the JAX package's `ml_dtypes` cast, edge values
  included; float32 and non-float inputs pass through.
- `ParallelTrainer.place_batches`: a placed round with the wrong dtype,
  shape or device raises (the placement contract of
  `tests/test_round_pipeline.py:237-262`); a placed round trains exactly
  as its host arrays do.
- `prepare_round_batches` equal to the JAX package's for rounds 0-2, with
  and without a retry, with and without a transform.
- `train()` with the levers on (the defaults: the round-prep thread,
  h2d_prefetch, donate_batches, collect_async) and off (all off and no
  prep thread: the synchronous loop), and with log_every 3: the same
  losses and test accuracies bit for bit, rounds in order; with
  h2d_prefetch the round's h2d phase is a pass-through after round 0, and
  with collect_async t_collect_ms is 0 (the counterparts of
  `tests/test_round_pipeline.py:440-459`, :531ff and
  `tests/test_apps.py:465`).
- A NaN at a round whose record is flushed by the collector one round
  later rolls back where the JAX loop does, with the same events.
- A failure on the round-prep thread or the collector re-raises in the
  caller of `train()`.
LeNet at local batch 4 on seeded data; the CPU, so no card is needed.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu import precision as jax_precision
from sparknet_tpu.apps.train_loop import \
    prepare_round_batches as jax_prepare_round_batches
from sparknet_tpu.data.dataset import ArrayDataset as JaxArrayDataset
from sparknet_tpu.data.dataset import RoundSampler as JaxRoundSampler
from sparknet_tpu.data.preprocess import \
    ImagePreprocessor as JaxImagePreprocessor
from sparknet_tpu.schema import Field as JaxField
from sparknet_tpu.schema import Schema as JaxSchema
from sparknet_tpu.utils.health import HealthConfig as JaxHealthConfig

from sparknet_tpu_torch import precision, zoo
from sparknet_tpu_torch.apps.train_loop import prepare_round_batches, train
from sparknet_tpu_torch.data.dataset import ArrayDataset, RoundSampler
from sparknet_tpu_torch.data.preprocess import ImagePreprocessor
from sparknet_tpu_torch.model.net import CompiledNet
from sparknet_tpu_torch.parallel.mesh import init_data_group
from sparknet_tpu_torch.parallel.trainer import ParallelTrainer, PlacedBatches
from sparknet_tpu_torch.schema import Field, Schema
from sparknet_tpu_torch.solver import SolverConfig
from sparknet_tpu_torch.utils.config import RunConfig
from sparknet_tpu_torch.utils.health import HealthConfig
from sparknet_tpu_torch.utils.logger import Logger
from test_torch_rollback import _run_both, cifar_dir  # noqa: F401

torch.set_num_threads(2)
TAU, LB = 2, 4


@pytest.fixture(autouse=True)
def _port_policy_isolated():
    yield
    precision.set_policy("float32")


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def test_cast_host_inputs_rounds_like_the_jax_package():
    r = np.random.default_rng(0)
    x = np.concatenate([
        r.standard_normal(4096).astype(np.float32) * 100,
        np.array([0.0, -0.0, 1e-40, -1e-40, 3.4e38, -3.4e38, np.inf,
                  -np.inf, 1.0039062, 1.0117188, 65504.0, 1e-8],
                 np.float32),
        # exact ties between two bfloat16 values
        (np.arange(64, dtype=np.uint32) << 16 | 0x8000).view(np.float32)])
    batch = {"data": x.reshape(-1, 2), "label": np.arange(5, dtype=np.int32)}
    got = precision.cast_host_inputs(batch, torch.bfloat16)
    want = jax_precision.cast_host_inputs(batch, jnp.bfloat16)
    assert got["data"].dtype == torch.bfloat16
    assert got["data"].device.type == "cpu"
    np.testing.assert_array_equal(_bits(got["data"]), _bits(want["data"]))
    assert got["label"] is batch["label"]
    assert precision.cast_host_inputs(batch, torch.float32) is batch
    nan = precision.cast_host_inputs({"x": np.full(3, np.nan, np.float32)},
                                     torch.bfloat16)["x"]
    assert torch.isnan(nan).all()
    # the policy is read on the calling thread when dt is not given
    with precision.policy("bfloat16"):
        assert precision.cast_host_inputs(batch)["data"].dtype == \
            torch.bfloat16


@pytest.fixture
def trainer(tmp_path):
    group = init_data_group("cpu", store_path=str(tmp_path / "store"),
                            rank=0, world_size=1)
    net = CompiledNet.compile(zoo.lenet(batch=LB))
    yield ParallelTrainer(net, SolverConfig(base_lr=0.01, momentum=0.9),
                          group, tau=TAU, donate_batches=True)
    group.close()


def _round(seed=0):
    r = np.random.default_rng(seed)
    return {"data": r.standard_normal((TAU, LB, 28, 28, 1)).astype(
                np.float32),
            "label": r.integers(0, 10, (TAU, LB, 1)).astype(np.int32)}


def test_a_placed_round_trains_as_its_host_arrays(trainer):
    runs = []
    for place in (False, True):
        state = trainer.init_state(0)
        losses = []
        for rnd in range(3):
            b = _round(rnd)
            if place:
                b = trainer.place_batches(b)
                assert isinstance(b, PlacedBatches)
                assert trainer.place_batches(b) is b  # a pass-through
            state, loss = trainer.train_round(state, b, (0, rnd))
            losses.append(float(loss))
        runs.append((losses, state.flat_params.detach().clone()))
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("what", ["dtype", "shape", "device", "missing"])
def test_a_wrongly_placed_round_fails_loudly(trainer, what):
    b = {k: torch.from_numpy(v) for k, v in _round().items()}
    match = {"dtype": "compute dtype", "shape": "leading dim",
             "device": "placed tensor is on", "missing": "missing"}[what]
    if what == "dtype":  # float32 placed under the bfloat16 policy
        with precision.policy("bfloat16"):
            with pytest.raises(ValueError, match=match):
                trainer.place_batches(b)
        return
    if what == "shape":
        b["data"] = b["data"][:1]
    elif what == "device":
        b["data"] = torch.empty(b["data"].shape, device="meta")
    else:
        del b["label"]
    with pytest.raises(ValueError, match=match):
        trainer.place_batches(b)


def _preprocessor(pkg, out_dtype):
    if pkg == "jax":
        schema = JaxSchema(JaxField("data", "float32", (5, 5, 3)),
                           JaxField("label", "int32", (1,)))
        cls = JaxImagePreprocessor
    else:
        schema = Schema(Field("data", "float32", (5, 5, 3)),
                        Field("label", "int32", (1,)))
        cls = ImagePreprocessor
    mean = np.random.default_rng(3).uniform(0, 255, (3, 8, 8)).astype(
        np.float32)
    return cls(schema, mean_image=mean, crop=5, out_dtype=out_dtype)


@pytest.mark.parametrize("transform", [None, "float32", "bfloat16"])
@pytest.mark.parametrize("retry", [0, 1])
def test_prepare_round_batches_is_the_jax_packages(transform, retry):
    r = np.random.default_rng(1)
    if transform is None:
        arrays = {"data": r.standard_normal((40, 4, 4, 3)).astype(
            np.float32), "label": r.integers(0, 10, (40, 1)).astype(np.int32)}
    else:
        arrays = {"data": r.integers(0, 256, (40, 3, 8, 8), dtype=np.uint8),
                  "label": r.integers(0, 10, (40, 1)).astype(np.int32)}
    mine = RoundSampler(ArrayDataset(arrays), 2, 3, TAU, seed=7)
    theirs = JaxRoundSampler(JaxArrayDataset(arrays), 2, 3, TAU, seed=7)
    for rnd in range(3):
        got = prepare_round_batches(
            mine, rnd, TAU, 7,
            transform and _preprocessor("port", transform),
            torch.bfloat16 if transform == "bfloat16" else torch.float32,
            retry, HealthConfig(inject_nan_rounds=(1,)))
        want = jax_prepare_round_batches(
            theirs, rnd, TAU, 7,
            transform and _preprocessor("jax", transform),
            jnp.bfloat16 if transform == "bfloat16" else jnp.float32,
            retry, JaxHealthConfig(inject_nan_rounds=(1,)))
        assert sorted(got) == sorted(want)
        for k in got:
            g, w = got[k], np.asarray(want[k])
            assert tuple(g.shape) == w.shape
            if isinstance(g, torch.Tensor) and rnd == 1:
                # the injected round: the port poisons its bfloat16
                # tensor, the JAX package leaves ml_dtypes arrays intact
                # (a known difference, ROADMAP C)
                assert torch.isnan(g).all() and not np.isnan(
                    w.astype(np.float32)).any()
            elif isinstance(g, torch.Tensor):  # bfloat16
                np.testing.assert_array_equal(_bits(g), _bits(w))
            else:
                np.testing.assert_array_equal(g, w)


def _dataset():
    r = np.random.default_rng(0)
    return ArrayDataset({"data": r.standard_normal(
        (64, 1, 28, 28)).astype(np.float32),
        "label": r.integers(0, 10, (64, 1)).astype(np.int32)})


def _train(tmp_path, tag, prefetch=True, logger=None, **levers):
    cfg = RunConfig(model="lenet", tau=TAU, local_batch=LB, max_rounds=5,
                    eval_every=2, eval_batch=16, seed=0,
                    workdir=str(tmp_path / tag),
                    solver=SolverConfig(base_lr=0.01, momentum=0.9),
                    **levers)
    jsonl = tmp_path / f"{tag}.jsonl"
    log = logger or Logger(echo=False, jsonl_path=str(jsonl))
    state = train(cfg, zoo.lenet(batch=LB), _dataset(), _dataset(),
                  logger=log, device="cpu", prefetch=prefetch)
    log.close()
    return [json.loads(l) for l in open(jsonl)], state


SYNC = dict(h2d_prefetch=False, donate_batches=False, collect_async=False)


def test_the_levers_leave_the_trajectory_bit_for_bit(tmp_path,
                                                    monkeypatch):
    placed_on = []
    orig = ParallelTrainer.place_batches

    def place(self, batches, compute_dt=None):
        import threading
        placed_on.append((threading.current_thread().name,
                          isinstance(batches, PlacedBatches)))
        return orig(self, batches, compute_dt)

    monkeypatch.setattr(ParallelTrainer, "place_batches", place)
    on, s_on = _train(tmp_path, "on")  # the defaults: every lever on
    # round 0 is prepared and placed on the main thread, every later
    # round on the round-prep thread; train_round passes each through
    assert sorted(placed_on) == sorted(
        [("MainThread", False)] + [("round-prep_0", False)] * 4
        + [("MainThread", True)] * 5), placed_on
    monkeypatch.undo()
    off, s_off = _train(tmp_path, "off", prefetch=False, **SYNC)
    every3, s_k = _train(tmp_path, "k3", log_every=3)

    def semantic(rows):
        return [{k: r[k] for k in ("step", "loss", "test_accuracy",
                                   "grad_norm") if k in r} for r in rows]

    assert semantic(on) == semantic(off) == semantic(every3)
    assert [r["step"] for r in on if "loss" in r] == [0, 1, 2, 3, 4]
    assert torch.equal(s_on.flat_params, s_off.flat_params)
    assert torch.equal(s_on.flat_params, s_k.flat_params)
    rounds_on = [r for r in on if "loss" in r]
    # placed on the prep thread: the round's h2d phase only passes through
    assert all(r["t_h2d_ms"] < 50.0 for r in rounds_on[1:]), rounds_on
    assert all(r["t_collect_ms"] == 0.0 and "t_collect_bg_ms" in r
               for r in rounds_on)
    assert all("t_collect_bg_ms" not in r for r in off if "loss" in r)
    for r in rounds_on:
        for k in ("t_data_ms", "t_round_ms", "t_prep_ms", "t_log_ms",
                  "t_ckpt_fetch_ms", "h2d_bytes", "h2d_async_bytes"):
            assert k in r and r[k] >= 0, (k, r)
    plain, _ = _train(tmp_path, "quiet", telemetry=False)
    assert semantic(plain) == semantic(on)
    assert not any(k.startswith("t_") and k != "t"
                   for r in plain for k in r)


def test_a_nan_flushed_a_round_later_rolls_back_as_in_the_jax_package(
        cifar_dir, tmp_path, monkeypatch):  # noqa: F811
    # round 2 is no checkpoint round: its record is flushed on the
    # collector while round 3 runs, and round 3's checkpoint drains it
    res = _run_both(cifar_dir, tmp_path, monkeypatch, 6,
                    dict(inject_nan_rounds=(2,), min_history=2))
    want, got = res["jax"], res["port"]

    def events(recs):
        return [{k: v for k, v in r.items() if k not in ("t", "ts")}
                for r in recs if r.get("event") == "rollback"]

    assert events(got) == events(want) == [
        {"step": 2, "event": "rollback", "reason": "nonfinite",
         "target_step": 2, "rollbacks": 1, "retry": 1, "lr_scale": 0.5}]
    steps = [[r["step"] for r in recs if "loss" in r] for recs in (got, want)]
    assert steps[0] == steps[1] == [0, 1, 2, 3, 2, 3, 4, 5]
    assert [r.get("health") for r in got if "loss" in r] == \
        [r.get("health") for r in want if "loss" in r]


class _Boom(RuntimeError):
    pass


def test_a_prep_thread_failure_reraises_in_the_caller(tmp_path):
    import threading

    class Transform:
        """Fails on the round-prep thread (round 0 is prepared inline)."""

        def convert_batch(self, batch, *, train=True, rng=None):
            if threading.current_thread() is not threading.main_thread():
                raise _Boom("round prep failed")
            return batch

    cfg = RunConfig(model="lenet", tau=TAU, local_batch=LB, max_rounds=3,
                    eval_every=0, workdir=str(tmp_path))
    ds = _dataset()
    ds = ArrayDataset({"data": np.transpose(ds.arrays["data"], (0, 2, 3, 1)),
                       "label": ds.arrays["label"]})
    with pytest.raises(_Boom, match="round prep failed"):
        train(cfg, zoo.lenet(batch=LB), ds, None, batch_transform=Transform(),
              logger=Logger(echo=False), device="cpu")


def test_a_collector_failure_reraises_in_the_caller(tmp_path):
    class Failing(Logger):
        def metrics(self, step, **kv):
            if "loss" in kv and step == 1:
                raise _Boom("collector failed")

    with pytest.raises(_Boom, match="collector failed"):
        _train(tmp_path, "boom", logger=Failing(echo=False))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("donate", [True, False])
def test_on_the_card_rounds_placed_ahead_train_as_host_arrays(tmp_path,
                                                              donate):
    """The loop's one-deep schedule on the card: round R+1 is placed on
    another thread (pinned staging, the copy stream, two donated slots or
    fresh buffers) while round R runs; losses and params equal those of
    the same rounds placed inline, bit for bit."""
    from concurrent.futures import ThreadPoolExecutor
    _need_card()
    torch.backends.cudnn.deterministic = True
    group = init_data_group("cuda", store_path=str(tmp_path / "store"),
                            rank=0, world_size=1)
    try:
        net = CompiledNet.compile(zoo.lenet(batch=LB))
        runs = []
        for ahead in (False, True):
            tr = ParallelTrainer(net, SolverConfig(base_lr=0.01,
                                                   momentum=0.9), group,
                                 tau=TAU, donate_batches=donate)
            state = tr.init_state(0)
            losses = []
            with ThreadPoolExecutor(1) as pool:
                nxt = pool.submit(tr.place_batches, _round(0),
                                  torch.float32) if ahead else None
                for rnd in range(6):
                    b = nxt.result() if ahead else _round(rnd)
                    if ahead and rnd + 1 < 6:
                        nxt = pool.submit(tr.place_batches, _round(rnd + 1),
                                          torch.float32)
                    state, loss = tr.train_round(state, b, (0, rnd))
                    if ahead:
                        assert b.ready is not None and b.nbytes > 0
                        assert (b.slot is not None) == donate
                    losses.append(loss)
            runs.append(([float(x) for x in losses],
                         state.flat_params.detach().clone()))
        assert runs[0][0] == runs[1][0]
        assert torch.equal(runs[0][1], runs[1][1])
    finally:
        group.close()
        torch.backends.cudnn.deterministic = False


@pytest.mark.gpu
def test_on_the_card_a_wrongly_placed_round_fails_loudly(tmp_path):
    _need_card()
    group = init_data_group("cuda", store_path=str(tmp_path / "store"),
                            rank=0, world_size=1)
    try:
        tr = ParallelTrainer(CompiledNet.compile(zoo.lenet(batch=LB)),
                             SolverConfig(), group, tau=TAU)
        b = {k: torch.from_numpy(v).cuda() for k, v in _round().items()}
        with precision.policy("bfloat16"):
            with pytest.raises(ValueError, match="compute dtype"):
                tr.place_batches(b)
        b["data"] = b["data"][:1]
        with pytest.raises(ValueError, match="leading dim"):
            tr.place_batches(b)
    finally:
        group.close()


@pytest.mark.gpu
def test_on_the_card_the_levers_leave_the_trajectory_bit_for_bit(tmp_path):
    _need_card()
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for tag, prefetch, levers in (("on", True, {}),
                                      ("off", False, SYNC)):
            cfg = RunConfig(model="lenet", tau=TAU, local_batch=LB,
                            max_rounds=5, eval_every=2, eval_batch=16,
                            seed=0, workdir=str(tmp_path / tag),
                            solver=SolverConfig(base_lr=0.01, momentum=0.9),
                            **levers)
            jsonl = tmp_path / f"{tag}.jsonl"
            log = Logger(echo=False, jsonl_path=str(jsonl))
            state = train(cfg, zoo.lenet(batch=LB), _dataset(), _dataset(),
                          logger=log, prefetch=prefetch)
            log.close()
            rows = [json.loads(l) for l in open(jsonl)]
            runs.append((rows, state.flat_params.detach().clone()))
        (on, p_on), (off, p_off) = runs
        assert [(r["step"], r.get("loss"), r.get("test_accuracy"))
                for r in on] == [(r["step"], r.get("loss"),
                                  r.get("test_accuracy")) for r in off]
        assert torch.equal(p_on, p_off)
        rounds = [r for r in on if "loss" in r]
        assert all(r["t_h2d_ms"] < 50.0 for r in rounds[1:]), rounds
        assert all(r["h2d_bytes"] == r["h2d_async_bytes"]
                   == TAU * LB * (28 * 28 * 4 + 4) for r in rounds)
    finally:
        torch.backends.cudnn.deterministic = False
