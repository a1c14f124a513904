"""The port's streaming ingest (`sparknet_tpu_torch/data/streaming.py`) and
the loop on a streaming source, against the JAX package's, on the CPU.

Inputs: JPEG tar shards written by `write_synthetic_shards` (four shards
of six 40×40 images, decoded at 36×36; both packages read the same
files), seeded mean images. Every comparison of data is bit for bit.
- `StreamingRoundSource` and `ParallelStreamingSource` (four readers)
  rounds, cursors, `cursor_at` and the epoch wrap equal the JAX package's
  (the counterparts of `tests/test_data.py:268-359,469-480,593,812`);
  `seek` / `seek_rows` from a round's cursor give the next rounds of an
  unbroken source; a reader-count change and a seek after the start are
  refused as in the JAX package; a decode thread's failure re-raises in
  the consumer.
- `streaming_sum_count` equals the JAX package's bit for bit (the same
  float64 sums in the same order) and the cached mean within 1 float32
  ulp (a sum and a division against `compute_mean_image`'s float64 mean).
- The loop on a streaming source, with the tiny LRN + MAX-pool net of
  `test_torch_imagenet.py` (crop 32, batch 4, τ = 2, float32), from the
  JAX package's init: checkpoints every 2 rounds carry the stream cursor
  of the round they follow (not the prefetched one), in the JAX
  package's format and equal to its rows; resume is exact, with the
  round-prep thread and without it; each package resumes the other's
  streamed step; a NaN at round 3 rolls back as in the JAX loop. Losses
  within rtol 1e-4 and params within 1e-4 × max |JAX| + 1e-6 (the
  tolerances of `test_torch_resume.py`: convolution sums run in another
  order).
"""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from sparknet_tpu.apps import imagenet_app as jax_app
from sparknet_tpu.apps.train_loop import resolve_spec as jax_resolve_spec
from sparknet_tpu.apps.train_loop import train as jax_train
from sparknet_tpu.data import imagenet as jax_imagenet
from sparknet_tpu.data import streaming as jax_streaming
from sparknet_tpu.data.preprocess import ImagePreprocessor as JaxPre
from sparknet_tpu.model.net import CompiledNet as JaxCompiledNet
from sparknet_tpu.schema import Field as JaxField
from sparknet_tpu.schema import Schema as JaxSchema
from sparknet_tpu.utils import checkpoint as jck
from sparknet_tpu.utils.health import HealthConfig as JaxHealthConfig

from sparknet_tpu_torch.apps import imagenet_app
from sparknet_tpu_torch.apps.train_loop import resolve_spec, train
from sparknet_tpu_torch.data import imagenet, streaming
from sparknet_tpu_torch.data.preprocess import (ImagePreprocessor,
                                                compute_mean_image)
from sparknet_tpu_torch.model.net import CompiledNet, params_from_jax
from sparknet_tpu_torch.parallel.trainer import ParallelTrainer
from sparknet_tpu_torch.schema import Field, Schema
from sparknet_tpu_torch.utils import checkpoint as ckpt
from sparknet_tpu_torch.utils.health import HealthConfig
from test_torch_imagenet import NET
from test_torch_train import jax_params

torch.set_num_threads(2)
SIZE = 36  # decoded height and width; the net crops 32
PKGS = {"port": (imagenet, streaming), "jax": (jax_imagenet, jax_streaming)}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream")
    imagenet.write_synthetic_shards(str(d), n_shards=4, per_shard=6,
                                    n_classes=4, size=40, seed=3)
    (d / "tiny.prototxt").write_text(NET)
    return d


def _shards(corpus, pkg):
    mod = PKGS[pkg][0]
    return (mod.list_shards(str(corpus), "train."),
            mod.load_label_map(str(corpus / "train.txt")))


def _single(corpus, pkg, workers, lb, tau, **kw):
    mod, smod = PKGS[pkg]
    shards, labels = _shards(corpus, pkg)
    return smod.StreamingRoundSource(
        mod.ShardedTarLoader(shards, labels, SIZE, SIZE), workers, lb, tau,
        **kw)


def _parallel(corpus, pkg, workers, lb, tau, n_sources=4):
    shards, labels = _shards(corpus, pkg)
    return PKGS[pkg][1].make_parallel_source(
        shards, labels, workers, lb, tau, n_sources, height=SIZE,
        width=SIZE)


def _rows(cur):
    """A cursor_at value as [[shard, entry, epochs], ...]."""
    cur = cur if isinstance(cur, list) else [cur]
    return [[int(s), int(e), int(ep)] for (s, e), ep in cur]


def _pull(src, n, start=0):
    out = []
    for r in range(start, start + n):
        b = src.next_round(round_index=r)
        out.append(({k: v.copy() for k, v in b.items()},
                    _rows(src.cursor_at(r))))
    return out


def _same_rounds(got, want):
    assert len(got) == len(want)
    for (gb, gc), (wb, wc) in zip(got, want):
        assert gc == wc
        assert sorted(gb) == sorted(wb)
        for k in gb:
            assert gb[k].dtype == wb[k].dtype and gb[k].shape == wb[k].shape
            np.testing.assert_array_equal(gb[k], wb[k])


MAKERS = {"single": _single, "parallel": _parallel}
#: (workers, local batch, tau): 8 and 12 examples a round over 24 images,
#: so 5 rounds wrap the epoch at least once
LAYOUTS = [(1, 4, 2), (2, 3, 2)]


@pytest.mark.parametrize("kind", sorted(MAKERS))
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: "w%db%dt%d" % l)
def test_rounds_and_cursors_are_the_jax_packages(corpus, kind, layout):
    make = MAKERS[kind]
    with make(corpus, "port", *layout) as mine, \
            make(corpus, "jax", *layout) as theirs:
        got, want = _pull(mine, 5), _pull(theirs, 5)
    _same_rounds(got, want)
    w, b, t = layout
    assert got[0][0]["data"].shape == (t, w * b, 3, SIZE, SIZE)
    assert got[0][0]["label"].shape == (t, w * b, 1)
    # the stream wrapped: some reader finished a pass over its shards
    assert max(ep for _, c in got for *_, ep in c) >= 1


@pytest.mark.parametrize("kind", sorted(MAKERS))
def test_seek_from_a_rounds_cursor_continues_the_stream(corpus, kind):
    make = MAKERS[kind]
    for pkg in PKGS:
        with make(corpus, pkg, 1, 4, 2) as unbroken:
            rounds = _pull(unbroken, 5)
        for k in (1, 3):
            with make(corpus, pkg, 1, 4, 2) as resumed:
                assert resumed.seek_rows(rounds[k - 1][1])
                _same_rounds(_pull(resumed, 5 - k, start=k), rounds[k:])


@pytest.mark.parametrize("kind", sorted(MAKERS))
def test_seek_refusals_are_the_jax_packages(corpus, kind):
    make = MAKERS[kind]
    for pkg in PKGS:
        with make(corpus, pkg, 1, 4, 2) as src:
            n = 1 if kind == "single" else 4
            assert src.seek_rows([[0, 0, 0]] * (n + 1)) is False
            src.next_round(round_index=0)
            with pytest.raises(RuntimeError, match="after streaming started"):
                src.seek_rows([[0, 0, 0]] * n)


@pytest.mark.parametrize("kind", sorted(MAKERS))
@pytest.mark.parametrize("fault", ["truncated tar", "no labeled image"])
def test_a_decode_threads_failure_reraises_in_the_consumer(
        corpus, tmp_path, kind, fault):
    bad = tmp_path / "bad"
    shutil.copytree(corpus, bad)
    if fault == "truncated tar":
        tar = bad / "train.0001.tar"
        tar.write_bytes(tar.read_bytes()[:2560])  # mid-member, no terminator
    else:
        (bad / "train.txt").write_text("nothing.JPEG 0\n")
    causes = []
    for pkg in PKGS:
        with MAKERS[kind](bad, pkg, 1, 4, 2) as src:
            with pytest.raises(RuntimeError,
                               match="streaming decode thread failed") as e:
                for r in range(6):
                    src.next_round(round_index=r)
        causes.append((type(e.value.__cause__).__name__,
                       str(e.value.__cause__).split(" ")[:3]))
    assert causes[0] == causes[1]
    assert causes[0][0] == ("TruncatedTarError" if fault == "truncated tar"
                            else "ValueError")


@pytest.mark.parametrize("workers", [1, 3])
def test_streaming_sum_count_is_the_jax_packages(corpus, workers):
    sums = {}
    for pkg in PKGS:
        mod, smod = PKGS[pkg]
        loader = mod.ShardedTarLoader(*_shards(corpus, pkg), SIZE, SIZE)
        sums[pkg] = smod.streaming_sum_count(loader, workers=workers)
    (s, n), (js, jn) = sums["port"], sums["jax"]
    assert n == jn == 24 and s.dtype == np.float64
    np.testing.assert_array_equal(s, js)
    images, _ = imagenet.ShardedTarLoader(*_shards(corpus, "port"), SIZE,
                                          SIZE).load_all()
    np.testing.assert_array_max_ulp((s / n).astype(np.float32),
                                    compute_mean_image(images), maxulp=1)


# -- the loop on a streaming source ------------------------------------------

OVERRIDES = ("crop=32", "local_batch=4", "tau=2", "eval_every=0",
             "n_classes=4", "precision=float32", "checkpoint_every=2",
             "checkpoint_async=false", "seed=0",
             'solver={"base_lr": 0.001, "momentum": 0.9, '
             '"lr_policy": "fixed"}')
SHAPES = dict(data=(4, 3, 32, 32), label=(4, 1))
MEAN = np.random.default_rng(7).uniform(0, 255, (3, SIZE, SIZE)).astype(
    np.float32)


def _pre(pkg):
    if pkg == "port":
        return ImagePreprocessor(
            Schema(Field("data", "float32", (32, 32, 3)),
                   Field("label", "int32", (1,))),
            mean_image=MEAN, crop=32, seed=0, out_dtype="float32")
    return JaxPre(JaxSchema(JaxField("data", "float32", (32, 32, 3)),
                            JaxField("label", "int32", (1,))),
                  mean_image=MEAN, crop=32, seed=0, out_dtype="float32")


def _records(workdir):
    paths = sorted(Path(workdir).glob("training_metrics_*.jsonl"),
                   key=lambda p: int(p.stem.rsplit("_", 1)[1]))
    return [json.loads(line) for p in paths
            for line in p.read_text().splitlines()]


def _losses(workdir):
    return [(r["step"], r["loss"]) for r in _records(workdir)
            if "loss" in r]


def _start(corpus):
    model = f"model={corpus / 'tiny.prototxt'}"
    jspec = jax_resolve_spec(jax_app.default_config().with_overrides(
        *OVERRIDES, model), **SHAPES)
    tspec = resolve_spec(imagenet_app.default_config().with_overrides(
        *OVERRIDES, model), **SHAPES)
    return params_from_jax(CompiledNet.compile(tspec),
                           jax_params(JaxCompiledNet.compile(jspec)),
                           torch.device("cpu"))


def _run(pkg, corpus, workdir, ckdir, rounds, health=None, prefetch=True,
         kind="single"):
    """One train() of either package on its own streaming source over the
    corpus; returns the final state (the port's) or None."""
    mods = (imagenet_app, resolve_spec) if pkg == "port" else \
        (jax_app, jax_resolve_spec)
    cfg = mods[0].default_config().with_overrides(
        *OVERRIDES, f"model={corpus / 'tiny.prototxt'}",
        f"max_rounds={rounds}", f"workdir={workdir}",
        f"checkpoint_dir={ckdir}",
        *(("n_devices=1", "trainer_impl=shard_map") if pkg == "jax" else ()))
    if health:
        cfg.health = (HealthConfig if pkg == "port" else
                      JaxHealthConfig)(**health)
    spec = mods[1](cfg, **SHAPES)
    with MAKERS[kind](corpus, pkg, 1, 4, 2) as src:
        if pkg == "jax":
            jax_train(cfg, spec, src, None, batch_transform=_pre(pkg))
            return None
        return train(cfg, spec, src, None, batch_transform=_pre(pkg),
                     device="cpu", prefetch=prefetch)


@pytest.fixture
def port_init(corpus, monkeypatch):
    start = _start(corpus)
    monkeypatch.setattr(ParallelTrainer, "init_state",
                        lambda self, seed=0: self.state_from_params(start))


@pytest.fixture(scope="module")
def jax_run(corpus, tmp_path_factory):
    """The JAX package's uninterrupted 6-round streamed run."""
    d = tmp_path_factory.mktemp("jax_stream")
    _run("jax", corpus, d / "w", d / "ck", 6)
    return d


def _close_params(flat, want_flat):
    for k in want_flat:
        if k == "it":
            np.testing.assert_array_equal(flat[k], want_flat[k])
            continue
        g, w = np.asarray(flat[k], np.float64), np.asarray(want_flat[k],
                                                           np.float64)
        assert g.shape == w.shape, k
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max() + 1e-6, k


def _held_losses(got, want):
    assert [s for s, _ in got] == [s for s, _ in want]
    np.testing.assert_allclose([l for _, l in got], [l for _, l in want],
                               rtol=1e-4)


@pytest.mark.parametrize("prefetch", [True, False])
def test_streamed_checkpoints_carry_the_jax_packages_cursor(
        corpus, tmp_path, port_init, jax_run, prefetch):
    _run("port", corpus, tmp_path / "w", tmp_path / "ck", 6,
         prefetch=prefetch)
    _held_losses(_losses(tmp_path / "w"), _losses(jax_run / "w"))
    # each step's cursor is the one after the round it follows: a fresh
    # source pulled that many rounds
    with _single(corpus, "port", 1, 4, 2) as fresh:
        after = _pull(fresh, 6)
    for step in (2, 4, 6):
        _, got, extra = ckpt.restore_flat(str(tmp_path / "ck"), step=step)
        _, want, jextra = jck.restore_flat(str(jax_run / "ck"), step=step)
        assert got == want == step
        assert extra["stream"] == jextra["stream"] == [after[step - 1][1]]
    flat, _, _ = ckpt.restore_flat(str(tmp_path / "ck"))
    jflat, _, _ = jck.restore_flat(str(jax_run / "ck"))
    _close_params(flat, jflat)


@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("kind", sorted(MAKERS))
def test_a_streamed_resume_is_exact(corpus, tmp_path, prefetch, kind):
    full = _run("port", corpus, tmp_path / "wa", tmp_path / "a", 6,
                prefetch=prefetch, kind=kind)
    _run("port", corpus, tmp_path / "wb", tmp_path / "b", 4,
         prefetch=prefetch, kind=kind)
    resumed = _run("port", corpus, tmp_path / "wb", tmp_path / "b", 6,
                   prefetch=prefetch, kind=kind)
    assert resumed.it == full.it == 12
    assert torch.equal(resumed.flat_params, full.flat_params)
    assert torch.equal(resumed.flat_momentum, full.flat_momentum)
    assert _losses(tmp_path / "wb")[4:] == _losses(tmp_path / "wa")[4:]
    a = ckpt.restore_flat(str(tmp_path / "a"), step=6)[2]["stream"]
    assert a == ckpt.restore_flat(str(tmp_path / "b"), step=6)[2]["stream"]
    assert len(a) == 1 and len(a[0]) == (4 if kind == "parallel" else 1)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_resumes_the_others_streamed_step(
        corpus, tmp_path, port_init, jax_run, writer):
    reader = "port" if writer == "jax" else "jax"
    if writer == "jax":
        shutil.copytree(jax_run / "ck", tmp_path / "ck")
        for s in (4, 6):
            shutil.rmtree(tmp_path / "ck" / f"step-{s}")
    else:
        _run("port", corpus, tmp_path / "w0", tmp_path / "ck", 2)
    _run(reader, corpus, tmp_path / "w", tmp_path / "ck", 6)
    _held_losses(_losses(tmp_path / "w"), _losses(jax_run / "w")[2:])
    got = ckpt.restore_flat(str(tmp_path / "ck"), step=6)
    want = jck.restore_flat(str(jax_run / "ck"), step=6)
    assert got[2]["stream"] == want[2]["stream"]
    _close_params(got[0], want[0])


def test_a_nan_round_rolls_back_on_a_stream_as_in_the_jax_loop(
        corpus, tmp_path, port_init):
    health = dict(inject_nan_rounds=(3,), min_history=2)
    _run("jax", corpus, tmp_path / "jw", tmp_path / "jck", 6, health)
    _run("port", corpus, tmp_path / "tw", tmp_path / "tck", 6, health)
    got, want = _records(tmp_path / "tw"), _records(tmp_path / "jw")

    def rollbacks(recs):
        return [{k: r[k] for k in ("reason", "target_step", "retry",
                                   "rollbacks", "lr_scale")}
                for r in recs if r.get("event") == "rollback"]

    assert rollbacks(got) == rollbacks(want)
    assert len(rollbacks(got)) == 1
    gl = [(r["step"], r["loss"]) for r in got if "loss" in r]
    wl = [(r["step"], r["loss"]) for r in want if "loss" in r]
    assert [s for s, _ in gl] == [s for s, _ in wl]
    # the poisoned round's loss is null in both (RFC 8259 JSON)
    assert [l is None for _, l in gl] == [l is None for _, l in wl]
    fin = [(g, w) for (_, g), (_, w) in zip(gl, wl) if w is not None]
    assert len(fin) == len(wl) - 1
    np.testing.assert_allclose(*zip(*fin), rtol=1e-4)
    t = ckpt.restore_flat(str(tmp_path / "tck"), step=6)
    j = jck.restore_flat(str(tmp_path / "jck"), step=6)
    assert t[2]["stream"] == j[2]["stream"]
    assert t[2]["health"] == j[2]["health"]
    _close_params(t[0], j[0])
