"""The port's bucket stores against the JAX package's, on the CPU: `gs://`
and `s3://` ingest (`data/gcs.py`, `data/s3.py`, the bucket paths of
`data/imagenet.py`) and checkpoint stores (`utils/checkpoint.py`), served
by the in-process fake GCS and SigV4-checking fake S3 of
`tests/fake_stores.py` on localhost. Every case runs on both stores.

Ingest (the counterparts of `tests/test_gcs.py` and `tests/test_s3.py`):
the listing, labels, sizes and freshness tokens equal the local
directory's and the JAX package's; the loader's pixels, labels and
cursors over the bucket equal the local loader's bit for bit on the first
epoch (a tarfile walk of one ranged stream) and the second (members carved
by the captured index); a mid-shard seek, cold and warm, continues as the
local stream does; a connection dropped mid-shard resumes with the same
bytes; a server that ignores Range fails loudly; an equal-size
replacement of a shard is walked again. A streaming source over the
bucket equals the local one.

Checkpoints (the counterparts of `tests/test_checkpoint_stores.py:97-251,
340`): a round trip with the JAX package's digests (each package reads
the other's bucket step, with equal bytes and `commit_ts`), corrupt-latest
fallback, an uncommitted save invisible and swept, `retain` (plain, the
newest verified step protected, no read-back of its own last write), an
async train-loop resume from a bucket equal to the unbroken run
(`torch.equal`), and the ImageNet app streaming from `gs://` with its
checkpoints and mean image on `s3://`, resumed exactly.
"""
import contextlib
import json
import os
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from fake_stores import bucket_store, corrupt_npz_bytes
from sparknet_tpu.data import gcs as jax_gcs
from sparknet_tpu.data import imagenet as jax_imagenet
from sparknet_tpu.data import s3 as jax_s3
from sparknet_tpu.utils import checkpoint as jck

from sparknet_tpu_torch.apps import cifar_app, imagenet_app
from sparknet_tpu_torch.apps.train_loop import resolve_spec, train
from sparknet_tpu_torch.data import gcs, imagenet, s3
from sparknet_tpu_torch.data.cifar import write_synthetic
from sparknet_tpu_torch.data.streaming import StreamingRoundSource
from sparknet_tpu_torch.utils import checkpoint as ckpt
from test_torch_imagenet import NET

torch.set_num_threads(2)
pytestmark = pytest.mark.filterwarnings("ignore::RuntimeWarning")
KINDS = ["gs", "s3"]
SIZE = 32


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("local")
    imagenet.write_synthetic_shards(str(d), n_shards=3, per_shard=6,
                                    n_classes=4, size=40, seed=5)
    imagenet.write_synthetic_shards(str(d), n_shards=1, per_shard=8,
                                    n_classes=4, size=40, seed=6,
                                    prefix="val")
    return d


def _objects(root, kind, prefix):
    out = {}
    for f in sorted(os.listdir(root)):
        p = os.path.join(root, f)
        if os.path.isfile(p):
            key = f"{prefix}/{f}" if kind == "gs" else f"bkt/{prefix}/{f}"
            out[key] = Path(p).read_bytes()
    return out


def _clear_port_caches():
    for m in (gcs, s3):
        m._CLIENTS.clear()
        m._SIZE_CACHE.clear()
        m._STAT_CACHE.clear()


@contextlib.contextmanager
def served(kind, root=None, monkeypatch=None):
    """A fake bucket `bkt` (the local files of `root` under imagenet/)
    wired into both packages: the endpoint, the caches cleared, fast
    retries and small upload parts (the parallel upload paths run)."""
    with bucket_store(kind, _objects(root, kind, "imagenet") if root
                      else None) as (url, srv):
        _clear_port_caches()
        for mod, val in ((gcs, 0.01), (jax_gcs, 0.01)):
            monkeypatch.setattr(mod, "BACKOFF_S", val)
        for mod in (gcs, jax_gcs):
            monkeypatch.setattr(mod, "GS_UPLOAD_CHUNK", 256 << 10)
        for mod in (s3, jax_s3):
            monkeypatch.setattr(mod, "S3_UPLOAD_PART", 256 << 10)
        try:
            yield f"{url}/imagenet", srv.handler
        finally:
            _clear_port_caches()


@pytest.fixture(params=KINDS)
def bucket(request, shards, monkeypatch):
    with served(request.param, shards, monkeypatch) as (url, handler):
        yield request.param, url, handler


def _loader(mod, root, labels=None):
    labels = labels or mod.load_label_map(f"{root}/train.txt")
    return mod.ShardedTarLoader(mod.list_shards(root, "train."), labels,
                                SIZE, SIZE)


def _key(kind, url):
    """The fake store's object key of a gs:// / s3:// url."""
    bkt_rest = url.split("://", 1)[1]
    return bkt_rest.split("/", 1)[1] if kind == "gs" else bkt_rest


# -- ingest -------------------------------------------------------------------

def test_listing_labels_and_sizes_are_the_local_dirs(bucket, shards):
    kind, url, _ = bucket
    remote = imagenet.list_shards(url, "train.")
    assert remote == jax_imagenet.list_shards(url, "train.")
    local = imagenet.list_shards(str(shards), "train.")
    assert [os.path.basename(p) for p in remote] == \
        [os.path.basename(p) for p in local]
    assert len(remote) == 3  # > the fakes' page size: pagination
    assert imagenet.load_label_map(f"{url}/train.txt") == \
        imagenet.load_label_map(str(shards / "train.txt")) == \
        jax_imagenet.load_label_map(f"{url}/train.txt")
    for r, l in zip(remote, local):
        assert imagenet.path_size(r) == os.path.getsize(l)
        size, token = imagenet.path_stat(r, fresh=True)
        assert size == os.path.getsize(l) and token
        assert (size, token) == jax_imagenet.path_stat(r, fresh=True)


def test_the_bucket_loader_is_bit_identical_to_local(bucket, shards):
    _, url, handler = bucket
    labels = imagenet.load_label_map(str(shards / "train.txt"))
    mine = _loader(imagenet, url, labels)
    local = [(i.tobytes(), l, p) for i, l, p in
             _loader(imagenet, str(shards), labels).iter_with_pos()]
    theirs = [(i.tobytes(), l, p) for i, l, p in
              _loader(jax_imagenet, url, labels).iter_with_pos()]
    for epoch in range(2):  # the walk, then the carve by the index
        got = [(i.tobytes(), l, p) for i, l, p in mine.iter_with_pos()]
        assert got == local == theirs, epoch
        assert len(mine._bucket_indices) == 3
    assert mine.skipped == 0


@pytest.mark.parametrize("warm", [False, True])
def test_a_mid_shard_seek_continues_as_the_local_stream(bucket, shards,
                                                       warm):
    _, url, _ = bucket
    labels = imagenet.load_label_map(str(shards / "train.txt"))
    full = [(i.tobytes(), l, p) for i, l, p in
            _loader(imagenet, str(shards), labels).iter_with_pos()]
    mid = full[7][2]
    assert mid[0] > 0  # in the second shard
    g = _loader(imagenet, url, labels)
    if warm:
        list(g.iter_with_pos())  # the member indices are captured
    cont = [(i.tobytes(), l, p) for i, l, p in g.iter_with_pos(mid)]
    assert cont == full[8:]


def test_a_dropped_connection_resumes_with_the_same_bytes(bucket, shards):
    kind, url, handler = bucket
    labels = imagenet.load_label_map(str(shards / "train.txt"))
    first = imagenet.list_shards(url, "train.")[0]
    handler.fail_once = {_key("gs", first)}  # both fakes: the object name
    got = _loader(imagenet, url, labels).load_all()
    want = _loader(imagenet, str(shards), labels).load_all()
    assert not handler.fail_once  # the truncated response was served
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_a_server_that_ignores_range_fails_loudly(bucket):
    kind, url, handler = bucket
    opener = gcs.gs_open_stream if kind == "gs" else s3.s3_open_stream
    shard = f"{url}/train.0000.tar"
    s = opener(shard, start=0)
    assert len(s.read(100)) == 100
    s.close()
    if kind == "gs":
        handler.ignore_range = True
    else:
        real = handler.do_GET

        def no_range(self):  # a middlebox that drops the header
            del self.headers["Range"]
            return real(self)

        handler.verify_auth = False
        handler.do_GET = no_range
    s = opener(shard, start=50)
    with pytest.raises(IOError, match="ignored Range"):
        s.read(10)
    s.close()


def test_an_equal_size_replacement_is_walked_again(bucket, shards):
    kind, url, handler = bucket
    labels = imagenet.load_label_map(str(shards / "train.txt"))
    loaders = [_loader(imagenet, url, labels),
               _loader(jax_imagenet, url, labels)]
    for ld in loaders:
        ld.load_all()
    first = imagenet.list_shards(url, "train.")[0]
    before = imagenet.path_stat(first, fresh=True)
    # one byte flipped inside the first member's JPEG, uploaded again:
    # the size holds, the generation / ETag changes
    raw = bytearray(handler.objects[_key(kind, first)])
    raw[600] ^= 0x01
    (gcs.gs_write if kind == "gs" else s3.s3_write)(first, bytes(raw))
    after = imagenet.path_stat(first, fresh=True)
    assert after[0] == before[0] and after[1] != before[1]
    (gi, gl), (wi, wl) = (ld.load_all() for ld in loaders)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gl, wl)
    assert loaders[0].skipped == loaders[1].skipped
    assert loaders[0]._bucket_indices[first][1] == after


def test_a_streaming_source_over_the_bucket_equals_local(bucket, shards):
    _, url, _ = bucket
    labels = imagenet.load_label_map(str(shards / "train.txt"))
    with StreamingRoundSource(_loader(imagenet, url, labels), 1, 4, 2) as g, \
            StreamingRoundSource(_loader(imagenet, str(shards), labels),
                                 1, 4, 2) as l:
        for r in range(4):  # 18 images: the stream wraps
            gr, lr = g.next_round(round_index=r), l.next_round(round_index=r)
            np.testing.assert_array_equal(gr["data"], lr["data"])
            np.testing.assert_array_equal(gr["label"], lr["label"])
            assert g.cursor_at(r) == l.cursor_at(r)


# -- checkpoint stores ---------------------------------------------------------

@pytest.fixture(params=KINDS)
def store(request, monkeypatch):
    kind = request.param
    with served(kind, monkeypatch=monkeypatch) as (url, handler):
        d = url.rsplit("/", 1)[0] + "/ck"
        pre = "ck" if kind == "gs" else "bkt/ck"

        def key(step, name):
            return f"{pre}/step-{step}/{name}"

        yield d, handler, key


def _tree(seed):
    r = np.random.default_rng(seed)
    return {"a": {"w": r.standard_normal((256, 300)).astype(np.float32),
                  "b": r.standard_normal((33,)).astype(np.float32),
                  "v": torch.from_numpy(r.standard_normal(16).astype(
                      np.float32)).to(torch.bfloat16)},
            "it": np.asarray([seed] * 4, np.int32)}


def _jax_tree(seed):
    t = _tree(seed)
    t["a"]["v"] = t["a"]["v"].float().numpy().astype(ml_dtypes.bfloat16)
    return t


def _same(flat, tree):
    np.testing.assert_array_equal(flat["a/w"], tree["a"]["w"])
    np.testing.assert_array_equal(flat["it"], tree["it"])
    v = flat["a/v"]
    got = (v.view(torch.int16).numpy() if isinstance(v, torch.Tensor)
           else np.asarray(v).view(np.int16))
    want = tree["a"]["v"]
    want = (want.view(torch.int16).numpy() if isinstance(want, torch.Tensor)
            else np.asarray(want).view(np.int16))
    np.testing.assert_array_equal(got, want)


def _meta(d, step):
    return json.loads(ckpt._bucket_ops(d).read(f"{d}/step-{step}/meta.json"))


def test_a_bucket_step_round_trips_with_the_jax_packages_digests(store,
                                                                 tmp_path):
    d, _, _ = store
    path = ckpt.save(d, _tree(1), step=1, extra={"n_devices": 4})
    assert ckpt.verify(path) and jck.verify(path)
    jck.save(d, _jax_tree(2), step=2, extra={"n_devices": 4})
    local = ckpt.save(str(tmp_path / "ref"), _tree(2), step=2)
    ref = json.load(open(os.path.join(local, "meta.json")))
    assert _meta(d, 2)["digests"] == ref["digests"]
    assert _meta(d, 1)["keys"] == ref["keys"]
    assert ckpt.latest_step(d) == jck.latest_step(d) == 2
    flat, step, extra = ckpt.restore_flat(d)
    assert step == 2 and extra["n_devices"] == 4 and "commit_ts" in extra
    _same(flat, _tree(2))
    jflat, _, jextra = jck.restore_flat(d, step=1)
    _same(jflat, _tree(1))
    assert jextra["commit_ts"] == _meta(d, 1)["commit_ts"]
    assert flat["a/v"].dtype == torch.bfloat16


def test_a_corrupt_latest_bucket_step_falls_back(store):
    d, handler, key = store
    for s in (1, 2, 3):
        ckpt.save(d, _tree(s), step=s)
    handler.objects[key(3, "state.npz")] = corrupt_npz_bytes(
        handler.objects[key(3, "state.npz")])
    assert not ckpt.verify(ckpt._join(d, "step-3"))
    flat, step, _ = ckpt.restore_flat(d)
    assert step == 2
    _same(flat, _tree(2))
    with pytest.raises(ckpt.CheckpointCorruptError, match="digest"):
        ckpt.restore_flat(d, step=3)
    assert ckpt.newest_verified_step(d) == jck.newest_verified_step(d) == 2


def test_an_uncommitted_bucket_step_is_invisible_and_swept(store):
    d, handler, key = store
    ckpt.save(d, _tree(1), step=1)
    ckpt.save(d, _tree(2), step=2, extra={"anomalous": True})
    assert ckpt.newest_verified_step(d, skip_anomalous=True) == 1
    handler.objects.pop(key(2, "meta.json"))  # killed before the commit
    assert ckpt.latest_step(d) == 1
    assert ckpt.restore_flat(d)[1] == 1
    ckpt.save(d, _tree(3), step=3)  # sweeps the orphan state
    assert ckpt._list_steps(d) == [1, 3]


def test_retain_over_a_bucket(store, monkeypatch):
    d, handler, key = store
    for s in range(1, 6):
        ckpt.save(d, _tree(s), step=s)
    calls = []
    real = ckpt.verify
    monkeypatch.setattr(ckpt, "verify", lambda p: calls.append(p) or real(p))
    ckpt.retain(d, keep=4)
    assert calls == []  # its own last write: no read-back
    assert ckpt._list_steps(d) == [2, 3, 4, 5]
    for s in (4, 5):
        handler.objects[key(s, "state.npz")] = corrupt_npz_bytes(
            handler.objects[key(s, "state.npz")])
    ckpt.invalidate_written_cache()  # another process's retention
    ckpt.retain(d, keep=2)
    assert ckpt._list_steps(d) == [3, 4, 5]  # 3: the newest verified
    assert ckpt.newest_verified_step(d) == 3


def _cifar(tmp_path, ckdir, rounds):
    data = tmp_path / "cifar"
    if not data.exists():
        write_synthetic(str(data), n_per_file=100)
    cfg = cifar_app.default_config().with_overrides(
        "tau=2", "local_batch=4", "eval_every=0", "checkpoint_every=2",
        "checkpoint_async=true", f"max_rounds={rounds}",
        f"data_dir={data}", f"workdir={tmp_path / 'w'}",
        f"checkpoint_dir={ckdir}")
    return train(cfg, resolve_spec(cfg, data=(4, 3, 32, 32), label=(4, 1)),
                 *cifar_app.build_datasets(cfg), device="cpu")


def test_an_async_train_loop_resumes_exactly_from_a_bucket(store, tmp_path):
    d, _, _ = store
    full = _cifar(tmp_path, d + "_full", 4)
    _cifar(tmp_path, d, 2)
    assert ckpt.latest_step(d) == 2
    resumed = _cifar(tmp_path, d, 4)
    assert resumed.it == full.it
    assert torch.equal(resumed.flat_params, full.flat_params)
    assert torch.equal(resumed.flat_momentum, full.flat_momentum)


def test_the_imagenet_app_streams_from_gs_and_resumes_from_s3(
        shards, tmp_path, monkeypatch):
    net = tmp_path / "tiny.prototxt"
    net.write_text(NET)
    common = ["--device", "cpu", "--stream", "always", "crop=32",
              "local_batch=4", "tau=2", "eval_every=2", "eval_batch=8",
              "n_classes=4", "precision=float32", "checkpoint_every=2",
              "checkpoint_sharded=off", f"model={net}",
              'solver={"base_lr": 0.001, "momentum": 0.9, '
              '"lr_policy": "fixed"}']
    with served("gs", shards, monkeypatch) as (data, _), \
            served("s3", monkeypatch=monkeypatch) as (ck_root, handler):
        ck = ck_root.rsplit("/", 1)[0]

        def run(name, rounds):
            imagenet_app.main(["--data-dir", data, *common,
                               f"workdir={tmp_path / name}",
                               f"checkpoint_dir={ck}/{name}",
                               f"max_rounds={rounds}"])

        run("full", 4)
        run("part", 2)
        assert ckpt.latest_step(f"{ck}/part") == 2
        run("part", 4)
        got = ckpt.restore_flat(f"{ck}/part", step=4)
        want = ckpt.restore_flat(f"{ck}/full", step=4)
        # 4 rounds of 8 over 18 images: image 14 of the second pass
        assert got[2]["stream"] == want[2]["stream"] == [[[2, 2, 1]]]
        for k in want[0]:
            np.testing.assert_array_equal(got[0][k], want[0][k], err_msg=k)
        assert "bkt/full/mean_image.npz" in handler.objects
    log = [json.loads(x) for p in sorted((tmp_path / "part").glob("*.jsonl"))
           for x in p.read_text().splitlines()]
    full = [json.loads(x) for p in (tmp_path / "full").glob("*.jsonl")
            for x in p.read_text().splitlines()]
    assert [(r["step"], r["loss"]) for r in log if "loss" in r] == \
        [(r["step"], r["loss"]) for r in full if "loss" in r]
