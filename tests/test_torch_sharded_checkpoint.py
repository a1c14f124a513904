"""The port's per-shard checkpoint layout (`utils/checkpoint.py:
save_sharded`, `parallel/mesh.py:plan_state_shards`, the loop's
`checkpoint_sharded`) against the JAX package's, on the CPU.

The store cases are those of `tests/test_checkpoint_stores.py:426-620`
(the JAX package's passing sharded tests), each on a local directory and
the fake `gs://` and `s3://` of `tests/fake_stores.py`, over cifar10_quick
replica states written rank by rank through `ParallelTrainer.
checkpoint_shards`:
- a per-shard round trip restores the flat map of a monolithic save of the
  same state, at one rank (the atomic commit) and two (the multi-rank
  commit), and writes the same bytes;
- a corrupt shard is a digest mismatch and `restore_flat` falls back; an
  uncommitted save is invisible and the next save sweeps it; an overwrite
  by a narrower world leaves no stale shard; `retain`'s written-cache
  covers every shard; the multi-rank commit protocol, driven rank by
  rank, commits only once every report landed and raises when one never
  does.
Across the packages, on all three stores: a JAX per-shard step of the
replica trainer's state on a CPU mesh of 2 and of 4 (`fetch_state_shards`,
`save_sharded`) restores to equal flat maps in both packages; the same
state written by 2 and by 4 gloo ranks through the loop's save
(`tests/torch_sharded_worker.py`, `checkpoint_sharded="auto"`) restores
equal in both packages, and its manifest equals the JAX one key for key
and piece for piece (digests and timestamps aside). The JAX plan of a
fully replicated leaf is the port's too.
Training: a 2-rank resume from a per-shard step is `torch.equal` to the
uninterrupted 2-rank run; at one rank the two layouts restore the same
state. On the card (`gpu`; skips here): 2 and 4 NCCL ranks write
per-shard steps by default and resume exactly, 2 ranks resume a 4-rank
step through `adapt_state`, and CaffeNet's save at 4 ranks is timed in
both layouts.
Every comparison is equality: the layouts move bytes, no arithmetic.
"""
import contextlib
import json
import os
import time

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from fake_stores import bucket_store, corrupt_npz_bytes
from sparknet_tpu import zoo as jax_zoo
from sparknet_tpu.data import gcs as jax_gcs
from sparknet_tpu.data import s3 as jax_s3
from sparknet_tpu.model.net import CompiledNet as JaxCompiledNet
from sparknet_tpu.parallel.mesh import fetch_state_shards, make_mesh
from sparknet_tpu.parallel.trainer import ParallelTrainer as JaxTrainer
from sparknet_tpu.solver import SolverConfig as JaxSolverConfig
from sparknet_tpu.utils import checkpoint as jck

import torch_sharded_worker
from sparknet_tpu_torch import zoo
from sparknet_tpu_torch.data import gcs, s3
from sparknet_tpu_torch.data.cifar import write_synthetic
from sparknet_tpu_torch.model.net import CompiledNet
from sparknet_tpu_torch.obs.registry import MetricsRegistry
from sparknet_tpu_torch.parallel.mesh import DataGroup, plan_state_shards
from sparknet_tpu_torch.parallel.trainer import ParallelTrainer
from sparknet_tpu_torch.solver import SolverConfig
from sparknet_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(2)
pytestmark = pytest.mark.filterwarnings("ignore::RuntimeWarning")
SPAWN_TIMEOUT_S = 240
STORES = ["local", "gs", "s3"]


def _spawn(fn, args, nprocs):
    ctx = mp.spawn(fn, args=args, nprocs=nprocs, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{fn.__name__} ranks did not finish in "
                        f"{SPAWN_TIMEOUT_S} s (a rank hangs)")


def _clear_port_caches():
    for m in (gcs, s3):
        m._CLIENTS.clear()
        m._SIZE_CACHE.clear()
        m._STAT_CACHE.clear()


@contextlib.contextmanager
def _served(kind, monkeypatch=None):
    """A fake bucket wired into both packages' clients (fast retries; in
    process, small upload parts so the parallel upload paths run);
    yields (checkpoint url, {"shard urls", "rewrite", "drop_meta"})."""
    with bucket_store(kind) as (url, srv):
        _clear_port_caches()
        if monkeypatch is not None:
            for mod in (gcs, jax_gcs):
                monkeypatch.setattr(mod, "BACKOFF_S", 0.01)
                monkeypatch.setattr(mod, "GS_UPLOAD_CHUNK", 256 << 10)
            for mod in (s3, jax_s3):
                monkeypatch.setattr(mod, "S3_UPLOAD_PART", 256 << 10)
        pre = "ck" if kind == "gs" else "bkt/ck"
        objects = srv.handler.objects

        def drop_meta(step):
            objects.pop(f"{pre}/step-{step}/meta.json", None)

        try:
            yield f"{url}/ck", drop_meta
        finally:
            _clear_port_caches()


@pytest.fixture(params=STORES)
def store(request, tmp_path, monkeypatch):
    """(checkpoint directory, drop_meta(step): the commit marker gone, as
    a writer killed before it landed leaves a step)."""
    if request.param == "local":
        d = str(tmp_path / "ck")
        yield d, lambda s: os.remove(os.path.join(d, f"step-{s}",
                                                  "meta.json"))
        return
    with _served(request.param, monkeypatch) as got:
        yield got


def _shard_urls(d, step):
    if ckpt.is_bucket_path(d):
        return sorted(u for u in ckpt._bucket_ops(d).list_urls(
            f"{d}/step-{step}") if "/shard-" in u)
    sd = os.path.join(d, f"step-{step}")
    return sorted(os.path.join(sd, f) for f in os.listdir(sd)
                  if f.startswith("shard-"))


def _rewrite(d, url, mutate):
    if ckpt.is_bucket_path(d):
        ops = ckpt._bucket_ops(d)
        ops.write(url, mutate(ops.read(url)))
    else:
        with open(url, "rb") as f:
            raw = f.read()
        with open(url, "wb") as f:
            f.write(mutate(raw))


def _bits(leaf):
    """(dtype name, shape, bytes) of a restored leaf of either package."""
    if isinstance(leaf, torch.Tensor):
        raw = (leaf.view(torch.int16) if leaf.dtype == torch.bfloat16
               else leaf).numpy().tobytes()
        return str(leaf.dtype).replace("torch.", ""), tuple(leaf.shape), raw
    a = np.asarray(leaf)
    return a.dtype.name, a.shape, a.tobytes()


def _assert_same_map(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert _bits(got[k]) == _bits(want[k]), k


# -- replica states of cifar10_quick ------------------------------------------

NET = None


def _net():
    global NET
    if NET is None:
        NET = CompiledNet.compile(zoo.cifar10_quick(batch=2))
    return NET


def _trainer(rank, world, velocity="float32"):
    """A trainer on a data group that is never formed: the boundary
    functions need no collective (`checkpoint_shards` never gathers)."""
    return ParallelTrainer(_net(), SolverConfig(velocity_dtype=velocity),
                           DataGroup(rank, world, torch.device("cpu")),
                           tau=1)


def _replica_flat(world, velocity="float32", seed=0):
    """A replica-layout flat map of `world` ranks: every params row the
    same (after an average), momentum rows of seeded values, it = 7."""
    tr = _trainer(0, 1, velocity)
    g = torch.Generator().manual_seed(seed)
    tree = tr.checkpoint_tree(tr.init_state(seed))
    flat = {}
    for l, lp in tree["params"].items():
        for p, a in lp.items():
            flat[f"params/{l}/{p}"] = np.ascontiguousarray(
                np.broadcast_to(a, (world,) + a.shape[1:]))
            m = torch.randn((world,) + a.shape[1:], generator=g)
            flat[f"momentum/{l}/{p}"] = (
                m.to(torch.bfloat16) if velocity == "bfloat16"
                else m.numpy())
    flat["it"] = np.full((world,), 7, np.int32)
    return flat


def _nest(flat):
    out = {}
    for k, v in flat.items():
        *head, last = k.split("/")
        node = out
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def _save_world(d, flat, world, step, velocity="float32", order=None,
                **kw):
    """The per-shard save of `world` ranks, driven rank by rank as the
    loop's stage 2 runs them (rank 0, which commits, last); with `order`
    only those ranks write, and the caller has prepared the step."""
    if world > 1 and order is None:
        ckpt.prepare_sharded_step(d, step)
    for r in order or list(range(1, world)) + [0]:
        tr = _trainer(r, world, velocity)
        snap = tr.checkpoint_shards(tr.state_from_checkpoint(
            flat, {"n_devices": world}))
        ckpt.save_sharded(d, snap, step=step, extra={"n_devices": world},
                          **kw)


# -- the store cases --------------------------------------------------------

@pytest.mark.parametrize("world", [1, 2])
def test_a_per_shard_round_trip_is_the_monolithic_flat_map(store, world):
    d, _ = store
    flat = _replica_flat(world, "bfloat16", seed=world)
    _save_world(d, flat, world, 1, "bfloat16")
    ckpt.save(d, _nest(flat), step=2, extra={"n_devices": world})
    got, step, extra = ckpt.restore_flat(d, step=1)
    want, _, _ = ckpt.restore_flat(d, step=2)
    assert step == 1 and isinstance(extra.pop("commit_ts"), float)
    assert extra == {"n_devices": world}
    _assert_same_map(got, want)
    _assert_same_map(got, flat)
    snap = _trainer(0, world, "bfloat16").checkpoint_shards(
        _trainer(0, world, "bfloat16").state_from_checkpoint(flat))
    assert ckpt.sharded_nbytes(snap) == sum(
        len(_bits(a)[2]) for a in want.values())
    assert ckpt.verify(ckpt._join(d, "step-1"))
    assert len(_shard_urls(d, 1)) == world


def test_a_corrupt_shard_is_detected_and_restore_falls_back(store):
    d, _ = store
    first = _replica_flat(2, seed=1)
    _save_world(d, first, 2, 1)
    _save_world(d, _replica_flat(2, seed=2), 2, 2)
    _rewrite(d, _shard_urls(d, 2)[1], corrupt_npz_bytes)
    assert not ckpt.verify(ckpt._join(d, "step-2"))
    with pytest.raises(ckpt.CheckpointCorruptError, match="digest"):
        ckpt.restore_flat(d, step=2)
    with pytest.warns(RuntimeWarning, match="digest mismatch"):
        flat, step, _ = ckpt.restore_flat(d)
    assert step == 1
    _assert_same_map(flat, first)
    assert ckpt.newest_verified_step(d) == 1


def test_an_uncommitted_save_is_invisible_and_swept(store):
    d, drop_meta = store
    flat = _replica_flat(2, seed=3)
    _save_world(d, flat, 2, 1)
    _save_world(d, flat, 2, 2)
    drop_meta(2)  # the shards landed, the commit marker did not
    assert ckpt.latest_step(d) == 1
    with pytest.warns(RuntimeWarning):
        _, step, _ = ckpt.restore_flat(d)
    assert step == 1
    _save_world(d, flat, 2, 3)  # its stage-1 prepare sweeps step 2
    if ckpt.is_bucket_path(d):
        assert _shard_urls(d, 2) == []
    else:
        assert not os.path.isdir(os.path.join(d, "step-2"))
    assert ckpt.latest_step(d) == 3


def test_an_overwrite_by_a_narrower_world_clears_stale_shards(store):
    d, _ = store
    for world in (4, 2, 1):
        flat = _replica_flat(world, seed=4 + world)
        _save_world(d, flat, world, 1)
        assert len(_shard_urls(d, 1)) == world
        got, _, extra = ckpt.restore_flat(d, step=1)
        assert extra["n_devices"] == world
        _assert_same_map(got, flat)


def test_retain_s_written_cache_covers_every_shard(store, monkeypatch):
    d, _ = store
    flat = _replica_flat(2, seed=6)
    for s in (1, 2, 3):
        _save_world(d, flat, 2, s)
    calls = []
    real = ckpt.verify
    monkeypatch.setattr(ckpt, "verify", lambda p: calls.append(p) or real(p))
    ckpt.retain(d, keep=2)
    assert calls == [], "retain re-verified the shards it just wrote"
    assert ckpt._list_steps(d) == [2, 3]
    _rewrite(d, _shard_urls(d, 3)[0], corrupt_npz_bytes)
    ckpt.retain(d, keep=2)
    assert calls, "a rewritten shard did not invalidate the cache"
    assert ckpt.newest_verified_step(d) == 2


def test_the_multi_rank_commit_protocol_rank_by_rank(store):
    d, _ = store
    flat = _replica_flat(2, seed=7)
    ops = ckpt._bucket_ops(d) if ckpt.is_bucket_path(d) else None

    def put(name, raw):
        if ops is not None:
            ops.write(f"{d}/step-1/{name}", raw)
        else:
            os.makedirs(os.path.join(d, "step-1"), exist_ok=True)
            with open(os.path.join(d, "step-1", name), "wb") as f:
                f.write(raw)

    def names():
        if ops is not None:
            return sorted(u.rsplit("/", 1)[1] for u in
                          ops.list_urls(f"{d}/step-1"))
        return sorted(os.listdir(os.path.join(d, "step-1")))

    # a crashed save's report and shard: the prepare clears both, so the
    # commit can never stamp a dead save's digests
    put("commit-1.json", json.dumps(
        {ckpt.shard_file_name(1, 2): "deadbeef" * 8}).encode())
    put(ckpt.shard_file_name(1, 2), b"torn")
    ckpt.prepare_sharded_step(d, 1)
    assert ckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_flat(d)
    # rank 1 writes first: its shard and report; the step stays invisible
    _save_world(d, flat, 2, 1, order=[1])
    assert ckpt.latest_step(d) is None
    assert names() == ["commit-1.json", ckpt.shard_file_name(1, 2)]
    # rank 0 writes, collects the reports, commits meta.json, cleans up
    _save_world(d, flat, 2, 1, order=[0])
    assert ckpt.latest_step(d) == 1
    assert names() == sorted(["meta.json", ckpt.shard_file_name(0, 2),
                              ckpt.shard_file_name(1, 2)])
    got, _, _ = ckpt.restore_flat(d, step=1)
    _assert_same_map(got, flat)
    # a report that never lands: rank 0 raises and commits nothing
    ckpt.prepare_sharded_step(d, 2)
    with pytest.raises(RuntimeError, match="never reported"):
        _save_world(d, flat, 2, 2, order=[0], commit_timeout_s=0.2)
    assert ckpt.latest_step(d) == 1


def test_the_writer_counts_shard_and_meta_writes(tmp_path):
    flat = _replica_flat(1, seed=8)
    tr = _trainer(0, 1)
    snap = tr.checkpoint_shards(tr.state_from_checkpoint(flat))
    reg = MetricsRegistry()
    w = ckpt.AsyncCheckpointWriter(registry=reg)
    try:
        w.submit(lambda: ckpt.save_sharded(str(tmp_path / "ck"), snap,
                                           step=1, metrics=w.note_write))
        w.wait()
    finally:
        w.close()
    writes = {ln.split("{", 1)[1].split("}")[0]: float(ln.rsplit(" ", 1)[1])
              for ln in reg.render_prometheus().splitlines()
              if ln.startswith("sparknet_checkpoint_writes_total{")}
    assert writes == {'outcome="ok",scope="shard"': 1.0,
                      'outcome="ok",scope="meta"': 1.0,
                      'outcome="ok",scope="snapshot"': 1.0}, writes


def test_a_failed_shard_write_raises_and_commits_nothing(tmp_path,
                                                         monkeypatch):
    flat = _replica_flat(1, seed=9)
    tr = _trainer(0, 1)
    snap = tr.checkpoint_shards(tr.state_from_checkpoint(flat))

    def broken(pieces):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_serialize_shard", broken)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save_sharded(str(tmp_path / "ck"), snap, step=1)
    assert ckpt.latest_step(str(tmp_path / "ck")) is None
    assert os.listdir(tmp_path / "ck") == []


# -- the piece plan ---------------------------------------------------------

@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_the_replicated_leaf_plan_is_the_jax_packages(world):
    """A fully replicated leaf (a JAX logical-layout step has them): the
    leading axis in contiguous chunks differing by at most one, chunk j in
    file j; a scalar, an empty leaf or a world of one in file 0."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = make_mesh(world)
    r = np.random.default_rng(world)
    leaves = {"w": r.standard_normal((7, 3)).astype(np.float32),
              "short": r.standard_normal((2, 5)).astype(np.float32),
              "empty": np.zeros((0, 4), np.float32),
              "step": np.asarray(5, np.int32)}
    want = fetch_state_shards(
        {k: jax.device_put(a, NamedSharding(mesh, P()))
         for k, a in leaves.items()}, mesh)
    for rank in range(world):
        got = plan_state_shards(replicated=leaves, rank=rank, world=world)
        assert got["n_shards"] == want["n_shards"] == world
        assert got["owners"] == {f: f for f in range(world)}
        for k, rec in want["leaves"].items():
            g = got["leaves"][k]
            assert tuple(g["shape"]) == tuple(rec["shape"])
            assert [p[:3] for p in g["pieces"]] == \
                [tuple(p[:3]) for p in rec["pieces"]], k
            for (fid, off, shape, arr), (_, _, _, jarr) in zip(
                    g["pieces"], rec["pieces"]):
                if fid == rank:
                    np.testing.assert_array_equal(arr, jarr)
                else:
                    assert arr is None


# -- across the packages: JAX steps and gloo-rank port steps, three stores --

def _jax_replica_state(world, velocity, seed):
    """The JAX replica trainer's state on a CPU mesh of `world`, with
    seeded momentum rows (they differ per device) and it = 3."""
    mesh = make_mesh(world)
    jt = JaxTrainer(JaxCompiledNet.compile(jax_zoo.cifar10_quick(batch=2)),
                    JaxSolverConfig(velocity_dtype=velocity), mesh, tau=1)
    st = jt.init_state(jax.random.PRNGKey(seed))
    r = np.random.default_rng(seed)
    mom = jax.tree.map(lambda a: jax.device_put(
        jax.numpy.asarray(r.standard_normal(a.shape), a.dtype), a.sharding),
        st.momentum)
    it = jax.device_put(jax.numpy.full(st.it.shape, 3, st.it.dtype),
                        st.it.sharding)
    return type(st)(st.params, mom, it), mesh


def _manifest(meta):
    """The manifest without its digests and timestamps (the commit's and
    the loop's publish_t)."""
    meta = dict(meta)
    meta.pop("commit_ts")
    meta["extra"] = {k: v for k, v in meta.get("extra", {}).items()
                     if k != "publish_t"}
    meta["shards"] = [{k: v for k, v in s.items() if k != "digest"}
                      for s in meta["shards"]]
    return meta


def _read_meta(d, step):
    path = ckpt._join(d, f"step-{step}")
    meta = ckpt._load_meta(path)
    assert meta is not None, path
    return meta


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """{(store, world): {"jax_by_jax", "jax_by_port", "port_by_jax",
    "port_by_port", "jax_meta", "port_meta", "files"}} — the JAX step
    written by `fetch_state_shards` + `save_sharded`, the port step by
    `world` gloo ranks through `_save_checkpoint` from the same state, each
    read by both packages. Worlds: 2 (float32 momentum), 4 (bfloat16)."""
    root = tmp_path_factory.mktemp("cross")
    out = {}
    with bucket_store("gs") as (gs_url, _), bucket_store("s3") as (s3_url,
                                                                 _):
        _clear_port_caches()
        bases = {"local": str(root), "gs": gs_url, "s3": s3_url}
        for world, velocity in ((2, "float32"), (4, "bfloat16")):
            st, mesh = _jax_replica_state(world, velocity, seed=world)
            for kind, base in bases.items():
                jck.save_sharded(f"{base}/jax{world}",
                                 fetch_state_shards(st, mesh), step=5,
                                 extra={"n_devices": world, "tp": 1})
            _spawn(torch_sharded_worker.save_ranks,
                   (world, str(root / f"store{world}"),
                    str(root / f"jax{world}"),
                    [f"{b}/port{world}" for b in bases.values()], 5,
                    velocity), world)
            for kind, base in bases.items():
                j, p = f"{base}/jax{world}", f"{base}/port{world}"
                out[(kind, world)] = {
                    "jax_by_jax": jck.restore_flat(j, step=5)[0],
                    "jax_by_port": ckpt.restore_flat(j, step=5)[0],
                    "port_by_jax": jck.restore_flat(p, step=5)[0],
                    "port_by_port": ckpt.restore_flat(p, step=5)[0],
                    "jax_meta": _read_meta(j, 5),
                    "port_meta": _read_meta(p, 5),
                    "port_verified": (ckpt.verify(ckpt._join(p, "step-5"))
                                      and jck.verify(ckpt._join(
                                          p, "step-5"))),
                    "files": sorted(_shard_urls(p, 5))}
        _clear_port_caches()
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", STORES)
def test_a_jax_per_shard_step_restores_equal_in_both_packages(cross, kind,
                                                              world):
    got = cross[(kind, world)]
    _assert_same_map(got["jax_by_port"], got["jax_by_jax"])
    assert got["jax_meta"]["format"] == "sharded"
    assert len(got["jax_meta"]["shards"]) == world


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", STORES)
def test_gloo_ranks_write_the_jax_manifest_and_the_same_state(cross, kind,
                                                              world):
    got = cross[(kind, world)]
    assert _manifest(got["port_meta"]) == _manifest(got["jax_meta"])
    assert all(len(s["digest"]) == 64 for s in got["port_meta"]["shards"])
    assert got["port_verified"] and len(got["files"]) == world
    _assert_same_map(got["port_by_port"], got["jax_by_jax"])
    _assert_same_map(got["port_by_jax"], got["jax_by_jax"])


# -- training ---------------------------------------------------------------

OVERRIDES = ("tau=2", "local_batch=4", "eval_every=0", "checkpoint_every=2")


@pytest.fixture(scope="module")
def cifar_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cifar")
    write_synthetic(str(d), n_per_file=100)
    return d


def _runs(out, layout=None):
    lay = () if layout is None else (f"checkpoint_sharded={layout}",)
    return [{"name": "full", "overrides": (
                *OVERRIDES, *lay, "max_rounds=4",
                f"checkpoint_dir={out}/full_ck")},
            {"name": "half", "overrides": (
                *OVERRIDES, *lay, "max_rounds=2",
                f"checkpoint_dir={out}/half_ck")},
            {"name": "resumed", "overrides": (
                *OVERRIDES, *lay, "max_rounds=4",
                f"checkpoint_dir={out}/half_ck")}]


def test_a_two_rank_resume_from_a_per_shard_step_is_exact(cifar_dir,
                                                          tmp_path):
    """Two gloo ranks on the default layout ("auto": per-shard above one
    rank): 2 rounds and a resume to 4 equal 4 rounds without a break,
    tensor for tensor, on each rank."""
    out = str(tmp_path)
    _spawn(torch_sharded_worker.train_runs,
           (2, str(tmp_path / "store"), str(cifar_dir), out, "cpu",
            _runs(out)), 2)
    meta = json.load(open(tmp_path / "half_ck" / "step-2" / "meta.json"))
    assert meta["format"] == "sharded" and len(meta["shards"]) == 2
    assert meta["extra"]["n_devices"] == 2
    for r in range(2):
        full = np.load(tmp_path / f"full_rank{r}.npz")
        resumed = np.load(tmp_path / f"resumed_rank{r}.npz")
        for k in ("it", "flat_params", "flat_momentum"):
            assert torch.equal(torch.from_numpy(resumed[k]),
                               torch.from_numpy(full[k])), (r, k)
        log = open(tmp_path / f"resumed_rank{r}.txt").read()
        assert "resumed from checkpoint round 2" in log


def test_at_one_rank_the_two_layouts_restore_the_same_state(cifar_dir,
                                                           tmp_path):
    from sparknet_tpu_torch.apps import cifar_app
    from sparknet_tpu_torch.apps.train_loop import resolve_spec, train
    states = {}
    for layout in ("off", "on"):
        cfg = cifar_app.default_config().with_overrides(
            *OVERRIDES, "max_rounds=2", f"data_dir={cifar_dir}",
            f"workdir={tmp_path / layout}", f"checkpoint_sharded={layout}",
            f"checkpoint_dir={tmp_path / layout / 'ck'}")
        train(cfg, resolve_spec(cfg, data=(4, 3, 32, 32), label=(4, 1)),
              *cifar_app.build_datasets(cfg), device="cpu")
        d = str(tmp_path / layout / "ck")
        meta = json.load(open(os.path.join(d, "step-2", "meta.json")))
        assert ("shards" in meta) == (layout == "on")
        flat, _, extra = ckpt.restore_flat(d, step=2)
        states[layout] = (flat, _trainer(0, 1).state_from_checkpoint(
            flat, extra))
    _assert_same_map(states["on"][0], states["off"][0])
    a, b = states["on"][1], states["off"][1]
    assert a.it == b.it == 4
    assert torch.equal(a.flat_params, b.flat_params)
    assert torch.equal(a.flat_momentum, b.flat_momentum)


@pytest.mark.gpu
@pytest.mark.parametrize("world", [2, 4])
def test_nccl_ranks_write_per_shard_steps_and_resume(cifar_dir, tmp_path,
                                                     world):
    """On `world` cards: the default layout is per-shard; a resume at the
    same world is torch.equal to the uninterrupted run. At 4: two ranks
    resume the 4-rank step through adapt_state (restored state equal to
    the CPU adapt_state of the step), and CaffeNet's full state is saved
    in both layouts in turns (stage-1 and save seconds printed and left in
    chiprun_out/sharded_saves.json)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA cards")
    out = str(tmp_path)
    runs = _runs(out)
    _spawn(torch_sharded_worker.train_runs,
           (world, str(tmp_path / "store"), str(cifar_dir), out, "cuda",
            runs), world)
    meta = json.load(open(tmp_path / "half_ck" / "step-2" / "meta.json"))
    assert meta["format"] == "sharded" and len(meta["shards"]) == world
    for r in range(world):
        full = np.load(tmp_path / f"full_rank{r}.npz")
        resumed = np.load(tmp_path / f"resumed_rank{r}.npz")
        for k in ("it", "flat_params", "flat_momentum"):
            assert np.array_equal(resumed[k], full[k]), (r, k)
    if world != 4:
        return
    flat, _, extra = ckpt.restore_flat(str(tmp_path / "full_ck"), step=4)
    _spawn(torch_sharded_worker.train_runs,
           (2, str(tmp_path / "store2"), str(cifar_dir), out, "cuda",
            [{"name": "at2", "overrides": (
                *OVERRIDES, "max_rounds=4",
                f"checkpoint_dir={out}/full_ck")}]), 2)
    for r in range(2):
        log = open(tmp_path / f"at2_rank{r}.txt").read()
        assert "ELASTIC resume from round 4: 4 devices" in log
        want = ParallelTrainer(
            CompiledNet.compile(zoo.cifar10_quick(batch=4)),
            SolverConfig(), DataGroup(r, 2, torch.device("cpu")),
            tau=2).state_from_checkpoint(flat, extra)
        got = np.load(tmp_path / f"at2_rank{r}.npz")
        assert got["it"] == want.it == 8
        assert np.array_equal(got["flat_params"], want.flat_params.numpy())
        assert np.array_equal(got["flat_momentum"],
                              want.flat_momentum.numpy())
    _spawn(torch_sharded_worker.time_saves,
           (4, str(tmp_path / "store3"), out, "cuda", 2), 4)
    rows = json.load(open(tmp_path / "saves.json"))
    for row in rows:
        print(f"sharded saves at 4 ranks: {row}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "sharded_saves.json"), "w") as f:
        json.dump({"card": torch.cuda.get_device_name(0), "rows": rows}, f)
    assert {r["layout"] for r in rows} == {"off", "auto"}
