"""The port's metrics history (obs/history.py) against the JAX package's.

The same scripted registry traffic — counters, gauges and histograms,
labeled and not, made from a seed with numpy — goes into a JAX registry
and a port registry, and each package's `MetricsHistory` samples its own
under the same injected clock (`sample_now(now=...)`). Everything here is
pure host arithmetic on the same inputs, so every comparison is exact:
- `series_key` / `split_key`, `quantile_from_buckets`, `fraction_over`
  and `merge_slots` on seeded histograms;
- the rings after the cascade (every ring, every slot, the partial
  coarse slot) and the windowed queries (`window`, `windowed_quantile`,
  `points`);
- the JSONL shards: the port's read by the JAX `read_history_shards`
  into equal slots and families, and the reverse; rotation and pruning;
- `/timeseries` over HTTP from each package's `StatusServer`: equal
  bodies, discovery included, and the same 400 on a bad query;
- `HistoryConfig` validation: the same errors.
"""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from sparknet_tpu.obs import history as jh
from sparknet_tpu.obs.http import StatusServer as JaxStatusServer
from sparknet_tpu.obs.registry import MetricsRegistry as JaxRegistry

from sparknet_tpu_torch.obs import history as ph
from sparknet_tpu_torch.obs.http import StatusServer
from sparknet_tpu_torch.obs.registry import MetricsRegistry

LAT = "sparknet_serve_request_latency_seconds"
REQ = "sparknet_serve_requests_total"
T0 = 1_700_000_000.0


class Scripted:
    """One package's registry with the families the serve stack exports,
    fed the same seeded operations as its twin."""

    def __init__(self, registry_cls):
        self.reg = registry_cls()
        self.lat = self.reg.histogram(LAT, "latency", labels=("model",))
        self.req = self.reg.counter(REQ, "requests",
                                    labels=("model", "outcome"))
        self.depth = self.reg.gauge("sparknet_serve_queue_depth", "depth",
                                    labels=("model",))
        self.plain = self.reg.counter("sparknet_plain_total", "unlabeled")

    def step(self, rng: np.random.Generator) -> None:
        for model in ("a", "b"):
            n = int(rng.integers(0, 30))
            for x in rng.lognormal(-4.0, 1.0, size=n):
                self.lat.observe(float(x), model=model)
            ok = int(rng.integers(0, 30))
            bad = int(rng.integers(0, 3))
            if ok:
                self.req.inc(ok, model=model, outcome="ok")
            if bad:
                self.req.inc(bad, model=model, outcome="failed")
            self.depth.set(float(rng.integers(0, 64)), model=model)
        self.plain.inc(float(rng.integers(0, 5)))


def _pair(seed: int, samples: int, cfg_kw=None, dirs=(None, None)):
    """(jax history, port history) after `samples` scripted samples."""
    cfg_kw = cfg_kw or dict(sample_interval_s=1.0,
                            rings=((1.0, 8), (4.0, 6), (16.0, 4)))
    out = []
    for mod, reg_cls, d in ((jh, JaxRegistry, dirs[0]),
                            (ph, MetricsRegistry, dirs[1])):
        s = Scripted(reg_cls)
        h = mod.MetricsHistory(s.reg, mod.HistoryConfig(persist_dir=d,
                                                        **cfg_kw))
        rng = np.random.default_rng(seed)
        for i in range(samples):
            s.step(rng)
            h.sample_now(now=T0 + (i + 1) * cfg_kw["sample_interval_s"])
        out.append(h)
    return out


def _rows(h):
    rings = []
    for r in h.rings:
        rows = [s.to_row() for s in r.slots]
        acc = None if r.acc is None else (r.acc.to_row(), r.acc_n)
        rings.append((r.res_s, r.factor, rows, acc))
    return rings


def _seeded_hist(seed: int):
    rng = np.random.default_rng(seed)
    le = sorted({round(float(x), 4) for x in rng.uniform(0.001, 2.0, 9)})
    counts = [float(c) for c in rng.integers(0, 50, len(le))]
    overflow = float(rng.integers(0, 5))
    return le, counts, sum(counts) + overflow


@pytest.mark.parametrize("seed", range(8))
def test_bucket_math_equals_the_jax_package(seed):
    le, counts, count = _seeded_hist(seed)
    rng = np.random.default_rng(100 + seed)
    for q in [0.0, 0.5, 0.9, 0.99, 1.0, *rng.uniform(0, 1, 6)]:
        assert ph.quantile_from_buckets(le, counts, count, q) == \
            jh.quantile_from_buckets(le, counts, count, q)
    thresholds = [0.0, le[0], le[-1], le[-1] * 2,
                  *rng.uniform(0, le[-1] * 1.2, 8)]
    for t in thresholds:
        assert ph.fraction_over(le, counts, count, t) == \
            jh.fraction_over(le, counts, count, t)
    # the edges: no observations
    assert ph.quantile_from_buckets(le, counts, 0, 0.5) is None
    assert ph.fraction_over(le, counts, 0, 0.1) == 0.0


@pytest.mark.parametrize("labels", [(), ("model",), ("model", "outcome")])
def test_series_keys_round_trip_like_the_jax_package(labels):
    values = ("caffenet", "ok")[:len(labels)]
    key = ph.series_key("sparknet_x", labels, values)
    assert key == jh.series_key("sparknet_x", labels, values)
    assert ph.split_key(key) == jh.split_key(key) == \
        ("sparknet_x", dict(zip(labels, values)))


@pytest.mark.parametrize("seed", range(4))
def test_merge_slots_equals_the_jax_package(seed):
    jhist, phist = _pair(seed, 12)
    jslots = list(jhist.rings[0].slots)
    pslots = list(phist.rings[0].slots)
    assert [s.to_row() for s in pslots] == [s.to_row() for s in jslots]
    assert ph.merge_slots(pslots).to_row() == \
        jh.merge_slots(jslots).to_row()
    assert ph.merge_slots([]) is None
    # Slot rows cross packages: each package's from_row reads the other's
    for js, ps in zip(jslots, pslots):
        assert ph.Slot.from_row(js.to_row()).to_row() == ps.to_row()
        assert jh.Slot.from_row(ps.to_row()).to_row() == js.to_row()


@pytest.mark.parametrize("seed,samples", [(0, 3), (1, 9), (2, 37), (3, 70)])
def test_ring_cascade_and_queries_equal_the_jax_package(seed, samples):
    jhist, phist = _pair(seed, samples)
    assert _rows(phist) == _rows(jhist)
    assert phist.families == jhist.families
    assert phist.samples_total == jhist.samples_total == samples
    now = T0 + samples
    for window in (3.0, 10.0, 30.0, 100.0):
        for name in (LAT, REQ, "sparknet_serve_queue_depth",
                     "sparknet_plain_total", "unknown"):
            for labels in (None, {"model": "a"}, {"outcome": "failed"}):
                assert phist.window(name, window, labels, now) == \
                    jhist.window(name, window, labels, now)
                assert phist.points(name, window, labels, now) == \
                    jhist.points(name, window, labels, now)
        for q in (0.5, 0.99):
            assert phist.windowed_quantile(LAT, q, window, now=now) == \
                jhist.windowed_quantile(LAT, q, window, now=now)
            assert phist.windowed_quantile(LAT, q, window, {"model": "b"},
                                           now) == \
                jhist.windowed_quantile(LAT, q, window, {"model": "b"}, now)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_shards_cross_packages(tmp_path, writer):
    d = str(tmp_path / "h")
    # a small shard bound: the writer rotates and prunes along the way
    kw = dict(sample_interval_s=0.5, rings=((0.5, 20), (2.0, 10)),
              shard_max_bytes=6000, shard_max_files=3)
    dirs = (d, None) if writer == "jax" else (None, d)
    jhist, phist = _pair(7, 40, cfg_kw=kw, dirs=dirs)
    for h in (jhist, phist):
        h.stop()
    files = sorted(p.name for p in (tmp_path / "h").iterdir())
    assert 1 < len(files) <= 3, files
    fam_j, slots_j = jh.read_history_shards(d)
    fam_p, slots_p = ph.read_history_shards(d)
    assert fam_p == fam_j
    assert [s.to_row() for s in slots_p] == [s.to_row() for s in slots_j]
    # the reader sees exactly the writer's newest base slots
    src = phist if writer == "port" else jhist
    base = [s.to_row() for s in src.rings[0].slots]
    got = [s.to_row() for s in slots_p]
    k = min(len(got), len(base))
    assert k >= 10 and got[-k:] == base[-k:]
    assert set(fam_p) == set(src.families)
    # a torn last line (a process killed mid-write) is skipped by both
    last = tmp_path / "h" / files[-1]
    with open(last, "a") as f:
        f.write('{"t0": 1, "c": {')
    assert [s.to_row() for s in ph.read_history_shards(d)[1]] == \
        [s.to_row() for s in jh.read_history_shards(d)[1]] == got
    assert ph.read_history_shards(str(tmp_path / "none")) == ({}, [])


def _get(server, path):
    host, port = server.address
    try:
        with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                    timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_timeseries_route_answers_as_the_jax_one():
    jhist, phist = _pair(3, 25)
    servers = [JaxStatusServer(0, jhist.registry),
               StatusServer(0, phist.registry)]
    jhist.attach_http(servers[0])
    phist.attach_http(servers[1])
    try:
        for path in ("/timeseries",
                     f"/timeseries?name={LAT}&window=10&q=0.9",
                     f"/timeseries?name={LAT}&window=30&model=a",
                     f"/timeseries?name={REQ}&window=5&outcome=ok",
                     "/timeseries?name=sparknet_serve_queue_depth&window=8",
                     "/timeseries?name=sparknet_plain_total"):
            want = _get(servers[0], path)
            got = _get(servers[1], path)
            assert got == want, path
            assert got[0] == 200
        assert set(_get(servers[1], "/timeseries")[1]) == \
            {"families", "rings", "samples_total"}
        for bad in ("/timeseries?name=nope",
                    f"/timeseries?name={LAT}&window=x"):
            j, p = _get(servers[0], bad), _get(servers[1], bad)
            assert p[0] == j[0] == 400
            assert p == j
    finally:
        for s in servers:
            s.stop()


@pytest.mark.parametrize("kw", [
    dict(sample_interval_s=0), dict(rings=()),
    dict(rings=((1.0, 0),)), dict(rings=((1.5, 4),)),
    dict(rings=((1.0, 4), (2.5, 4))), dict(sample_interval_s=2.0,
                                           rings=((1.0, 4),)),
    dict(shard_max_bytes=0), dict(shard_max_files=0)])
def test_history_config_refuses_as_the_jax_one(kw):
    with pytest.raises(ValueError) as je:
        jh.HistoryConfig(**kw)
    with pytest.raises(ValueError) as pe:
        ph.HistoryConfig(**kw)
    assert str(pe.value) == str(je.value)


def test_the_sampler_thread_samples_and_listeners_run():
    s = Scripted(MetricsRegistry)
    h = ph.MetricsHistory(s.reg, ph.HistoryConfig(
        sample_interval_s=0.05, rings=((0.05, 100),)))
    seen = []
    two = threading.Event()

    def listener(hist, t):
        seen.append(t)
        if len(seen) >= 2:
            two.set()

    h.add_listener(listener)
    h.start()
    try:
        assert two.wait(timeout=30), "the sampler thread never sampled"
    finally:
        h.stop()
    assert h.samples_total >= 2 and seen == sorted(seen)
