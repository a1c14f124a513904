"""The port's telemetry surface against the JAX package, on the CPU:
heartbeats (`utils/heartbeat.py`), the pod view (`obs/pod.py`), the status
server (`obs/http.py`), device telemetry (`obs/device.py`), run metadata
(`obs/meta.py`) and the train loop's registry, status server, heartbeats
and pod endpoint (`apps/train_loop.py`).

Everything here is exact: the same inputs give equal records, families,
renders and pod views in both packages, with the fields that read the
wall clock (`ts`, `t`, `pid`, `age_s`, `staleness_s`, the straggler log's
`ts`) masked. The one-off differences are named where they are checked:
the port's device telemetry reads the card's allocator (no compile events,
no live-array count: ROADMAP A10) and its build-info labels name torch.
"""
import json
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from fake_stores import bucket_store
from sparknet_tpu.apps.train_loop import train as jax_train
from sparknet_tpu.data.dataset import ArrayDataset as JaxArrayDataset
from sparknet_tpu.obs import MetricsRegistry as JaxRegistry
from sparknet_tpu.obs import StatusServer as JaxStatusServer
from sparknet_tpu.obs import pod as jax_pod
from sparknet_tpu.utils import heartbeat as jax_hb
from sparknet_tpu.utils.config import ElasticConfig as JaxElasticConfig
from sparknet_tpu.utils.config import RunConfig as JaxRunConfig
from sparknet_tpu.utils.logger import Logger as JaxLogger
from sparknet_tpu.zoo import lenet as jax_lenet

from sparknet_tpu_torch import zoo
from sparknet_tpu_torch.apps.train_loop import train
from sparknet_tpu_torch.data import gcs, s3
from sparknet_tpu_torch.data.dataset import ArrayDataset
from sparknet_tpu_torch.obs import device as obs_device
from sparknet_tpu_torch.obs import meta
from sparknet_tpu_torch.obs import pod
from sparknet_tpu_torch.obs.http import StatusServer
from sparknet_tpu_torch.obs.registry import MetricsRegistry
from sparknet_tpu_torch.utils import heartbeat as hb
from sparknet_tpu_torch.utils.config import ElasticConfig, RunConfig
from sparknet_tpu_torch.utils.logger import Logger

torch.set_num_threads(2)
PKGS = {"port": (hb, pod, MetricsRegistry, StatusServer),
        "jax": (jax_hb, jax_pod, JaxRegistry, JaxStatusServer)}
CLOCK_KEYS = ("t", "ts", "pid", "age_s", "staleness_s")


def _mask(obj):
    """`obj` with every wall-clock field removed, recursively."""
    if isinstance(obj, dict):
        return {k: _mask(v) for k, v in obj.items() if k not in CLOCK_KEYS}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


# -- heartbeats ---------------------------------------------------------------

def _clear_port_caches():
    for m in (gcs, s3):
        m._CLIENTS.clear()
        m._SIZE_CACHE.clear()
        m._STAT_CACHE.clear()


@pytest.mark.parametrize("store", ["local", "gs", "s3"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_heartbeat_reads_the_same_in_both_packages(tmp_path, writer,
                                                     store):
    """One package writes (locally, or through the fake GCS or S3); both
    read the same fields."""
    def run(root):
        path = pod.worker_heartbeat_path(root, 3)
        w = PKGS[writer][0].HeartbeatWriter(path, interval_s=0.0)
        assert w.beat(7, status="spike", rollbacks=2, force=True, worker=3,
                      round_s=0.25, data_wait_s=0.01, membership_epoch=2,
                      n_members=4, last_loss=None)
        w.flush()
        got = {k: PKGS[k][0].read_heartbeat(path) for k in PKGS}
        assert got["port"]["role"] == "train" and got["port"]["step"] == 7
        assert got["port"]["age_s"] is not None and got["port"]["age_s"] < 60
        assert _mask(got["port"]) == _mask(got["jax"]) == {
            "role": "train", "step": 7, "status": "spike", "rollbacks": 2,
            "worker": 3, "round_s": 0.25, "data_wait_s": 0.01,
            "membership_epoch": 2, "n_members": 4, "last_loss": None}
        assert got["port"]["t"] == got["jax"]["t"]
        # the prefix lists the same worker in both packages
        assert pod.discover_worker_heartbeats(root) == \
            jax_pod.discover_worker_heartbeats(root) == {"3": path}

    if store == "local":
        run(str(tmp_path / "pod"))
        return
    with bucket_store(store) as (url, _):
        _clear_port_caches()
        try:
            run(f"{url}/pod")
        finally:
            _clear_port_caches()


def test_heartbeat_throttle_and_reads_are_the_jax_packages(tmp_path):
    seq = [dict(status="ok"), dict(status="ok"), dict(status="spike"),
           dict(status="spike"), dict(status="ok", force=True)]
    wrote = {}
    for k, (m, *_) in PKGS.items():
        w = m.HeartbeatWriter(str(tmp_path / k / "hb.json"), interval_s=60)
        wrote[k] = [w.beat(i, **kw) for i, kw in enumerate(seq)]
    assert wrote["port"] == wrote["jax"] == [True, False, True, False, True]
    for bad in ("[1, 2]", "{torn", ""):
        p = tmp_path / "bad.json"
        p.write_text(bad)
        assert hb.read_heartbeat(str(p)) is jax_hb.read_heartbeat(str(p))
    assert hb.read_heartbeat(str(tmp_path / "missing.json")) is None
    for rec in (None, {}, {"t": time.time() - 50}, {"age_s": 3.5},
                {"t": "x"}):
        a, b = hb.staleness_s(rec), jax_hb.staleness_s(rec)
        assert (a is None) == (b is None) and (a is None or abs(a - b) < 1)
    ids = ["10", "2", "b", "a", "1"]
    assert sorted(ids, key=hb.worker_sort_key) == \
        sorted(ids, key=jax_hb.worker_sort_key) == ["1", "2", "10", "a", "b"]


# -- exposition parse / merge / render ---------------------------------------

def _registry(cls, rounds, round_s, lat=(0.05,)):
    reg = cls()
    reg.counter("sparknet_train_rounds_total", "rounds").inc(rounds)
    reg.gauge("sparknet_train_round_seconds", "round").set(round_s)
    h = reg.histogram("sparknet_serve_request_latency_seconds", "lat",
                      buckets=(0.1, 1.0))
    for v in lat:
        h.observe(v)
    reg.counter("sparknet_health_rounds_total", "cls",
                labels=("cls",)).inc(rounds, cls="ok")
    reg.gauge("g", labels=("path", "worker")).set(1, path='a"b\\c\nd',
                                                  worker="x")
    return reg


def _families(fams):
    return {n: (f.kind, f.help, dict(f.samples), dict(f.hists))
            for n, f in fams.items()}


EXPOSITIONS = {
    "two_workers": lambda cls: {"0": _registry(cls, 10, 0.1),
                                "1": _registry(cls, 6, 0.4, (0.05, 5.0))},
    "kind_conflict": lambda cls: {"0": _kind(cls, "counter"),
                                  "1": _kind(cls, "gauge")},
    "one_worker_escapes": lambda cls: {"7": _registry(cls, 3, 2.5)},
}


def _kind(cls, kind):
    reg = cls()
    (reg.counter("m").inc(3) if kind == "counter" else reg.gauge("m").set(9))
    return reg


@pytest.mark.parametrize("case", sorted(EXPOSITIONS))
def test_exposition_parse_merge_render_are_the_jax_packages(case):
    texts = {k: {w: r.render_prometheus() for w, r in
                 EXPOSITIONS[case](PKGS[k][2]).items()} for k in PKGS}
    assert texts["port"] == texts["jax"]
    parsed = {k: {w: PKGS[k][1].parse_exposition(t) for w, t in
                  texts[k].items()} for k in PKGS}
    for w in parsed["port"]:
        assert _families(parsed["port"][w]) == _families(parsed["jax"][w])
    merged = {k: PKGS[k][1].merge_expositions(parsed[k]) for k in PKGS}
    assert _families(merged["port"]) == _families(merged["jax"])
    out = pod.render_exposition(merged["port"])
    assert out == jax_pod.render_exposition(merged["jax"])
    # the merged text parses back to itself
    assert pod.render_exposition(pod.parse_exposition(out)) == out


@pytest.mark.parametrize("times", [
    {"0": 0.1, "1": 1.0}, {"0": 0.1, "1": 0.11}, {"0": 1.0, "1": 1.0,
                                                  "2": 10.0},
    {"0": 1.0, "1": 1.0, "2": 1.0}, {"3": 0.5}, {},
    {str(i): 1.0 + 0.01 * i for i in range(9)} | {"9": 4.0}])
def test_flag_stragglers_is_the_jax_packages(times):
    assert pod.flag_stragglers(times) == jax_pod.flag_stragglers(times)
    kw = dict(thresh_sigma=2.0, rel_floor=0.1, two_worker_ratio=1.05)
    assert pod.flag_stragglers(times, **kw) == \
        jax_pod.flag_stragglers(times, **kw)


# -- the aggregator: file mode ----------------------------------------------

def _write(pod_dir, i, step=5, age=0.0, role="train", **kv):
    p = pod.worker_heartbeat_path(pod_dir, i)
    hb.HeartbeatWriter(p, role=role, interval_s=0.0).beat(step, force=True,
                                                          **kv)
    if age:
        rec = json.load(open(p))
        rec["t"] = time.time() - age
        json.dump(rec, open(p, "w"))
    return p


def _file_pod(pod_dir, case):
    if case == "straggler":
        for i, rs in enumerate((0.1, 0.1, 1.5)):
            _write(pod_dir, i, round_s=rs, data_wait_s=0.001, last_loss=1.0)
    elif case == "stale":
        _write(pod_dir, 0, round_s=0.1)
        _write(pod_dir, 1, round_s=0.1, age=3600)
        _write(pod_dir, 2, status="done", round_s=0.1)
    elif case == "epoch":
        _write(pod_dir, 0, 7, round_s=0.1, membership_epoch=2, n_members=3)
        _write(pod_dir, 1, 6, round_s=0.1, membership_epoch=1, n_members=4)
        _write(pod_dir, 2, 6, status="resize", round_s=0.3, rollbacks=1)
    elif case == "serve_rows":
        _write(pod_dir, 0, 7, round_s=0.1)
        _write(pod_dir, 1, 42, role="serve", models={
            "mnist": {"step": 42, "freshness_s": 3.25, "step_lag": 1,
                      "queue_depth": 3, "p99_ms": 8.5, "requests_ok": 100,
                      "requests_shed": 2, "swaps": 1,
                      "slow_request": {"ms": 12, "stage": "fwd",
                                       "trace": "abcdef0123"},
                      "slo_budget_remaining": 0.5,
                      "slo_firing": ["mnist:avail:page"]}})


@pytest.mark.parametrize("case", ["straggler", "stale", "epoch",
                                  "serve_rows", "vanished"])
def test_file_mode_pod_view_is_the_jax_packages(tmp_path, case):
    pod_dir = str(tmp_path / "pod")
    aggs = {k: PKGS[k][1].PodAggregator(pod_dir=pod_dir, min_refresh_s=0.0,
                                        stale_after_s=60.0) for k in PKGS}
    if case == "vanished":
        for i in range(3):
            _write(pod_dir, i, 4, round_s=0.1)
        for a in aggs.values():
            a.pod_status()
        os.remove(pod.worker_heartbeat_path(pod_dir, 1))
    else:
        _file_pod(pod_dir, case)
    status = {k: a.pod_status() for k, a in aggs.items()}
    assert _mask(status["port"]) == _mask(status["jax"])
    assert pod.format_pod_table(status["jax"]) == \
        jax_pod.format_pod_table(status["jax"])
    assert aggs["port"].render() == aggs["jax"].render()
    assert aggs["port"].healthz() == aggs["jax"].healthz()
    expect = {"straggler": lambda s: s["stragglers"] == ["2"],
              "stale": lambda s: s["candidate_dead"] == ["1"],
              "epoch": lambda s: s["membership_epoch"] == 2,
              "serve_rows": lambda s: "models" in s["workers"][1],
              "vanished": lambda s: s["candidate_dead"] == ["1"]}
    assert expect[case](status["port"]), status["port"]


# -- the aggregator: http mode ------------------------------------------------

HTTP_CASES = ("straggler", "clean", "dead_worker", "hung_loop")


@pytest.mark.parametrize("case", HTTP_CASES)
def test_http_mode_pod_view_is_the_jax_packages(case):
    vitals = [{"role": "train", "round": 10, "status": "ok", "loss": 1.0,
               "round_s": 0.1, "data_wait_s": 0.001, "rollbacks": 0},
              {"role": "train", "round": 9, "status": "ok", "loss": 1.2,
               "round_s": 1.0, "data_wait_s": 0.6, "rollbacks": 0}]
    if case == "clean":
        vitals[1]["round_s"] = 0.1
    if case == "hung_loop":
        vitals[0]["beat_ts"] = time.time()
        vitals[1]["beat_ts"] = time.time() - 3600
    regs = [_registry(MetricsRegistry, 10, 0.1),
            _registry(MetricsRegistry, 9, vitals[1]["round_s"])]
    servers = [StatusServer(0, reg, status=(lambda v=v: dict(v)))
               for reg, v in zip(regs, vitals)]
    try:
        urls = {str(i): f"http://{s.address[0]}:{s.address[1]}"
                for i, s in enumerate(servers)}
        if case == "dead_worker":
            urls["2"] = "http://127.0.0.1:1/"
        status, text = {}, {}
        for k in PKGS:
            a = PKGS[k][1].PodAggregator(workers=urls, min_refresh_s=0.0,
                                         stale_after_s=60.0, timeout_s=2.0)
            status[k], text[k] = a.pod_status(), a.render()
        for s in status.values():  # the connection errors name the port
            for w in s["workers"]:
                w.pop("error", None)
        assert _mask(status["port"]) == _mask(status["jax"])
        assert text["port"] == text["jax"]
        if case == "straggler":
            assert status["port"]["stragglers"] == ["1"]
            assert 'sparknet_train_rounds_total{worker="pod"} 19' in \
                text["port"]
    finally:
        for s in servers:
            s.stop()


def test_the_pod_endpoint_serves_what_the_jax_one_serves(tmp_path):
    pod_dir = str(tmp_path / "pod")
    _file_pod(pod_dir, "straggler")
    got = {}
    for k in PKGS:
        agg = PKGS[k][1].PodAggregator(pod_dir=pod_dir, min_refresh_s=0.0)
        srv = agg.serve(0)
        try:
            base = f"http://{srv.address[0]}:{srv.address[1]}"
            m = urllib.request.urlopen(base + "/metrics", timeout=10)
            got[k] = {
                "pod": json.loads(urllib.request.urlopen(
                    base + "/pod/status", timeout=10).read()),
                "status": json.loads(urllib.request.urlopen(
                    base + "/status", timeout=10).read()),
                "healthz": json.loads(urllib.request.urlopen(
                    base + "/healthz", timeout=10).read()),
                "type": m.headers["Content-Type"],
                "metrics": m.read().decode()}
        finally:
            agg.stop()
    assert _mask(got["port"]) == _mask(got["jax"])
    assert got["port"]["pod"]["stragglers"] == ["2"]


def test_the_status_server_routes_like_the_jax_one():
    def ts(path):
        if "bad" in path:
            raise ValueError("bad query")
        return {"path": path}

    got = {}
    for k in PKGS:
        reg = PKGS[k][2]()
        reg.counter("c").inc(2)
        srv = PKGS[k][3](0, reg, healthz=lambda: (False, {"why": "x"}),
                         status=lambda: {"round": 3},
                         routes={"/pod": lambda: {"a": 1}})
        srv.add_route("/timeseries", ts)
        base = f"http://{srv.address[0]}:{srv.address[1]}"
        out = {}
        try:
            for path in ("/metrics", "/healthz", "/status", "/pod/x",
                         "/timeseries?name=a", "/timeseries?bad=1",
                         "/nothing"):
                try:
                    r = urllib.request.urlopen(base + path, timeout=10)
                    out[path] = (r.status, r.read().decode())
                except urllib.error.HTTPError as e:
                    out[path] = (e.code, e.read().decode())
        finally:
            srv.stop()
        got[k] = out
    assert got["port"] == got["jax"]
    assert got["port"]["/healthz"][0] == 503
    assert got["port"]["/timeseries?bad=1"][0] == 400


# -- the console --------------------------------------------------------------

def test_podview_selfcheck(capsys):
    assert pod.main(["--selfcheck"]) == 0
    assert "FAIL" not in capsys.readouterr().out


def test_podview_module_runs_as_a_command(tmp_path):
    pod_dir = str(tmp_path / "pod")
    _file_pod(pod_dir, "straggler")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    out = {}
    for name, mod in (("port", "sparknet_tpu_torch.obs.pod"),
                      ("jax", "sparknet_tpu.obs.pod")):
        p = subprocess.run([sys.executable, "-m", mod, "--pod-dir", pod_dir,
                            "--json"], env=env, capture_output=True,
                           text=True, timeout=240)
        assert p.returncode == 0, p.stderr[-2000:]
        out[name] = json.loads(p.stdout)
    assert _mask(out["port"]) == _mask(out["jax"])
    assert out["port"]["stragglers"] == ["2"]
    p = subprocess.run([sys.executable, "-m", "sparknet_tpu_torch.obs.pod",
                        "--selfcheck"], env=env, capture_output=True,
                       text=True, timeout=240)
    assert p.returncode == 0 and "straggler attribution" in p.stdout
    p = subprocess.run(
        [sys.executable, "-c",
         "import sys, sparknet_tpu_torch.obs.pod as m; "
         "m.main(['--pod-dir', sys.argv[1]]); "
         "print(sorted(k for k in sys.modules if k == 'jax' "
         "or k.startswith('sparknet_tpu.')))", pod_dir],
        env=env, capture_output=True, text=True, timeout=240)
    assert p.returncode == 0 and p.stdout.strip().endswith("[]"), p.stdout


# -- device telemetry and run metadata ----------------------------------------

def test_device_telemetry_leaves_the_cpu_unset():
    reg = MetricsRegistry()
    tel = obs_device.DeviceTelemetry(reg)
    tel.sample()
    obs_device.DeviceTelemetry(reg, devices=[torch.device("cpu")]).sample()
    snap = reg.snapshot()
    for name in ("sparknet_device_hbm_bytes_in_use",
                 "sparknet_device_hbm_peak_bytes",
                 "sparknet_device_hbm_bytes_reserved",
                 "sparknet_device_hbm_bytes_limit"):
        assert snap[name]["values"] == {}, name


def test_device_telemetry_reads_the_allocator_stats(monkeypatch):
    stats = {"allocated_bytes.all.current": 1024,
             "allocated_bytes.all.peak": 4096,
             "reserved_bytes.all.current": 8192}

    class Props:
        total_memory = 1 << 30

    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d: stats)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: Props)
    reg = MetricsRegistry()
    obs_device.DeviceTelemetry(reg, devices=[torch.device("cuda", 3)]
                               ).sample()
    text = reg.render_prometheus()
    assert 'sparknet_device_hbm_bytes_in_use{device="cuda:3"} 1024' in text
    assert 'sparknet_device_hbm_peak_bytes{device="cuda:3"} 4096' in text
    assert 'sparknet_device_hbm_bytes_reserved{device="cuda:3"} 8192' in text
    assert 'sparknet_device_hbm_bytes_limit{device="cuda:3"} 1073741824' \
        in text

    def boom(d):
        raise RuntimeError("no stats")
    monkeypatch.setattr(torch.cuda, "memory_stats", boom)
    obs_device.DeviceTelemetry(reg, devices=[torch.device("cuda", 3)]
                               ).sample()  # a failed read is a skip


def test_run_metadata_names_torch_and_the_device():
    m = meta.run_metadata()
    assert m["torch_version"] == torch.__version__
    assert m["backend"] in ("cuda", "cpu") and m["device_kind"]
    assert m["git_rev"] == meta.git_rev() != ""
    reg = MetricsRegistry()
    meta.register_build_info(reg)
    (labels, v), = reg.snapshot()["sparknet_build_info"]["values"].items()
    names = reg.snapshot()["sparknet_build_info"]["labels"]
    assert v == 1 and dict(zip(names, labels))["torch_version"] == \
        torch.__version__
    assert "jax_version" not in names


# -- the train loop's surface ------------------------------------------------

#: families only the JAX loop registers: the compile-event record, the
#: jitted round's cache size and the live jax array count, which have no
#: eager counterpart (ROADMAP A10)
JAX_ONLY = {"sparknet_compile_events_total", "sparknet_compile_seconds",
            "sparknet_train_round_compiled_variants",
            "sparknet_device_live_arrays"}
#: the caching allocator's reserved bytes, which XLA does not report
PORT_ONLY = {"sparknet_device_hbm_bytes_reserved"}

LOOP_CASES = {
    "pod": dict(status_port=0, pod_port=0),
    "elastic": dict(status_port=0, pod_port=0, heartbeat_path="hb.json",
                    checkpoint_dir="ck", checkpoint_every=2,
                    elastic=dict(enabled=True, expected_workers=1,
                                 poll_interval_s=0.0, tau_adapt=True)),
}


@pytest.fixture(scope="module")
def loop_runs(tmp_path_factory):
    """The JAX and the port train loop under each case's config: lenet,
    b16, τ 2, 3 rounds; /metrics, /status, /healthz and the pod view
    scraped at round 2."""
    r = np.random.default_rng(0)
    data = {"data": r.standard_normal((128, 1, 28, 28)).astype(np.float32),
            "label": r.integers(0, 10, (128, 1)).astype(np.int32)}
    out = {}
    for case, kw in LOOP_CASES.items():
        for k in PKGS:
            root = str(tmp_path_factory.mktemp(f"{case}_{k}"))
            kw2 = dict(kw, pod_dir=os.path.join(root, "pod"))
            for path_key in ("heartbeat_path", "checkpoint_dir"):
                if path_key in kw2:
                    kw2[path_key] = os.path.join(root, kw2[path_key])
            el = kw2.pop("elastic", None)
            common = dict(model="lenet", local_batch=16, tau=2, max_rounds=3,
                          eval_every=0, workdir=root, heartbeat_every_s=0.0,
                          **kw2)
            if k == "port":
                cfg = RunConfig(**common, elastic=el and ElasticConfig(**el))
            else:
                cfg = JaxRunConfig(n_devices=1, trainer_impl="shard_map",
                                   **common,
                                   elastic=el and JaxElasticConfig(**el))
            scraped = {}

            def hook(rnd, state, cfg=cfg, scraped=scraped):
                if rnd != 2:
                    return
                # both loops flush on a collector thread: wait (bounded)
                # until this worker's first flush reached the pod view
                deadline = time.monotonic() + 60
                host, port = cfg.pod_address
                while time.monotonic() < deadline:
                    s = json.loads(urllib.request.urlopen(
                        f"http://{host}:{port}/pod/status",
                        timeout=10).read())
                    if s["workers"] and \
                            s["workers"][0]["round_s"] is not None:
                        break
                    time.sleep(0.05)
                host, port = cfg.status_address
                base = f"http://{host}:{port}"
                for path in ("/metrics", "/status", "/healthz"):
                    scraped[path] = urllib.request.urlopen(
                        base + path, timeout=10).read().decode()
                host, port = cfg.pod_address
                scraped["pod"] = json.loads(urllib.request.urlopen(
                    f"http://{host}:{port}/pod/status", timeout=10).read())

            log_kw = dict(echo=False,
                          jsonl_path=os.path.join(root, "m.jsonl"))
            if k == "port":
                train(cfg, zoo.lenet(batch=16), ArrayDataset(data), None,
                      logger=Logger(**log_kw), round_hook=hook, device="cpu")
            else:
                jax_train(cfg, jax_lenet(batch=16), JaxArrayDataset(data),
                          None, logger=JaxLogger(**log_kw), round_hook=hook)
            out[(case, k)] = {"cfg": cfg, "scraped": scraped, "root": root}
    return out


def _family_names(text):
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")}


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_the_loop_s_metric_families_are_the_jax_loop_s(loop_runs, case):
    port = _family_names(loop_runs[(case, "port")]["scraped"]["/metrics"])
    jax = _family_names(loop_runs[(case, "jax")]["scraped"]["/metrics"])
    assert port == (jax - JAX_ONLY) | PORT_ONLY, (port ^ jax)
    assert "sparknet_train_round_seconds" in port
    if case == "elastic":
        assert {"sparknet_pod_membership_epoch", "sparknet_pod_members",
                "sparknet_heartbeat_beats_total",
                "sparknet_checkpoint_writes_total"} <= port


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_the_loop_s_status_and_pod_view_are_the_jax_loop_s(loop_runs, case):
    got = {k: loop_runs[(case, k)]["scraped"] for k in PKGS}
    for path in ("/status", "/healthz"):
        a, b = (json.loads(got[k][path]) for k in PKGS)
        assert set(a) == set(b), (path, set(a) ^ set(b))
        # the flushed round at the scrape depends on the collector
        # thread's timing in both loops: its key, not its value
        assert a["role"] == b["role"] == "train" and a["round"] in (0, 1, 2)
        assert set(a.get("phase_means", {})) <= \
            set(b.get("phase_means", {})) | {"h2d_mean_s",
                                             "dispatch_mean_s"}
    pods = {k: got[k]["pod"] for k in PKGS}
    assert set(pods["port"]) == set(pods["jax"])
    assert pods["port"]["n_workers"] == pods["jax"]["n_workers"] == 1
    w = {k: pods[k]["workers"][0] for k in PKGS}
    assert set(w["port"]) == set(w["jax"])
    assert w["port"]["worker"] == "0" and w["port"]["alive"]
    assert w["port"]["round_s"] is not None
    assert pods["port"]["membership_epoch"] == pods["jax"]["membership_epoch"]


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_the_loop_s_heartbeats_have_the_jax_schema(loop_runs, case):
    recs = {}
    for k in PKGS:
        cfg = loop_runs[(case, k)]["cfg"]
        recs[k] = [json.load(open(pod.worker_heartbeat_path(cfg.pod_dir,
                                                            0)))]
        if cfg.heartbeat_path:
            recs[k].append(json.load(open(cfg.heartbeat_path)))
    for a, b in zip(recs["port"], recs["jax"]):
        assert set(a) == set(b), set(a) ^ set(b)
        assert (a["role"], a["status"], a["step"]) == \
            (b["role"], b["status"], b["step"]) == ("train", "done", 3)
    assert recs["port"][0]["worker"] == 0
    assert recs["port"][0]["round_s"] is not None
