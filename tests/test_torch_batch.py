"""Bulk inference (`sparknet_tpu_torch.batch`) against the JAX package's
`sparknet_tpu.batch`, and the serving satellites it rides on:

  - work-unit planning and the resumable manifest (manifest-LAST commit,
    resume identity and version pinned);
  - the object-store surface (atomic local writes, temp files invisible
    to listings; a fake `gs://` bucket);
  - the per-request named-output route on both front doors and through
    the router's proxy hop, unknown blobs rejected typed; journal rows
    carry priority and deadline; hedging skips the low class;
  - the driver end to end: resume exactly once, a dead replica is a
    retry (not a job failure), kill -9 of the driver against local and
    fake-`gs://` output stores;
  - parity: on one lenet replica with buckets (1,), window 1 and
    concurrency 1 (every row its own forward), the port's driver and the
    JAX driver write manifests equal apart from `job_id`, parts with
    equal arrays, JSONL rows with the same keys; their CLIs take the
    same options; and each package's driver completes against the other
    package's replica (the spkn frames are byte-equal,
    tests/test_torch_wire.py).

Lenet on the CPU, ephemeral ports.
"""
import http.client
import io
import json
import os
import signal
import socket
import subprocess
import sys
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from sparknet_tpu import zoo as jax_zoo
from sparknet_tpu.batch import BatchConfig as JaxBatchConfig
from sparknet_tpu.batch import BatchDriver as JaxBatchDriver
from sparknet_tpu.batch import driver as jax_driver
from sparknet_tpu.net_api import JaxNet
from sparknet_tpu.serve import BinaryFrontend as JaxBinaryFrontend
from sparknet_tpu.serve import InferenceServer as JaxServer
from sparknet_tpu.serve import ServeConfig as JaxServeConfig

from sparknet_tpu_torch import zoo
from sparknet_tpu_torch.batch import (BatchConfig, BatchDriver,
                                      load_manifest, store)
from sparknet_tpu_torch.batch import driver as port_driver
from sparknet_tpu_torch.batch import manifest as mf
from sparknet_tpu_torch.batch.driver import UnitFailedError
from sparknet_tpu_torch.net_api import TorchNet
from sparknet_tpu_torch.serve import (BinaryFrontend, HttpFrontend,
                                      InferenceServer, ModelRouter,
                                      RouterConfig, ServeConfig,
                                      binary_infer, http_infer)
from sparknet_tpu_torch.serve.http_frontend import (NPZ_CONTENT_TYPE,
                                                    _encode_npz)
from sparknet_tpu_torch.utils.logger import Logger

from fake_stores import bucket_store

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(i: int) -> dict:
    r = np.random.default_rng(9000 + i)
    return {"data": r.standard_normal((28, 28, 1)).astype(np.float32)}


def _input_npz(path, n: int) -> str:
    r = np.random.default_rng(7)
    np.savez(str(path),
             data=r.standard_normal((n, 28, 28, 1)).astype(np.float32))
    return str(path)


def _port_net():
    return TorchNet(zoo.lenet(batch=4), device="cpu")


@pytest.fixture(scope="module")
def served():
    """One port lenet replica behind both front doors, shared per
    module."""
    cfg = ServeConfig(max_batch=4, max_wait_ms=2.0, buckets=(1, 4),
                      outputs=("prob",), metrics_every_batches=0)
    srv = InferenceServer(_port_net(), cfg)
    srv.start()
    bfe = BinaryFrontend(srv, port=0)
    hfe = HttpFrontend(srv, port=0)
    yield srv, bfe, hfe
    bfe.stop()
    hfe.stop()
    srv.stop()


def _addr(fe) -> str:
    return f"{fe.address[0]}:{fe.address[1]}"


def _dead_addr() -> str:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()  # nothing listens here now
    return addr


# -- manifest -----------------------------------------------------------------

def test_plan_units_disjoint_cover_ragged():
    units = mf.plan_units(20, 6)
    assert units == [(0, 6), (6, 12), (12, 18), (18, 20)]
    with pytest.raises(ValueError):
        mf.plan_units(0, 6)
    with pytest.raises(ValueError):
        mf.plan_units(6, 0)


def test_manifest_roundtrip_pending_and_done(tmp_path):
    m = mf.new_manifest("j1", "in.npz", 20, 6, "m", ("fc1",))
    assert m["n_units"] == 4 and not m["done"]
    assert mf.pending_units(m) == \
        [(0, 0, 6), (1, 6, 12), (2, 12, 18), (3, 18, 20)]
    mf.record_unit(m, 1, 6, 12, 123, "r1", 1)
    assert not m["done"]
    assert [u for u, _, _ in mf.pending_units(m)] == [0, 2, 3]
    for uid, lo, hi in mf.pending_units(m):
        mf.record_unit(m, uid, lo, hi, 1, "r1", 1)
    assert m["done"]
    mf.save_manifest(str(tmp_path), m)
    assert mf.load_manifest(str(tmp_path)) == m
    assert mf.load_manifest(str(tmp_path / "nowhere")) is None
    # the bytes are the JAX package's
    from sparknet_tpu.batch import manifest as jax_mf
    jax_mf.save_manifest(str(tmp_path / "jax"), m)
    assert (tmp_path / "jax" / mf.MANIFEST_NAME).read_bytes() == \
        (tmp_path / mf.MANIFEST_NAME).read_bytes()


def test_manifest_resume_identity_pinned():
    m = mf.new_manifest("j1", "in.npz", 20, 6, "m", ("fc1",))
    mf.check_resume(m, "in.npz", 20, 6, "m", ("fc1",))  # same job: fine
    for bad in (("OTHER.npz", 20, 6, "m", ("fc1",)),
                ("in.npz", 21, 6, "m", ("fc1",)),
                ("in.npz", 20, 7, "m", ("fc1",)),
                ("in.npz", 20, 6, "m2", ("fc1",)),
                ("in.npz", 20, 6, "m", ("fc2",))):
        with pytest.raises(ValueError, match="resume"):
            mf.check_resume(m, *bad)


def test_manifest_version_pinned(tmp_path):
    store.write_bytes(str(tmp_path / mf.MANIFEST_NAME),
                      json.dumps({"version": 999}).encode())
    with pytest.raises(ValueError, match="version"):
        mf.load_manifest(str(tmp_path))


# -- store --------------------------------------------------------------------

def test_store_local_roundtrip_and_tmp_invisible(tmp_path):
    url = str(tmp_path / "a" / "b.bin")
    assert not store.exists(url)
    store.write_bytes(url, b"xyz")
    assert store.exists(url) and store.read_bytes(url) == b"xyz"
    (tmp_path / "a" / ".tmp-torn").write_bytes(b"partial")
    assert store.list_names(str(tmp_path / "a")) == ["b.bin"]
    store.delete(url)
    store.delete(url)  # idempotent
    assert not store.exists(url)
    assert store.list_names(str(tmp_path / "missing")) == []


def test_store_gs_roundtrip():
    with bucket_store("gs") as (root, _srv):
        url = store.join(root, "job", "part-00000.npz")
        assert store.is_bucket(url)
        assert not store.exists(url)
        store.write_bytes(url, b"npzbytes")
        assert store.exists(url)
        assert store.read_bytes(url) == b"npzbytes"
        assert store.list_names(store.join(root, "job")) == \
            ["part-00000.npz"]
        store.delete(url)
        assert not store.exists(url)


# -- the named-output route ---------------------------------------------------

def test_outputs_route_on_both_frontends(served):
    """fc1 by name over both wires: exactly that blob, bit-equal (one
    replica, one bucket, raw f32 both ways); no outputs = the lane's
    configured default."""
    _, bfe, hfe = served
    x = _example(0)
    hurl = f"http://{hfe.address[0]}:{hfe.address[1]}"
    out_b = binary_infer(bfe.address, "default", x, deadline_s=30.0,
                         outputs=("fc1",))
    out_h = http_infer(hurl, "default", x, deadline_s=30.0,
                       outputs=("fc1",))
    assert set(out_b) == set(out_h) == {"fc1"}
    np.testing.assert_array_equal(out_b["fc1"], out_h["fc1"])
    assert set(binary_infer(bfe.address, "default", x,
                            deadline_s=30.0)) == {"prob"}


def test_outputs_route_json_body(served):
    _, _, hfe = served
    conn = http.client.HTTPConnection(*hfe.address, timeout=30)
    conn.request("POST", "/v1/models/default/infer",
                 body=json.dumps({
                     "inputs": {"data": _example(1)["data"].tolist()},
                     "outputs": ["fc2", "prob"]}),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    assert resp.status == 200, body
    assert set(body["outputs"]) == {"fc2", "prob"}


def test_unknown_output_blob_rejected_typed(served):
    _, bfe, hfe = served
    x = _example(2)
    with pytest.raises(ValueError, match="unknown output blob"):
        binary_infer(bfe.address, "default", x, deadline_s=30.0,
                     outputs=("not_a_blob",))
    conn = http.client.HTTPConnection(*hfe.address, timeout=30)
    conn.request("POST", "/v1/models/default/infer",
                 body=json.dumps({"inputs": {"data": x["data"].tolist()},
                                  "outputs": ["not_a_blob"]}),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    assert resp.status == 400
    assert body["error_kind"] == "bad_request"
    assert "not_a_blob" in body["error"]


def test_outputs_route_through_router_proxy_hop(served):
    _, bfe, _ = served
    router = ModelRouter(RouterConfig(workers=2))
    router.add_remote_replica("default",
                              f"spkn://127.0.0.1:{bfe.address[1]}")
    router.start()
    rfe = BinaryFrontend(router, port=0)
    try:
        out = binary_infer(rfe.address, "default", _example(3),
                           deadline_s=30.0, outputs=("fc1", "prob"))
        assert set(out) == {"fc1", "prob"}
        direct = binary_infer(bfe.address, "default", _example(3),
                              deadline_s=30.0, outputs=("fc1",))
        np.testing.assert_array_equal(out["fc1"], direct["fc1"])
    finally:
        rfe.stop()
        router.stop()


def test_journal_rows_pin_priority_and_deadline(served, tmp_path):
    srv, _, _ = served
    jpath = tmp_path / "journal.jsonl"
    journal = Logger(jsonl_path=str(jpath), echo=False)
    bfe = BinaryFrontend(srv, port=0, journal=journal)
    hfe = HttpFrontend(srv, port=0, journal=journal)
    try:
        binary_infer(bfe.address, "default", _example(4),
                     deadline_s=2.5, tenant="batch", priority="low")
        conn = http.client.HTTPConnection(*hfe.address, timeout=30)
        conn.request("POST", "/v1/models/default/infer",
                     body=_encode_npz(_example(5)),
                     headers={"Content-Type": NPZ_CONTENT_TYPE,
                              "Accept": NPZ_CONTENT_TYPE,
                              "X-Priority": "low",
                              "X-Deadline-Ms": "2500"})
        conn.getresponse().read()
        conn.close()
    finally:
        bfe.stop()
        hfe.stop()
        journal.close()
    rows = [json.loads(l) for l in jpath.read_text().strip().splitlines()]
    by_transport = {r["transport"]: r for r in rows}
    assert set(by_transport) == {"binary", "http"}
    for r in by_transport.values():
        assert r["priority"] == "low"
        assert r["deadline_ms"] == pytest.approx(2500.0)


def test_hedging_skips_low_priority():
    """Under a config where normal traffic is hedge-eligible on every
    request (min delay 0, budget 1.0), a low-priority flood never enters
    the hedge arm and leaves hedged flat."""
    reps = []
    for _ in range(2):
        s = InferenceServer(_port_net(), ServeConfig(
            model_name="m", max_batch=4, max_wait_ms=2.0,
            outputs=("prob",), metrics_every_batches=0))
        s.start()
        reps.append((s, BinaryFrontend(s, port=0)))
    router = ModelRouter(RouterConfig(workers=4, hedge=True,
                                      hedge_min_delay_ms=0.0,
                                      hedge_budget=1.0))
    for _, fe in reps:
        router.add_remote_replica("m", f"spkn://127.0.0.1:{fe.address[1]}")
    router.start()
    try:
        futs = [router.submit("m", _example(i), deadline_s=30.0)
                for i in range(16)]
        for f in futs:
            f.result(timeout=30.0)
        before = dict(router.status()["hedging"]["m"])
        assert before["routed"] == 16 and before["hedged"] > 0
        futs = [router.submit("m", _example(i), deadline_s=30.0,
                              priority="low") for i in range(16)]
        for f in futs:
            f.result(timeout=30.0)
        assert router.status()["hedging"]["m"] == before
    finally:
        router.stop()
        for s, fe in reps:
            fe.stop()
            s.stop()


# -- the driver ---------------------------------------------------------------

def _job_cfg(inp, out, addrs, cls=BatchConfig, **kw):
    base = dict(input=str(inp), output=str(out),
                replicas=list(addrs), outputs=("fc1",), unit_rows=6,
                window=4, concurrency=2, deadline_s=30.0,
                request_timeout_s=60.0)
    base.update(kw)
    return cls(**base)


def _assert_exactly_once(out_dir, n_rows, unit_rows, blob="fc1"):
    """The committed artifacts are the exactly-once proof: manifest
    ranges equal the plan, each part holds exactly its unit's rows."""
    m = load_manifest(str(out_dir))
    assert m is not None and m["done"]
    got = sorted((u["start"], u["stop"]) for u in m["units"].values())
    assert got == sorted(mf.plan_units(n_rows, unit_rows))
    total = 0
    for uid_s, u in m["units"].items():
        with np.load(os.path.join(str(out_dir),
                                  mf.part_name(int(uid_s)))) as z:
            assert z[blob].shape[0] == u["rows"]
            total += z[blob].shape[0]
    assert total == n_rows


def test_driver_end_to_end_and_resume(served, tmp_path):
    _, bfe, _ = served
    inp = _input_npz(tmp_path / "in.npz", 20)
    out = tmp_path / "out"
    res = BatchDriver(_job_cfg(inp, out, [_addr(bfe)])).run()
    assert res["done"] and res["units_this_run"] == 4
    assert res["rows_this_run"] == 20 and res["rows_per_s"] > 0
    _assert_exactly_once(out, 20, 6)
    res2 = BatchDriver(_job_cfg(inp, out, [_addr(bfe)])).run()
    assert res2["units_this_run"] == 0
    assert res2["units_skipped_resume"] == 4
    # an orphan part (a crash between the part and its manifest row) is
    # redone
    m = load_manifest(str(out))
    del m["units"]["2"]
    m["done"] = False
    mf.save_manifest(str(out), m)
    res3 = BatchDriver(_job_cfg(inp, out, [_addr(bfe)])).run()
    assert res3["units_this_run"] == 1 and res3["done"]
    _assert_exactly_once(out, 20, 6)


def test_driver_resume_identity_mismatch_fails_loudly(served, tmp_path):
    _, bfe, _ = served
    inp = _input_npz(tmp_path / "in.npz", 12)
    out = tmp_path / "out"
    BatchDriver(_job_cfg(inp, out, [_addr(bfe)], unit_rows=6)).run()
    with pytest.raises(ValueError, match="resume"):
        BatchDriver(_job_cfg(inp, out, [_addr(bfe)], unit_rows=4)).run()


def test_driver_cost_and_metrics_accounting(served, tmp_path):
    _, bfe, _ = served
    inp = _input_npz(tmp_path / "in.npz", 12)
    drv = BatchDriver(_job_cfg(inp, tmp_path / "out", [_addr(bfe)],
                               cost_per_replica_hour=3.6))
    res = drv.run()
    assert res["cost_usd"] > 0
    assert res["cost_per_million_embeddings"] == pytest.approx(
        res["cost_usd"] / (12 / 1e6), rel=2e-2)
    reg = drv.registry
    assert reg.counter("sparknet_batch_units_done_total").value() == 2
    assert reg.counter("sparknet_batch_rows_total").value() == 12
    assert reg.counter("sparknet_batch_output_bytes_total").value() == \
        res["output_bytes"] > 0
    assert reg.gauge("sparknet_batch_units_inflight").value() == 0


def test_driver_dead_replica_is_a_retry_not_a_job_failure(served,
                                                          tmp_path):
    _, bfe, _ = served
    inp = _input_npz(tmp_path / "in.npz", 24)
    drv = BatchDriver(_job_cfg(inp, tmp_path / "out",
                               [_dead_addr(), _addr(bfe)],
                               backoff_cap_s=0.05))
    res = drv.run()
    assert res["done"] and res["retries"] > 0
    assert int(drv._c_retries.value(kind="error") or 0) > 0
    _assert_exactly_once(tmp_path / "out", 24, 6)


def test_driver_all_replicas_dead_fails_named(tmp_path):
    inp = _input_npz(tmp_path / "in.npz", 6)
    with pytest.raises(UnitFailedError, match="hard failures"):
        BatchDriver(_job_cfg(inp, tmp_path / "out", [_dead_addr()],
                             max_attempts=2, backoff_cap_s=0.01)).run()


def test_driver_rejects_bad_config():
    with pytest.raises(ValueError):
        BatchConfig(input="x", output="y", replicas=[])
    with pytest.raises(ValueError):
        BatchConfig(input="x", output="y", replicas=["a:1"], unit_rows=0)
    with pytest.raises(ValueError):
        BatchConfig(input="x", output="y", replicas=["a:1"],
                    max_attempts=0)


# -- kill -9 chaos ------------------------------------------------------------

def _spawn_driver(inp, out, addrs):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-m", "sparknet_tpu_torch.batch.driver",
         "--input", str(inp), "--out", str(out),
         "--replicas", ",".join(addrs), "--outputs", "fc1",
         "--unit-rows", "6", "--window", "4", "--concurrency", "1",
         "--pace-s", "0.25", "--timeout-s", "60",
         "--deadline-ms", "30000"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, env=env)


def _kill_mid_job(proc, out_dir, min_units=1):
    """Wait for >= min_units committed units, then SIGKILL."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < 120.0:
        if proc.poll() is not None:
            pytest.fail("driver exited before the kill window")
        m = load_manifest(str(out_dir))
        if m is not None and len(m["units"]) >= min_units:
            break
        time.sleep(0.05)
    else:
        pytest.fail("driver never committed a unit to kill against")
    proc.send_signal(signal.SIGKILL)
    proc.wait(timeout=30.0)


@pytest.mark.chaos
def test_driver_kill9_resumes_exactly_once_local(served, tmp_path):
    _, bfe, _ = served
    inp = _input_npz(tmp_path / "in.npz", 48)
    out = tmp_path / "out"
    _kill_mid_job(_spawn_driver(inp, out, [_addr(bfe)]), out)
    partial = load_manifest(str(out))
    assert partial is not None and not partial["done"]
    done_before = len(partial["units"])
    assert 0 < done_before < partial["n_units"]
    res = BatchDriver(_job_cfg(inp, out, [_addr(bfe)])).run()
    assert res["done"]
    assert res["units_skipped_resume"] == done_before
    assert res["units_this_run"] == partial["n_units"] - done_before
    _assert_exactly_once(out, 48, 6)


@pytest.mark.chaos
def test_driver_kill9_resumes_exactly_once_fake_gs(served, tmp_path):
    """The same kill -9 contract with the parts and manifest in a fake
    gs:// bucket: the killed subprocess inherits the emulator env, the
    resuming in-process driver shares it."""
    _, bfe, _ = served
    inp = _input_npz(tmp_path / "in.npz", 48)
    with bucket_store("gs") as (root, _srv):
        out = store.join(root, "job-kill")
        _kill_mid_job(_spawn_driver(inp, out, [_addr(bfe)]), out)
        partial = load_manifest(out)
        assert partial is not None and not partial["done"]
        done_before = len(partial["units"])
        assert 0 < done_before < partial["n_units"]
        res = BatchDriver(_job_cfg(inp, out, [_addr(bfe)])).run()
        assert res["done"]
        assert res["units_skipped_resume"] == done_before
        m = load_manifest(out)
        got = sorted((u["start"], u["stop"]) for u in m["units"].values())
        assert got == sorted(mf.plan_units(48, 6))
        assert set(store.list_names(out)) == {mf.MANIFEST_NAME} | {
            mf.part_name(u) for u in range(m["n_units"])}


# -- parity with the JAX driver -----------------------------------------------

@pytest.fixture(scope="module")
def replicas():
    """One lenet replica of each package, buckets (1,): every row is its
    own forward. The port's net holds the JAX net's weights."""
    jnet = JaxNet(jax_zoo.lenet(batch=4), seed=4)
    tnet = _port_net()
    tnet.load_jax_params({l: {p: np.asarray(v) for p, v in lp.items()}
                          for l, lp in jnet.params.items()})
    kw = dict(max_batch=1, max_wait_ms=1.0, buckets=(1,),
              outputs=("prob",), metrics_every_batches=0)
    out = {}
    srv = InferenceServer(tnet, ServeConfig(**kw)).start()
    out["port"] = (srv, BinaryFrontend(srv, port=0))
    jsrv = JaxServer(jnet, JaxServeConfig(**kw))
    jsrv.start()
    out["jax"] = (jsrv, JaxBinaryFrontend(jsrv, port=0))
    yield {k: _addr(fe) for k, (_, fe) in out.items()}
    for s, fe in out.values():
        fe.stop()
        s.stop()


def _run_job(pkg, inp, out, addr, jsonl):
    cls, drv = ((BatchConfig, BatchDriver) if pkg == "port"
                else (JaxBatchConfig, JaxBatchDriver))
    return drv(_job_cfg(inp, out, [addr], cls=cls, outputs=("fc1", "prob"),
                        unit_rows=5, window=1, concurrency=1,
                        jsonl_path=str(jsonl))).run()


def _parts(out_dir, m):
    got = {}
    for uid in sorted(m["units"]):
        with np.load(os.path.join(str(out_dir),
                                  mf.part_name(int(uid)))) as z:
            got[uid] = {k: z[k] for k in z.files}
    return got


@pytest.mark.parametrize("replica", ["port", "jax"])
def test_both_drivers_write_the_same_job(replicas, tmp_path, replica):
    """Both packages' drivers against one replica (the port's, then the
    JAX package's: each driver also runs against the other package's
    replica): equal manifests apart from job_id, parts with equal arrays,
    summaries and JSONL rows with the same keys."""
    inp = _input_npz(tmp_path / "in.npz", 13)
    res, man, parts, rows = {}, {}, {}, {}
    for pkg in ("port", "jax"):
        out = tmp_path / f"out-{pkg}"
        jsonl = tmp_path / f"{pkg}.jsonl"
        res[pkg] = _run_job(pkg, inp, out, replicas[replica], jsonl)
        man[pkg] = load_manifest(str(out))
        parts[pkg] = _parts(out, man[pkg])
        rows[pkg] = [json.loads(l) for l in open(jsonl)]
        _assert_exactly_once(out, 13, 5)
        assert res[pkg]["done"] and res[pkg]["rows_this_run"] == 13
    assert man["port"]["job_id"] != man["jax"]["job_id"]
    for m in man.values():
        m.pop("job_id")
    assert man["port"] == man["jax"]
    assert parts["port"].keys() == parts["jax"].keys()
    for uid, blobs in parts["port"].items():
        assert blobs.keys() == {"fc1", "prob"} == parts["jax"][uid].keys()
        for k, v in blobs.items():
            assert np.array_equal(v, parts["jax"][uid][k]), (uid, k)
    assert res["port"].keys() == res["jax"].keys()
    keys = {pkg: sorted((r.get("event"), tuple(sorted(r))) for r in rs)
            for pkg, rs in rows.items()}
    assert keys["port"] == keys["jax"]
    assert [r["event"] for r in rows["port"]].count("batch_unit") == 3


def test_the_cli_takes_the_jax_cli_s_options():
    helps = {}
    for k, mod in (("port", port_driver), ("jax", jax_driver)):
        buf = io.StringIO()
        with redirect_stdout(buf), pytest.raises(SystemExit) as e:
            mod.main(["--help"])
        assert e.value.code == 0
        helps[k] = buf.getvalue()
    assert helps["port"] == helps["jax"]
    assert "--pace-s" in helps["port"] and "--replicas" in helps["port"]


def test_the_cli_runs_a_job_and_prints_its_summary(served, tmp_path,
                                                   capsys):
    _, bfe, _ = served
    inp = _input_npz(tmp_path / "in.npz", 8)
    rc = port_driver.main(["--input", inp, "--out", str(tmp_path / "out"),
                           "--replicas", f"spkn://{_addr(bfe)}",
                           "--outputs", "fc1", "--unit-rows", "4",
                           "--job-id", "j-cli"])
    assert rc == 0
    res = json.loads(capsys.readouterr().out)
    assert res["job_id"] == "j-cli" and res["done"]
    _assert_exactly_once(tmp_path / "out", 8, 4)
