"""The port's request tracing (obs/reqtrace.py) against the JAX package's.

`obs/reqtrace.py` is a copy of the JAX module: context mint, encode and
parse; the tail-sampling policy; bounded buffers under a flood;
per-process clock offsets; the shard round trip and assembly — each checked on the same
inputs through both packages, exactly (the rows are the same numbers).
Over HTTP, the port's frontend echoes the client's `X-Trace-Id` and its
server records the admission, decode, queue, form, forward and depad
stages, as the JAX frontend and server do. Over the binary wire the
server's request row carries the client's span id and the same stages,
with the client's `wire:binary` span, as in the JAX package; a router
fronted directly mints the context and its proxy hop joins the same
trace; a hedged request's server rows carry leg=primary and leg=hedge
once each (both legs held at gates until both have arrived, so the hedge
fires without timing). The live two-process selfcheck
(`python -m sparknet_tpu_torch.obs.reqtrace --selfcheck`) assembles one
trace across a router here and a replica in a child process.
"""
import http.client
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from sparknet_tpu import zoo as jax_zoo
from sparknet_tpu.net_api import JaxNet
from sparknet_tpu.obs import reqtrace as jax_rt
from sparknet_tpu.serve.batcher import QueueFullError as JaxQueueFull
from sparknet_tpu.serve.binary_frontend import \
    BinaryFrontend as JaxBinaryFrontend
from sparknet_tpu.serve.binary_frontend import \
    binary_infer as jax_binary_infer
from sparknet_tpu.serve.router import ModelRouter as JaxRouter
from sparknet_tpu.serve.router import RouterConfig as JaxRouterConfig
from sparknet_tpu.serve.http_frontend import HttpFrontend as JaxFrontend
from sparknet_tpu.serve.server import InferenceServer as JaxServer
from sparknet_tpu.serve.server import ServeConfig as JaxServeConfig

from sparknet_tpu_torch import zoo
from sparknet_tpu_torch.net_api import TorchNet
from sparknet_tpu_torch.obs import reqtrace
from sparknet_tpu_torch.serve.admission import TenantLimitError
from sparknet_tpu_torch.serve.batcher import (DeadlineExpiredError,
                                              QueueFullError)
from sparknet_tpu_torch.serve.http_frontend import (NPZ_CONTENT_TYPE,
                                                    HttpFrontend,
                                                    NoReplicaError,
                                                    UnknownModelError,
                                                    _encode_npz)
from sparknet_tpu_torch.serve.binary_frontend import (BinaryFrontend,
                                                      binary_infer)
from sparknet_tpu_torch.serve.router import ModelRouter, RouterConfig
from sparknet_tpu_torch.serve.server import InferenceServer, ServeConfig

torch.set_num_threads(2)

MODS = {"port": reqtrace, "jax": jax_rt}


def test_context_mint_encode_parse_child():
    ctx = reqtrace.mint_context(sampled=True)
    assert len(ctx.trace_id) == 16 and len(ctx.span_id) == 8
    assert reqtrace.parse_context(ctx.encoded()) == ctx
    kid = ctx.child()
    assert kid.trace_id == ctx.trace_id and kid.span_id != ctx.span_id
    assert kid.sampled is True
    hedge = ctx.child(leg="hedge")
    assert hedge.leg == "hedge" and hedge.child().leg == "hedge"
    assert reqtrace.parse_context(hedge.encoded()).leg == "hedge"
    assert reqtrace.ctx_str(ctx) == ctx.encoded()
    assert reqtrace.ctx_str(None) is None
    # the wire form and the tolerant parse are the JAX package's
    for s in (ctx.encoded(), hedge.encoded(), "ABCDEF-12-1",
              "0123456789abcdef-01234567-0-primary", "aa-bb-1-" + "x" * 40,
              None, "", "xyz", "nothex!-00-1", "aa-bb", "aa-bb-7", 42,
              "a" * 33 + "-bb-1", "aa-" + "b" * 17 + "-0"):
        p, j = reqtrace.parse_context(s), jax_rt.parse_context(s)
        assert (p is None) == (j is None), s
        if p is not None:
            assert (p.trace_id, p.span_id, p.sampled, p.leg) == \
                (j.trace_id, j.span_id, j.sampled, j.leg)
            assert p.encoded() == j.encoded()


def test_outcome_mapping_walks_the_mro_as_the_jax_one_does():
    class SubQueueFull(QueueFullError):
        pass
    for exc, want in ((SubQueueFull("x"), "queue_full"),
                      (TenantLimitError("t"), "tenant_limit"),
                      (DeadlineExpiredError("d"), "deadline"),
                      (NoReplicaError("n"), "no_replica"),
                      (UnknownModelError("m"), "unknown_model"),
                      (TimeoutError(), "timeout"),
                      (ConnectionError(), "connection"),
                      (ValueError("?"), "error")):
        assert reqtrace.outcome_of(exc) == want
    assert jax_rt.outcome_of(JaxQueueFull("x")) == \
        reqtrace.outcome_of(QueueFullError("x"))


@pytest.mark.parametrize("k", sorted(MODS))
def test_tail_sampling_policy(k):
    rt = MODS[k]
    tr = rt.RequestTracer(head_sample=0.0, slow_min_n=4)
    # healthy + unsampled: forgotten
    assert tr.finish(tr.begin(rt.mint_context(), model="m"), "ok") is False
    # a typed shed: always captured
    rec = tr.begin(rt.mint_context(), model="m")
    assert tr.finish_exc(rec, TimeoutError("slow store")) is True
    row = [r for r in tr.drain_rows() if r["k"] == "r"][0]
    assert row["outcome"] == "timeout" and row["why"] == ["outcome"]
    # beyond the live windowed p95, the threshold read before this
    # observation joins the window
    for _ in range(16):
        tr.finish(tr.begin(rt.mint_context(), model="m"), "ok")
    slow = tr.begin(rt.mint_context(), model="m")
    slow["ts"] -= 2e6  # backdated 2 s
    assert tr.finish(slow, "ok") is True
    assert "slow" in [r for r in tr.drain_rows() if r["k"] == "r"][0]["why"]
    # the head-sample flag minted into the context
    rec = tr.begin(rt.mint_context(sampled=True), model="m")
    assert tr.finish(rec, "ok") is True
    assert "sampled" in [r for r in tr.drain_rows()
                         if r["k"] == "r"][0]["why"]
    assert tr.exemplars()["m"][-1]["outcome"] == "ok"
    assert tr.worst("m")["ms"] >= 2000.0
    assert tr.stats()["finished"] == 20


def test_bounded_buffers_account_drops_as_the_jax_tracer_does():
    stats = {}
    for k, rt in MODS.items():
        tr = rt.RequestTracer(head_sample=1.0, max_pending=64,
                              max_rows=128, flush_every=10 ** 9, seed=3)
        ctxs = [rt.TraceContext(trace_id=f"{i:016x}", span_id="0000000a")
                for i in range(300)]
        for ctx in ctxs:   # spans of traces that never finish
            tr.stage(ctx, "queue", 0.0, 1.0)
        st1 = tr.stats()
        assert st1["pending_spans"] <= 64
        assert st1["dropped_spans"] >= 300 - 64
        for i in range(300):
            ctx = rt.TraceContext(trace_id=f"{i + 1000:016x}",
                                  span_id="0000000b", sampled=True)
            tr.finish(tr.begin(ctx, model="m"), "ok")
        st2 = tr.stats()
        assert st2["buffered_rows"] <= 128 and st2["dropped_rows"] > 0
        assert st2["finished"] == 300
        rec = tr.begin(rt.mint_context(sampled=True), model="m")
        tr.drain_rows()
        assert tr.finish(rec, "ok") is True
        stats[k] = (st1, st2)
    assert stats["port"] == stats["jax"]


def _row(k, proc, span, ts_us, dur_us, **kw):
    base = {"k": k, "trace": "t" * 16, "span": span, "ts": ts_us,
            "dur": dur_us, "pid": 1, "proc": proc}
    if k == "r":
        base.update(root=False, model="m", transport="binary",
                    outcome="ok", why=["sampled"], stages={})
    else:
        base.update(name="wire:binary", kind="client")
    base.update(kw)
    return base


def test_clock_offsets_recover_a_synthetic_skew_as_the_jax_assembler():
    skew = 500_000.0
    rows = [_row("r", "router", "aaaa", 1_000.0, 60_000.0, root=True,
                 transport="router", stages={"queue": 1.0}),
            _row("s", "router", "bbbb", 5_000.0, 50_000.0),
            _row("r", "replica", "bbbb", 10_000.0 + skew, 40_000.0,
                 stages={"forward": 35.0, "queue": 2.0}),
            _row("r", "lonely", "cccc", 3.0, 4.0)]
    offs = reqtrace.clock_offsets(rows)
    assert offs == jax_rt.clock_offsets(rows)
    assert offs["router"] == 0.0 and offs["lonely"] == 0.0
    assert offs["replica"] == pytest.approx(-skew, abs=1.0)
    assert reqtrace.chrome_trace("t" * 16, rows, offs) == \
        jax_rt.chrome_trace("t" * 16, rows, offs)
    s = reqtrace.trace_summary("t" * 16, rows, offs)
    assert s == jax_rt.trace_summary("t" * 16, rows, offs)
    assert s["hops"] == 1 and s["wire_ms"] == pytest.approx(10.0)
    assert s["forward_ms"] == pytest.approx(35.0)
    assert s["dominant"] == "forward"


def test_shard_round_trip_loader_and_cli(tmp_path, capsys):
    tr = reqtrace.RequestTracer(out_dir=str(tmp_path / "shards"),
                                head_sample=1.0, proc="p/1")
    ctxs = []
    for i in range(3):
        ctx = tr.mint(sampled=True)
        rec = tr.begin(ctx, transport="http", model="m")
        tr.stage(ctx, "queue", rec["ts"], 10.0 * (i + 1), bucket=4)
        tr.stage(ctx, "forward", rec["ts"] + 10.0, 20.0)
        tr.finish(rec, "ok" if i else "deadline")
        ctxs.append(ctx)
    path = tr.flush()
    assert path.endswith(".jsonl") and "/" not in path.split("trace-")[1]
    with open(path, "a") as f:
        f.write("not json\n{\"k\": \"junk\"}\n")
    shards = [str(tmp_path / "shards")]
    rows = reqtrace.load_shards(shards)
    assert rows == jax_rt.load_shards(shards)
    assert {r["k"] for r in rows} == {"r", "s"}
    asm = reqtrace.assemble(rows)
    jasm = jax_rt.assemble(rows)
    assert set(asm) == {c.trace_id for c in ctxs}
    for tid in asm:
        assert asm[tid]["summary"] == jasm[tid]["summary"]
        assert asm[tid]["chrome"] == jasm[tid]["chrome"]
    assert asm[ctxs[2].trace_id]["summary"]["queue_ms"] == \
        pytest.approx(0.03)
    summaries = [t["summary"] for t in asm.values()]
    assert reqtrace.format_slowest(summaries) == \
        jax_rt.format_slowest(summaries)
    # the CLI: Chrome traces and the JSON table
    out = tmp_path / "chrome"
    assert reqtrace.main(shards + ["--out", str(out), "--json"]) == 0
    table = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {t["trace"] for t in table} == set(asm)
    assert len(list(out.glob("trace-*.json"))) == 3
    # --selfcheck runs the live two-process proof (a router here, a
    # replica behind the binary frontend in a child) and keeps its trace
    keep = tmp_path / "selfcheck"
    assert reqtrace.main(["--selfcheck", "--keep", str(keep),
                          "--device", "cpu"]) == 0
    assert "selfcheck OK" in capsys.readouterr().out
    assert len(list(keep.glob("trace-*.json"))) == 1


def test_request_tracing_context_manager_flushes(tmp_path):
    with reqtrace.request_tracing(str(tmp_path), head_sample=1.0,
                                  proc="cm") as tr:
        assert reqtrace.active() is tr
        ctx = tr.mint()
        tr.finish(tr.begin(ctx, model="m"), "ok")
    assert reqtrace.active() is None
    rows = reqtrace.load_shards([str(tmp_path)])
    assert [r["trace"] for r in rows] == [ctx.trace_id]


def _lenet_lanes():
    jnet = JaxNet(jax_zoo.lenet(batch=2), seed=1)
    tnet = TorchNet(zoo.lenet(batch=2), device="cpu")
    cfg = dict(max_batch=2, max_wait_ms=1.0, buckets=(1, 2),
               outputs=("prob",), metrics_every_batches=0)
    return {"port": (InferenceServer(tnet, ServeConfig(**cfg)),
                     HttpFrontend),
            "jax": (JaxServer(jnet, JaxServeConfig(**cfg)), JaxFrontend)}


def test_the_trace_header_is_echoed_over_http_with_the_jax_stages():
    x = {"data": np.ones((28, 28, 1), np.float32)}
    stages = {}
    for k, (srv, fe_cls) in _lenet_lanes().items():
        rt = MODS[k]
        with rt.request_tracing(None, head_sample=1.0, proc="t") as tr, \
                srv:
            fe = fe_cls(srv, port=0)
            try:
                ctx = tr.mint(sampled=True)
                conn = http.client.HTTPConnection(*fe.address, timeout=30)
                conn.request("POST", "/v1/models/default/infer",
                             body=_encode_npz(x),
                             headers={"Content-Type": NPZ_CONTENT_TYPE,
                                      "Accept": NPZ_CONTENT_TYPE,
                                      "X-Trace-Id": ctx.encoded()})
                resp = conn.getresponse()
                echoed = resp.getheader("X-Trace-Id")
                resp.read()
                # a shed is captured with its outcome and echoed too
                conn.request("POST", "/v1/models/nope/infer",
                             body=_encode_npz(x),
                             headers={"Content-Type": NPZ_CONTENT_TYPE})
                bad = conn.getresponse()
                bad_echo = bad.getheader("X-Trace-Id")
                bad.read()
                conn.close()
            finally:
                fe.stop()
            rows = tr.drain_rows()
        assert resp.status == 200 and echoed == ctx.encoded(), k
        assert bad.status == 404 and bad_echo is not None, k
        req = [r for r in rows if r["k"] == "r"]
        assert len(req) == 2, (k, req)
        ok = [r for r in req if r["trace"] == ctx.trace_id][0]
        assert ok["span"] == ctx.span_id and ok["transport"] == "http"
        assert [r["outcome"] for r in req if r is not ok] == \
            ["unknown_model"]
        stages[k] = set(ok["stages"])
    assert stages["port"] == stages["jax"]
    assert {"admission", "decode", "queue", "form", "forward",
            "depad"} <= stages["port"]


# -- the binary wire, the router, hedges --------------------------------------

def _rows_until(tr, pred, timeout=30.0):
    """The tracer's buffered rows once `pred(rows)` holds (completion
    callbacks may land just after the client's future resolves)."""
    deadline = time.monotonic() + timeout
    rows = []
    while time.monotonic() < deadline:
        rows = rows + tr.drain_rows()
        if pred(rows):
            return rows
        time.sleep(0.005)
    raise AssertionError(f"rows never satisfied the predicate: {rows}")


PKG = {"port": (InferenceServer, ServeConfig, BinaryFrontend, binary_infer,
                ModelRouter, RouterConfig),
       "jax": (JaxServer, JaxServeConfig, JaxBinaryFrontend,
               jax_binary_infer, JaxRouter, JaxRouterConfig)}


def _lenets():
    jnet = JaxNet(jax_zoo.lenet(batch=2), seed=1)
    tnet = TorchNet(zoo.lenet(batch=2), device="cpu")
    tnet.load_jax_params({l: {p: np.asarray(v) for p, v in lp.items()}
                          for l, lp in jnet.params.items()})
    return {"port": tnet, "jax": jnet}


_CFG = dict(max_batch=2, max_wait_ms=1.0, buckets=(1, 2), outputs=("prob",),
            metrics_every_batches=0)
_X = {"data": np.ones((28, 28, 1), np.float32)}


def test_the_trace_rides_the_binary_wire_as_in_the_jax_package():
    seen = {}
    for k, net in _lenets().items():
        srv_cls, cfg_cls, fe_cls, infer, _, _ = PKG[k]
        rt = MODS[k]
        with rt.request_tracing(None, head_sample=1.0, proc="t") as tr, \
                srv_cls(net, cfg_cls(**_CFG)) as srv:
            fe = fe_cls(srv, port=0)
            try:
                ctx = tr.mint(sampled=True)
                cli_rec = tr.begin(ctx, transport="cli")
                out = infer(fe.address, "default", _X, trace=ctx)
                tr.finish(cli_rec, "ok")
                assert np.asarray(out["prob"]).shape == (10,)
                rows = _rows_until(tr, lambda rs: any(
                    r["k"] == "r" and r["transport"] == "binary"
                    for r in rs))
            finally:
                fe.stop()
        req = [r for r in rows
               if r["k"] == "r" and r["transport"] == "binary"]
        assert len(req) == 1, k
        assert (req[0]["trace"], req[0]["span"], req[0]["outcome"]) == \
            (ctx.trace_id, ctx.span_id, "ok"), k
        wire_spans = [r for r in rows
                      if r["k"] == "s" and r.get("kind") == "client"]
        assert [(w["span"], w["name"]) for w in wire_spans] == \
            [(ctx.span_id, "wire:binary")], k
        seen[k] = {r["name"] for r in rows
                   if r["k"] == "s" and r.get("kind") == "server"}
    assert seen["port"] == seen["jax"]
    assert {"admission", "decode", "queue", "form", "forward",
            "reply"} <= seen["port"]


def test_a_router_mints_and_its_proxy_hop_joins_the_trace():
    shapes = {}
    for k, net in _lenets().items():
        srv_cls, cfg_cls, fe_cls, _, router_cls, rcfg_cls = PKG[k]
        rt = MODS[k]
        with rt.request_tracing(None, head_sample=1.0, proc="t") as tr, \
                srv_cls(net, cfg_cls(**_CFG)) as srv:
            fe = fe_cls(srv, port=0)
            router = router_cls(rcfg_cls(workers=2, hedge=False))
            router.add_remote_replica(
                "default", f"spkn://{fe.address[0]}:{fe.address[1]}")
            try:
                with router:
                    out = router.infer("default", _X, timeout=30.0)
                assert np.asarray(out["prob"]).shape == (10,)
                rows = _rows_until(
                    tr, lambda rs: sum(r["k"] == "r" for r in rs) >= 2)
            finally:
                fe.stop()
        req = [r for r in rows if r["k"] == "r"]
        assert len({r["trace"] for r in req}) == 1, k
        by_transport = {r["transport"]: r for r in req}
        assert set(by_transport) == {"router", "binary"}, k
        assert by_transport["router"]["root"] is True
        wire_spans = {r["span"] for r in rows
                      if r["k"] == "s" and r.get("kind") == "client"}
        assert by_transport["binary"]["span"] in wire_spans
        assert by_transport["binary"]["span"] != \
            by_transport["router"]["span"]
        shapes[k] = sorted(set(by_transport["router"]) |
                           set(by_transport["binary"]))
    assert shapes["port"] == shapes["jax"]


class _Gated:
    def __init__(self, inner):
        self._inner = inner
        self.gate = threading.Event()
        self.entered = threading.Event()

    def __getattr__(self, k):
        return getattr(self._inner, k)

    def forward(self, *a, **kw):
        self.entered.set()
        assert self.gate.wait(timeout=60), "the test never opened the gate"
        return self._inner.forward(*a, **kw)


def test_hedge_legs_tagged_exactly_once():
    """Both replicas hold their forwards on gates; with a zero hedge
    delay the request's primary leg enters one and its hedge the other;
    then both gates open. The server rows carry leg=primary and
    leg=hedge exactly once each, in one trace."""
    net = _lenets()["port"]
    nets = [_Gated(net), _Gated(net)]
    servers = [InferenceServer(n, ServeConfig(**_CFG)).start() for n in nets]
    fes = [BinaryFrontend(s, port=0) for s in servers]
    router = ModelRouter(RouterConfig(workers=4, hedge=True,
                                      hedge_budget=1.0,
                                      hedge_min_delay_ms=0.0))
    for fe in fes:
        router.add_remote_replica(
            "default", f"spkn://{fe.address[0]}:{fe.address[1]}")
    try:
        with reqtrace.request_tracing(None, head_sample=1.0,
                                      proc="t") as tr, router:
            fut = router.submit("default", _X, deadline_s=60.0)
            for n in nets:
                assert n.entered.wait(timeout=30)
            for n in nets:
                n.gate.set()
            assert np.asarray(fut.result(timeout=30)["prob"]).shape == (10,)

            def both_legs(rs):
                legs = [r.get("leg") for r in rs if r["k"] == "r"
                        and r["transport"] == "binary"]
                return "primary" in legs and "hedge" in legs
            rows = _rows_until(tr, both_legs)
    finally:
        for n in nets:
            n.gate.set()
        for fe, s in zip(fes, servers):
            fe.stop()
            s.stop()
    legs = [r.get("leg") for r in rows
            if r["k"] == "r" and r["transport"] == "binary"]
    assert sorted(legs) == ["hedge", "primary"], legs
    assert len({r["trace"] for r in rows if r["k"] == "r"}) == 1


def test_two_process_slow_request_assembles_one_trace(tmp_path):
    """The selfcheck, in this process: a router here proxies a slowed
    lenet request over the binary wire to a replica subprocess; the
    assembled trace crosses both processes with a matched wire hop and
    the forward (the planted 40 ms) dominating."""
    keep = str(tmp_path / "selfcheck")
    assert reqtrace._selfcheck(keep=keep, delay_ms=40.0, device="cpu") == 0
    rows = reqtrace.load_shards([keep + "/shards"])
    traces = reqtrace.assemble(rows)
    crossing = [t for t in traces.values() if t["summary"]["procs"] >= 2]
    assert crossing
    s = max(crossing, key=lambda t: t["summary"]["total_ms"])["summary"]
    assert s["hops"] >= 1
    assert s["forward_ms"] >= 20.0
    assert s["dominant"] == "forward"


def test_the_selfcheck_command_passes():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "sparknet_tpu_torch.obs.reqtrace",
         "--selfcheck", "--device", "cpu"], cwd=repo, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("selfcheck OK: trace ")
    assert "crossed 2 processes" in r.stdout


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a machine with no card")
def test_the_selfcheck_runs_on_the_card_unless_asked_for_the_cpu(tmp_path):
    # without --device the replica's net goes to the card: with no card
    # the selfcheck raises before it starts the child
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reqtrace.main(["--selfcheck", "--keep", str(tmp_path / "k")])
    assert not (tmp_path / "k").exists()
