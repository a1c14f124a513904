"""The port's request tracing (obs/reqtrace.py) against the JAX package's.

`obs/reqtrace.py` is a copy of the JAX module (less its selfcheck, which
drives the binary frontend): context mint, encode and parse; the
tail-sampling policy; bounded buffers under a flood; per-process clock
offsets; the shard round trip and assembly — each checked on the same
inputs through both packages, exactly (the rows are the same numbers).
Over HTTP, the port's frontend echoes the client's `X-Trace-Id` and its
server records the admission, decode, queue, form, forward and depad
stages, as the JAX frontend and server do.
"""
import http.client
import json

import numpy as np
import pytest
import torch

from sparknet_tpu import zoo as jax_zoo
from sparknet_tpu.net_api import JaxNet
from sparknet_tpu.obs import reqtrace as jax_rt
from sparknet_tpu.serve.batcher import QueueFullError as JaxQueueFull
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
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        reqtrace.main(["--selfcheck"])


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
