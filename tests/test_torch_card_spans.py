"""The trainers' spans and their timing on the card (`obs/trace.py`), the
round records' card fields and period (`apps/train_loop.py`), and the
benchmark's readers of them (`portbench/metrics/`).

- With a tracer on, each step of both trainers is a `step` span (round,
  step) around `forward`, `backward` and `solver` spans that inherit its
  args, and each round has an `exchange` span (sync_sgd also one a step);
  `GraphNet._eval` makes one span a computed node, named by its op.
- `CardClock`: the anchor and lead arithmetic on a scripted event clock,
  the `card` lane, the anchor moving to the newest edge, the event pool.
- The loop with a card clock on a fake event clock (the CPU has no CUDA
  events): `card_*_ms`, `host_lead_ms` and `t_card_round_ms` in the
  records, `images_per_sec` read from the card's period, the card lane
  in the written trace.
- With no tracer: no span object, no `record_function`, no card event and
  no card field.
- The readers on synthetic records, None where the field is absent.
- On the card (`gpu`): the spans fill 80-100% of the round's card period,
  the host leads, the re-anchored clock places idle-card events within
  -50..150 us of their queueing over 60 s, and a profiler trace puts a
  step's kernels under its ranges.
"""
import json
import statistics
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import load
from sparknet_tpu_torch import zoo
from sparknet_tpu_torch.apps import train_loop
from sparknet_tpu_torch.apps.train_loop import train
from sparknet_tpu_torch.backend import GraphNet, build_mnist_graph
from sparknet_tpu_torch.data.dataset import ArrayDataset
from sparknet_tpu_torch.model.net import CompiledNet
from sparknet_tpu_torch.obs import trace
from sparknet_tpu_torch.parallel.graph_trainer import GraphTrainer
from sparknet_tpu_torch.parallel.mesh import init_data_group
from sparknet_tpu_torch.parallel.trainer import ParallelTrainer
from sparknet_tpu_torch.solver import SolverConfig
from sparknet_tpu_torch.utils.config import RunConfig
from sparknet_tpu_torch.utils.logger import Logger

torch.set_num_threads(2)
TAU, LB = 2, 4
CARD_FIELDS = ("card_forward_ms", "card_backward_ms", "card_solver_ms",
               "card_exchange_ms", "host_lead_ms")


class FakeEvent:
    """A timing event on a scripted card clock: `record` stamps the
    clock's time (ms), `elapsed_time` subtracts, as a CUDA event's."""

    made = 0

    def __init__(self, clock):
        FakeEvent.made += 1
        self.clock, self.t = clock, None

    def record(self, stream=None):
        self.t = self.clock()

    def elapsed_time(self, end):
        return end.t - self.t

    def synchronize(self):
        pass


def host_ms():
    """A card that reaches each event as the host queues it."""
    return time.perf_counter() * 1e3


@pytest.fixture(autouse=True)
def _no_tracer_left():
    yield
    trace.stop_tracing()


@pytest.fixture
def group(tmp_path):
    g = init_data_group("cpu", store_path=str(tmp_path / "store"), rank=0,
                        world_size=1)
    yield g
    g.close()


def _host_spans(tr):
    main = [e for e in tr.events() if e["ph"] == "X" and e["cat"] == "host"]
    return [(e["name"], e.get("args", {}), e["ts"], e["ts"] + e["dur"])
            for e in main]


def _inside(inner, outer):
    return outer[2] <= inner[2] and inner[3] <= outer[3]


def _lenet_round(seed):
    r = np.random.default_rng(seed)
    return {"data": r.standard_normal((TAU, LB, 28, 28, 1)).astype(
                np.float32),
            "label": r.integers(0, 10, (TAU, LB, 1)).astype(np.int32)}


@pytest.mark.parametrize("mode", ["local_sgd", "sync_sgd"])
def test_parallel_trainer_span_tree(group, mode):
    tau = TAU if mode == "local_sgd" else 1
    tr_ = ParallelTrainer(CompiledNet.compile(zoo.lenet(batch=LB)),
                          SolverConfig(base_lr=0.01, momentum=0.9), group,
                          tau=tau, mode=mode)
    state = tr_.init_state(0)
    tracer = trace.start_tracing()
    tracer.attach_card("cpu", new_event=lambda: FakeEvent(host_ms))
    for rnd in range(2):
        b = {k: v[:tau] for k, v in _lenet_round(rnd).items()}
        state, _ = tr_.train_round(state, b, (0, rnd))
    trace.stop_tracing()
    spans = _host_spans(tracer)
    steps = [s for s in spans if s[0] == "step"]
    assert [s[1] for s in steps] == [{"round": r, "step": t}
                                     for r in range(2) for t in range(tau)]
    per_step = ["forward", "backward"] + (
        ["exchange"] if mode == "sync_sgd" else []) + ["solver"]
    for st in steps:
        kids = [s for s in spans if s[0] != "step" and _inside(s, st)]
        assert sorted(s[0] for s in kids) == sorted(per_step)
        assert all(s[1] == st[1] for s in kids)
    ends = [s for s in spans if s[0] == "exchange" and s[1].get("step")
            is None]
    assert [s[1] for s in ends] == [{"round": 0}, {"round": 1}]
    # the card spans in queue order, and every one on the card lane
    batch = tracer.card.take()
    card = batch[2]
    assert [c[0] for c in card] == (per_step * tau + ["exchange"]) * 2
    fields = tracer.card.resolve(batch)
    assert set(fields) == set(CARD_FIELDS)
    assert all(v >= 0 for k, v in fields.items() if k != "host_lead_ms")
    lane = [e for e in tracer.events() if e.get("cat") == "card"]
    assert len(lane) == len(card)
    assert {"name": "thread_name", "ph": "M", "pid": tracer.pid,
            "tid": lane[0]["tid"], "args": {"name": "card"}} in \
        tracer.events()


def _mnist_batches(net, seed=0):
    r = np.random.default_rng(seed)
    shapes, dtypes = net.input_shapes(), net.input_dtypes()
    out = {}
    for name in net.input_names:
        shape = (TAU,) + tuple(shapes[name])
        if dtypes[name].startswith("int"):
            out[name] = r.integers(0, 10, shape).astype(np.int32)
        else:
            out[name] = r.standard_normal(shape).astype(np.float32)
    return out


def test_graph_trainer_span_tree_and_node_spans(group):
    net = GraphNet(build_mnist_graph(batch=2, train_size=8), device="cpu")
    gt = GraphTrainer(net, group, tau=TAU)
    state = gt.init_state()
    tracer = trace.start_tracing()
    for rnd in range(2):
        state, _ = gt.train_round(state, _mnist_batches(net, rnd))
    trace.stop_tracing()
    spans = _host_spans(tracer)
    steps = [s for s in spans if s[0] == "step"]
    assert [s[1] for s in steps] == [{"round": r, "step": t}
                                     for r in range(2) for t in range(TAU)]
    for st in steps:
        phases = sorted((s for s in spans if s[0] in (
            "forward", "backward", "solver") and _inside(s, st)),
            key=lambda s: s[2])
        assert [s[0] for s in phases] == ["forward", "backward", "solver"]
        assert all(s[1] == st[1] for s in phases)
        nodes = [s for s in spans if "node" in s[1]
                 and _inside(s, phases[0])]
        assert {s[0] for s in nodes} >= {"Conv2D", "MatMul"}
        assert all(s[1]["round"] == st[1]["round"]
                   and s[1]["step"] == st[1]["step"] for s in nodes)
    ends = [s for s in spans if s[0] == "exchange"]
    assert [s[1] for s in ends] == [{"round": 0}, {"round": 1}]
    # no card clock attached: host spans only, nothing kept for the card
    assert tracer.card is None
    assert not [e for e in tracer.events() if e.get("cat") == "card"]


def test_eval_spans_each_computed_node_by_its_op():
    net = GraphNet(build_mnist_graph(batch=2, train_size=8), device="cpu")
    batch = {k: torch.from_numpy(v[0])
             for k, v in _mnist_batches(net).items()}
    fetch = ("loss",)
    computed = [n for n in net._topo_order(fetch) if n.op not in (
        "Placeholder", "Variable", "Assign", "NoOp", "Train", "Const")]
    with trace.tracing() as tracer:
        with trace.span("outer", round=7):
            net._eval(net.variables, batch, fetch)
    spans = [s for s in _host_spans(tracer) if s[0] != "outer"]
    assert [(s[0], s[1]) for s in spans] == [
        (n.op, {"node": n.name, "round": 7}) for n in computed]


def test_card_clock_anchor_and_lead_arithmetic(monkeypatch):
    tr = trace.Tracer()
    host = iter([1000.0,                    # the anchor, recorded
                 1100.0, 1300.0,            # forward, round 0 step 0
                 1890.0, 1950.0,            # forward, step 1
                 1990.0, 2000.0,            # exchange
                 3000.0, 3010.0])           # solver, the next round
    card = iter([7.0, 7.5, 7.8, 7.9, 8.0, 8.1, 8.95, 9.0, 9.2])
    monkeypatch.setattr(tr, "now_us", lambda: next(host))
    FakeEvent.made = 0
    clock = tr.attach_card("cpu", new_event=lambda: FakeEvent(
        lambda: next(card)))
    assert clock.anchor_us == 1000.0
    for name, args in (("forward", {"step": 0}), ("forward", {"step": 1}),
                       ("exchange", None)):
        clock.add(name, args, clock.edge(), clock.edge())
    got = clock.resolve(clock.take())
    # the card reached the edges at 1500, 1800 / 1900, 2000 / 2100, 2950
    # us on the host clock: leads 400, 500 / 10, 50 / 110, 950 us
    assert got == pytest.approx({"card_forward_ms": 0.4,
                                 "card_exchange_ms": 0.85,
                                 "host_lead_ms": 0.010})
    lane = [(e["name"], e["ts"], e["dur"], e.get("args"))
            for e in tr.events() if e.get("cat") == "card"]
    assert lane == pytest.approx([("forward", 1500.0, 300.0, {"step": 0}),
                                  ("forward", 1900.0, 100.0, {"step": 1}),
                                  ("exchange", 2100.0, 850.0, None)])
    # the edges' events went back to the pool
    assert FakeEvent.made == 7
    clock.add("solver", None, clock.edge(), clock.edge())
    assert FakeEvent.made == 7
    assert clock.resolve(clock.take()) == pytest.approx(
        {"card_solver_ms": 0.2, "host_lead_ms": 0.0})
    assert clock.resolve(clock.take()) == {}


def test_card_clock_reanchors_when_due(monkeypatch):
    tr = trace.Tracer()
    host = iter([0.0, 100.0, 150.0, 5100.0, 5200.0, 5210.0])
    card = iter([1.0, 1.2, 1.4, 50.0, 50.1, 50.4])
    monkeypatch.setattr(tr, "now_us", lambda: next(host))
    clock = tr.attach_card("cpu", new_event=lambda: FakeEvent(
        lambda: next(card)))
    assert not clock.reanchor_if_due()  # younger than REANCHOR_S
    clock.add("forward", None, clock.edge(), clock.edge())
    before = clock.take()
    monkeypatch.setattr(clock, "REANCHOR_S", 0.0)
    assert clock.reanchor_if_due()
    # an anchor recorded on the idle card at host 5100 us, card 50.0 ms
    assert (clock.anchor.t, clock.anchor_us) == (50.0, 5100.0)
    clock.add("solver", None, clock.edge(), clock.edge())
    # a batch taken before the new anchor resolves against its own
    assert clock.resolve(before) == pytest.approx(
        {"card_forward_ms": 0.2, "host_lead_ms": 0.1})
    assert clock.resolve(clock.take()) == pytest.approx(
        {"card_solver_ms": 0.3, "host_lead_ms": 0.0})


def _dataset():
    r = np.random.default_rng(0)
    return ArrayDataset({"data": r.standard_normal(
        (64, 1, 28, 28)).astype(np.float32),
        "label": r.integers(0, 10, (64, 1)).astype(np.int32)})


def _train(tmp_path, tag, **kw):
    cfg = RunConfig(model="lenet", tau=TAU, local_batch=LB, max_rounds=4,
                    eval_every=0, seed=0, workdir=str(tmp_path / tag),
                    solver=SolverConfig(base_lr=0.01, momentum=0.9), **kw)
    jsonl = tmp_path / f"{tag}.jsonl"
    log = Logger(echo=False, jsonl_path=str(jsonl))
    train(cfg, zoo.lenet(batch=LB), _dataset(), logger=log, device="cpu")
    log.close()
    return [json.loads(l) for l in open(jsonl) if '"loss"' in l]


def test_the_loop_reports_the_card_split_and_period(tmp_path, monkeypatch):
    started = trace.start_tracing

    def on_a_card(tracer=None):
        tr = started(tracer)
        tr.attach_card("cpu", new_event=lambda: FakeEvent(host_ms))
        return tr

    record = train_loop._record_scalars

    def timed_done(*a):
        vec, _ = record(*a)
        done = FakeEvent(host_ms)
        done.record()
        return vec, done

    monkeypatch.setattr(trace, "start_tracing", on_a_card)
    monkeypatch.setattr(train_loop, "_record_scalars", timed_done)
    rows = _train(tmp_path, "card", trace_out=str(tmp_path / "t.json"))
    assert [r["step"] for r in rows] == [0, 1, 2, 3]
    images = TAU * LB
    assert "t_card_round_ms" not in rows[0]
    assert rows[0]["images_per_sec"] == pytest.approx(
        images / rows[0]["round_s"], rel=1e-4)
    for r in rows[1:]:
        assert r["t_card_round_ms"] > 0
        assert r["images_per_sec"] == pytest.approx(
            images / (r["t_card_round_ms"] / 1e3), rel=1e-3)
    for r in rows:
        assert set(CARD_FIELDS) <= set(r), r
        assert abs(r["host_lead_ms"]) < 1.0
        # a fake card as fast as the host: its spans are the host's
        assert r["card_forward_ms"] + r["card_backward_ms"] + \
            r["card_solver_ms"] + r["card_exchange_ms"] < r["t_round_ms"]
    evs = json.load(open(tmp_path / "t.json"))["traceEvents"]
    lanes = {e["args"]["name"]: e["tid"] for e in evs
             if e["name"] == "thread_name"}
    card = [e["name"] for e in evs if e.get("tid") == lanes["card"]
            and e["ph"] == "X"]
    assert card == (["forward", "backward", "solver"] * TAU
                    + ["exchange"]) * 4


def test_with_no_tracer_the_loop_adds_nothing(tmp_path, monkeypatch):
    counts = {"span": 0, "record_function": 0, "edge": 0}
    span_init = trace._Span.__init__

    def count_span(self, *a):
        counts["span"] += 1
        span_init(self, *a)

    rf_enter = torch.autograd.profiler.record_function.__enter__

    def count_rf(self):
        counts["record_function"] += 1
        return rf_enter(self)

    edge = trace.CardClock.edge

    def count_edge(self):
        counts["edge"] += 1
        return edge(self)

    monkeypatch.setattr(trace._Span, "__init__", count_span)
    monkeypatch.setattr(torch.autograd.profiler.record_function,
                        "__enter__", count_rf)
    monkeypatch.setattr(trace.CardClock, "edge", count_edge)
    rows = _train(tmp_path, "off")
    assert len(rows) == 4
    assert counts == {"span": 0, "record_function": 0, "edge": 0}
    assert not {k for r in rows for k in r} & (
        set(CARD_FIELDS) | {"t_card_round_ms"})
    # the stubs count when a tracer and a profiler are on
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        _train(tmp_path, "on", trace_out=str(tmp_path / "t.json"))
    assert counts["span"] > 0 and counts["record_function"] > 0


def test_spans_are_record_function_ranges_under_a_profiler(group,
                                                          tmp_path):
    tr_ = ParallelTrainer(CompiledNet.compile(zoo.lenet(batch=LB)),
                          SolverConfig(), group, tau=TAU)
    state = tr_.init_state(0)
    with trace.tracing():
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]) as prof:
            tr_.train_round(state, _lenet_round(0), (0, 0))
    path = str(tmp_path / "p.json")
    prof.export_chrome_trace(path)
    evs = json.load(open(path))["traceEvents"]
    ranges = [e for e in evs if e.get("cat") == "user_annotation"]
    names = [e["name"] for e in ranges]
    for name, n in (("step", TAU), ("forward", TAU), ("backward", TAU),
                    ("solver", TAU), ("exchange", 1)):
        assert names.count(name) == n, (name, names)
    convs = [e for e in evs if e.get("cat") == "cpu_op"
             and e["name"] == "aten::convolution"]
    fwd = [e for e in ranges if e["name"] == "forward"]
    assert convs and all(any(f["ts"] <= c["ts"] <= f["ts"] + f["dur"]
                             for f in fwd) for c in convs)


READERS = [("forward_ms", "card_forward_ms", statistics.mean),
           ("backward_ms", "card_backward_ms", statistics.mean),
           ("solver_ms", "card_solver_ms", statistics.mean),
           ("exchange_ms", "card_exchange_ms", statistics.mean),
           ("host_lead_ms", "host_lead_ms", statistics.median)]


@pytest.mark.parametrize("name,field,reduce", READERS,
                         ids=[r[0] for r in READERS])
def test_readers_of_the_card_split(name, field, reduce):
    read = load.metric_reader(name)
    vals = [3.0, 1.0, 10.0, 2.5]
    recs = [{"round": i, "loss": 1.0, field: v} for i, v in enumerate(vals)]
    # a record without the field (a card's first round) is left out
    recs.append({"round": 9, "loss": 1.0})
    assert read(SimpleNamespace(records=recs)) == pytest.approx(
        reduce(vals))
    assert read(SimpleNamespace(records=[{"round": 0, "loss": 1.0}])) \
        is None
    assert read(SimpleNamespace(records=[])) is None


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_on_the_card_the_spans_fill_the_round_and_the_host_leads(
        tmp_path, monkeypatch):
    """The benchmark's CaffeNet cell, traced for a short window: each
    window round's forward + backward + solver + exchange card ms lie in
    80-100% of its card period, and the host never trails the card."""
    _need_card()
    from portbench import cell as cell_mod
    records = []
    keep = cell_mod.CaptureLog.metrics

    def metrics(self, step, **kv):
        keep(self, step, **kv)
        records.append(dict(kv, round=step))

    monkeypatch.setattr(cell_mod.CaptureLog, "metrics", metrics)
    c = load.find_cell(load.load_benchmark(), "caffenet.b256.tau5")
    res = cell_mod.run_rank(c, 2 ** 31 + 5, 5.0, True, 0, 1, "cuda:0",
                            time.time(), str(tmp_path),
                            str(tmp_path / "kernels"))
    assert res["correct"], res["checks"]
    for name in ("forward_ms", "backward_ms", "solver_ms", "host_lead_ms"):
        assert name in res["metrics"], res["metrics"]
    lo = cell_mod.WARM
    window = [r for r in records if lo <= r["round"] < lo
              + res["timed_rounds"]]
    assert len(window) == res["timed_rounds"]
    for row in window:
        spans = sum(row[k] for k in CARD_FIELDS if k != "host_lead_ms")
        share = spans / row["t_card_round_ms"]
        print(f"round {row['round']}: spans {spans:.3f} ms of "
              f"{row['t_card_round_ms']:.3f} ({100 * share:.1f}%), "
              f"lead {row['host_lead_ms']:.3f} ms")
        assert 0.8 <= share <= 1.0, row
        assert row["host_lead_ms"] >= -0.05, row


@pytest.mark.gpu
def test_on_the_card_the_anchor_holds_over_a_minute():
    """A probe every 5 s for 60 s, the card busy in between (as in a
    run), re-anchored as the loop re-anchors: an event queued on the idle
    card is placed no earlier than 50 us before the host queued it (the
    floor a `host_lead_ms` reading is held to) and no later than 150 us
    after. One anchor alone wanders further (printed)."""
    _need_card()
    tr = trace.Tracer()
    clock = tr.attach_card(torch.device("cuda", torch.cuda.current_device()))
    first = (clock.anchor, clock.anchor_us)
    leads, raw = [], []
    t_end = time.perf_counter() + 60.0
    while True:
        torch.cuda.synchronize()
        ev, queued = clock.edge()
        torch.cuda.synchronize()
        leads.append(clock.anchor_us + clock.anchor.elapsed_time(ev) * 1e3
                     - queued)
        raw.append(first[1] + first[0].elapsed_time(ev) * 1e3 - queued)
        if time.perf_counter() >= t_end:
            break
        t_busy = time.perf_counter() + 5.0
        while time.perf_counter() < t_busy:
            torch.cuda._sleep(int(0.1 * 1.5e9))  # ~0.1 s of spinning
            torch.cuda.synchronize()
        clock.reanchor_if_due()
    print(f"anchor: one anchor's leads (us) {[round(x, 1) for x in raw]}; "
          f"re-anchored every {clock.REANCHOR_S} s "
          f"{[round(x, 1) for x in leads]}")
    assert all(-50.0 <= x <= 150.0 for x in leads), leads


@pytest.mark.gpu
def test_on_the_card_a_profile_puts_a_steps_kernels_under_its_ranges(
        tmp_path):
    _need_card()
    group = init_data_group("cuda", store_path=str(tmp_path / "store"),
                            rank=0, world_size=1)
    try:
        # no health norms: a step's kernels are its forward, backward
        # and solver
        tr_ = ParallelTrainer(CompiledNet.compile(zoo.lenet(batch=64)),
                              SolverConfig(), group, tau=TAU,
                              compute_health=False)
        state = tr_.init_state(0)
        r = np.random.default_rng(0)
        b = {"data": r.standard_normal((TAU, 64, 28, 28, 1)).astype(
                 np.float32),
             "label": r.integers(0, 10, (TAU, 64, 1)).astype(np.int32)}
        tr_.train_round(state, b, (0, 0))
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with trace.tracing():
            with torch.profiler.profile(activities=acts) as prof:
                tr_.train_round(state, b, (0, 1))
                torch.cuda.synchronize()
    finally:
        group.close()
    path = str(tmp_path / "p.json")
    prof.export_chrome_trace(path)
    evs = json.load(open(path))["traceEvents"]
    ranges = {}
    for e in evs:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            ranges.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"]))
    launch = {e["args"]["correlation"]: e["ts"] for e in evs
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    kernels = [(launch[e["args"]["correlation"]], e["dur"]) for e in evs
               if e.get("cat") == "kernel"
               and e.get("args", {}).get("correlation") in launch]

    def under(name, ts):
        return any(a <= ts <= b for a, b in ranges.get(name, ()))

    assert len(ranges["step"]) == TAU
    for a, b in ranges["step"]:
        mine = [(ts, d) for ts, d in kernels if a <= ts <= b]
        fwd = sum(d for ts, d in mine if under("forward", ts))
        bwd = sum(d for ts, d in mine if under("backward", ts))
        named = sum(d for ts, d in mine if under("forward", ts)
                    or under("backward", ts) or under("solver", ts))
        total = sum(d for _, d in mine)
        print(f"step [{a}, {b}]: {len(mine)} kernels, forward {fwd:.1f} "
              f"us, backward {bwd:.1f} us, named {named:.1f} of "
              f"{total:.1f} us")
        assert fwd > 0 and bwd > 0
        assert named >= 0.9 * total
