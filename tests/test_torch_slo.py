"""The port's SLO layer (obs/slo.py) against the JAX package's.

Each package's `BurnRateAlerter` watches its own `MetricsHistory`, fed the
same scripted registry traffic (seeded numpy latencies and outcomes:
quiet, an incident, recovery) under the same injected clock. Exact
comparisons, since both sides do the same host arithmetic on the same
inputs:
- the page and the ticket fire and resolve on the same sample;
  `firing_pages()`, `summary()`, `state()` (the /slo/status body) and the
  `slo_alert` JSONL rows (less the logger's own t/ts stamps) are equal;
- zero traffic burns nothing: no alert, the whole budget left;
- `SloSpec` validation raises what the JAX one raises;
- `build_report` on the same shards and journal gives the same JSON, and
  `format_report` the same text; the CLI's `--json` output is equal, and
  `--selfcheck` exits 0;
- `/slo/status` over HTTP answers with the JAX package's body.
"""
import json
import os
import urllib.request

import numpy as np
import pytest

from sparknet_tpu.obs import history as jh
from sparknet_tpu.obs import slo as jslo
from sparknet_tpu.obs.http import StatusServer as JaxStatusServer
from sparknet_tpu.obs.registry import MetricsRegistry as JaxRegistry
from sparknet_tpu.utils.logger import Logger as JaxLogger

from sparknet_tpu_torch.obs import history as ph
from sparknet_tpu_torch.obs import slo as pslo
from sparknet_tpu_torch.obs.http import StatusServer
from sparknet_tpu_torch.obs.registry import MetricsRegistry
from sparknet_tpu_torch.utils.logger import Logger

T0 = 1_700_000_000.0
ROUTED = "sparknet_serve_routed_latency_seconds"
SPECS = {
    "both": [dict(model="m", latency_ms=50.0, availability=0.99,
                  window_s=120.0, fast_window_s=10.0, fast_confirm_s=2.0,
                  slow_window_s=60.0, slow_confirm_s=10.0)],
    "latency": [dict(model="m", latency_ms=25.0, latency_quantile=0.95,
                     window_s=60.0, fast_burn=4.0, fast_window_s=8.0,
                     fast_confirm_s=3.0, slow_window_s=30.0,
                     slow_confirm_s=6.0)],
    "two_models": [dict(model="m", availability=0.999, window_s=90.0,
                        fast_window_s=6.0, fast_confirm_s=2.0,
                        slow_window_s=20.0, slow_confirm_s=5.0),
                   dict(model="n", latency_ms=10.0, window_s=90.0,
                        fast_window_s=6.0, fast_confirm_s=2.0,
                        slow_window_s=20.0, slow_confirm_s=5.0)],
}


def _drive(mods, reg_cls, logger_cls, specs, seed, jsonl=None,
           hist_dir=None, samples=60, quiet=False):
    """One package's history + alerter through a scripted incident.
    Returns (history, alerter, per-sample firing pages)."""
    hmod, smod = mods
    reg = reg_cls()
    lat = reg.histogram(smod.LATENCY_METRIC, labels=("model",))
    routed = reg.histogram(ROUTED, labels=("model",))
    req = reg.counter(smod.REQUESTS_METRIC, labels=("model", "outcome"))
    hist = hmod.MetricsHistory(reg, hmod.HistoryConfig(
        sample_interval_s=1.0, rings=((1.0, 300), (10.0, 60)),
        persist_dir=hist_dir))
    log = (logger_cls(echo=False, jsonl_path=jsonl) if jsonl else None)
    alerter = smod.BurnRateAlerter(hist, [smod.SloSpec(**s) for s in specs],
                                   logger=log).attach()
    rng = np.random.default_rng(seed)
    pages = []
    for i in range(samples):
        burning = (not quiet) and samples // 3 <= i < 2 * samples // 3
        for model in ("m", "n"):
            n = 0 if quiet else int(rng.integers(5, 30))
            slow = rng.uniform(0.0, 1.0, n) < (0.6 if burning else 0.002)
            for s in slow:
                x = float(rng.uniform(0.06, 0.4) if s
                          else rng.uniform(0.001, 0.009))
                lat.observe(x, model=model)
                # the router's vantage: the lane's time plus a hop
                routed.observe(x + float(rng.uniform(0.0, 0.02)),
                               model=model)
                req.inc(model=model, outcome="failed" if s and burning
                        and rng.uniform() < 0.5 else "ok")
        hist.sample_now(now=T0 + i)
        pages.append(alerter.firing_pages())
    if log is not None:
        log.close()
    return hist, alerter, pages


def _alert_rows(path):
    out = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("event") == "slo_alert":
                out.append({k: v for k, v in rec.items()
                            if k not in ("t", "ts")})
    return out


@pytest.mark.parametrize("specs", sorted(SPECS))
@pytest.mark.parametrize("seed", range(3))
def test_the_alerter_fires_and_resolves_with_the_jax_one(tmp_path, specs,
                                                        seed):
    jp, pp = str(tmp_path / "j.jsonl"), str(tmp_path / "p.jsonl")
    jhist, jal, jpages = _drive((jh, jslo), JaxRegistry, JaxLogger,
                                SPECS[specs], seed, jsonl=jp)
    phist, pal, ppages = _drive((ph, pslo), MetricsRegistry, Logger,
                                SPECS[specs], seed, jsonl=pp)
    assert ppages == jpages
    assert any(ppages), "the incident never paged"
    assert not ppages[-1], "the page did not resolve after recovery"
    assert pal.summary() == jal.summary()
    assert pal.state() == jal.state()
    assert pal.alerts_fired == jal.alerts_fired > 0
    rows = _alert_rows(pp)
    assert rows == _alert_rows(jp)
    assert {r["edge"] for r in rows} == {"firing", "resolved"}
    for name in ("sparknet_slo_alerts_total",
                 "sparknet_slo_error_budget_remaining"):
        assert phist.registry.snapshot()[name]["values"] == \
            jhist.registry.snapshot()[name]["values"]


def test_zero_traffic_burns_nothing():
    for mods, reg, log in (((jh, jslo), JaxRegistry, JaxLogger),
                           ((ph, pslo), MetricsRegistry, Logger)):
        _, al, pages = _drive(mods, reg, log, SPECS["both"], 0,
                              samples=30, quiet=True)
        assert not any(pages) and al.alerts_fired == 0
        assert al.summary() == {"firing": [],
                                "budget_remaining": {"m": 1.0},
                                "alerts_fired_total": 0}


@pytest.mark.parametrize("kw", [
    dict(), dict(latency_ms=10.0, latency_quantile=1.0),
    dict(availability=1.0), dict(availability=0.0),
    dict(latency_ms=0.0), dict(latency_ms=5.0, window_s=0),
    dict(latency_ms=5.0, fast_confirm_s=-1.0),
    dict(latency_ms=5.0, fast_burn=0.0),
    dict(latency_ms=5.0, fast_confirm_s=120.0),
    dict(latency_ms=5.0, slow_confirm_s=900.0)])
def test_slo_spec_refuses_as_the_jax_one(kw):
    with pytest.raises(ValueError) as je:
        jslo.SloSpec(model="m", **kw)
    with pytest.raises(ValueError) as pe:
        pslo.SloSpec(model="m", **kw)
    assert str(pe.value) == str(je.value)


def test_one_spec_per_model():
    for smod, hmod, reg in ((jslo, jh, JaxRegistry),
                            (pslo, ph, MetricsRegistry)):
        h = hmod.MetricsHistory(reg())
        with pytest.raises(ValueError, match="one SloSpec per model"):
            smod.BurnRateAlerter(h, [smod.SloSpec("m", latency_ms=1.0),
                                     smod.SloSpec("m", availability=0.9)])


@pytest.fixture(scope="module")
def incident(tmp_path_factory):
    """Shards and a journal of one scripted incident (written by the JAX
    package), plus request rows in the journal for the tenant axis."""
    root = tmp_path_factory.mktemp("incident")
    hist_dir = str(root / "history")
    jsonl = str(root / "journal.jsonl")
    hist, _, _ = _drive((jh, jslo), JaxRegistry, JaxLogger,
                        SPECS["two_models"], 5, jsonl=jsonl,
                        hist_dir=hist_dir, samples=90)
    hist.stop()
    with open(jsonl, "a") as f:
        for i, (tenant, outcome) in enumerate(
                [("t1", "ok"), ("t1", None), ("t2", "failed"),
                 (None, "ok")]):
            f.write(json.dumps({"kind": "request", "tenant": tenant,
                                "outcome": outcome, "model": "m",
                                "ts": T0 + i}) + "\n")
    return hist_dir, jsonl


@pytest.mark.parametrize("spec", [None, "two_models", "both"])
@pytest.mark.parametrize("window", [10.0, 30.0])
def test_build_report_equals_the_jax_one(incident, spec, window):
    hist_dir, jsonl = incident
    specs = SPECS[spec] if spec else ()
    want = jslo.build_report(hist_dir, journals=[jsonl],
                             specs=[jslo.SloSpec(**s) for s in specs],
                             report_window_s=window)
    got = pslo.build_report(hist_dir, journals=[jsonl],
                            specs=[pslo.SloSpec(**s) for s in specs],
                            report_window_s=window)
    assert json.dumps(got, sort_keys=True) == \
        json.dumps(want, sort_keys=True)
    assert set(got["models"]) == {"m", "n"}
    assert got["alerts"] and got["tenants"]
    assert pslo.format_report(got) == jslo.format_report(want)
    assert pslo.discover_models(*ph.read_history_shards(hist_dir)) == \
        ["m", "n"]


def test_the_cli_reports_as_the_jax_one(incident, capsys):
    hist_dir, jsonl = incident
    argv = [hist_dir, "--journal", jsonl, "--window", "15", "--json",
            "--model", "m", "--latency-ms", "20", "--availability", "0.99"]
    assert jslo.main(argv) == 0
    want = capsys.readouterr().out
    assert pslo.main(argv) == 0
    assert capsys.readouterr().out == want
    assert pslo.main([str(os.path.dirname(hist_dir) + "/none")]) == 0
    with pytest.raises(SystemExit):
        pslo.main([hist_dir, "--latency-ms", "20"])  # --model required


def test_the_cli_reads_another_latency_family(incident, capsys):
    """The port's `--latency-metric` (the router's routed latency): the
    report equals the JAX `build_report` under a spec naming that
    family, and differs from the lane family's."""
    hist_dir, jsonl = incident
    argv = [hist_dir, "--window", "15", "--json", "--model", "m",
            "--latency-ms", "10", "--latency-metric", ROUTED]
    assert pslo.main(argv) == 0
    got = json.loads(capsys.readouterr().out)
    want = jslo.build_report(hist_dir, specs=[jslo.SloSpec(
        model="m", latency_ms=10.0, latency_metric=ROUTED)],
        report_window_s=15.0)
    assert got == json.loads(json.dumps(want))
    assert pslo.main(argv[:-2]) == 0
    lane = json.loads(capsys.readouterr().out)
    assert got["models"]["m"]["slo"]["latency"] != \
        lane["models"]["m"]["slo"]["latency"]


def test_selfcheck_passes(capsys):
    assert pslo.main(["--selfcheck"]) == 0
    out = capsys.readouterr().out
    assert "FAIL" not in out and "injected burn fires a page" in out


def test_slo_status_route_answers_as_the_jax_one():
    servers = []
    bodies = []
    for (mods, reg, log, srv_cls) in (
            ((jh, jslo), JaxRegistry, JaxLogger, JaxStatusServer),
            ((ph, pslo), MetricsRegistry, Logger, StatusServer)):
        hist, al, _ = _drive(mods, reg, log, SPECS["both"], 1)
        srv = srv_cls(0, hist.registry)
        al.attach_http(srv)
        servers.append(srv)
        host, port = srv.address
        with urllib.request.urlopen(f"http://{host}:{port}/slo/status",
                                    timeout=10) as r:
            bodies.append(json.loads(r.read()))
    for s in servers:
        s.stop()
    assert bodies[1] == bodies[0]
    assert set(bodies[1]) == {"specs", "alerts", "firing",
                              "budget_remaining", "alerts_fired_total",
                              "audit"}
