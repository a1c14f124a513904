"""`sparknet-metrics` (`obs/summary.py`) against the JAX package's.

The records are the port's own, written live: its self-check's JSONLs
(two lenet trainings as workers 0 and 1, a hot-reloading server, a fleet
that grows, a batch job, the burn-rate alerter's edges), plus eval rows
and health events through the port's Logger, plus the JAX batch test's
hand-written rows. Each set, alone and merged, gives equal `summarize()`
and `format_text()` from both packages. The port's self-check passes on
the CPU with every view; without a card and without `--device cpu` it
raises before it runs anything.
"""
import json
import os

import pytest
import torch

from sparknet_tpu.obs import summary as jax_summary

from sparknet_tpu_torch.obs import summary
from sparknet_tpu_torch.utils.logger import Logger

torch.set_num_threads(2)

#: the self-check's JSONLs, by the view each feeds
SELFCHECK_FILES = ("selfcheck_metrics_w0", "selfcheck_metrics_w1",
                   "selfcheck_serve_metrics", "selfcheck_fleet_metrics",
                   "selfcheck_batch_metrics", "selfcheck_slo_metrics")


@pytest.fixture(scope="module")
def jsonls(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("summary"))
    paths = summary._selfcheck_jsonl(2, out_dir=root, device="cpu")
    extra = os.path.join(root, "events.jsonl")
    log = Logger(None, echo=False, jsonl_path=extra)
    log.metrics(0, loss=2.5, t_data_ms=1.5, t_round_ms=20.0)
    log.metrics(1, test_accuracy=0.25)
    log.event(1, "rollback", reason="nonfinite", target_step=0)
    log.metrics(2, loss=float("nan"), health="nonfinite")
    log.event(2, "spike_skip", loss=9.5)
    log.metrics(3, test_accuracy=0.5)
    log.close()
    out = {os.path.basename(p)[:-len(".jsonl")]: p for p in paths}
    out["events"] = extra
    assert set(out) == set(SELFCHECK_FILES) | {"events"}
    return out


#: the JAX batch test's records (tests/test_batch.py, the batch view)
BATCH_RECORDS = [
    {"step": 0, "event": "batch_unit", "unit": 0, "rows": 6,
     "replica": "a:1", "attempts": 1, "bytes": 100, "dt_s": 0.1},
    {"step": 1, "event": "batch_unit", "unit": 1, "rows": 6,
     "replica": "b:2", "attempts": 2, "bytes": 100, "dt_s": 0.2},
    {"step": 1, "event": "batch_retry", "unit": 1, "kind": "shed",
     "replica": "a:1", "attempt": 1, "error": "PriorityShedError"},
    {"step": 2, "event": "batch_done", "job_id": "j", "done": True,
     "units_total": 2, "units_done": 2, "rows_total": 12,
     "elapsed_s": 0.3, "rows_per_s": 40.0, "retries": 1,
     "cost_per_million_embeddings": 1.5},
]


def _both(paths, tail=10):
    out = {}
    for k, mod in (("port", summary), ("jax", jax_summary)):
        recs = mod.load_records(paths)
        s = mod.summarize(recs, tail=tail)
        out[k] = (recs, s, mod.format_text(s))
    return out


@pytest.mark.parametrize("which", list(SELFCHECK_FILES) +
                         ["events", "trainings", "all"])
def test_summaries_are_the_jax_package_s(jsonls, which):
    if which == "all":
        paths = list(jsonls.values())
    elif which == "trainings":
        paths = [jsonls["selfcheck_metrics_w0"],
                 jsonls["selfcheck_metrics_w1"]]
    else:
        paths = [jsonls[which]]
    got = _both(paths, tail=3 if which == "all" else 10)
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1] == got["jax"][1]
    assert got["port"][2] == got["jax"][2]
    s = got["port"][1]
    view = {"selfcheck_serve_metrics": "serve",
            "selfcheck_fleet_metrics": "fleet",
            "selfcheck_batch_metrics": "batch",
            "selfcheck_slo_metrics": "slo", "trainings": "pod"}.get(which)
    if view is not None:
        assert s.get(view), (view, sorted(s))
    if which == "selfcheck_serve_metrics":
        assert s["freshness"]["models"]["default"]["steps_served"] == [1, 2]
    if which == "events":
        assert [e["event"] for e in s["event_trail"]] == \
            ["rollback", "spike_skip"]
        assert [e["test_accuracy"] for e in s["eval_tail"]] == [0.25, 0.5]
        assert "nan/inf" in got["port"][2]


def test_the_batch_view_is_the_jax_package_s():
    s, js = summary.summarize(BATCH_RECORDS), \
        jax_summary.summarize(BATCH_RECORDS)
    assert s == js
    b = s["batch"]
    assert b["units"] == 2 and b["rows"] == 12
    assert b["retries_by_kind"] == {"shed": 1}
    assert b["units_by_replica"] == {"a:1": 1, "b:2": 1}
    assert b["attempts_max"] == 2
    assert b["jobs"]["j"]["done"] and \
        b["jobs"]["j"]["cost_per_million_embeddings"] == 1.5
    text = summary.format_text(s)
    assert text == jax_summary.format_text(js)
    assert "batch view" in text and "$1.5/M embeddings" in text
    assert "batch" not in summary.summarize([{"step": 0, "loss": 1.0}])


def test_the_cli_prints_text_and_json(jsonls, capsys):
    assert summary.main([jsonls["events"]]) == 0
    text = capsys.readouterr().out
    assert "loss tail:" in text and "health/event audit trail:" in text
    assert summary.main(["--json", "--tail", "2",
                         jsonls["selfcheck_batch_metrics"]]) == 0
    s = json.loads(capsys.readouterr().out)
    assert s["batch"]["units"] == 2
    with pytest.raises(SystemExit):
        summary.main([])


def test_the_selfcheck_passes_on_the_cpu_with_every_view(tmp_path, capsys):
    keep = tmp_path / "keep"
    assert summary.main(["--selfcheck", "--selfcheck-workers", "2",
                         "--device", "cpu", "--json", "--keep",
                         str(keep)]) == 0
    s = json.loads(capsys.readouterr().out)
    for view in ("step_time_breakdown", "pod", "serve", "freshness",
                 "fleet", "batch", "slo"):
        assert s.get(view), view
    assert s["pod"]["n_workers"] == 2
    assert (keep / "selfcheck_trace_w0.json").exists()


def test_the_selfcheck_needs_a_card_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    keep = tmp_path / "keep"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        summary.main(["--selfcheck", "--keep", str(keep)])
    assert not keep.exists()
