"""The port's serving replica as an operator sees it, against the JAX
package's: the registry's metric families, the /status keys and the
heartbeat schema of a watched server behind an HTTP frontend; the serve
CLI with `--checkpoint-dir` and `--heartbeat` against the JAX CLI's
printed keys; the CLI answering on its own HTTP socket (`--http-port 0`,
a subprocess); and the flags and config fields of later slices, which
stop naming their ROADMAP item.
"""
import json
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from sparknet_tpu import zoo as jax_zoo
from sparknet_tpu.net_api import JaxNet
from sparknet_tpu.serve.admission import TenantAdmission as JaxTenants
from sparknet_tpu.serve.http_frontend import HttpFrontend as JaxFrontend
from sparknet_tpu.serve.server import InferenceServer as JaxServer
from sparknet_tpu.serve.server import ServeConfig as JaxServeConfig
from sparknet_tpu.utils import checkpoint as jck

from sparknet_tpu_torch import zoo
from sparknet_tpu_torch.net_api import TorchNet
from sparknet_tpu_torch.serve import app
from sparknet_tpu_torch.serve.admission import TenantAdmission
from sparknet_tpu_torch.serve.http_frontend import HttpFrontend, http_infer
from sparknet_tpu_torch.serve.server import InferenceServer, ServeConfig
from sparknet_tpu_torch.utils.heartbeat import read_heartbeat

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent

#: families only the JAX server registers (none: its compile-event record
#: goes to registries attached to it explicitly, which a server is not)
JAX_ONLY: set = set()
#: status keys only the port reports: the torch device it serves on
PORT_ONLY_STATUS = {"device"}


def _families(text):
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")}


def _lenet_step(directory, step=3, seed=2):
    """A step of seeded lenet weights in the JAX package's format, written
    by the JAX package's store."""
    net = JaxNet(jax_zoo.lenet(batch=4), seed=seed)
    flat = {f"params/{l}/{p}": np.asarray(v)[None]
            for l, lp in net.params.items() for p, v in lp.items()}
    jck.save(str(directory), flat, step=step)


@pytest.fixture(scope="module")
def watched(tmp_path_factory):
    """Both packages' servers, watched (status port, heartbeat, a
    checkpoint dir with step 3), behind an HTTP frontend with a tenant
    door; /metrics and /status scraped after four requests, the heartbeat
    read live and after stop."""
    root = tmp_path_factory.mktemp("watched")
    _lenet_step(root / "ck")
    out = {}
    for k, srv_cls, cfg_cls, fe_cls, door, net in (
            ("jax", JaxServer, JaxServeConfig, JaxFrontend, JaxTenants,
             JaxNet(jax_zoo.lenet(batch=4))),
            ("port", InferenceServer, ServeConfig, HttpFrontend,
             TenantAdmission, TorchNet(zoo.lenet(batch=4), device="cpu"))):
        hb = str(root / f"hb_{k}.json")
        srv = srv_cls(net, cfg_cls(max_batch=4, outputs=("prob",),
                                   status_port=0, heartbeat_path=hb,
                                   heartbeat_every_s=0.0,
                                   checkpoint_dir=str(root / "ck"),
                                   metrics_every_batches=0)).start()
        fe = fe_cls(srv, port=0, tenants=door(rate_rps=100.0))
        try:
            url = f"http://{fe.address[0]}:{fe.address[1]}"
            for i in range(4):
                x = {"data": np.full((28, 28, 1), i, np.float32)}
                http_infer(url, "default", x, tenant="t", timeout=30.0)
            host, port = srv.status_address
            base = f"http://{host}:{port}"
            scraped = {p: urllib.request.urlopen(base + p, timeout=30
                                                 ).read().decode()
                       for p in ("/metrics", "/status", "/healthz")}
            # the worker beats at every duty tick (heartbeat_every_s=0),
            # so the file already carries the traffic's vitals
            live = read_heartbeat(hb)
        finally:
            fe.stop()
            srv.stop()
        out[k] = dict(scraped=scraped, live=live, done=read_heartbeat(hb))
    return out


def test_the_serve_registry_has_the_jax_server_s_families(watched):
    port = _families(watched["port"]["scraped"]["/metrics"])
    jax = _families(watched["jax"]["scraped"]["/metrics"])
    assert port == jax - JAX_ONLY, port ^ jax
    assert {"sparknet_serve_http_requests_total",
            "sparknet_serve_swaps_total",
            "sparknet_serve_model_freshness_seconds",
            "sparknet_serve_model_step_lag",
            "sparknet_heartbeat_beats_total",
            "sparknet_build_info"} <= port
    text = watched["port"]["scraped"]["/metrics"]
    assert 'sparknet_serve_http_requests_total{code="200",' \
        'transport="http"} 4' in text
    assert 'sparknet_serve_swaps_total{model="default",' \
        'outcome="initial"} 1' in text
    assert 'sparknet_serve_model_step{model="default"} 3' in text


def test_status_and_healthz_have_the_jax_server_s_keys(watched):
    st = {k: json.loads(v["scraped"]["/status"])
          for k, v in watched.items()}
    assert set(st["port"]) == set(st["jax"]) | PORT_ONLY_STATUS
    for key in ("model_step", "requests_ok", "swaps", "swap_failures",
                "quant", "buckets", "batch_size_hist", "replica"):
        assert st["port"][key] == st["jax"][key], key
    assert st["port"]["model_step"] == 3 and st["port"]["requests_ok"] == 4
    assert set(st["port"]["models"]["default"]) == \
        set(st["jax"]["models"]["default"])
    h = {k: json.loads(v["scraped"]["/healthz"])
         for k, v in watched.items()}
    assert set(h["port"]) == set(h["jax"]) and h["port"]["status"] == "ok"


def test_the_serve_heartbeat_has_the_jax_schema(watched):
    for when in ("live", "done"):
        a, b = watched["port"][when], watched["jax"][when]
        assert set(a) == set(b), (when, set(a) ^ set(b))
        assert (a["role"], a["step"], a["status"]) == \
            (b["role"], b["step"], b["status"])
    live = watched["port"]["live"]
    assert live["role"] == "serve" and live["step"] == 3
    assert set(live["models"]["default"]) == \
        set(watched["jax"]["live"]["models"]["default"])
    assert watched["port"]["done"]["status"] == "done"


def test_the_serve_cli_with_a_checkpoint_dir_prints_the_jax_keys(
        tmp_path, capsys):
    from sparknet_tpu.serve.app import main as jax_main
    _lenet_step(tmp_path / "ck", step=5)
    st = {}
    for k, fn, extra in (("port", app.main, ["--device", "cpu"]),
                         ("jax", jax_main, [])):
        hb = tmp_path / f"hb_{k}.json"
        fn(["--model", "lenet", "--outputs", "prob", "--max-batch", "4",
            "--demo", "12", "--workdir", str(tmp_path / k),
            "--checkpoint-dir", str(tmp_path / "ck"), "--heartbeat",
            str(hb), "--poll-interval", "0.5"] + extra)
        st[k] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert read_heartbeat(str(hb))["status"] == "done"
        assert read_heartbeat(str(hb))["step"] == 5
    assert set(st["port"]) == set(st["jax"]) | PORT_ONLY_STATUS
    for key in ("requests_ok", "requests_failed", "model_step", "swaps",
                "quant", "buckets"):
        assert st["port"][key] == st["jax"][key], key
    assert st["port"]["model_step"] == 5 and st["port"]["requests_ok"] == 12


def _line_reader(stream, q):
    for line in iter(stream.readline, ""):
        q.put(line)
    q.put(None)


def test_the_serve_cli_answers_on_its_http_socket(tmp_path):
    """`python -m sparknet_tpu_torch.serve.app --http-port 0`: the CLI
    logs its data plane's address, answers an npz request there with the
    checkpoint's step, and drains on SIGINT with the status on stderr."""
    _lenet_step(tmp_path / "ck", step=7)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "sparknet_tpu_torch.serve.app", "--model",
         "lenet", "--device", "cpu", "--http-port", "0", "--status-port",
         "0", "--checkpoint-dir", str(tmp_path / "ck"), "--outputs",
         "prob", "--max-batch", "4", "--workdir", str(tmp_path / "w")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    lines: "queue.Queue" = queue.Queue()
    threading.Thread(target=_line_reader, args=(proc.stderr, lines),
                     daemon=True).start()
    try:
        url = None
        seen = []
        while url is None:
            line = lines.get(timeout=120)
            assert line is not None, "".join(seen)
            seen.append(line)
            m = re.search(r"HTTP data plane at (http://[\d.]+:\d+)/v1", line)
            if m:
                url = m.group(1)
        meta = {}
        out = http_infer(url, "default",
                         {"data": np.zeros((28, 28, 1), np.float32)},
                         deadline_s=30.0, timeout=60.0, meta=meta)
        assert out["prob"].shape == (10,) and meta["step"] == 7
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            assert r.status == 200
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=120) == 0
        tail = []
        while True:
            line = lines.get(timeout=60)
            if line is None:
                break
            tail.append(line)
        status = json.loads(tail[-1])
        assert status["requests_ok"] == 1 and status["model_step"] == 7
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


@pytest.mark.parametrize("dest,unset,what", app.LATER_FLAGS,
                         ids=[d for d, _, _ in app.LATER_FLAGS])
def test_flags_of_later_slices_stop_naming_their_roadmap_item(
        dest, unset, what, capsys, tmp_path):
    flag = "--" + dest.replace("_", "-")
    argv = ["--model", "lenet", "--device", "cpu", "--demo", "1",
            "--workdir", str(tmp_path)]
    if unset is False:
        argv.append(flag)
    else:
        argv += [flag, {"models": "a=lenet", "graph": "g.pb",
                        "history_dir": "h", "rollout_gate": "g.json",
                        "compile_cache": "c",
                        "fleet_provider": "none"}.get(dest, "2")]
    with pytest.raises(SystemExit) as e:
        app.main(argv)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert flag in err and "ROADMAP" in err and "not ported" in err


@pytest.mark.parametrize("field,value,item", [
    ("history", True, "A10c"), ("history_dir", "h", "A10c"),
    ("slo_availability", 0.999, "A10c"), ("slo_spec", object(), "A10c"),
    ("rollout_gate", "g.json", "A10b"), ("compile_cache_dir", "c",
                                        "A10d")])
def test_config_fields_of_later_slices_raise_naming_their_item(field, value,
                                                              item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        ServeConfig(**{field: value})
    ServeConfig(**{field: getattr(ServeConfig(), field)})  # the default


def test_tenant_flags_build_the_door(tmp_path, capsys):
    with pytest.raises(SystemExit):
        app.main(["--model", "lenet", "--device", "cpu", "--demo", "1",
                  "--tenant-weights", "a=2", "--workdir", str(tmp_path)])
    assert "--tenant-weights requires --tenant-rate" in \
        capsys.readouterr().err
    assert app.parse_weights_arg("a=2,b=0.5") == {"a": 2.0, "b": 0.5}
    assert app.parse_weights_arg(None) == {}
    with pytest.raises(SystemExit, match="tenant=weight"):
        app.parse_weights_arg("a=x")
    app.main(["--model", "lenet", "--device", "cpu", "--demo", "3",
              "--tenant-rate", "5", "--tenant-weights", "a=2",
              "--http-port", "0", "--request-journal",
              str(tmp_path / "j.jsonl"), "--workdir", str(tmp_path)])
    st = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert st["requests_ok"] == 3
