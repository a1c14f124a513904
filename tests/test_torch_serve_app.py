"""The port's serving replica as an operator sees it, against the JAX
package's: the registry's metric families, the /status keys and the
heartbeat schema of a watched server behind an HTTP frontend; the serve
CLI with `--checkpoint-dir` and `--heartbeat` against the JAX CLI's
printed keys; the CLI answering on its own HTTP socket (`--http-port 0`,
a subprocess); `--graph` (the second backend: a GraphDef JSON and its
weights npz) against the JAX CLI, and its refusal of hot reload and int8;
and `--compile-cache` / `compile_cache_dir`,
which point the kernel builds at the warm-up cache.
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


def _graph_files(tmp_path):
    """The builder's mnist graph (batch 4) as JSON, and a weights npz of
    seeded values (not the graph's own init)."""
    from sparknet_tpu_torch.backend import GraphNet, build_mnist_graph
    from sparknet_tpu_torch.model.weights import WeightCollection
    graph = build_mnist_graph(batch=4)
    gpath, wpath = str(tmp_path / "mnist.json"), str(tmp_path / "w.npz")
    graph.save(gpath)
    shapes = {k: tuple(v.shape) for k, v in GraphNet(
        graph, device="cpu").variables.items()}
    r = np.random.default_rng(4)
    WeightCollection({k: [0.05 * r.standard_normal(s)]
                      for k, s in shapes.items()}, list(shapes)).save(wpath)
    return gpath, wpath


def test_the_graph_flag_serves_a_json_graph_with_its_weights(tmp_path,
                                                             capsys):
    """`--graph g.json --weights w.npz`: the port's CLI serves what the JAX
    CLI serves (the same status keys and counts), and the net it builds
    answers as the JAX GraphNet with those weights (rtol 1e-5, atol
    1e-6)."""
    from sparknet_tpu.serve.app import build_net as jax_build_net
    from sparknet_tpu.serve.app import main as jax_main
    gpath, wpath = _graph_files(tmp_path)
    st = {}
    for k, fn, extra in (("port", app.main, ["--device", "cpu"]),
                         ("jax", jax_main, [])):
        fn(["--graph", gpath, "--weights", wpath, "--outputs", "prob",
            "--max-batch", "4", "--demo", "6", "--workdir",
            str(tmp_path / k)] + extra)
        st[k] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(st["port"]) == set(st["jax"]) | PORT_ONLY_STATUS
    for key in ("requests_ok", "requests_failed", "model_step", "quant"):
        assert st["port"][key] == st["jax"][key], key
    assert st["port"]["requests_ok"] == 6
    pnet = app.build_net("lenet", wpath, 4, None, None, 0, "cpu",
                         graph=gpath)
    jnet = jax_build_net(None, gpath, wpath, 4, 10, None)
    x = np.random.default_rng(5).standard_normal(
        (4, 28, 28, 1)).astype(np.float32)
    batch = {"data": x, "label": np.zeros((4, 1), np.int32)}
    np.testing.assert_allclose(pnet.forward(batch, ["prob"])["prob"],
                               jnet.forward(batch, ["prob"])["prob"],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("flag", ["checkpoint_dir", "quant"])
def test_a_graph_net_refuses_hot_reload_and_int8(flag, tmp_path):
    """A graph net serves f32 from its weights file: the manager refuses a
    checkpoint dir and int8 with the JAX package's reasons."""
    from sparknet_tpu.backend import GraphNet as JaxGraphNet
    from sparknet_tpu.serve.model_manager import ServeModelError as JaxErr
    from sparknet_tpu_torch.backend import GraphNet, build_mnist_graph
    from sparknet_tpu_torch.serve.model_manager import ServeModelError
    kw = ({"checkpoint_dir": str(tmp_path)} if flag == "checkpoint_dir"
          else {"quant": "int8"})
    graph = build_mnist_graph(batch=4)
    with pytest.raises(JaxErr) as want:
        JaxServer(JaxGraphNet(graph), JaxServeConfig(**kw))
    with pytest.raises(ServeModelError) as got:
        InferenceServer(GraphNet(graph, device="cpu"), ServeConfig(**kw))
    tail = "serve a graph net from a weights file instead" \
        if flag == "checkpoint_dir" else "the graph backend serves f32"
    assert tail in str(want.value) and tail in str(got.value)


@pytest.mark.parametrize("how", ["config", "flag"])
def test_the_compile_cache_points_the_kernel_builds_at_the_warm_up_cache(
        how, tmp_path, capsys):
    """`ServeConfig.compile_cache_dir` and the CLI's `--compile-cache`
    (each lane's config) initialize the warm-up cache when the server is
    built: the kernel builds go to that directory, first caller wins."""
    from sparknet_tpu_torch.ops import _build
    from sparknet_tpu_torch.utils import compile_cache

    d = str(tmp_path / "kernel-cache")
    compile_cache.reset_for_tests()
    try:
        if how == "config":
            cfg = ServeConfig(max_batch=4, compile_cache_dir=d)
            assert compile_cache.cache_dir() is None
            InferenceServer(TorchNet(zoo.lenet(batch=4), device="cpu"), cfg)
        else:
            app.main(["--model", "lenet", "--device", "cpu", "--demo", "1",
                      "--compile-cache", d, "--workdir", str(tmp_path)])
            assert json.loads(capsys.readouterr().out.strip()
                              .splitlines()[-1])["requests_ok"] == 1
        assert compile_cache.cache_dir() == d and os.path.isdir(d)
        assert _build.library_path("lrn_fwd").parent == Path(d)
        assert compile_cache.init_compile_cache(
            str(tmp_path / "other")) == d
    finally:
        compile_cache.reset_for_tests()
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR


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


@pytest.mark.parametrize("n_classes,want", [(None, 1000), (10, 10)],
                         ids=["default", "10"])
def test_caffenet_serves_its_published_1000_classes_unless_told(n_classes,
                                                                want):
    """`--n-classes` defaults to None, the zoo CaffeNet's published 1000
    (the JAX CLI defaults to 10; ROADMAP C); given, both packages build
    the same head."""
    from sparknet_tpu.apps.train_loop import resolve_spec as jax_resolve
    from sparknet_tpu.model.net import CompiledNet as JaxCompiledNet
    from sparknet_tpu.utils.config import RunConfig
    from sparknet_tpu_torch.model.net import CompiledNet

    spec = app.resolve_spec("caffenet", 2, n_classes, 67)
    assert CompiledNet.compile(spec).blob_shapes["fc8"] == (2, want)
    jspec = jax_resolve(RunConfig(model="caffenet", local_batch=2,
                                  n_classes=n_classes or 1000, crop=67))
    assert tuple(JaxCompiledNet.compile(jspec).blob_shapes["fc8"]) == \
        (2, want)
