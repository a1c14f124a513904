"""The port's inference server (serve/) on the CPU, and against the JAX one.

Small nets (lenet, cifar10_quick) over `TorchNet(device="cpu")`. The parity
case serves the same requests through the JAX package's
`InferenceServer(JaxNet)` and the port's server, with the JAX weights
carried over as a checkpoint flat map (`start(weights=...)`, through
`params_from_checkpoint_flat`); served `prob` must agree within atol 1e-6
(convolution sum order differs between the packages).
"""
import json
import threading
import time

import numpy as np
import pytest
import torch

from sparknet_tpu import zoo as jax_zoo
from sparknet_tpu.net_api import JaxNet
from sparknet_tpu.serve.server import InferenceServer as JaxServer
from sparknet_tpu.serve.server import ServeConfig as JaxServeConfig

from sparknet_tpu_torch import zoo
from sparknet_tpu_torch.model.net import params_to_jax
from sparknet_tpu_torch.obs import trace as obs_trace
from sparknet_tpu_torch.net_api import TorchNet
from sparknet_tpu_torch.serve import app
from sparknet_tpu_torch.serve.model_manager import (
    ModelManager, ServeModelError, params_from_checkpoint_flat)
from sparknet_tpu_torch.serve.server import (InferenceServer, ServeConfig,
                                             default_buckets, zeros_batch)

torch.set_num_threads(2)


def _images(n, shape, seed=0):
    r = np.random.default_rng(seed)
    return [r.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _lenet(max_batch=8, seed=0):
    return TorchNet(zoo.lenet(batch=max_batch), device="cpu", seed=seed)


def test_concurrent_requests_answered_exactly_once():
    net = _lenet()
    xs = _images(48, (28, 28, 1))
    results = {}
    lock = threading.Lock()
    with InferenceServer(net, ServeConfig(max_batch=8, max_wait_ms=2.0,
                                          outputs=("prob",))) as srv:
        def client(ids):
            futs = [(i, srv.submit({"data": xs[i]})) for i in ids]
            for i, f in futs:
                out = f.result(timeout=60)
                with lock:
                    assert i not in results
                    results[i] = out["prob"]

        threads = [threading.Thread(target=client, args=(range(k, 48, 6),))
                   for k in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        st = srv.status()
    assert sorted(results) == list(range(48))
    assert st["requests_ok"] == 48 and st["requests_failed"] == 0
    assert sum(n for n, _ in srv.batch_log) == 48
    # another batch size may take another convolution sum order: allclose
    ref = net.forward({"data": np.stack(xs),
                       "label": np.zeros((48, 1), np.int32)})["prob"]
    for i in range(48):
        np.testing.assert_allclose(results[i], ref[i], rtol=1e-4, atol=1e-6)


def test_padding_is_lossless_within_a_bucket():
    """Three requests pad into bucket 4: each answer equals the same rows
    forwarded with zero padding to 4, bit for bit."""
    net = _lenet(max_batch=4)
    xs = _images(3, (28, 28, 1), seed=1)
    srv = InferenceServer(net, ServeConfig(max_batch=4, max_wait_ms=500.0,
                                           outputs=("prob",))).start()
    try:
        futs = [srv.submit({"data": x}) for x in xs]
        got = [f.result(timeout=60)["prob"] for f in futs]
    finally:
        srv.stop()
    assert srv.batch_log == [(3, 4)]
    padded = zeros_batch(net, 4)
    padded["data"][:3] = np.stack(xs)
    ref = net.forward(padded)["prob"]
    for i in range(3):
        np.testing.assert_array_equal(got[i], ref[i])


def test_misshaped_request_rejected_at_the_door():
    net = _lenet(max_batch=2)
    with InferenceServer(net, ServeConfig(max_batch=2)) as srv:
        with pytest.raises(ValueError, match="per-example shape"):
            srv.submit({"data": np.zeros((28, 28), np.float32)})
        with pytest.raises(ValueError, match="not a net input"):
            srv.submit({"pixels": np.zeros((28, 28, 1), np.float32)})
        with pytest.raises(ValueError, match="unknown output blob"):
            srv.submit({"data": np.zeros((28, 28, 1), np.float32)},
                       outputs=("nope",))
        out = srv.infer({"data": np.zeros((28, 28, 1), np.float32)})
        assert out["prob"].shape == (10,)
        hidden = srv.submit({"data": np.zeros((28, 28, 1), np.float32)},
                            outputs=("fc1",)).result(timeout=60)
        assert set(hidden) == {"fc1"} and hidden["fc1"].shape == (512,)
        assert srv.status()["requests_failed"] == 0


def test_served_prob_matches_jax_server_with_carried_weights():
    jnet = JaxNet(jax_zoo.cifar10_quick(batch=4), seed=7)
    flat = {f"{lname}/{pname}": np.asarray(v)
            for lname, lp in jnet.params.items() for pname, v in lp.items()}
    tnet = TorchNet(zoo.cifar10_quick(batch=4), device="cpu", seed=0)
    xs = _images(6, (32, 32, 3), seed=2)
    cfg = dict(max_batch=4, max_wait_ms=20.0, outputs=("prob",))
    with JaxServer(jnet, JaxServeConfig(**cfg)) as js:
        want = [f.result(timeout=120)["prob"]
                for f in [js.submit({"data": x}) for x in xs]]
    srv = InferenceServer(tnet, ServeConfig(**cfg)).start(weights=flat)
    try:
        got = [f.result(timeout=60)["prob"]
               for f in [srv.submit({"data": x}) for x in xs]]
    finally:
        srv.stop()
    assert srv.status()["model_step"] == 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_checkpoint_flat_layouts():
    """Bare params, the replica-axis TrainState and TP column shards all
    extract to the same weights; a missing or mis-shaped leaf is named."""
    net = _lenet(max_batch=2)
    jp = params_to_jax(net.net, net.params)
    bare = {f"{l}/{p}": v for l, lp in jp.items() for p, v in lp.items()}
    replica = {f"params/{l}/{p}": np.stack([v, v])
               for l, lp in jp.items() for p, v in lp.items()}
    replica["momentum/fc1/w"] = np.zeros(3)
    tp = dict(replica)
    tp["params/fc1/w"] = np.stack(np.split(jp["fc1"]["w"], 2, axis=1))
    tp["params/fc1/b"] = np.stack(np.split(jp["fc1"]["b"], 2))
    for flat, k in ((bare, 1), (replica, 1), (tp, 2)):
        got = params_from_checkpoint_flat(flat, net, tp=k)
        for lname, lp in net.params.items():
            for pname, t in lp.items():
                torch.testing.assert_close(got[lname][pname], t, rtol=0,
                                           atol=0)
    with pytest.raises(ServeModelError, match="fc2/b"):
        params_from_checkpoint_flat(
            {k: v for k, v in bare.items() if k != "fc2/b"}, net)
    with pytest.raises(ServeModelError, match="conv1/w"):
        params_from_checkpoint_flat({**bare, "conv1/w": np.zeros((5, 5))},
                                    net)


def test_canary_rolls_back_nonfinite_weights():
    net = _lenet(max_batch=2)
    good = net.params
    flat = {f"{l}/{p}": v for l, lp in params_to_jax(net.net, good).items()
            for p, v in lp.items()}
    poisoned = {**flat, "fc2/b": np.full_like(flat["fc2/b"], np.nan)}
    mgr = ModelManager(net, canary_batch=zeros_batch(net, 1),
                       canary_outputs=("prob",))
    assert not mgr.install(poisoned, step=3)
    assert net.params is good and mgr.swap_failures == 1
    assert "canary" in mgr.last_error
    with pytest.raises(ServeModelError, match="initial weights rejected"):
        mgr.load_initial(poisoned, step=3)
    assert mgr.install(flat, step=4) and mgr.step == 4


def test_forward_spans_are_traced_when_tracing_is_on(tmp_path):
    net = _lenet(max_batch=2)
    path = tmp_path / "trace.json"
    with InferenceServer(net, ServeConfig(max_batch=2)) as srv:
        with obs_trace.tracing(str(path)) as tr:
            srv.infer({"data": np.zeros((28, 28, 1), np.float32)})
            # the worker resolves the request inside its forward span, so
            # `infer` can return before the span closes: wait (bounded)
            # until it has been recorded before tracing stops
            deadline = time.monotonic() + 5.0
            while not any(e["name"] == "forward" for e in tr.events()) \
                    and time.monotonic() < deadline:
                time.sleep(0.001)
        srv.infer({"data": np.zeros((28, 28, 1), np.float32)})
    events = json.loads(path.read_text())["traceEvents"]
    forwards = [e for e in events if e["name"] == "forward"]
    assert len(forwards) == 1 and forwards[0]["args"] == {"n": 1}
    assert forwards[0]["dur"] > 0
    assert {"thread_name", "process_name"} <= {e["name"] for e in events}


def test_serve_config_validates_buckets():
    assert default_buckets(8) == (1, 2, 4, 8)
    assert default_buckets(6) == (1, 2, 4, 6)
    for bad in ((), (0, 4), (4, 2, 8), (1, 2)):
        with pytest.raises(ValueError):
            ServeConfig(max_batch=4, buckets=bad)


def test_status_counts_bucket_first_forwards():
    net = _lenet(max_batch=4)
    xs = _images(5, (28, 28, 1), seed=4)
    with InferenceServer(net, ServeConfig(max_batch=4, max_wait_ms=50.0,
                                          buckets=(1, 4),
                                          outputs=("prob",))) as srv:
        srv.infer({"data": xs[0]})
        for f in [srv.submit({"data": x}) for x in xs[1:]]:
            f.result(timeout=60)
        srv.infer({"data": xs[0]})
        st = srv.status()
    assert st["bucket_compiles"] == 2 and st["buckets"] == [1, 4]
    assert st["requests_ok"] == 6 and st["device"] == "cpu"
    assert st["p50_ms"] is not None


def test_serve_app_demo_runs_on_cpu(capsys, tmp_path):
    app.main(["--model", "lenet", "--max-batch", "4", "--demo", "6",
              "--device", "cpu", "--outputs", "prob",
              "--workdir", str(tmp_path)])
    st = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert st["requests_ok"] == 6 and st["device"] == "cpu"
    assert st["buckets"] == [1, 2, 4]


def test_serve_app_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        app.main(["--model", "lenet", "--demo", "1",
                  "--workdir", str(tmp_path)])
    with pytest.raises(ValueError, match="unknown model"):
        app.main(["--model", "vgg", "--device", "cpu", "--demo", "1",
                  "--workdir", str(tmp_path)])
