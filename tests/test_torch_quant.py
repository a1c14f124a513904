"""The port's int8 weight-only serving (model/quant.py) against the JAX
package's.

- `quantize_params` of the same numpy params (the JAX layouts) gives
  `w_q` and `w_scale` equal to the JAX package's bit for bit, and the port
  layouts are exact permutations of them.
- `QuantConfig` validates with the JAX package's messages.
- The quantized forward of lenet and cifar10_quick, port against JAX, on
  the same weights and batch: within atol 1e-6 with `act="float32"` (the
  convolutions' sum order) and within atol 2e-2 with `act="bfloat16"` (a
  few bfloat16 ulps of a probability).
- The quantized forward stays within the QuantConfig tolerance of the f32
  forward (the JAX package's acceptance pin), and the f32 path is
  bit-equal before and after a quantized install.
- A corrupted `w_scale` is rejected by the parity canary mid-traffic with
  zero bad responses — the expectation of the JAX package's
  `test_corrupted_scale_checkpoint_canary_rejected_mid_traffic` (red on
  the reference, so the port is held to what it states).
- The serve CLI with `--quant int8` and `--buckets-from`, against the JAX
  CLI's printed keys.
"""
import json
import threading
import time

import numpy as np
import pytest
import torch

from sparknet_tpu import zoo as jax_zoo
from sparknet_tpu.model import quant as jax_quant
from sparknet_tpu.net_api import JaxNet
from sparknet_tpu.serve.server import parity_batch as jax_parity_batch

from sparknet_tpu_torch import zoo
from sparknet_tpu_torch.model import quant
from sparknet_tpu_torch.model.net import params_to_jax
from sparknet_tpu_torch.net_api import TorchNet
from sparknet_tpu_torch.serve.model_manager import ModelManager
from sparknet_tpu_torch.serve.server import (InferenceServer, ServeConfig,
                                             parity_batch, zeros_batch)
from sparknet_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(2)

SMALL = {"lenet": lambda: zoo.lenet(batch=4),
         "cifar10_quick": lambda: zoo.cifar10_quick(batch=4),
         "adult_mlp": lambda: zoo.adult_mlp(batch=4),
         "caffenet": lambda: zoo.caffenet(batch=4, crop=67, n_classes=16)}
JAX_SMALL = {"lenet": lambda: jax_zoo.lenet(batch=4),
             "cifar10_quick": lambda: jax_zoo.cifar10_quick(batch=4)}


def _quantized(net, params):
    """Port f32 params -> port quantized params, through the JAX layouts
    (the manager's route)."""
    return quant.quant_params_to_port(
        net.net, quant.quantize_params(params_to_jax(net.net, params)),
        net.device)


def _jax_numpy(jnet):
    return {l: {p: np.asarray(v) for p, v in lp.items()}
            for l, lp in jnet.params.items()}


def _pair(name, seed=3):
    """A JaxNet and a TorchNet holding the same weights."""
    jnet = JaxNet(JAX_SMALL[name](), seed=seed)
    tnet = TorchNet(SMALL[name](), device="cpu")
    tnet.load_jax_params(_jax_numpy(jnet))
    return jnet, tnet


# -- the arithmetic ----------------------------------------------------------

@pytest.mark.parametrize("name", ["lenet", "cifar10_quick", "caffenet",
                                  "adult_mlp"])
def test_quantize_params_is_bit_equal_to_the_jax_package(name):
    net = TorchNet(SMALL[name](), device="cpu", seed=5)
    jp = params_to_jax(net.net, net.params)
    got = quant.quantize_params(jp)
    want = jax_quant.quantize_params(jp)
    assert set(got) == set(want)
    for lname in want:
        assert set(got[lname]) == set(want[lname])
        for pname, w in want[lname].items():
            w = np.asarray(w)
            assert got[lname][pname].dtype == w.dtype
            np.testing.assert_array_equal(got[lname][pname], w)
    # the port layouts are exact permutations; w_scale rides the output
    # axis (axis 0 in the port)
    port = quant.quant_params_to_port(net.net, got, net.device)
    types = {l.name: l.type for l in net.net.spec.layers}
    for lname, lp in port.items():
        wq = lp["w_q"].numpy()
        ref = np.asarray(want[lname]["w_q"])
        if types[lname] == "Convolution":
            ref = np.transpose(ref, (3, 2, 0, 1))
        else:
            ref = ref.T
        assert wq.dtype == np.int8 and np.array_equal(wq, ref)
        np.testing.assert_array_equal(lp["w_scale"].numpy(),
                                      np.asarray(want[lname]["w_scale"]))
        # the port's dequantization = JAX's, permuted, bit for bit
        deq = quant.dequantize_params(port)[lname]["w"].numpy()
        jdeq = np.asarray(jax_quant.dequantize_params(want)[lname]["w"])
        jdeq = (np.transpose(jdeq, (3, 2, 0, 1))
                if types[lname] == "Convolution" else jdeq.T)
        np.testing.assert_array_equal(deq, jdeq)
    assert quant.is_quantized(port) and not quant.is_quantized(net.params)
    assert quant.is_quantized(_quantized(net, net.params))


def test_quantize_leaf_bounds_and_zero_channel():
    r = np.random.default_rng(0)
    w = (r.standard_normal((5, 5, 3, 16)) * r.uniform(0.01, 3.0, 16))
    w = w.astype(np.float32)
    w[..., 3] = 0.0
    q = quant.quantize_leaf(w)
    jq = jax_quant.quantize_leaf(w)
    for k in ("w_q", "w_scale"):
        np.testing.assert_array_equal(q[k], np.asarray(jq[k]))
    assert q["w_q"].dtype == np.int8 and q["w_scale"].shape == (16,)
    deq = q["w_q"].astype(np.float32) * q["w_scale"]
    assert np.all(np.abs(deq - w) <= q["w_scale"] / 2 + 1e-7)
    assert np.all(q["w_q"][..., 3] == 0) and np.isfinite(q["w_scale"]).all()


@pytest.mark.parametrize("kw", [dict(mode="int4"), dict(act="float16"),
                                dict(rtol=-1.0), dict(atol=-0.1)])
def test_quant_config_errors_are_the_jax_package_s(kw):
    errs = []
    for mod in (quant, jax_quant):
        with pytest.raises(ValueError) as e:
            mod.QuantConfig(**kw)
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    with pytest.raises(ValueError) as a:
        quant.QuantConfig.coerce(3)
    with pytest.raises(ValueError) as b:
        jax_quant.QuantConfig.coerce(3)
    assert str(a.value) == str(b.value)
    qc = quant.QuantConfig()
    assert (qc.mode, qc.act, qc.rtol, qc.atol) == ("int8", "bfloat16",
                                                   0.05, 0.08)
    assert quant.QuantConfig.coerce("int8") == qc
    assert quant.QuantConfig.coerce({"act": "float32"}).act_dtype() == \
        torch.float32
    assert qc.act_dtype() == torch.bfloat16


# -- the forward -------------------------------------------------------------

@pytest.mark.parametrize("act,atol", [("float32", 1e-6),
                                      ("bfloat16", 2e-2)])
@pytest.mark.parametrize("name", ["lenet", "cifar10_quick"])
def test_quantized_forward_matches_the_jax_package(name, act, atol):
    """Same weights, same quantization, same batch: the port's quantized
    forward against the JAX package's, per bucket."""
    jnet, tnet = _pair(name)
    jqc, tqc = jax_quant.QuantConfig(act=act), quant.QuantConfig(act=act)
    f32 = _jax_numpy(jnet)
    jnet.params = jax_quant.quantize_params(jnet.params, jqc)
    jnet.set_quant(jqc)
    tnet.params = quant.quant_params_to_port(
        tnet.net, quant.quantize_params(f32), tnet.device)
    tnet.set_quant(tqc)
    for bucket in (1, 4):
        batch = jax_parity_batch(jnet, bucket, seed=11)
        want = jnet.forward(batch)
        got = tnet.forward(batch)
        for k, w in want.items():
            if np.ndim(w) < 1:
                continue
            assert got[k].dtype == np.float32
            np.testing.assert_allclose(got[k], np.asarray(w, np.float32),
                                       rtol=0, atol=atol,
                                       err_msg=f"{name} {act} {k}")


@pytest.mark.parametrize("name", sorted(SMALL))
def test_quantized_forward_within_the_gate_of_f32(name):
    """The JAX package's acceptance pin, on the port: int8 weights and
    bfloat16 activations within QuantConfig's rtol/atol of the f32
    forward at buckets 1 and 4."""
    net = TorchNet(SMALL[name](), device="cpu", seed=1)
    qc = quant.QuantConfig()
    f32 = net.params
    qp = _quantized(net, f32)
    for bucket in (1, 4):
        batch = parity_batch(net, bucket, seed=11)
        net.params, net.quant = f32, None
        ref = net.forward(batch)
        net.params = qp
        net.set_quant(qc)
        out = net.forward(batch)
        for k, rv in ref.items():
            if np.ndim(rv) < 1:
                continue
            assert np.isfinite(out[k]).all()
            np.testing.assert_allclose(out[k], rv, rtol=qc.rtol,
                                       atol=qc.atol, err_msg=f"{name} {k}")
    net.params, net.quant = f32, None


def test_f32_path_is_bit_equal_across_a_quantized_install():
    net = TorchNet(zoo.lenet(batch=4), device="cpu", seed=2)
    batch = parity_batch(net, 4, seed=3)
    ref = net.forward(batch, blob_names=["prob"])
    with torch.inference_mode():
        direct = net.net.apply(net.params, net._prep(batch))["prob"]
    np.testing.assert_array_equal(ref["prob"], direct.numpy())
    f32 = net.params
    net.params = _quantized(net, f32)
    net.set_quant(quant.QuantConfig())
    net.forward(batch, blob_names=["prob"])
    net.params = f32
    net.set_quant(None)
    again = net.forward(batch, blob_names=["prob"])
    np.testing.assert_array_equal(ref["prob"], again["prob"])


def test_bfloat16_host_batches_feed_the_quantized_forward():
    """The quantized lane's bfloat16 pad buffers: the same answer as the
    float32 batch (the first layer rounds it the same way)."""
    net = TorchNet(zoo.lenet(batch=4), device="cpu")
    net.params = _quantized(net, net.params)
    net.set_quant(quant.QuantConfig())
    batch = parity_batch(net, 4, seed=5)
    bf = zeros_batch(net, 4, bf16=True)
    assert bf["data"].dtype == torch.bfloat16
    assert bf["label"].dtype == np.int32
    bf["data"][:] = torch.from_numpy(batch["data"])
    np.testing.assert_array_equal(net.forward(bf)["prob"],
                                  net.forward(batch)["prob"])
    with pytest.raises(ValueError, match="net expects"):
        net.forward({**bf, "data": bf["data"][:, :3]})


# -- the manager and the server ---------------------------------------------

def _save(params, directory, step, scale=1.0):
    """f32 params in the JAX layouts as a replica-axis TrainState step
    (the JAX package's format)."""
    flat = {f"params/{l}/{p}": (v * scale)[None]
            for l, lp in params.items() for p, v in lp.items()}
    return ckpt.save(str(directory), flat, step=step)


def test_manager_quantizes_initial_weights_and_hot_swaps(tmp_path):
    net = TorchNet(zoo.lenet(batch=4), device="cpu")
    m = ModelManager(net, quant=quant.QuantConfig(),
                     parity_batch=parity_batch(net, 1))
    assert m.load_initial() is None
    assert quant.is_quantized(net.params) and net.quant is not None
    assert 0 <= m.last_parity_drift <= quant.QuantConfig().atol
    assert m.forwards == 2 and m.reference_forwards == 1

    net2 = TorchNet(zoo.lenet(batch=4), device="cpu", seed=4)
    f32 = params_to_jax(net2.net, net2.params)
    _save(f32, tmp_path / "ck", step=5, scale=0.5)
    m2 = ModelManager(net2, checkpoint_dir=str(tmp_path / "ck"),
                      quant=quant.QuantConfig(),
                      parity_batch=parity_batch(net2, 1),
                      canary_batch=zeros_batch(net2, 1, bf16=True))
    assert m2.load_initial() == 5
    assert quant.is_quantized(net2.params)
    deq = quant.dequantize_params(net2.params)["conv1"]["w"].numpy()
    want = np.transpose(f32["conv1"]["w"] * 0.5, (3, 2, 0, 1))
    assert np.max(np.abs(deq - want)) <= \
        float(net2.params["conv1"]["w_scale"].max()) / 2 + 1e-6


def _wait(cond, timeout=60.0):
    """Bounded wait on a condition the worker thread makes true."""
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, "condition never held"
        time.sleep(0.005)


def _example(i):
    r = np.random.default_rng(1000 + i)
    return {"data": r.standard_normal((28, 28, 1)).astype(np.float32)}


def test_corrupted_scale_is_rejected_by_the_parity_canary_mid_traffic(
        tmp_path, monkeypatch):
    """Mid-traffic: (1) a good step hot-swaps into the quantized path,
    (2) a step whose quantization comes out corrupted (fc1's scale x16:
    digest-valid bytes, poisoned math) is rejected by the parity gate with
    the server answering from the previous weights, (3) with honest
    quantization back the next step serves. Zero dropped, zero bad
    responses."""
    import sparknet_tpu_torch.serve.model_manager as mm

    net = TorchNet(zoo.lenet(batch=4), device="cpu")
    f32 = params_to_jax(net.net, net.params)
    d = tmp_path / "ck"
    _save(f32, d, step=1)
    cfg = ServeConfig(max_batch=4, max_wait_ms=2.0, outputs=("prob",),
                      checkpoint_dir=str(d), poll_interval_s=0.0,
                      metrics_every_batches=0, quant="int8")
    answered, bad = [], []
    stop = threading.Event()

    def client():
        i = 0
        while not stop.is_set():
            try:
                p = srv.infer(_example(i), timeout=30.0)["prob"]
                if p.shape != (10,) or p.dtype != np.float32 or \
                        not np.isfinite(p).all() or \
                        abs(float(p.sum()) - 1.0) > 5e-2:
                    bad.append((i, p))
                answered.append(i)
            except Exception as e:
                bad.append((i, e))
            i += 1

    real = mm.quantize_params

    def corrupted(params, cfg_):
        qp = real(params, cfg_)
        qp["fc1"]["w_scale"] = qp["fc1"]["w_scale"] * 16.0
        return qp

    with InferenceServer(net, cfg) as srv:
        assert srv.manager.step == 1 and quant.is_quantized(net.params)
        threads = [threading.Thread(target=client) for _ in range(3)]
        for t in threads:
            t.start()
        try:
            _wait(lambda: len(answered) > 5)
            _save(f32, d, step=2, scale=0.9)
            _wait(lambda: srv.manager.step == 2)
            assert quant.is_quantized(net.params)
            monkeypatch.setattr(mm, "quantize_params", corrupted)
            fails = srv.manager.swap_failures
            _save(f32, d, step=3, scale=0.8)
            _wait(lambda: srv.manager.swap_failures > fails)
            assert srv.manager.step == 2
            assert "quantization rejected" in srv.manager.last_error
            monkeypatch.setattr(mm, "quantize_params", real)
            _save(f32, d, step=4, scale=0.8)
            _wait(lambda: srv.manager.step == 4)
            n = len(answered)
            _wait(lambda: len(answered) > n + 5)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60)
        assert not bad, bad[:3]
        assert srv.manager.swaps == 2 and srv.manager.swap_failures == 1
        assert srv.status()["requests_failed"] == 0


def test_quantized_server_answers_float32_within_the_gate():
    spec = zoo.lenet(batch=4)
    net_f = TorchNet(spec, device="cpu", seed=6)
    net_q = TorchNet(spec, device="cpu", seed=6)
    base = dict(max_batch=4, max_wait_ms=2.0, buckets=(1, 4),
                outputs=("prob",), metrics_every_batches=0)
    with InferenceServer(net_f, ServeConfig(**base)) as sf:
        refs = [sf.infer(_example(i)) for i in range(3)]
    with InferenceServer(net_q, ServeConfig(**base, quant="int8")) as sq:
        outs = [sq.infer(_example(i)) for i in range(3)]
        for f in [sq.submit(_example(i)) for i in range(4)]:
            f.result(timeout=30.0)
        st = sq.status()
        assert st["quant"] == "int8" and st["bucket_compiles"] <= 2
        assert set(sq._bucket_buf) <= {1, 4}
        assert all(v["data"].dtype == torch.bfloat16
                   for v in sq._bucket_buf.values())
    qc = quant.QuantConfig()
    for ref, out in zip(refs, outs):
        assert out["prob"].dtype == np.float32
        np.testing.assert_allclose(out["prob"], ref["prob"], rtol=qc.rtol,
                                   atol=qc.atol)


def test_serve_cli_quant_and_buckets_from_match_the_jax_cli(tmp_path,
                                                            capsys):
    """The JAX CLI's `test_serve_cli_quant_and_buckets_from`, run through
    both CLIs: the same printed keys (the port adds "device"), the same
    counts, and the same ladder derived from the same JSONL."""
    from sparknet_tpu.serve.app import main as jax_main

    from sparknet_tpu_torch.serve.app import main

    runs = {}
    for k, fn, extra in (("port", main, ["--device", "cpu"]),
                         ("jax", jax_main, [])):
        wd = tmp_path / k
        fn(["--model", "lenet", "--outputs", "prob", "--max-batch", "4",
            "--quant", "int8", "--demo", "6", "--workdir", str(wd)]
           + extra)
        st = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert st["requests_ok"] == 6 and st["requests_failed"] == 0
        assert st["quant"] == "int8"
        jsonls = sorted(str(p) for p in wd.glob("serving_metrics_*.jsonl"))
        assert jsonls
        runs[k] = (st, jsonls)
    assert set(runs["port"][0]) - set(runs["jax"][0]) == {"device"}
    assert set(runs["jax"][0]) <= set(runs["port"][0])
    # one recorded histogram, handed to both CLIs as the ladder source
    src = runs["port"][1]
    ladders = {}
    for k, fn, extra in (("port", main, ["--device", "cpu"]),
                         ("jax", jax_main, [])):
        fn(["--model", "lenet", "--outputs", "prob", "--max-batch", "4",
            "--buckets-from"] + src + ["--buckets-k", "2", "--demo", "4",
                                       "--workdir", str(tmp_path / "b")]
           + extra)
        st = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert st["requests_ok"] == 4
        ladders[k] = st["buckets"]
    assert ladders["port"] == ladders["jax"]
    assert ladders["port"][-1] == 4 and len(ladders["port"]) <= 2
    with pytest.raises(SystemExit):
        main(["--model", "lenet", "--device", "cpu", "--quant-tol", "0.1",
              "--demo", "1", "--workdir", str(tmp_path)])
    assert "--quant-tol requires --quant" in capsys.readouterr().err
