"""The port's net (zoo, model/net.py, net_api.py) against the JAX package.

Weights are made once by the JAX package (`CompiledNet.init_params`) and
carried into the port with `params_from_jax`; the same numpy batch then
goes through both `CompiledNet.apply`s and every blob is compared.
Tolerance: rtol 1e-4, atol 1e-5 on activations (convolution and matrix
sums run in another order on the two sides; the JAX conv1 also takes the
exact space-to-depth rewrite, the port's does not), atol 1e-6 on `prob`.
CaffeNet runs at batch 2, crop 67, 16 classes, with the JAX LRN both fused
(`OpsImpl()`) and as the Pallas kernel under the interpreter.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu import zoo as jax_zoo
from sparknet_tpu.model.layers import OpsImpl as JaxOpsImpl
from sparknet_tpu.model.net import CompiledNet as JaxCompiledNet
from sparknet_tpu.net_api import JaxNet

from sparknet_tpu_torch import precision, zoo
from sparknet_tpu_torch.model.layers import OpsImpl
from sparknet_tpu_torch.model.net import (CompiledNet, params_from_jax,
                                          params_to_jax)
from sparknet_tpu_torch.net_api import TorchNet

torch.set_num_threads(2)
CPU = torch.device("cpu")

ZOO_ARGS = {
    "cifar10_quick": [dict(batch=2), dict(batch=100)],
    "caffenet": [dict(batch=2, crop=67, n_classes=16),
                 dict(batch=128, crop=227, n_classes=1000)],
    "lenet": [dict(batch=2), dict(batch=64)],
    "adult_mlp": [dict(batch=3, n_features=5), dict()],
}
# (builder kwargs, input scale): x50 drives CaffeNet's LRNs off identity
NETS = {
    "cifar10_quick": (dict(batch=2), 1.0),
    "lenet": (dict(batch=2), 1.0),
    "caffenet": (dict(batch=2, crop=67, n_classes=16), 50.0),
}


def _jax_params(jnet, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jnet.init_params(jax.random.PRNGKey(seed)))


def _batch(jnet, scale, seed=0):
    r = np.random.default_rng(seed)
    out = {}
    for name, shape in jnet.input_shapes.items():
        if jnet.input_dtypes[name] == "int32":
            out[name] = r.integers(0, 10, shape).astype(np.int32)
        else:
            out[name] = (scale * r.standard_normal(shape)).astype(np.float32)
    return out


@pytest.mark.parametrize("name,kw", [(n, kw) for n, kws in ZOO_ARGS.items()
                                     for kw in kws])
def test_zoo_specs_equal_across_packages(name, kw):
    assert dataclasses.asdict(getattr(zoo, name)(**kw)) == \
        dataclasses.asdict(getattr(jax_zoo, name)(**kw))


@pytest.mark.parametrize("name", sorted(NETS))
def test_compiled_shapes_equal_across_packages(name):
    kw, _ = NETS[name]
    jnet = JaxCompiledNet.compile(getattr(jax_zoo, name)(**kw))
    tnet = CompiledNet.compile(getattr(zoo, name)(**kw))
    assert tnet.input_shapes == jnet.input_shapes
    assert tnet.blob_shapes == jnet.blob_shapes
    assert tnet.output_names == jnet.output_names
    assert tnet.param_layers() == jnet.param_layers()


@pytest.mark.parametrize("name", sorted(NETS) + ["adult_mlp"])
def test_params_round_trip_exactly(name):
    kw = NETS.get(name, (dict(batch=3, n_features=5), 1.0))[0]
    jnet = JaxCompiledNet.compile(getattr(jax_zoo, name)(**kw))
    tnet = CompiledNet.compile(getattr(zoo, name)(**kw))
    jp = _jax_params(jnet)
    back = params_to_jax(tnet, params_from_jax(tnet, jp, CPU))
    assert back.keys() == jp.keys()
    for lname in jp:
        assert back[lname].keys() == jp[lname].keys()
        for pname in jp[lname]:
            assert back[lname][pname].dtype == np.float32
            np.testing.assert_array_equal(back[lname][pname],
                                          jp[lname][pname])


def test_params_from_jax_names_the_mismatch():
    tnet = CompiledNet.compile(zoo.lenet(batch=2))
    jp = _jax_params(JaxCompiledNet.compile(jax_zoo.lenet(batch=2)))
    bad = {**jp, "conv2": {**jp["conv2"], "w": jp["conv2"]["w"][..., :3]}}
    with pytest.raises(ValueError, match="conv2/w"):
        params_from_jax(tnet, bad, CPU)
    with pytest.raises(ValueError, match="fc1"):
        params_from_jax(tnet, {k: v for k, v in jp.items() if k != "fc1"},
                        CPU)
    with pytest.raises(ValueError, match="fc2/b"):
        params_from_jax(tnet, {**jp, "fc2": {"w": jp["fc2"]["w"]}}, CPU)


def test_conv_and_ip_layouts_are_torch_layouts():
    """conv HWIO -> OIHW (grouped: I = cin/group), IP (in, out) -> (out, in)."""
    spec = zoo.caffenet(batch=2, crop=67, n_classes=16)
    tnet = CompiledNet.compile(spec)
    jp = _jax_params(JaxCompiledNet.compile(
        jax_zoo.caffenet(batch=2, crop=67, n_classes=16)))
    tp = params_from_jax(tnet, jp, CPU)
    assert tuple(tp["conv2"]["w"].shape) == (256, 48, 5, 5)
    np.testing.assert_array_equal(tp["conv2"]["w"][7, 3, 1, 2].item(),
                                  jp["conv2"]["w"][1, 2, 3, 7])
    assert tuple(tp["fc6"]["w"].shape) == (4096, 256)
    np.testing.assert_array_equal(tp["fc6"]["w"].numpy(), jp["fc6"]["w"].T)


BLOB_CASES = [("cifar10_quick", "fused", "auto"), ("lenet", "fused", "auto"),
              ("caffenet", "fused", "auto"), ("caffenet", "pallas", "auto"),
              ("caffenet", "pallas", "plain")]


@pytest.mark.parametrize("name,jax_lrn,port_lrn", BLOB_CASES)
def test_every_blob_matches_jax(name, jax_lrn, port_lrn):
    kw, scale = NETS[name]
    jnet = JaxCompiledNet.compile(getattr(jax_zoo, name)(**kw))
    tnet = CompiledNet.compile(getattr(zoo, name)(**kw))
    jp = _jax_params(jnet)
    batch = _batch(jnet, scale)
    jops = (JaxOpsImpl() if jax_lrn == "fused"
            else JaxOpsImpl(lrn="pallas", interpret=True))
    want = jnet.apply(jax.tree_util.tree_map(jnp.asarray, jp),
                      {k: jnp.asarray(v) for k, v in batch.items()},
                      ops=jops)
    with torch.inference_mode():
        got = tnet.apply(params_from_jax(tnet, jp, CPU),
                         {k: torch.from_numpy(v) for k, v in batch.items()},
                         ops=OpsImpl(lrn=port_lrn))
    assert got.keys() == want.keys()
    for blob in want:
        w, g = np.asarray(want[blob]), got[blob].numpy()
        assert g.shape == w.shape, blob
        if blob == "prob":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=blob)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                       err_msg=blob)


def test_image_blobs_stay_channels_last_inside():
    """Every 4-D blob comes out as a contiguous NHWC view: the layers kept
    channels_last memory end to end (the LRN kernel reads it uncopied)."""
    tnet = CompiledNet.compile(zoo.caffenet(batch=2, crop=67, n_classes=16))
    params = tnet.init_params(torch.Generator().manual_seed(0), CPU)
    x = torch.randn(2, 67, 67, 3, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        blobs = tnet.apply(params, {"data": x,
                                    "label": torch.zeros(2, 1, dtype=torch.int32)})
    for name, b in blobs.items():
        if b.ndim == 4:
            assert b.is_contiguous(), name


def test_torchnet_matches_jaxnet_with_carried_weights():
    spec_kw = dict(batch=4)
    jnet = JaxNet(jax_zoo.cifar10_quick(**spec_kw), seed=3)
    tnet = TorchNet(zoo.cifar10_quick(**spec_kw), device="cpu")
    tnet.load_jax_params(jax.tree_util.tree_map(np.asarray, jnet.params))
    batch = _batch(jnet.net, 1.0, seed=2)
    want, got = jnet.forward(batch), tnet.forward(batch)
    assert got.keys() == want.keys() == {"prob", "accuracy", "loss"}
    np.testing.assert_allclose(got["prob"], want["prob"], atol=1e-6)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got["accuracy"] == want["accuracy"]
    assert [dataclasses.astuple(f) for f in tnet.output_schema().fields] \
        == [dataclasses.astuple(f) for f in jnet.output_schema().fields]


def test_torchnet_forward_accepts_nchw_and_hidden_blobs():
    net = TorchNet(zoo.lenet(batch=2), device="cpu", seed=1)
    x = np.random.default_rng(0).standard_normal((2, 28, 28, 1)).astype(
        np.float32)
    label = np.zeros((2, 1), np.int32)
    nhwc = net.forward({"data": x, "label": label}, ["conv2"])
    nchw = net.forward({"data": np.transpose(x, (0, 3, 1, 2)),
                        "label": label}, ["conv2"])
    assert nhwc["conv2"].shape == (2, 14, 14, 64)
    for k in nhwc:
        np.testing.assert_array_equal(nhwc[k], nchw[k])
    with pytest.raises(ValueError, match="net expects"):
        net.forward({"data": x[:, :27], "label": label})
    with pytest.raises(ValueError, match="missing net input"):
        net.forward({"data": x})


def test_torchnet_weights_round_trip_and_seed():
    a = TorchNet(zoo.lenet(batch=2), device="cpu", seed=5)
    b = TorchNet(zoo.lenet(batch=2), device="cpu", seed=6)
    w = a.get_weights()
    assert w.layer_names == ["conv1", "conv2", "fc1", "fc2"]
    assert w["conv1"][0].shape == (32, 1, 5, 5)        # Caffe OIHW
    assert w["fc1"][0].shape == (512, 3136)            # Caffe (out, in)
    b.set_weights(w)
    for lname, blobs in b.get_weights().weights.items():
        for x, y in zip(blobs, w[lname]):
            np.testing.assert_array_equal(x, y)
    again = TorchNet(zoo.lenet(batch=2), device="cpu", seed=5).get_weights()
    np.testing.assert_array_equal(again["fc2"][0], w["fc2"][0])
    w.weights["fc2"][0] = w.weights["fc2"][0][:, :7]
    with pytest.raises(ValueError, match="fc2/w"):
        b.set_weights(w)


def test_precision_float32_turns_tf32_off():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        TorchNet(zoo.lenet(batch=1), device="cpu").forward(
            {"data": np.zeros((1, 28, 28, 1), np.float32),
             "label": np.zeros((1, 1), np.int32)})
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def test_bfloat16_policy_runs_bf16_and_tracks_float32():
    """Under "bfloat16" convolutions and products take and give bf16; the
    probabilities stay within bf16 rounding of the float32 forward."""
    tnet = CompiledNet.compile(zoo.cifar10_quick(batch=2))
    params = tnet.init_params(torch.Generator().manual_seed(0), CPU)
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    batch = {"data": x, "label": torch.zeros(2, 1, dtype=torch.int32)}
    with torch.inference_mode():
        f32 = tnet.apply(params, batch)
        with precision.policy("bfloat16"):
            bf16 = tnet.apply(params, batch)
    assert f32["conv1"].dtype == torch.float32
    assert bf16["conv1"].dtype == bf16["prob"].dtype == torch.bfloat16
    np.testing.assert_allclose(bf16["prob"].float().numpy(),
                               f32["prob"].numpy(), atol=2e-2)
    with pytest.raises(ValueError, match="unknown precision policy"):
        precision.set_policy("float16")


@pytest.mark.gpu
def test_torchnet_on_card_matches_cpu_and_launches_lrn_kernel():
    """CaffeNet (batch 2, crop 67) on the card vs the same weights on the
    CPU: prob within atol 1e-6, two lrn_fwd launches per forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sparknet_tpu_torch.ops import cuda_lrn
    spec = zoo.caffenet(batch=2, crop=67, n_classes=16)
    gpu, cpu = TorchNet(spec, device="cuda"), TorchNet(spec, device="cpu")
    batch = _batch(CompiledNet.compile(spec), 50.0)
    before = cuda_lrn.lrn_fwd.launches
    got = gpu.forward(batch)
    assert cuda_lrn.lrn_fwd.launches == before + 2
    np.testing.assert_allclose(got["prob"], cpu.forward(batch)["prob"],
                               rtol=0, atol=1e-6)
