"""The raw-pixel door: the port's InferenceServer with a `preprocessor`
against the JAX server's.

CaffeNet (crop 67, 16 classes, the JAX package's seeded init carried into
the port) behind both packages' servers, each with its own
`ImagePreprocessor` (crop 67, one seeded mean image). Requests are seeded
uint8 CHW images of 3x80x80, the preprocessor's raw schema, not the net's
input schema.
- Per request (bucket 1) and in one batch of 8 (the requests are queued
  before the server starts, so the worker forms one batch): the port's
  prob within rtol 1e-4 / atol 1e-6 of the JAX server's (convolution sums
  run in another order), and `torch.equal` to the port net's forward of
  the host-decoded bucket (the request rows decoded by the same
  preprocessor, padded with zeros as the server pads).
- The router's `add_model(preprocessor=)` decodes at the lane's door, as
  the JAX router's does.
- A mis-shaped raw payload passes the door (no schema check before the
  decode) and fails its own group's future, as in the JAX server (a
  ValueError in the port; the JAX native plane asserts instead); a
  well-formed request queued beside it, of another signature, answers.
"""
import numpy as np
import pytest
import torch

from sparknet_tpu import zoo as jax_zoo
from sparknet_tpu.data.preprocess import ImagePreprocessor as JaxPre
from sparknet_tpu.net_api import JaxNet
from sparknet_tpu.schema import Field as JaxField
from sparknet_tpu.schema import Schema as JaxSchema
from sparknet_tpu.serve.router import ModelRouter as JaxRouter
from sparknet_tpu.serve.router import RouterConfig as JaxRouterConfig
from sparknet_tpu.serve.server import InferenceServer as JaxServer
from sparknet_tpu.serve.server import ServeConfig as JaxServeConfig

from sparknet_tpu_torch import zoo
from sparknet_tpu_torch.data.preprocess import ImagePreprocessor
from sparknet_tpu_torch.net_api import TorchNet
from sparknet_tpu_torch.schema import Field, Schema
from sparknet_tpu_torch.serve.router import ModelRouter, RouterConfig
from sparknet_tpu_torch.serve.server import InferenceServer, ServeConfig

torch.set_num_threads(2)

CROP, RAW, NCLS, N = 67, 80, 16, 8
RTOL, ATOL = 1e-4, 1e-6


def _images(n=N, seed=11, size=RAW):
    r = np.random.default_rng(seed)
    return [r.integers(0, 256, (3, size, size)).astype(np.uint8)
            for _ in range(n)]


def _mean():
    return np.random.default_rng(12).uniform(
        100, 140, (3, RAW, RAW)).astype(np.float32)


@pytest.fixture(scope="module")
def nets():
    jnet = JaxNet(jax_zoo.caffenet(batch=N, crop=CROP, n_classes=NCLS),
                  seed=3)
    pnet = TorchNet(zoo.caffenet(batch=N, crop=CROP, n_classes=NCLS),
                    device="cpu")
    pnet.load_jax_params({l: {p: np.asarray(v) for p, v in lp.items()}
                          for l, lp in jnet.params.items()})
    return jnet, pnet


def _pre(jax: bool):
    mean = _mean()
    if jax:
        return JaxPre(JaxSchema(JaxField("data", "float32", (CROP, CROP, 3))),
                      mean_image=mean, crop=CROP)
    return ImagePreprocessor(Schema(Field("data", "float32",
                                          (CROP, CROP, 3))),
                             mean_image=mean, crop=CROP)


def _cfg(cls, **kw):
    return cls(**{**dict(max_batch=N, buckets=(1, N), max_wait_ms=2.0,
                         outputs=("prob",), metrics_every_batches=0), **kw})


def _serve(server, images, together: bool):
    """Each image's prob: one at a time, or all queued before the worker
    starts (one batch)."""
    if together:
        futs = [server.submit({"data": im}) for im in images]
        server.start()
    else:
        server.start()
        futs = []
        for im in images:
            futs.append(server.submit({"data": im}))
            futs[-1].result(timeout=120)
    try:
        return np.stack([f.result(timeout=120)["prob"] for f in futs])
    finally:
        server.stop()


def _direct(pnet, images, bucket):
    """The port net's forward of the host-decoded, zero-padded bucket."""
    dec = _pre(False).convert_batch({"data": np.stack(images)},
                                    train=False)["data"]
    data = np.zeros((bucket, CROP, CROP, 3), np.float32)
    data[:len(images)] = dec
    out = pnet.forward({"data": data,
                        "label": np.zeros((bucket, 1), np.int32)}, ["prob"])
    return out["prob"][:len(images)]


@pytest.mark.parametrize("together", [False, True],
                         ids=["per_request", "batched"])
def test_raw_pixels_answer_as_the_jax_server_and_the_decoded_bucket(
        nets, together):
    jnet, pnet = nets
    images = _images()
    want = _serve(JaxServer(jnet, _cfg(JaxServeConfig),
                            preprocessor=_pre(True)), images, together)
    server = InferenceServer(pnet, _cfg(ServeConfig),
                             preprocessor=_pre(False))
    got = _serve(server, images, together)
    assert got.shape == (N, NCLS)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert sorted({b for _, b in server.batch_log}) == \
        ([N] if together else [1])
    if together:
        direct = _direct(pnet, images, N)
    else:
        direct = np.concatenate([_direct(pnet, [im], 1) for im in images])
    assert torch.equal(torch.from_numpy(got), torch.from_numpy(direct))


def test_the_router_lane_decodes_at_its_door(nets):
    jnet, pnet = nets
    images = _images(4, seed=13)
    out = {}
    for k, router, cfg, net in (
            ("jax", JaxRouter(JaxRouterConfig(workers=1)),
             _cfg(JaxServeConfig), jnet),
            ("port", ModelRouter(RouterConfig(workers=1)),
             _cfg(ServeConfig), pnet)):
        lane = router.add_model("img", net, cfg=cfg,
                                preprocessor=_pre(k == "jax"))
        assert lane.preprocessor is not None
        with router:
            out[k] = np.stack([router.infer("img", {"data": im},
                                            timeout=120)["prob"]
                               for im in images])
    np.testing.assert_allclose(out["port"], out["jax"], rtol=RTOL,
                               atol=ATOL)


def test_a_mis_shaped_raw_payload_fails_as_the_jax_server_fails_it(nets):
    """A 3x60x60 image (smaller than the mean image and the crop) is
    accepted at submit and fails in the decode of its own signature
    group; a good image queued beside it answers."""
    jnet, pnet = nets
    bad = _images(1, seed=14, size=60)[0]
    good = _images(1, seed=15)[0]
    errors, answers = {}, {}
    for k, server in (
            ("jax", JaxServer(jnet, _cfg(JaxServeConfig),
                              preprocessor=_pre(True))),
            ("port", InferenceServer(pnet, _cfg(ServeConfig),
                                     preprocessor=_pre(False)))):
        f_bad = server.submit({"data": bad})
        f_good = server.submit({"data": good})
        server.start()
        try:
            with pytest.raises(Exception) as e:
                f_bad.result(timeout=120)
            errors[k] = type(e.value)
            answers[k] = f_good.result(timeout=120)["prob"]
        finally:
            server.stop()  # joins the worker: its counts are final
        assert server.requests_failed == 1 and server.requests_ok == 1
    # the port's native plane checks its offsets with a ValueError where
    # the JAX plane asserts (numpy's broadcast raises ValueError in both)
    assert errors["port"] is ValueError
    assert errors["jax"] in (ValueError, AssertionError)
    np.testing.assert_allclose(answers["port"], answers["jax"], rtol=RTOL,
                               atol=ATOL)
