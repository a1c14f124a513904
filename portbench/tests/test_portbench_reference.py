"""The plain reference held to the port at a tiny size on the CPU: one
CaffeNet TRAIN step (LRN, MAX pool, dropout), Caffe's AVE pool and its Caffe SGD update,
one graph step with its in-graph Momentum, and the τ average over
workers. This file may import both; `portbench/reference/` imports
nothing of the port."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import compare, inputs
from portbench.reference import caffe as ref_caffe
from portbench.reference import graph as ref_graph
from portbench.reference import precision as ref_precision
from portbench.reference.train import follow
from portbench.tests import tiny

CPU = torch.device("cpu")


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.fixture
def f32_policy():
    from sparknet_tpu_torch import precision
    precision.set_policy("float32")
    yield
    precision.set_policy("float32")


def test_caffenet_step_matches_the_port(f32_policy):
    from sparknet_tpu_torch import zoo
    from sparknet_tpu_torch.model.layers import OpsImpl, seeded_generator
    from sparknet_tpu_torch.model.net import CompiledNet
    from sparknet_tpu_torch.solver import SgdSolver, SolverConfig, \
        value_and_grad
    config, traffic = tiny.caffe(precision="float32")
    net = CompiledNet.compile(zoo.caffenet(batch=4, crop=67, n_classes=10))
    w = inputs.make_weights(config, 5, CPU)
    rows = inputs.make_round(config, traffic, 5, 0, 0, CPU)
    data, label = rows["data"][0], rows["label"][0]
    port = {}
    for key, v in w.items():
        layer, leaf = key.split("/")
        port.setdefault(layer, {})[leaf] = v.clone().requires_grad_(True)
    gen = seeded_generator((5, 0, 0, 0))
    loss_p, grads_p = value_and_grad(
        net.loss_fn(ops=OpsImpl(lrn="plain", pool="plain")), port,
        {"data": data.float(), "label": label}, gen)
    mine = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    loss_r = ref_caffe.loss(config, mine, {"data": data, "label": label},
                            "float32", (5, 0, 0, 0))
    grads_r = dict(zip(mine, torch.autograd.grad(loss_r, list(
        mine.values()))))
    lr = float(loss_r.detach())
    assert abs(float(loss_p) - lr) <= 1e-6 * abs(lr)
    flat_p = {f"{l}/{p}": g for l, lp in grads_p.items() for p, g in lp.items()}
    # a convolution's weight gradient over random rows nearly cancels, so
    # the two layouts' summation orders move it most: held as the check
    # holds it (gaps of norms; the per-unit median)
    keys = list(grads_r)
    assert max(compare.leaf_gaps(flat_p, grads_r, keys)) < 1e-4
    assert float(compare.unit_gaps(flat_p, grads_r, keys, compare.unit_axes(
        config, keys)).median()) < 1e-6
    # one Caffe SGD update from those gradients
    solver = SgdSolver(net, SolverConfig(**config["solver"]))
    sstate = solver.init_state(port)
    solver.update(port, sstate, grads_p)
    sgd = ref_caffe.Sgd(config)
    mom = sgd.zeros(mine)
    with torch.no_grad():
        sgd.update(mine, mom, grads_r, 0)
    mom_p = {f"{l}/{p}": v for l, lp in sstate.momentum.items()
             for p, v in lp.items()}
    assert max(compare.leaf_gaps(mom_p, mom, keys)) < 1e-4
    for key in mine:
        layer, leaf = key.split("/")
        assert _rel(port[layer][leaf].detach(), mine[key].detach()) < 1e-6


def test_dropout_masks_are_the_loops():
    from sparknet_tpu_torch.model.layers import ApplyCtx, seeded_generator
    ctx = ApplyCtx(train=True, generator=seeded_generator((9, 2, 1, 3)))
    want = torch.rand((4, 32), generator=ctx.fold("drop6", CPU))
    got = torch.rand((4, 32), generator=ref_caffe.dropout_generator(
        (9, 2, 1, 3), "drop6", CPU))
    assert torch.equal(want, got)


def test_lrn_matches_the_ports_plain_formula():
    from sparknet_tpu_torch.ops.lrn import lrn_plain
    x = 30 * torch.randn(2, 16, 5, 5, generator=torch.Generator()
                         .manual_seed(0))
    want = lrn_plain(x.permute(0, 2, 3, 1), 5, 1e-4, 0.75, 1.0)
    got = ref_caffe.lrn(x, 5, 1e-4, 0.75, 1.0).permute(0, 2, 3, 1)
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-6)


def test_graph_step_matches_the_port(f32_policy):
    from sparknet_tpu_torch.backend import GraphNet

    from portbench.adapters.graph import Program
    config, traffic = tiny.graph()
    w = inputs.make_weights(config, 3, CPU)
    graph = Program(config, traffic).graph(
        {k: v.numpy() for k, v in w.items()})
    net = GraphNet(graph, device="cpu")
    rows = inputs.make_round(config, traffic, 3, 0, 0, CPU)
    data, label = rows["data"][0], rows["label"][0]
    new, loss_p = net.make_train_step()(
        net.init_train_state(), {"data": data.float(), "label": label})
    mine = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    loss_r = ref_graph.loss(config, mine, {"data": data, "label": label},
                            "float32", (3, 0, 0, 0))
    grads = dict(zip(mine, torch.autograd.grad(loss_r,
                                               list(mine.values()))))
    lr = float(loss_r.detach())
    assert abs(float(loss_p) - lr) <= 1e-6 * abs(lr)
    opt = ref_graph.Momentum(config)
    accum = opt.zeros(mine)
    with torch.no_grad():
        opt.update(mine, accum, grads, 0)
    for k in mine:
        assert _rel(new["variables"][k], mine[k].detach()) < 1e-6, k
        assert _rel(new["slots"][k], accum[k]) < 1e-5, k


def test_the_graph_builder_is_build_alexnet_graphs():
    from sparknet_tpu_torch.backend.builder import build_alexnet_graph

    from portbench.adapters.graph import Program
    config = tiny._json("configs/alexnet_graph.json")
    want = build_alexnet_graph(batch=2, n_classes=1000)
    config["batch"] = 2
    shapes = {k: s for k, s, _ in ref_graph.weight_leaves(config)}
    got = Program(config, dict(local_batch=2)).graph(
        {k: np.zeros(s, np.float32) for k, s in shapes.items()})

    def strip(g):
        return [(n.name, n.op, list(n.inputs),
                 {k: (np.shape(v) if k == "init" else v)
                  for k, v in n.attrs.items()}) for n in g.nodes]

    assert strip(got) == strip(want)


def test_the_zoo_caffenet_is_the_published_layer_list():
    from sparknet_tpu_torch import zoo
    config = tiny._json("configs/caffenet.json")
    spec = zoo.caffenet(batch=256, crop=227, n_classes=1000)
    ours = [(l["name"], l["type"]) for l in config["layers"]]
    theirs = [(l.name, l.type) for l in spec.layers
              if l.type not in ("Softmax", "Accuracy")]
    assert ours == theirs
    by_name = {l.name: l for l in spec.layers}
    for layer in config["layers"]:
        l = by_name[layer["name"]]
        if layer["type"] == "Convolution":
            p, q = layer["convolution_param"], l.conv
            assert (p["num_output"], p["kernel_size"], p.get("stride", 1),
                    p.get("pad", 0), p.get("group", 1)) == (
                q.num_output, q.kernel_size, q.stride, q.pad, q.group)
            assert p["weight_filler"]["std"] == q.weight_filler.std
            assert p["bias_filler"]["value"] == q.bias_filler.value
        if layer["type"] == "InnerProduct":
            p, q = layer["inner_product_param"], l.inner_product
            assert p["num_output"] == q.num_output
            assert p["weight_filler"]["std"] == q.weight_filler.std
        if layer.get("param"):
            assert [(x["lr_mult"], x["decay_mult"]) for x in layer["param"]] \
                == [(x.lr_mult, x.decay_mult) for x in l.params]
        if layer["type"] == "LRN":
            p = layer["lrn_param"]
            assert (p["local_size"], p["alpha"], p["beta"]) == (
                l.lrn.local_size, l.lrn.alpha, l.lrn.beta)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12,
                      -3.0 - 2 ** -9 - 2 ** -11])
    got = ref_precision.round_tf32(x)
    assert got.tolist() == [1.0, 1.0, 1.0 + 2 ** -10, -3.0 - 2 ** -9]


def _caffe_ave_pool(x: np.ndarray, k: int, s: int, pad: int) -> np.ndarray:
    """Caffe's AVE forward, loop for loop (pooling_layer.cpp)."""
    from portbench.reference.caffe import caffe_pool_size
    n, c, h, w = x.shape
    oh, ow = caffe_pool_size(h, k, s, pad), caffe_pool_size(w, k, s, pad)
    y = np.zeros((n, c, oh, ow))
    for ph in range(oh):
        for pw in range(ow):
            hs, ws = ph * s - pad, pw * s - pad
            he, we = min(hs + k, h + pad), min(ws + k, w + pad)
            size = (he - hs) * (we - ws)
            hs, ws, he, we = max(hs, 0), max(ws, 0), min(he, h), min(we, w)
            y[:, :, ph, pw] = x[:, :, hs:he, ws:we].sum(axis=(2, 3)) / size
    return y


@pytest.mark.parametrize("hw,k,s,pad", [
    ((8, 8), 3, 2, 0), ((7, 9), 3, 2, 1), ((6, 6), 2, 2, 0),
    ((13, 13), 3, 2, 0), ((5, 5), 3, 3, 1)])
def test_ave_pool_divides_as_caffe(hw, k, s, pad):
    """AVE pooling (cifar10_quick's pool2 and pool3) against Caffe's loop
    and against the port's `ops.pooling.pool2d`, forward and backward."""
    from sparknet_tpu_torch.ops.pooling import pool2d
    from portbench.reference.caffe import caffe_pool_size
    g = torch.Generator().manual_seed(sum(hw) * 10 + k)
    x = torch.randn((2, 3) + hw, generator=g, dtype=torch.float64)
    want_hw = [caffe_pool_size(d, k, s, pad) for d in hw]
    got = ref_caffe.pool(x, "AVE", k, s, pad, want_hw)
    np.testing.assert_allclose(got.numpy(), _caffe_ave_pool(x.numpy(), k, s,
                                                            pad), rtol=1e-12)
    xr = x.float().requires_grad_(True)
    xp = x.float().requires_grad_(True)
    yr = ref_caffe.pool(xr, "AVE", k, s, pad, want_hw)
    yp = pool2d(xp, "AVE", k, s, pad)
    torch.testing.assert_close(yr, yp, rtol=1e-6, atol=1e-6)
    dy = torch.randn(yr.shape, generator=g)
    torch.testing.assert_close(torch.autograd.grad(yr, xr, dy)[0],
                               torch.autograd.grad(yp, xp, dy)[0],
                               rtol=1e-6, atol=1e-6)


def test_the_reference_pools_max_and_ave_only():
    with pytest.raises(ValueError, match="STOCHASTIC"):
        ref_caffe.pool(torch.zeros(1, 1, 4, 4), "STOCHASTIC", 2, 2, 0, [2, 2])


@pytest.mark.parametrize("kind,cell", [
    ("caffe", "caffenet.b256.tau5"), ("graph", "alexnet_graph.b256.tau5")])
def test_the_controls_fail_the_checks_of_their_cells(kind, cell):
    """The control, the reference in the precision below the
    configuration's, put in the program's place: the comparison that
    decides `correct` says not correct under the cell's own limits."""
    from portbench.reference.precision import CONTROL
    config, traffic = getattr(tiny, kind)(
        precision=tiny._json(f"configs/{'caffenet' if kind == 'caffe' else 'alexnet_graph'}.json")["precision"])
    limits = tiny._json(f"limits/{cell}.json")
    ref = follow(config, traffic, 8, 1, 3, CPU)
    got = follow(config, traffic, 8, 1, 3, CPU,
                 mode=CONTROL[config["precision"]])
    nums = compare.numbers(got, ref, compare.unit_axes(config, ref["first"]))
    assert not compare.decide(nums, limits), nums


def test_the_reference_follows_itself_exactly():
    config, traffic = tiny.graph()
    a = follow(config, traffic, 4, 2, 2, CPU)
    b = follow(config, traffic, 4, 2, 2, CPU)
    assert a["loss"] == b["loss"]
    nums = compare.numbers(a, b, compare.unit_axes(config, b["first"]))
    assert set(nums.values()) == {0.0}


def test_the_average_is_over_workers():
    config, traffic = tiny.graph()
    one = follow(config, traffic, 4, 2, 1, CPU, fault="no_exchange")
    avg = follow(config, traffic, 4, 2, 1, CPU)
    assert compare.numbers(one, avg, compare.unit_axes(
        config, avg["first"]))["change_gap"] > 0.05
