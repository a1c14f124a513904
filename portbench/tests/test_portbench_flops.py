"""The yardstick's frozen arithmetic against hand counts and PERF.md's
bounds."""
from __future__ import annotations

import math

import pytest

from portbench import flops, load
from portbench.reference import caffe as ref_caffe
from portbench.reference import graph as ref_graph
from portbench.tests.tiny import _json

CAFFENET = _json("configs/caffenet.json")
GRAPH = _json("configs/alexnet_graph.json")
H100 = flops.peaks("NVIDIA H100 80GB HBM3")


def test_caffenet_training_flops_per_image():
    hand = (2 * 55 * 55 * 11 * 11 * 3 * 96 + 2 * 27 * 27 * 25 * 48 * 256
            + 2 * 13 * 13 * 9 * 256 * 384 + 2 * 13 * 13 * 9 * 192 * 384
            + 2 * 13 * 13 * 9 * 192 * 256 + 2 * 9216 * 4096
            + 2 * 4096 * 4096 + 2 * 4096 * 1000)
    assert flops.forward_flops_per_image(CAFFENET) == hand
    assert round(flops.train_flops_per_image(CAFFENET) / 1e9, 6) == 4.346441


def test_caffenet_flops_match_the_ports_count():
    from sparknet_tpu_torch import zoo
    from sparknet_tpu_torch.model.net import CompiledNet
    from sparknet_tpu_torch.utils.flops import train_flops_per_image
    net = CompiledNet.compile(zoo.caffenet(batch=2, crop=227,
                                           n_classes=1000))
    assert train_flops_per_image(net) == flops.train_flops_per_image(
        CAFFENET)


def test_alexnet_graph_training_flops_per_image():
    hand = (2 * 57 * 57 * 121 * 3 * 64 + 2 * 28 * 28 * 25 * 64 * 192
            + 2 * 13 * 13 * 9 * 192 * 384 + 2 * 13 * 13 * 9 * 384 * 256
            + 2 * 13 * 13 * 9 * 256 * 256 + 2 * 9216 * 4096
            + 2 * 4096 * 4096 + 2 * 4096 * 1000)
    assert flops.forward_flops_per_image(GRAPH) == hand
    assert round(flops.train_flops_per_image(GRAPH) / 1e9, 3) == 4.418


def test_peaks_by_card_name():
    assert H100["bf16_flops"] == 989.4e12
    assert H100["hbm_bytes"] == 3.35e12
    assert flops.peaks("NVIDIA H100 PCIe")["bf16_flops"] == 756e12
    assert flops.peaks("cpu") is None


def _lrn_shapes():
    shapes = ref_caffe.shapes(CAFFENET)
    out = []
    for layer in CAFFENET["layers"]:
        if layer["type"] == "LRN":
            n, c, h, w = shapes[f"{layer['name']}:in"]
            out.append((n, h, w, c))
    return out


def test_lrn_bounds_are_perf_mds():
    shapes = _lrn_shapes()
    assert shapes == [(256, 27, 27, 96), (256, 13, 13, 256)]
    work = [flops.lrn_work(s, 2, 5) for s in shapes]
    fwd = sum(flops.bound_ms(w["fwd_bytes"], w["fwd_ops"], H100)
              for w in work)
    bwd = sum(flops.bound_ms(w["bwd_bytes"], w["bwd_ops"], H100)
              for w in work)
    assert round(fwd, 4) == 0.0346 and round(bwd, 4) == 0.0519
    # bound by bytes, not by operations
    assert all(w["fwd_bytes"] / H100["hbm_bytes"] > w["fwd_ops"]
               / H100["f32_flops"] for w in work)


def test_maxpool_bwd_bound_is_perf_mds():
    shapes = ref_caffe.shapes(CAFFENET)
    total = 0.0
    pools = [l for l in CAFFENET["layers"] if l["type"] == "Pooling"]
    assert [l["name"] for l in pools] == ["pool1", "pool2", "pool5"]
    for layer in pools:
        n, c, h, w = shapes[f"{layer['name']}:in"]
        _, _, oh, ow = shapes[layer["name"]]
        work = flops.maxpool_bwd_work((n, h, w, c), (n, oh, ow, c), 3, 2)
        total += flops.bound_ms(work["bytes"], work["ops"], H100)
    assert round(total, 4) == 0.1965


@pytest.mark.parametrize("size,k,s,pad,want", [
    (55, 3, 2, 0, 27), (27, 3, 2, 0, 13), (13, 3, 2, 0, 6),
    (32, 3, 2, 0, 16), (13, 3, 2, 1, 7), (6, 3, 2, 0, 3)])
def test_caffe_pool_size(size, k, s, pad, want):
    assert ref_caffe.caffe_pool_size(size, k, s, pad) == want


def test_weight_leaves_cover_the_nets_parameters():
    leaves = ref_caffe.weight_leaves(CAFFENET)
    n = sum(math.prod(s) for _, s, _ in leaves)
    assert n == 60965224  # 243.9 MB of float32: PERF.md's 244 MB
    g = ref_graph.weight_leaves(GRAPH)
    assert [k for k, _, _ in g][:2] == ["conv1_w", "conv1_b"]
    assert dict((k, s) for k, s, _ in g)["fc6_w"] == (9216, 4096)


def test_every_cell_has_limits_between_its_readings():
    from portbench.compare import NAMES
    bench = load.load_benchmark()
    for w in bench["workloads"]:
        limits = _json(f"limits/{w['name']}.json")
        assert set(limits) == set(NAMES)
        # a null limit: a number the cell does not compare (PERF.md)
        assert all(v is None or 0 < v < 1 for v in limits.values())
        assert sum(v is not None for v in limits.values()) >= 3
