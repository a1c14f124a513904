"""Tiny cells for the CPU tests: the configurations' own layer lists at a
size a test run holds (CaffeNet at crop 67, 10 classes and a tenth of the
rate; a two-conv graph at crop 16), with the cells' real limits."""
from __future__ import annotations

import copy
import json

from portbench import load

UNITS = {"train_img_per_s": "img/s", "setup_s": "s", "prep_wait_ms": "ms",
         "step_mfu": "%", "device_idle_pct": "%", "lrn_roofline_pct": "%",
         "maxpool_bwd_roofline_pct": "%", "allreduce_ms": "ms"}


def _json(rel: str) -> dict:
    with open(load.HERE / rel) as f:
        return json.load(f)


def caffe(batch: int = 4, crop: int = 67, classes: int = 10, tau: int = 2,
          precision: str = "float32"):
    c = copy.deepcopy(_json("configs/caffenet.json"))
    c.update(batch=batch, crop=crop, n_classes=classes, precision=precision)
    # at crop 67 the published rate diverges within some tens of rounds
    c["solver"] = dict(c["solver"], base_lr=0.001)
    for layer in c["layers"]:
        if layer["name"] == "fc8":
            layer["inner_product_param"]["num_output"] = classes
    t = dict(_json("traffic/b256.tau5.json"), local_batch=batch, tau=tau)
    return c, t


def graph(batch: int = 4, crop: int = 16, classes: int = 10, tau: int = 2,
          precision: str = "float32"):
    c = copy.deepcopy(_json("configs/alexnet_graph.json"))
    c.update(batch=batch, crop=crop, n_classes=classes, precision=precision)
    c["layers"] = [
        {"name": "conv1", "op": "Conv2D", "kernel": 3, "in": 3, "out": 8,
         "stride": 2, "padding": "SAME", "std": 0.1, "bias": 0.0,
         "relu": True, "pool": {"ksize": 3, "strides": 2,
                                "padding": "VALID"}},
        {"name": "conv2", "op": "Conv2D", "kernel": 3, "in": 8, "out": 8,
         "stride": 1, "padding": "SAME", "std": 0.1, "bias": 0.0,
         "relu": True},
        {"name": "flat", "op": "Flatten"},
        {"name": "fc6", "op": "MatMul", "in": 72, "out": 32, "std": 0.1,
         "bias": 0.1, "relu": True},
        {"name": "fc8", "op": "MatMul", "in": 32, "out": classes,
         "std": 0.1, "bias": 0.0, "relu": False},
        {"name": "loss", "op": "SparseSoftmaxCrossEntropy"}]
    t = dict(_json("traffic/b256.tau5.json"), local_batch=batch, tau=tau)
    return c, t


def cell(name: str, config: dict, traffic: dict, chips: int = 1,
         limits_of: str = None, per_layer=()) -> load.Cell:
    """A cell over a tiny configuration, held to the limits of the
    benchmark cell `limits_of`."""
    limits = _json(f"limits/{limits_of}.json") if limits_of else {
        "loss_gap": 1e-4, "grad_gap": 1e-4, "grad_unit_gap": 1e-4,
        "momentum_gap": 1e-4, "change_gap": 1e-4}
    return load.Cell(name=name, config=config, traffic=traffic, chips=chips,
                     end_to_end=["train_img_per_s", "setup_s"],
                     per_layer=list(per_layer), units=UNITS, limits=limits)
