"""On the card (marked `gpu`; they skip without one): a one-card cell's run
end to end, and its control failing the check at the cell's own size.

    python -m pytest -m gpu portbench/tests
"""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import load


def _need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["caffenet.b256.tau5",
                                  "alexnet_graph.b256.tau5"])
def test_a_cell_runs_and_is_correct(cell):
    _need_card()
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "4242", "--seconds", "3", "--trace", "0"], cwd=load.ROOT,
        capture_output=True, text=True, timeout=1200, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert line["metrics"]["train_img_per_s"]["value"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["caffenet.b256.tau5",
                                  "alexnet_graph.b256.tau5"])
def test_the_control_fails_at_the_cells_size(cell):
    _need_card()
    import torch

    from portbench import compare
    from portbench.calibrate import reference_readings
    c = load.find_cell(load.load_benchmark(), cell)
    rows = reference_readings(c, [4243], 1, ["control"],
                              torch.device("cuda:0"))
    assert rows and not compare.decide(rows[0][2], c.limits), rows
