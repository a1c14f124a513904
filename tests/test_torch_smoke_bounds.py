"""The chip smoke's yardstick: the bounds it puts beside each kernel's time.

A kernel's bound is the least time the card could take for its work: the
bytes it must move (each input read once, each output written once) over
the H100's 3.35 TB/s, or its f32 operations over 67 TFLOP/s, whichever is
larger. A redesign of a kernel must not move its own bound, so this pins
the numbers at the shapes of one CaffeNet training step (batch 256,
bfloat16) exactly, on the CPU: `chip_smoke` imports no torch at its top.
"""
import importlib.util
import math
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# CaffeNet's MAX pools at batch 256: NHWC x and y
POOLS = {"pool1": ((256, 55, 55, 96), (256, 27, 27, 96)),
         "pool2": ((256, 27, 27, 256), (256, 13, 13, 256)),
         "pool5": ((256, 13, 13, 256), (256, 6, 6, 256))}
# its LRNs at batch 256 on the recompute route: (rows, C)
NORMS = {"norm1": (256 * 27 * 27, 96), "norm2": (256 * 13 * 13, 256)}


@pytest.mark.parametrize("layer", sorted(POOLS))
def test_maxpool_bwd_bound_is_its_bytes(layer):
    """x, y and dy read once, dx written once: 2 * (nx + ny) * 2 bytes in
    bf16, bound by bytes."""
    cs = _smoke()
    x, y = POOLS[layer]
    b = cs.maxpool_bwd_bound(x, y, 3, 2)
    assert b["bytes"] == 2 * (math.prod(x) + math.prod(y)) * 2
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(b["bytes"] / 3.35e12 * 1e3,
                                          rel=1e-12)


def test_training_step_bounds_sum_to_the_recorded_yardstick():
    """pool1 + pool2 + pool5: 0.1965 ms; norm1 + norm2 on the recompute
    route (x and dy read, dx written: 3 * rows * C * 2 bytes): 0.0519 ms."""
    cs = _smoke()
    pool = [cs.maxpool_bwd_bound(x, y, 3, 2) for x, y in POOLS.values()]
    assert [b["bytes"] for b in pool] == [369033216, 235405312, 53739520]
    assert sum(b["bound_ms"] for b in pool) == pytest.approx(0.196471,
                                                             abs=5e-7)
    lrn = [cs.lrn_bwd_bound(rows, c, 2, 5, saved=False)
           for rows, c in NORMS.values()]
    assert [b["bytes"] for b in lrn] == [3 * r * c * 2
                                         for r, c in NORMS.values()]
    assert all(b["bound_by"] == "bytes" for b in lrn)
    assert sum(b["bound_ms"] for b in lrn) == pytest.approx(0.051925,
                                                            abs=5e-7)


def test_saved_mode_reads_the_scale_too():
    """The saved-scale route also reads the scale: 4 * rows * C bytes."""
    cs = _smoke()
    rows, c = 100 * 27 * 27, 96
    assert cs.lrn_bwd_bound(rows, c, 4, 5, saved=True)["bytes"] == \
        4 * rows * c * 4


def test_lrn_fwd_bounds_are_pinned():
    """lrn_fwd y only at the training step's shapes (b256 bf16, x read and
    y written: 2 * rows * C * 2 bytes): 71,663,616 + 44,302,336 bytes,
    0.034617 ms; with the scale at batch 100 in f32 (x read, y and the
    scale written: 3 * rows * C * 4 bytes): 135,897,600 bytes, 0.040566
    ms. Both bound by bytes."""
    cs = _smoke()
    y_only = [cs.lrn_bound(256, h, w, c, 2, 5)
              for h, w, c in ((27, 27, 96), (13, 13, 256))]
    assert [b["bytes"] for b in y_only] == [71663616, 44302336]
    assert all(b["bound_by"] == "bytes" for b in y_only)
    assert sum(b["bound_ms"] for b in y_only) == pytest.approx(0.034617,
                                                               abs=5e-7)
    scale = [cs.lrn_fwd_scale_bound(100 * h * w, c, 4, 5)
             for h, w, c in ((27, 27, 96), (13, 13, 256))]
    assert sum(b["bytes"] for b in scale) == 135897600
    assert all(b["bound_by"] == "bytes" for b in scale)
    assert sum(b["bound_ms"] for b in scale) == pytest.approx(0.040566,
                                                              abs=5e-7)
