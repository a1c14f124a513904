"""lrn_roofline_pct: the LRN kernels' share of their roofline, forward
and backward at every LRN layer's shape and dtype, through the port's
public `ops.lrn.lrn` with autograd (portbench/metrics_common.py)."""
from portbench.metrics_common import lrn_roofline


def read(ctx):
    return lrn_roofline(ctx)
