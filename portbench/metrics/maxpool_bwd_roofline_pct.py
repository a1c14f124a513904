"""maxpool_bwd_roofline_pct: the MAX-pool backward kernel's share of its
roofline at every MAX pool layer's shape and dtype, through the port's
public `ops.pooling.pool2d` with autograd (portbench/metrics_common.py)."""
from portbench.metrics_common import maxpool_bwd_roofline


def read(ctx):
    return maxpool_bwd_roofline(ctx)
