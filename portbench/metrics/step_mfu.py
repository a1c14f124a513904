"""step_mfu: the whole training step's share of the cards' dense bf16
peak: training FLOPs per image (portbench/flops.py) x the images every
rank trained in the window, over the window's seconds, over the peak of
one card times the ranks."""
from portbench import flops
from portbench.metrics_common import require_card


def read(ctx):
    require_card(ctx, "step_mfu")
    pk = flops.peaks(ctx.device_name)
    if pk is None:
        return None
    rate = flops.train_flops_per_image(ctx.config) * ctx.images / ctx.window_s
    return 100.0 * rate / (pk["bf16_flops"] * ctx.world)
