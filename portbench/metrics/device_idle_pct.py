"""device_idle_pct: 100 x (1 - the union of device operations' intervals
over the traced rounds' window), from torch.profiler's trace of rank 0."""
from portbench import devtime
from portbench.metrics_common import require_card


def read(ctx):
    require_card(ctx, "device_idle_pct")
    prof = ctx.profile
    if prof is None or not prof.events:
        return None
    busy, _ = devtime.busy_and_gaps(prof.events, prof.t0, prof.t1)
    return 100.0 * (1.0 - busy / (prof.t1 - prof.t0))
