"""host_lead_ms: how far the host ran ahead of the card: the median over
the window's rounds of the loop's `host_lead_ms`, each round's smallest
lead at an edge of its card-timed spans (the time the card reached the
edge, on the host's clock, minus the time the host queued it). Near 0
the card waited on the host. None where the records lack it."""
import statistics


def read(ctx):
    vals = [r["host_lead_ms"] for r in ctx.records if "host_lead_ms" in r]
    if not vals:
        return None
    return statistics.median(vals)
