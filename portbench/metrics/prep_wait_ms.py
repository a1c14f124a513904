"""prep_wait_ms: the loop's own wait for a round's batches, as its
telemetry records it: the mean over the window's rounds of t_data_ms (the
main thread's wait for round prep) + t_h2d_ms (placement's blocking
share)."""


def read(ctx):
    waits = [r["t_data_ms"] + r["t_h2d_ms"] for r in ctx.records
             if "t_data_ms" in r and "t_h2d_ms" in r]
    if not waits:
        return None
    return sum(waits) / len(waits)
