"""forward_ms: card ms a round between the edges of the program's
"forward" spans (summed over the round's steps): the mean over the
window's rounds of the loop's `card_forward_ms`, which rank 0's records
carry while its tracer times spans on the card (the traced run). None
where the records lack it."""


def read(ctx):
    vals = [r["card_forward_ms"] for r in ctx.records
            if "card_forward_ms" in r]
    if not vals:
        return None
    return sum(vals) / len(vals)
