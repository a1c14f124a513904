"""exchange_ms: card ms a round of rank 0's "exchange" spans, from the
tau-boundary average through the round's scalar all-reduce, with rank
0's wait for the slowest rank in it (`allreduce_ms` is the part without
the wait): the mean over the window's rounds of the loop's
`card_exchange_ms`. None where the records lack it."""


def read(ctx):
    vals = [r["card_exchange_ms"] for r in ctx.records
            if "card_exchange_ms" in r]
    if not vals:
        return None
    return sum(vals) / len(vals)
