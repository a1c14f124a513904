"""allreduce_ms: device time of the exchange per round, without the wait
for the slowest rank: the NCCL kernels of the traced rounds taken in
their order on every rank (each rank launches the same collectives in the
same order), the shortest of each collective's kernels over the ranks
(the rank that arrived last waited for no one), summed over the rounds'
collectives (the tau-boundary parameter average and the round's
scalars). Where the ranks' kernels do not pair up, the smallest of the
ranks' sums."""
import sys

from portbench.metrics_common import require_card


def nccl_durations(events):
    """The durations (us) of the NCCL kernels in `events`, in start
    order."""
    return [d for name, _, d in sorted(events, key=lambda e: e[1])
            if "nccl" in name.lower()]


def read(ctx):
    require_card(ctx, "allreduce_ms")
    prof = ctx.profile
    if ctx.world < 2 or prof is None:
        return None
    per_rank = [nccl_durations(ev) for ev in prof.rank_events]
    if len({len(d) for d in per_rank}) == 1:
        us = sum(min(col) for col in zip(*per_rank))
    else:  # the kernels do not pair up: the least-waiting rank's sum
        print(f"portbench: allreduce_ms: NCCL kernels by rank "
              f"{[len(d) for d in per_rank]}; the least rank's sum",
              file=sys.stderr)
        us = min(sum(d) for d in per_rank)
    if us <= 0:
        return None
    return us / 1e3 / prof.rounds
