"""Sequence parallelism: ring attention and the all-to-all (Ulysses) form.

The counterpart of `sparknet_tpu/parallel/ring_attention.py`. A long
sequence is sharded over a process group, the port's form of the JAX
package's ("seq",) mesh axis: one process per card, a `DataGroup` (NCCL on
the card, gloo on the CPU; `parallel/mesh.py`). Each rank holds its
[B, L/n, H, D] block of q, k and v, block r holding positions
r·L/n ... (r+1)·L/n − 1 (`shard_sequence`; `gather_sequence` is the way
back).

  - **Ring** (`ring_attention`): at step t this rank holds KV shard
    src = (me − t) mod n and folds it into a stable online softmax
    (`ops/attention.py:block_accumulate`); then the KV shard moves one rank
    on, j → j+1. The move is `_RingShift`, ONE autograd Function for k and
    v together over one `dist.batch_isend_irecv`, whose backward is the
    inverse permutation (JAX's transpose of `lax.ppermute`). One node per
    step keeps the backward's P2P calls in one order on every rank: two
    independent nodes could run in different orders on different ranks
    and pair k's gradient with v's, or hang. The JAX scan's last rotation,
    whose result is unused, is not made; at n = 1 nothing moves.
  - **Ulysses** (`ulysses_attention`): a tiled all-to-all swaps sequence
    sharding for head sharding (`lax.all_to_all(..., tiled=True)`'s chunk
    order: the heads split into n contiguous groups, rank j takes group j,
    the sequence blocks join in rank order), exact local attention runs
    over the whole sequence for H/n heads, and the inverse all-to-all
    swaps back. `_AllToAll` is an autograd Function over
    `dist.all_to_all_single` whose backward is the inverse all-to-all; it
    moves q, k and v in one node, in a fixed order.

No silent fallback: a CUDA tensor on a gloo group, or a CPU tensor on an
NCCL group, raises; nothing moves tensors between devices to make a call
work.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.distributed as dist

from ..ops.attention import (attention, block_accumulate,
                             finalize_accumulator, init_accumulator)
from .mesh import DataGroup

SEQ_AXIS = "seq"


def _check_devices(group: DataGroup, *tensors: torch.Tensor) -> None:
    """Raise ValueError unless every tensor lies on the group's device type
    and, above a world of one, the group's backend communicates that type
    (NCCL CUDA tensors, gloo CPU ones)."""
    want = group.device.type
    for t in tensors:
        if t.device.type != want:
            raise ValueError(
                f"a {t.device.type} tensor on a group of {want} ranks: "
                f"nothing moves it to the group's device")
    if group.size > 1 and dist.is_initialized():
        backend = str(dist.get_backend(group.pg))
        if (backend, want) not in (("nccl", "cuda"), ("gloo", "cpu")):
            raise ValueError(f"the group's {backend} backend does not "
                             f"communicate its {want} tensors")


def _global_rank(group: DataGroup, r: int) -> int:
    return r if group.pg is None else dist.get_global_rank(group.pg, r)


def _shift(group: DataGroup, tensors: Sequence[torch.Tensor], step: int
           ) -> Tuple[torch.Tensor, ...]:
    """Each tensor sent `step` ranks on (mod n) and its counterpart received
    from `step` ranks back, all in one batch of P2P calls."""
    n, me = group.size, group.rank
    dst = _global_rank(group, (me + step) % n)
    src = _global_rank(group, (me - step) % n)
    sends = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in sends]
    ops = ([dist.P2POp(dist.isend, t, dst, group=group.pg, tag=i)
            for i, t in enumerate(sends)]
           + [dist.P2POp(dist.irecv, t, src, group=group.pg, tag=i)
              for i, t in enumerate(outs)])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return tuple(outs)


class _RingShift(torch.autograd.Function):
    """(k, v) of rank j -> rank j+1 (mod n); backward: j+1 -> j."""

    @staticmethod
    def forward(ctx, group: DataGroup, k: torch.Tensor, v: torch.Tensor):
        ctx.group = group
        return _shift(group, (k, v), +1)

    @staticmethod
    def backward(ctx, gk: torch.Tensor, gv: torch.Tensor):
        return (None,) + _shift(ctx.group, (gk, gv), -1)


def ring_permute(group: DataGroup, k: torch.Tensor, v: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k and v moved one rank on together, differentiably (`lax.ppermute`
    with perm j -> j+1); the identity at n = 1, with no collective."""
    if group.size == 1:
        return k, v
    _check_devices(group, k, v)
    return _RingShift.apply(group, k, v)


def _tiled_all_to_all(group: DataGroup, x: torch.Tensor, split: int,
                      concat: int) -> torch.Tensor:
    """`lax.all_to_all(x, split_axis=split, concat_axis=concat,
    tiled=True)`: x cut into n chunks along `split`, chunk j sent to rank j,
    the chunks received joined along `concat` in rank order."""
    parts = torch.stack(x.chunk(group.size, dim=split)).contiguous()
    out = torch.empty_like(parts, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, parts, group=group.pg)
    return torch.cat(out.unbind(0), dim=concat)


class _AllToAll(torch.autograd.Function):
    """Tiled all-to-all of each tensor in turn; backward: the inverse (split
    and concat swapped), in the same order."""

    @staticmethod
    def forward(ctx, group: DataGroup, split: int, concat: int,
                *xs: torch.Tensor):
        ctx.group, ctx.split, ctx.concat = group, split, concat
        return tuple(_tiled_all_to_all(group, x, split, concat) for x in xs)

    @staticmethod
    def backward(ctx, *gs: torch.Tensor):
        return (None, None, None) + tuple(
            _tiled_all_to_all(ctx.group, g, ctx.concat, ctx.split)
            for g in gs)


def all_to_all(group: DataGroup, split: int, concat: int,
               *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Each of `xs` through a differentiable tiled all-to-all; the identity
    at n = 1, with no collective."""
    if group.size == 1:
        return xs
    _check_devices(group, *xs)
    if any(x.shape[split] % group.size for x in xs):
        raise ValueError(f"dim {split} of {[tuple(x.shape) for x in xs]} "
                         f"does not split over {group.size} ranks")
    return _AllToAll.apply(group, split, concat, *xs)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   group: DataGroup, causal: bool = False) -> torch.Tensor:
    """This rank's [B, L/n, H, D] output block from its blocks of q, k, v.

    Rank `me` first holds KV shard `me`; at step t it holds shard
    (me − t) mod n, whose causal offsets follow from that."""
    n, me = group.size, group.rank
    _check_devices(group, q, k, v)
    lq = q.shape[1]
    o, m, l = init_accumulator(q.shape, q.device)
    k_cur, v_cur = k, v
    for t in range(n):
        src = (me - t) % n  # whose shard this rank holds at step t
        o, m, l = block_accumulate(o, m, l, q, k_cur, v_cur,
                                   k_offset=src * lq, q_offset=me * lq,
                                   causal=causal)
        if t < n - 1:  # the last rotation's result would go unused
            k_cur, v_cur = ring_permute(group, k_cur, v_cur)
    return finalize_accumulator(o, m, l, q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      group: DataGroup, causal: bool = False
                      ) -> torch.Tensor:
    """This rank's [B, L/n, H, D] output block; H % n == 0.

    all-to-all: sequence-sharded -> head-sharded (the whole L, H/n heads),
    exact attention here, then back."""
    n = group.size
    if q.shape[2] % n:
        raise ValueError(f"heads {q.shape[2]} not divisible by the "
                         f"sequence group's size {n}")
    _check_devices(group, q, k, v)
    # [B, L/n, H, D] -> gather the sequence, scatter the heads -> [B, L, H/n, D]
    qh, kh, vh = all_to_all(group, 2, 1, q, k, v)
    oh = attention(qh, kh, vh, causal=causal)
    return all_to_all(group, 1, 2, oh)[0]


def shard_sequence(x: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """This rank's block of a global [B, L, H, D] tensor along L,
    contiguous (a view where the block already is; differentiable)."""
    if x.shape[1] % group.size:
        raise ValueError(f"length {x.shape[1]} does not split over "
                         f"{group.size} ranks")
    return x.chunk(group.size, dim=1)[group.rank].contiguous()


def gather_sequence(x: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """The global [B, L, H, D] tensor from every rank's block, in rank order
    (one `all_gather`; a collective, and not differentiable)."""
    _check_devices(group, x)
    rows = group.all_gather(x.detach())  # [n, B, L/n, H, D]
    return torch.cat(rows.unbind(0), dim=1)


def make_ring_attention(group: DataGroup, *, causal: bool = False,
                        impl: str = "ring") -> Callable:
    """Host-level wrapper: `apply(q, k, v)` takes the GLOBAL [B, L, H, D]
    tensors (every rank the same), runs `impl` ("ring" or "ulysses") on
    this rank's blocks and returns the global output on every rank (a
    collective: every rank calls it)."""
    if impl not in ("ring", "ulysses"):
        raise ValueError(f"unknown impl {impl!r}: expected 'ring' or "
                         f"'ulysses'")
    fn = ring_attention if impl == "ring" else ulysses_attention

    def apply(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
        out = fn(shard_sequence(q, group), shard_sequence(k, group),
                 shard_sequence(v, group), group=group, causal=causal)
        return gather_sequence(out, group)

    return apply
