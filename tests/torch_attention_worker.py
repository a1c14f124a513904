"""One rank of the port's sequence-parallel attention, for
tests/test_torch_ring_attention.py (gloo CPU ranks against the JAX
package) and tests/test_torch_attention_cards.py (NCCL ranks, one per
card, against exact attention). It imports torch and the port only: the
tests spawn it with torch.multiprocessing, it joins a group through a
FileStore and writes what it saw to `<out>/rank<r>.npz`.
"""
import os
import time

import numpy as np
import torch

from sparknet_tpu_torch import precision
from sparknet_tpu_torch.ops.attention import attention
from sparknet_tpu_torch.parallel.mesh import DataGroup, init_data_group
from sparknet_tpu_torch.parallel.ring_attention import (
    gather_sequence, make_ring_attention, ring_attention, ring_permute,
    shard_sequence, ulysses_attention)

IMPLS = {"ring": ring_attention, "ulysses": ulysses_attention}


def _join(rank, world, store_path, device):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    return init_data_group(device, store_path=store_path, rank=rank,
                           world_size=world)


def run_parity(rank, world, store_path, qkv, out_dir):
    """On gloo CPU ranks, for each impl and causal flag: the global output
    of `make_ring_attention`, and the gradients of sum(out**2) in q, k, v
    (each rank differentiates its own block's share; the blocks' gradients
    gathered). Also: `ring_permute` moves each rank's (k, v) to the next
    rank and its backward brings the gradients back; Ulysses with heads
    that do not split over the ranks raises ValueError."""
    torch.set_num_threads(1)
    group = _join(rank, world, store_path, "cpu")
    try:
        q, k, v = (torch.from_numpy(a) for a in qkv)
        out = {}
        for impl, fn in IMPLS.items():
            for causal in (False, True):
                key = f"{impl}/{int(causal)}"
                out[f"out/{key}"] = make_ring_attention(
                    group, causal=causal, impl=impl)(q, k, v).numpy()
                shards = [shard_sequence(x, group).requires_grad_()
                          for x in (q, k, v)]
                o = fn(*shards, group=group, causal=causal)
                torch.sum(o ** 2).backward()
                for name, s in zip(("dq", "dk", "dv"), shards):
                    out[f"{name}/{key}"] = gather_sequence(s.grad,
                                                           group).numpy()
        # the permute: rank j's (k, v) lands on j+1; the weights of rank
        # j+1 come back to rank j as the gradient
        kk = torch.full((2, 3), float(rank), requires_grad=True)
        vv = torch.full((4,), 10.0 + rank, requires_grad=True)
        k1, v1 = ring_permute(group, kk, vv)
        out["perm/k"], out["perm/v"] = k1.detach().numpy(), v1.detach().numpy()
        w = 100.0 + rank
        (torch.sum(k1 * w) + torch.sum(v1 * 2 * w)).backward()
        out["perm/dk"], out["perm/dv"] = kk.grad.numpy(), vv.grad.numpy()
        heads = world + 1  # never divisible by world >= 2
        odd = torch.zeros((1, 2, heads, 4))
        try:
            ulysses_attention(odd, odd, odd, group=group)
            out["odd_heads_raised"] = 0
        except ValueError:
            out["odd_heads_raised"] = 1
        # the same gloo group taken for a group of another device type
        meta = torch.zeros((1, 2 * world, 2, 4), device="meta")
        try:
            ring_attention(meta, meta, meta, group=DataGroup(
                group.rank, group.size, meta.device, pg=group.pg))
            out["backend_mismatch_raised"] = 0
        except ValueError as e:
            out["backend_mismatch_raised"] = int("gloo backend" in str(e))
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        group.close()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_card(rank, world, store_path, setup, out_dir):
    """For each (impl, causal, policy) in setup["cases"]: this rank's block
    of q, k, v (drawn on every rank from one seed, [B, L, H, D]) through
    the impl, forward and backward of sum(out**2) timed after one warm-up
    run (host clock around synchronized work) with the peak memory of the
    timed run; then exact `attention` over the whole sequence one head at
    a time under the same policy, and the largest error of the output and
    of dq, dk, dv on this rank's rows, each beside the largest |reference|
    there. setup: {"device", "B", "L", "H", "D", "seed", "cases"}."""
    device = setup["device"]
    dev = torch.device(f"cuda:{rank}" if device == "cuda" else "cpu")
    if dev.type == "cpu":
        torch.set_num_threads(1)
    group = _join(rank, world, store_path, dev)
    try:
        B, L, H, D = (setup[k] for k in ("B", "L", "H", "D"))
        gen = torch.Generator(device=dev).manual_seed(setup["seed"])
        q, k, v = (torch.randn((B, L, H, D), generator=gen, device=dev)
                   for _ in range(3))
        lq = L // world
        rows = slice(rank * lq, (rank + 1) * lq)
        out = {}
        for impl, causal, pol in setup["cases"]:
            key = f"{impl}/{int(causal)}/{pol}"
            fn = IMPLS[impl]
            with precision.policy(pol):
                dt = precision.compute_dtype()

                def fwd_bwd():
                    shards = [shard_sequence(x, group).to(dt)
                              .requires_grad_() for x in (q, k, v)]
                    o = fn(*shards, group=group, causal=causal)
                    torch.sum(o.float() ** 2).backward()
                    return o.detach(), [s.grad for s in shards]

                fwd_bwd()  # warm-up: the first P2P and all-to-all calls
                _sync(dev)
                group.barrier()
                if dev.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.perf_counter()
                o, grads = fwd_bwd()
                _sync(dev)
                out[f"ms/{key}"] = (time.perf_counter() - t0) * 1e3
                if dev.type == "cuda":
                    out[f"peak/{key}"] = torch.cuda.max_memory_allocated(dev)
                err = dict.fromkeys(("out", "dq", "dk", "dv"), 0.0)
                ref = dict.fromkeys(("out", "dq", "dk", "dv"), 0.0)
                for h in range(H):
                    xs = [x[:, :, h:h + 1].to(dt).requires_grad_()
                          for x in (q, k, v)]
                    oh = attention(*xs, causal=causal)
                    torch.sum(oh.float() ** 2).backward()
                    pairs = [("out", o, oh.detach())] + [
                        (n, g, x.grad) for n, g, x in
                        zip(("dq", "dk", "dv"), grads, xs)]
                    for n, got, want in pairs:
                        got = got[:, :, h].float()
                        want = want[:, rows, 0].float()
                        err[n] = max(err[n], float((got - want).abs().max()))
                        ref[n] = max(ref[n], float(want.abs().max()))
                    del xs, oh, pairs
                for n in err:
                    out[f"err/{n}/{key}"] = err[n]
                    out[f"ref/{n}/{key}"] = ref[n]
                del o, grads
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        group.close()
