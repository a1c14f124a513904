"""Sequence-parallel attention on NCCL ranks, one per card, at long
context: ring and Ulysses, causal and not, under the "float32" (TF32 off)
and "bfloat16" policies, at B, H, D = 1, 8, 128 and L = 32768 on 4 ranks
(8192 tokens a rank), L = 16384 on 2. The ranks are
`tests/torch_attention_worker.py:run_card` processes; this file imports
torch and the port only. Each rank draws q, k, v from one seed on its
card, runs forward and backward of sum(out**2) through its block (timed
after a warm-up run, with the peak memory of the timed run) and holds the
output and dq, dk, dv on its rows to exact `attention` over the whole
sequence, computed one head at a time under the same policy (all eight
heads' float32 scores at once would not fit: 8 x 4.3 GB at L = 32768,
before the backward).

Tolerance: the largest |error| of each of the four over the largest
|reference| there, at most 1e-4 under "float32" (sums of up to 32768
terms in another order) and 3e-2 under "bfloat16" (scores, probabilities
and products rounded to bfloat16, whose ulp is 2**-8 relative: the ring
rounds each block's unnormalized probabilities where exact attention
rounds the normalized ones).

Also `dryrun_multichip(2)` and `(4)` on the cards. Skips without the cards
it needs; run on a machine with four: `python -m pytest -m gpu
tests/test_torch_attention_cards.py -q -s` (figures printed and left in
chiprun_out/attention_cards.json). `card_runs(..., device="cpu")`
rehearses the same cases on gloo CPU ranks at a small size:
`PYTHONPATH=. python tests/test_torch_attention_cards.py`.
"""
import json
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_attention_worker
from sparknet_tpu_torch.dryrun import dryrun_multichip

SPAWN_TIMEOUT_S = 900
#: the context length a card world runs at
CARD_L = {2: 16384, 4: 32768}
B, H, D = 1, 8, 128
CASES = [(impl, causal, pol) for impl in ("ring", "ulysses")
         for causal in (False, True) for pol in ("float32", "bfloat16")]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def spawn(world, tmp_path, setup):
    """run_card on `world` ranks; their npz results."""
    ctx = mp.spawn(torch_attention_worker.run_card,
                   args=(world, str(tmp_path / "store"), setup,
                         str(tmp_path)), nprocs=world, join=False)
    waited = 0
    while not ctx.join(timeout=5):
        waited += 5
        if waited >= SPAWN_TIMEOUT_S:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks did not finish in "
                        f"{SPAWN_TIMEOUT_S} s")
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


def card_runs(tmp_path, world, device="cuda", L=None, d=D):
    """Every case of CASES on `world` ranks (module docstring); returns
    one row per rank and case: ms, peak bytes, FLOPs of the forward, and
    each tensor's error over its largest reference."""
    L = L or CARD_L[world]
    res = spawn(world, tmp_path, {"device": device, "B": B, "L": L, "H": H,
                                  "D": d, "seed": 17, "cases": CASES})
    lq = L // world
    rows = []
    for impl, causal, pol in CASES:
        key = f"{impl}/{int(causal)}/{pol}"
        for r, got in enumerate(res):
            rel = {n: got[f"err/{n}/{key}"] / got[f"ref/{n}/{key}"]
                   for n in ("out", "dq", "dk", "dv")}
            row = {"world": world, "rank": r, "impl": impl,
                   "causal": causal, "policy": pol, "L": L,
                   "fwd_bwd_ms": float(got[f"ms/{key}"]),
                   "peak_bytes": int(got.get(f"peak/{key}", -1)),
                   # 4·B·H·Lq·L·D: the two products of every score a rank
                   # computes (Ulysses: H/n heads over all L queries)
                   "fwd_flops": 4 * B * H * lq * L * d,
                   **{f"rel_err_{n}": float(e) for n, e in rel.items()}}
            rows.append(row)
            print(f"attention cards: {json.dumps(row)}", flush=True)
            for n, e in rel.items():
                assert e <= TOL[pol], (key, r, n, e)
    return rows


@pytest.mark.gpu
@pytest.mark.parametrize("world", [2, 4])
def test_nccl_ring_and_ulysses_at_long_context(tmp_path, world):
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA cards")
    rows = card_runs(tmp_path, world)
    os.makedirs("chiprun_out", exist_ok=True)
    path = os.path.join("chiprun_out", "attention_cards.json")
    prev = json.load(open(path)) if os.path.exists(path) else {}
    prev[str(world)] = {"card": torch.cuda.get_device_name(0), "rows": rows}
    with open(path, "w") as f:
        json.dump(prev, f)


@pytest.mark.gpu
@pytest.mark.parametrize("world", [2, 4])
def test_the_dry_run_on_cards(world):
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA cards")
    res = dryrun_multichip(world)
    assert res["meta"]["backend"] == "cuda"
    assert res["meta"]["device_kind"] == torch.cuda.get_device_name(0)
    for key in ("loss", "tp_loss", "sp_loss", "graph_loss"):
        assert np.isfinite(res[key]), key
    assert 0.0 <= res["acc"] <= 1.0
    assert res["graph_replica_spread"] <= 1e-5
    print(res["line"], flush=True)


if __name__ == "__main__":
    # the rehearsal on gloo CPU ranks, which needs no card:
    # PYTHONPATH=. python tests/test_torch_attention_cards.py
    import pathlib
    import tempfile

    for n in (2, 4):
        with tempfile.TemporaryDirectory() as tmp:
            card_runs(pathlib.Path(tmp), n, device="cpu", L=64 * n, d=32)
        print(f"rehearsal: {n} gloo ranks passed (L {64 * n}, D 32; "
              f"torch {torch.__version__})", flush=True)
