"""The sharded and tensor-parallel trainers on NCCL ranks, one per card,
at CaffeNet's full width (crop 227, 1000 classes, dropout-free: a dropout
mask is drawn by the tensor's device generator, so CPU and card masks
differ). The ranks are `tests/torch_zero_worker.py` processes; this file
imports torch and the port only. Skips without the cards it needs; run on
a machine with four: `python -m pytest -m gpu tests/test_torch_zero_cards.py
-q -s`.

`card_runs(..., device="cpu")` rehearses the same cases on gloo CPU ranks
at a small size: `PYTHONPATH=. python tests/test_torch_zero_cards.py` runs
it for 2 and 4 ranks.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_zero_worker
from sparknet_tpu_torch import zoo
from sparknet_tpu_torch.model.net import CompiledNet, jax_param_shapes
from sparknet_tpu_torch.model.spec import DropoutParam

TAU = 2
SOLVER = dict(base_lr=0.001, momentum=0.9, weight_decay=0.001)
SPAWN_TIMEOUT_S = 900


def spawn(world, tmp_path, sub, spec, params, rounds, ev, setup):
    """Run torch_zero_worker on `world` ranks; their npz results."""
    out = tmp_path / sub
    out.mkdir()
    ctx = mp.spawn(torch_zero_worker.run,
                   args=(world, str(out / "store"), spec, params, rounds, ev,
                         setup, str(out)), nprocs=world, join=False)
    deadline = SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        deadline -= 5
        if deadline <= 0:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks did not finish in "
                        f"{SPAWN_TIMEOUT_S} s")
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]


CARD_NET = dict(crop=227, n_classes=1000)
CARD_BATCH, CARD_ROUNDS = 2, 2


def _card_inputs(crop, n_classes, world, seed=21):
    spec = zoo.caffenet(batch=CARD_BATCH, crop=crop, n_classes=n_classes)
    spec = spec.replace(layers=tuple(
        dataclasses.replace(l, dropout=DropoutParam(dropout_ratio=0.0))
        if l.type == "Dropout" else l for l in spec.layers))
    net = CompiledNet.compile(spec)
    params = {l: {p: t.numpy() for p, t in lp.items()}
              for l, lp in net.init_params(torch.Generator().manual_seed(0),
                                           torch.device("cpu")).items()}
    r = np.random.default_rng(seed)
    rounds = [{"data": r.standard_normal(
        (TAU, world * CARD_BATCH, crop, crop, 3)).astype(np.float32),
        "label": r.integers(0, n_classes, (TAU, world * CARD_BATCH, 1))
        .astype(np.int32)} for _ in range(CARD_ROUNDS)]
    return spec, net, params, rounds


def card_runs(tmp_path, world, device="cuda", crop=227, n_classes=1000):
    """The multi-card cases (`test_nccl_zero_and_tp_on_caffenet`), or their
    rehearsal on gloo CPU ranks at a small size (`device="cpu"`): at 2
    ranks the ZeRO modes' at-rest memory and losses against gloo CPU
    ranks; at 4 ranks DP x TP 2 x 2 against the 2-rank DP run."""
    solver = SOLVER
    if world == 2:
        spec, net, params, rounds = _card_inputs(crop, n_classes, 2)
        res = {m: spawn(2, tmp_path, m, spec, params, rounds, None,
                        {"impl": "named", "state_sharding": m,
                         "solver": solver, "device": device})
               for m in ("replicated", "momentum", "full")}
        cpu = {m: spawn(2, tmp_path, f"cpu_{m}", spec, params, rounds, None,
                        {"impl": "named", "state_sharding": m,
                         "solver": solver})
               for m in ("momentum", "full")}
        shapes = jax_param_shapes(net)
        shardable = sum(4 * int(np.prod(s)) for lp in shapes.values()
                        for s in lp.values() if any(d % 2 == 0 for d in s))
        for m in ("momentum", "full"):
            for r in range(2):
                for i in range(CARD_ROUNDS):
                    np.testing.assert_allclose(res[m][r][f"loss/{i}"],
                                               cpu[m][r][f"loss/{i}"],
                                               rtol=1e-4)
                if device != "cuda":
                    continue
                cut = (int(res["replicated"][r]["memory_allocated"])
                       - int(res[m][r]["memory_allocated"]))
                want = shardable // 2 * (2 if m == "full" else 1)
                print(f"card: rank {r} {m}: memory_allocated at rest "
                      f"{int(res[m][r]['memory_allocated'])} B, "
                      f"{cut} B under replicated's (at least {want} B: "
                      f"(n-1)/n of the shardable state) "
                      f"[{torch.cuda.get_device_name(0)}]")
                # the caching allocator rounds each buffer up to 512 B
                assert cut >= want - 2 * 512, (m, r, cut, want)
        return res
    spec, net, params, rounds = _card_inputs(crop, n_classes, 2)
    dp = spawn(2, tmp_path, "dp", spec, params, rounds, None,
               {"solver": solver, "device": device})
    tp = spawn(4, tmp_path, "tp", spec, params, rounds, None,
               {"tp": 2, "solver": solver, "device": device})
    tp_layers = {l.name for l in net.spec.layers
                 if l.type == "InnerProduct"
                 and l.inner_product.num_output % 2 == 0}
    assert {"fc6", "fc7", "fc8"} <= tp_layers
    for r in range(4):
        for i in range(CARD_ROUNDS):
            np.testing.assert_allclose(tp[r][f"loss/{i}"],
                                       dp[r // 2][f"loss/{i}"], rtol=1e-4)
        # the card's at-rest params hold half of each sharded layer
        assert int(tp[r]["at_rest/params"]) < int(dp[0]["at_rest/params"])
    return {"dp": dp, "tp": tp}


@pytest.mark.gpu
@pytest.mark.parametrize("world", [2, 4])
def test_nccl_zero_and_tp_on_caffenet(tmp_path, world):
    """On `world` cards, full-width CaffeNet (`card_runs`): at 2 NCCL ranks
    "momentum" and "full" hold at least (n-1)/n less of the shardable
    momentum (and params) at rest than "replicated", and their losses are
    within rtol 1e-4 of 2 gloo CPU ranks running the same workers; at 4,
    DP x TP 2 x 2 (fc6, fc7 and fc8 column-sharded) is within rtol 1e-4 of
    the 2-rank DP run."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA cards")
    card_runs(tmp_path, world, **CARD_NET)


if __name__ == "__main__":
    # the rehearsal on gloo CPU ranks, which needs no card:
    # PYTHONPATH=. python tests/test_torch_zero_cards.py
    import pathlib
    import tempfile

    for n in (2, 4):
        with tempfile.TemporaryDirectory() as d:
            card_runs(pathlib.Path(d), n, device="cpu", crop=67,
                      n_classes=16)
        print(f"rehearsal: {n} gloo ranks passed (crop 67, 16 classes; "
              f"torch {torch.__version__})", flush=True)
