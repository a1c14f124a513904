"""The relaunch supervisor (`python -m sparknet_tpu_torch.parallel.
supervise`), the port's counterpart of `scripts/tpu_pod_launch.sh watch`,
on the CPU.

- Fake commands (`python -c`, `poll_secs=0`): exit 75 then 0 relaunches
  with no strike (the relaunch is marked $SPARKNET_ELASTIC_RELAUNCH=1);
  two fast failures stop with 1; a failure after `progress_secs` is no
  strike; a failing rank stops its peers, and a failure beside a 75 is a
  failure, never a relaunch; the ranks get torchrun's environment.
- The new size from a relaunch record: one machine's members own equal
  blocks of ranks (2 -> 1 -> 2 ranks, at most --nproc; a world of one
  watching a nominal worker stays one); over several machines the
  survivors keep their local ranks and an evicted machine's supervisor
  stops with 75.
- A real run: the two-machine gloo elastic run of test_torch_elastic.py
  (4 ranks as 2 machines of 2; machine 1 falls silent, every rank exits
  75 at round 5's boundary) under two supervisors, one per machine.
  Machine 0's relaunches once at 2 ranks, which resume the periodic
  step 4 and finish: launches 2, relaunches 1, strikes 0, code 0;
  machine 1's stops with 75. The final params and momentum equal, bit
  for bit, those of the same relaunch driven by hand.
Every wait is bounded.
"""
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_elastic_worker
from sparknet_tpu_torch.model.net import CompiledNet
from sparknet_tpu_torch.model.prototxt import net_from_prototxt
from sparknet_tpu_torch.parallel.supervise import Supervisor, free_port
from sparknet_tpu_torch.solver import SolverConfig
from sparknet_tpu_torch.utils.config import ElasticConfig
from test_parallel import TINY_MLP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
TIMEOUT_S = 240

#: a rank that exits with codes[launch] (its launch count kept in a file
#: per rank) after `sleep` seconds, and records its environment
FAKE = r"""
import json, os, sys, time
d, codes, sleep = sys.argv[1], json.loads(sys.argv[2]), float(sys.argv[3])
rank = os.environ["RANK"]
path = os.path.join(d, f"count-{rank}")
n = int(open(path).read()) if os.path.exists(path) else 0
open(path, "w").write(str(n + 1))
keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
        "MASTER_ADDR", "MASTER_PORT", "SPARKNET_ELASTIC_RELAUNCH",
        "SPARKNET_RELAUNCH_RECORD")
with open(os.path.join(d, f"env-{rank}-{n}.json"), "w") as f:
    json.dump({k: os.environ.get(k) for k in keys}, f)
mine = codes[int(rank)] if isinstance(codes[0], list) else codes
time.sleep(sleep if int(rank) == 0 else 0)
sys.exit(mine[min(n, len(mine) - 1)])
"""


def _fake(tmp_path, codes, sleep=0.0, **kw):
    import json
    lines = []
    sup = Supervisor([sys.executable, "-c", FAKE, str(tmp_path),
                      json.dumps(codes), str(sleep)],
                     poll_secs=0.0, echo=lines.append, **kw)
    t0 = time.monotonic()
    code = sup.run()
    return code, lines, time.monotonic() - t0


def _env(tmp_path, rank, launch):
    import json
    return json.load(open(tmp_path / f"env-{rank}-{launch}.json"))


def test_exit_75_relaunches_with_no_strike(tmp_path):
    code, lines, _ = _fake(tmp_path, [75, 0])
    assert code == 0
    assert lines[-1] == ("supervise: launches 2, relaunches 1, strikes 0, "
                         "code 0")
    assert "relaunching now" in lines[1] and "no strike" in lines[1]
    assert _env(tmp_path, 0, 0)["SPARKNET_ELASTIC_RELAUNCH"] is None
    assert _env(tmp_path, 0, 1)["SPARKNET_ELASTIC_RELAUNCH"] == "1"


def test_exit_75_resets_the_strike_count(tmp_path):
    code, lines, _ = _fake(tmp_path, [3, 75, 4, 0])
    assert code == 0
    assert lines[-1] == ("supervise: launches 4, relaunches 1, strikes 2, "
                         "code 0")


def test_two_fast_failures_stop_with_1(tmp_path):
    code, lines, _ = _fake(tmp_path, [3, 4, 0])
    assert code == 1
    assert lines[-1] == ("supervise: launches 2, relaunches 0, strikes 2, "
                         "code 1")
    assert "two fast failures" in lines[-2]


def test_a_failure_after_progress_secs_is_no_strike(tmp_path):
    code, lines, _ = _fake(tmp_path, [3, 3, 0], sleep=0.5,
                           progress_secs=0.3)
    assert code == 0
    assert lines[-1] == ("supervise: launches 3, relaunches 0, strikes 0, "
                         "code 0")
    assert sum("no strike" in ln for ln in lines) == 2


def test_the_ranks_get_torchruns_environment(tmp_path):
    code, _, _ = _fake(tmp_path, [0], nproc=3)
    assert code == 0
    envs = [_env(tmp_path, r, 0) for r in range(3)]
    assert [(e["RANK"], e["WORLD_SIZE"], e["LOCAL_RANK"],
             e["LOCAL_WORLD_SIZE"]) for e in envs] == \
        [(str(r), "3", str(r), "3") for r in range(3)]
    assert {e["MASTER_ADDR"] for e in envs} == {"127.0.0.1"}
    assert len({e["MASTER_PORT"] for e in envs}) == 1
    assert len({e["SPARKNET_RELAUNCH_RECORD"] for e in envs}) == 1


@pytest.mark.parametrize("codes,want", [
    ([[0], [3]], 3),         # rank 1 fails while rank 0 sleeps
    ([[75], [3]], 3),        # a failure beside a 75 is not a relaunch
])
def test_a_failing_rank_stops_its_peers(tmp_path, codes, want):
    code, lines, secs = _fake(tmp_path, codes, sleep=60.0, nproc=2)
    assert code == 1 and secs < 30, (lines, secs)
    assert all(f"exit {want} after" in ln for ln in lines
               if ln.startswith("supervise: launch "))
    assert lines[-1] == ("supervise: launches 2, relaunches 0, strikes 2, "
                         "code 1")


def _rec(members, previous, world, machine=0, n_machines=1, local_size=1):
    return {"epoch": 1, "members": members, "previous": previous,
            "world": world, "machine": machine, "n_machines": n_machines,
            "local_size": local_size}


def test_the_new_size_comes_from_the_relaunch_record():
    sup = Supervisor(["true"], nproc=2)
    assert sup.resize(_rec(["0"], ["0", "1"], 2)) and sup.nproc == 1
    assert sup.resize(_rec(["0", "1"], ["0"], 1)) and sup.nproc == 2
    assert sup.resize(_rec(["0", "1", "2"], ["0", "1"], 2)) and \
        sup.nproc == 2  # at most --nproc
    assert sup.resize(None) and sup.nproc == 2
    one = Supervisor(["true"], nproc=1)  # a nominal worker 1, no rank
    assert one.resize(_rec(["0"], ["0", "1"], 1)) and one.nproc == 1
    m1 = Supervisor(["true"], nproc=2, nnodes=3, node_rank=2,
                    master_port=1)
    assert m1.resize(_rec(["0", "2"], ["0", "1", "2"], 6, machine=2,
                          n_machines=3, local_size=2))
    assert (m1.nnodes, m1.node_rank, m1.nproc) == (2, 1, 2)
    m2 = Supervisor(["true"], nproc=2, nnodes=2, node_rank=1,
                    master_port=1)
    assert not m2.resize(_rec(["0"], ["0", "1"], 4, machine=1,
                              n_machines=2, local_size=2))


# -- a real run: two machines of two gloo ranks ------------------------------

ROUNDS, KILL_AT = 8, 2
SOLVER = dict(base_lr=0.05, momentum=0.9, weight_decay=0.001,
              lr_policy="fixed")


def _data(n=512, seed=0):
    r = np.random.default_rng(seed)
    data = r.standard_normal((n, 6)).astype(np.float32)
    return {"data": data,
            "label": (data.sum(-1, keepdims=True) > 0).astype(np.int32)}


def _runs(root):
    """The first launch (machine 1 silent after round 1, backdated after
    round 2: evicted at round 5's boundary) and the relaunch."""
    def cfg(name):
        return dict(model="prototxt-inline", local_batch=4, tau=2,
                    max_rounds=ROUNDS, eval_every=0,
                    workdir=str(root / name), checkpoint_dir=str(root / "ck"),
                    checkpoint_every=4, pod_dir=str(root / "pod"),
                    heartbeat_every_s=0.0, collect_async=False,
                    elastic=ElasticConfig(
                        enabled=True, stale_after_s=120.0,
                        reprobe_backoff_s=0.0, dead_probes=2,
                        poll_interval_s=0.0, min_workers=1),
                    solver=SolverConfig(**SOLVER))
    return ({"name": "first", "cfg": cfg("first"),
             "plan": {"silence_rank": 2, "silence_at": KILL_AT - 1,
                      "backdate_at": KILL_AT}},
            {"name": "relaunch", "cfg": cfg("relaunch"), "plan": {}})


def _params():
    tnet = CompiledNet.compile(net_from_prototxt(TINY_MLP))
    return {l: {p: t.detach().numpy() for p, t in lp.items()}
            for l, lp in tnet.init_params(torch.Generator().manual_seed(0),
                                          torch.device("cpu")).items()}


def _load(out, name, world):
    res = []
    for r in range(world):
        with open(os.path.join(out, f"{name}_rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


def _spawn(args, nprocs):
    ctx = mp.spawn(torch_elastic_worker.loop, args=args, nprocs=nprocs,
                   join=False)
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the hand-driven ranks did not finish")


def test_a_supervised_two_machine_run_relaunches_once_and_finishes(
        tmp_path):
    params, data = _params(), _data()
    # by hand: the first launch on 4 ranks, the relaunch on 2
    hand = tmp_path / "hand"
    first, relaunch = _runs(hand)
    for run in (first, relaunch):
        os.makedirs(run["cfg"]["workdir"])
    _spawn((4, 2, str(hand / "store1"), TINY_MLP, params, data, [first],
            str(hand)), 4)
    assert [e["end"] for e in _load(str(hand), "first", 4)] == \
        ["relaunch"] * 4
    _spawn((2, 2, str(hand / "store2"), TINY_MLP, params, data,
            [dict(relaunch, cfg=dict(relaunch["cfg"], resume=True))],
            str(hand)), 2)
    want = _load(str(hand), "relaunch", 2)
    # supervised: one supervisor per machine, the same two runs
    sup = tmp_path / "sup"
    os.makedirs(sup)
    first, relaunch = _runs(sup)
    with open(sup / "spec.pkl", "wb") as f:
        pickle.dump({"net": TINY_MLP, "params": params, "data": data,
                     "out": str(sup), "first": first,
                     "relaunch": relaunch}, f)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, TESTS, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "sparknet_tpu_torch.parallel.supervise",
         "--nproc", "2", "--nnodes", "2", "--node-rank", str(m),
         "--master-addr", "127.0.0.1", "--master-port", str(port),
         "--poll-secs", "0", "--",
         sys.executable, os.path.join(TESTS, "torch_supervise_worker.py"),
         str(sup / "spec.pkl")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for m in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    lines = [[ln for ln in out.splitlines() if ln.startswith("supervise:")]
             for out in outs]
    assert procs[0].returncode == 0, outs[0][-3000:]
    assert lines[0][-1] == ("supervise: launches 2, relaunches 1, "
                            "strikes 0, code 0"), lines[0]
    assert lines[0][0].startswith("supervise: launch 1: 4 rank(s) (2 "
                                  "machine(s) x 2), node 0: exit 75")
    assert lines[0][2].startswith("supervise: launch 2: 2 rank(s) (1 "
                                  "machine(s) x 2), node 0: exit 0")
    assert procs[1].returncode == 75, outs[1][-3000:]
    assert "not in membership epoch 1" in lines[1][1]
    assert lines[1][-1] == ("supervise: launches 1, relaunches 1, "
                            "strikes 0, code 75"), lines[1]
    logs = [open(sup / "relaunch" / f"l{r}.txt").read() for r in range(2)]
    assert all("ELASTIC resume from round 4: 4 devices" in log
               for log in logs)
    got = _load(str(sup), "relaunch", 2)
    for g, w in zip(got, want):
        assert g["end"] == w["end"] == "done"
        assert g["state"]["it"] == w["state"]["it"] == ROUNDS * 2
        for kind in ("params", "momentum"):
            for l, lp in w["state"][kind].items():
                for p, a in lp.items():
                    np.testing.assert_array_equal(
                        g["state"][kind][l][p], a, err_msg=f"{kind}/{l}/{p}")
