"""The readings the check's limits are set from: the program's numbers over
many seeds (the lower readings), and the control's and each planted
fault's (the upper ones). The benchmark's own runs do not run this.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--parts program,control,faults] [--world N] [--out FILE]

  program  the program's first rounds against the reference, as a run's
           check compares them (a several-card cell spawns its ranks);
  control  the reference in the precision below the configuration's
           (`reference/precision.py:CONTROL`), put in the program's place;
  faults   the reference with each fault of `reference/train.py:FAULTS`
           that the cell can have planted, put in the program's place
           ("no_exchange" only where there are several workers).

`--world` emulates that many workers in the control and the faults on
one card. Prints one JSON line a seed and part, then the summary: for each number the largest
program reading and the smallest control and fault readings.
"""
import time

T_START_EPOCH = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path.pop(0)
sys.path.insert(0, ROOT)
CACHE = os.path.join(HERE, "_cache")


def reference_readings(cell, seeds, world: int, parts, device) -> list:
    """[(part, seed, numbers)] of the control and the faults."""
    from portbench import compare
    from portbench.cell import CHECK_ROUNDS
    from portbench.reference.precision import CONTROL
    from portbench.reference.train import follow
    rows = []
    for seed in seeds:
        ref = follow(cell.config, cell.traffic, seed, world, CHECK_ROUNDS,
                     device)
        todo = []
        if "control" in parts:
            mode = CONTROL[cell.config["precision"]]
            todo.append((f"control:{mode}", dict(mode=mode)))
        if "faults" in parts:
            todo += [("unchanged", dict(fault="unchanged")),
                     ("half_batch", dict(fault="half_batch"))]
            if world > 1:
                todo.append(("no_exchange", dict(fault="no_exchange")))
        for part, kw in todo:
            got = follow(cell.config, cell.traffic, seed, world,
                         CHECK_ROUNDS, device, **kw)
            rows.append((part, seed, compare.numbers(
                got, ref, compare.unit_axes(cell.config, ref["first"]))))
            print(json.dumps({"part": part, "seed": seed, **rows[-1][2]}),
                  flush=True)
    return rows


def program_rank(rank: int, world: int, args: dict, queue) -> None:
    """One rank of the program's readings: the check's rounds for every
    seed in one process."""
    import traceback

    import torch
    import torch.distributed as dist

    from portbench import cell as cell_mod
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    try:
        cell = args["cell"]
        device = f"cuda:{rank}" if args["device"] == "cuda" else "cpu"
        if world > 1:
            if device != "cpu":
                torch.cuda.set_device(rank)
            dist.init_process_group(
                "nccl" if device != "cpu" else "gloo",
                store=dist.FileStore(args["store"], world), rank=rank,
                world_size=world,
                **({"device_id": torch.device(device)} if device != "cpu"
                   else {}))
        out = []
        try:
            for seed in args["seeds"]:
                res = cell_mod.run_rank(cell, seed, None, False, rank, world,
                                        device, T_START_EPOCH,
                                        args["tmp"][rank], args["cache_dir"])
                if rank == 0:
                    out.append(("program", seed, res["numbers"]))
                    print(json.dumps({"part": "program", "seed": seed,
                                      **res["numbers"]}), flush=True)
        finally:
            if world > 1:
                dist.destroy_process_group()
        queue.put(("ok", rank, out))
    except BaseException:
        queue.put(("error", rank, traceback.format_exc()))
        raise


def program_readings(cell, seeds, device: str, tmp: str) -> list:
    import multiprocessing as mp
    n = cell.chips
    tmps = [os.path.join(tmp, f"rank{r}") for r in range(n)]
    for t in tmps:
        os.makedirs(t)
    shared = {"cell": cell, "seeds": seeds,
              "device": device, "store": os.path.join(tmp, "store"),
              "tmp": tmps, "cache_dir": os.path.join(CACHE, "kernels")}
    if n == 1:
        import queue as q
        box = q.Queue()
        program_rank(0, 1, shared, box)
        kind, _, payload = box.get()
        return payload
    ctx = mp.get_context("spawn")
    box = ctx.Queue()
    procs = [ctx.Process(target=program_rank, args=(r, n, shared, box))
             for r in range(n)]
    for p in procs:
        p.start()
    got = [box.get(timeout=3000) for _ in range(n)]
    for p in procs:
        p.join(timeout=120)
    bad = [g for g in got if g[0] != "ok"]
    if bad:
        raise RuntimeError(bad[0][2])
    return next(g[2] for g in got if g[1] == 0)


def summary(rows) -> dict:
    from portbench.compare import NAMES
    out = {}
    for part in sorted({r[0] for r in rows}):
        nums = [r[2] for r in rows if r[0] == part]
        pick = max if part == "program" else min
        out[part] = {k: pick(n[k] for n in nums) for k in NAMES}
        out[part]["seeds"] = len(nums)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   type=lambda s: [int(x) for x in s.split(",")])
    p.add_argument("--parts", default="program,control,faults",
                   type=lambda s: s.split(","))
    p.add_argument("--world", type=int, default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    from portbench import load
    cell = load.find_cell(load.load_benchmark(), args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    rows = []
    tmp = tempfile.mkdtemp(prefix="portbench-calibrate-")
    try:
        if "program" in args.parts:
            rows += program_readings(cell, args.seeds, device, tmp)
        if {"control", "faults"} & set(args.parts):
            dev = torch.device("cuda:0" if device == "cuda" else "cpu")
            rows += reference_readings(cell, args.seeds,
                                       args.world or cell.chips,
                                       args.parts, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summ = {"workload": args.workload,
            "device": (torch.cuda.get_device_name(0) if device == "cuda"
                       else "cpu"),
            "summary": summary(rows),
            "rows": [{"part": a, "seed": s, **n} for a, s, n in rows]}
    print(json.dumps({"summary": summ["summary"]}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summ, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
