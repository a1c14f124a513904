"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds `BENCHMARK.json`. A one-card cell
runs in this process; a cell of n cards spawns n rank processes, one a
card, joined over a file store in a temporary directory, and this process
touches no card. The last line of standard output is one JSON object:
`correct`, `attempted` (the window's rounds), `failed` (its rounds with a
loss that is not finite), `metrics` (the end-to-end metrics, or with
--trace 1 the per-layer ones), `device`, with --trace 1 `breakdown`, and
last `checks`: each number the check compared beside its limit. The
checks are also the last lines of standard error.

Kernel builds go to portbench/_cache/ in the checkout, so only a
checkout's first run builds. Exits with a code other than 0, and prints
no result, without enough CUDA cards, or where a process of the run holds
JAX or the JAX package.
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
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed must be a whole number >= 0")
    if args.seconds <= 0:
        p.error("--seconds must be > 0")
    return args


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import load
    cell = load.find_cell(load.load_benchmark(), args.workload)
    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA card: nothing measured", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    from portbench import cell as cell_mod
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        if cell.chips == 1:
            results = [cell_mod.run_rank(
                cell, args.seed, args.seconds, bool(args.trace), 0, 1,
                "cuda:0", T_START_EPOCH, tmp,
                os.path.join(CACHE, "kernels"))]
        else:
            results = cell_mod.spawn(
                cell, args.seed, args.seconds, bool(args.trace), "cuda",
                T_START_EPOCH, tmp, os.path.join(CACHE, "kernels"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    found = sorted(set(cell_mod.forbidden_modules()).union(
        *[r["forbidden"] for r in results]))
    if found:
        print(f"portbench: the run loaded {found}: the port must run "
              f"without JAX", file=sys.stderr)
        return 3
    line = assemble(cell, results, bool(args.trace))
    for name, c in line["checks"].items():
        limit = "not compared" if c["limit"] is None else repr(c["limit"])
        print(f"check {name} {c['value']!r} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def assemble(cell, results: list, trace: bool) -> dict:
    """The result line from the ranks' results (rank 0's first)."""
    r0 = results[0]
    device = {"platform": "gpu", "kind": r0["device_name"],
              "count": cell.chips,
              "memory_peak_bytes": max(r["memory_peak_bytes"]
                                       for r in results)}
    if trace:
        device["busy_s"] = sum(r["busy_s"] for r in results) / len(results)
        device["window_s"] = sum(r["trace_window_s"]
                                 for r in results) / len(results)
    line = {"correct": bool(r0["correct"]),
            "attempted": r0["timed_rounds"],
            "failed": sum(r["failed"] for r in results),
            "metrics": r0["metrics"], "device": device}
    if trace and "breakdown" in r0:
        line["breakdown"] = r0["breakdown"]
    line["checks"] = r0["checks"]
    return line


if __name__ == "__main__":
    sys.exit(main())
