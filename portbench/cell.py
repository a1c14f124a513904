"""One rank of one cell: set-up, the measured window, the traced rounds,
the metric readers and the check.

The program runs once, from the benchmark's weights and rows, through
rounds counted by the round hook (`Rounds`):

  rounds 0 .. 2   the first rounds, which the reference follows: the
                  program adapter copies the optimizer state after the
                  first step, the hook the state after round 0 and the
                  weights after round 2 (what round 3 starts from);
  rounds 3 .. 7   warm rounds; the period over rounds 5 to 7 sizes the
                  window: n = ceil(seconds / period) rounds, the largest
                  n of any rank (every rank must stop at the same round),
                  and the loop's `max_rounds` is set to end after them;
  window          rounds 8 .. 8 + n - 1, timed from a synchronize after
                  round 7 to a synchronize after the last one;
  traced rounds   with --trace 1, 5 more rounds under `torch.profiler`
                  on every rank; the ranks' device operations are
                  gathered to each after them.

Set-up is everything before the window: the process's imports, the rows
and weights, the kernels' first builds and the first eight rounds.
"""
from __future__ import annotations

import gc
import math
import os
import sys
import time
from types import SimpleNamespace
from typing import List, Optional

import torch

from . import compare, devtime, load

CHECK_ROUNDS = 3
PERIOD_FROM = 4
WARM = 8
TRACE_ROUNDS = 5
#: top-level modules no process of a run may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "sparknet_tpu")


def forbidden_modules() -> List[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class CaptureLog:
    """The loop's logger: its per-round records in memory, nothing
    printed (the run's standard output ends in the result line)."""

    def __init__(self):
        self.worker = None
        self.records: List[dict] = []

    def log(self, message: str, i: Optional[int] = None) -> None:
        pass

    def metrics(self, step: int, **kv) -> None:
        # logged once the round's scalars are off the card: the time the
        # round finished there, to the collector's wake-up
        self.records.append(dict(kv, round=step, t_logged=time.perf_counter()))

    def event(self, step: int, event: str, **kv) -> None:
        self.records.append(dict(kv, round=step, event=event))

    def close(self) -> None:
        pass


class Rounds:
    """The round hook (module docstring). It never stops a rank alone:
    the window's length is agreed over the group, and the loop ends at
    `max_rounds` on every rank."""

    def __init__(self, program, seconds: float, trace: bool, world: int,
                 device: torch.device, tmp: str):
        self.program = program
        self.seconds = None if seconds is None else float(seconds)
        self.trace = trace
        self.world = world
        self.device = device
        self.tmp = tmp
        self.cfg = None  # the loop's RunConfig, set by the program adapter
        self.first = self.momentum0 = self.params_after = None
        self.timed = None
        self.t0 = self.t1 = None
        self.prof = None
        self.profile = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, rnd: int, state) -> None:
        if rnd == 0:
            self.momentum0 = self.program.momentum(state)
            if self.seconds is None:  # the check's rounds alone
                self.cfg.max_rounds = CHECK_ROUNDS
        if rnd == CHECK_ROUNDS - 1:
            self.params_after = self.program.params(state)
        if rnd == PERIOD_FROM:
            self.sync()
            self.t_a = time.perf_counter()
        if rnd == WARM - 1:
            self.sync()
            period = (time.perf_counter() - self.t_a) / (WARM - 1
                                                         - PERIOD_FROM)
            n = torch.tensor([max(1, math.ceil(self.seconds / period))],
                             dtype=torch.int64, device=self.device)
            if self.world > 1:
                import torch.distributed as dist
                dist.all_reduce(n, op=dist.ReduceOp.MAX)
            self.timed = int(n.item())
            self.cfg.max_rounds = (WARM + self.timed
                                   + (TRACE_ROUNDS if self.trace else 0))
            self.sync()
            self.t0_epoch = time.time()
            self.t0 = time.perf_counter()
        if self.timed is not None and rnd == WARM + self.timed - 1:
            self.sync()
            self.t1 = time.perf_counter()
            if self.trace:
                self._start_profile()
        if self.trace and self.timed is not None and \
                rnd == WARM + self.timed + TRACE_ROUNDS - 1:
            self._stop_profile()

    def _start_profile(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        from sparknet_tpu_torch.obs import trace as obs_trace
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        tracer = obs_trace.active_tracer()
        with record_function(devtime.MARK):
            self.mark_perf_us = time.perf_counter() * 1e6
            self.mark_host_us = tracer.now_us() if tracer else None
        self.p0 = time.perf_counter()

    def _stop_profile(self) -> None:
        self.sync()
        self.p1 = time.perf_counter()
        self.prof.stop()
        path = os.path.join(self.tmp, "device_trace.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        trace = devtime.load_trace(path)
        os.remove(path)
        mark = devtime.mark_ts(trace)
        if mark is None:
            raise RuntimeError("the profiler's trace has no mark annotation: "
                               "its clock cannot be placed")
        # device clock = perf_counter us + shift
        shift = mark - self.mark_perf_us
        events = devtime.device_events(trace)
        # every rank's device operations, in rank order, for the readers
        # of what differs between ranks (each on its own device clock)
        rank_events = [events]
        if self.world > 1:
            import torch.distributed as dist
            rank_events = [None] * self.world
            dist.all_gather_object(rank_events, events)
        self.profile = SimpleNamespace(
            events=events, rank_events=rank_events,
            t0=self.p0 * 1e6 + shift, t1=self.p1 * 1e6 + shift,
            rounds=TRACE_ROUNDS,
            host_shift=(None if self.mark_host_us is None
                        else mark - self.mark_host_us))


def run_rank(cell, seed: int, seconds: Optional[float], trace: bool,
             rank: int, world: int, device: str, t_start_epoch: float,
             tmp: str, cache_dir: str) -> dict:
    """Run this rank's share of `cell` (a `load.Cell`); returns what the
    parent assembles the result line from. Metrics and the check are
    rank 0's. `seconds=None` runs the check's rounds alone and returns
    rank 0's numbers (`calibrate.py`)."""
    from . import inputs, programs
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    program = programs.program_for(cell.config, cell.traffic)
    source = inputs.RoundSource(cell.config, cell.traffic, seed, rank, dev)
    weights = inputs.make_weights(cell.config, seed, dev)
    log = CaptureLog()
    hook = Rounds(program, seconds, trace, world, dev, tmp)
    host_trace = (os.path.join(tmp, "host_trace.json")
                  if trace and rank == 0 else None)
    state = program.run(seed, weights, source, log, hook, dev,
                        workdir=tmp, cache_dir=cache_dir,
                        trace_out=host_trace)
    hook.sync()
    if seconds is None:
        return _check_only(cell, seed, world, rank, dev, log, hook, state)
    if hook.t1 is None:
        raise RuntimeError(f"the loop ended before the window closed "
                           f"(rounds logged: {len(log.records)})")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    del state, source
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    tau, lb = cell.traffic["tau"], cell.traffic["local_batch"]
    window = [r for r in log.records if "loss" in r
              and WARM <= r["round"] < WARM + hook.timed]
    failed = sum(1 for r in window if not math.isfinite(r["loss"])
                 or r.get("nonfinite"))
    done = [r["t_logged"] for r in window]
    periods = sorted(b - a for a, b in zip(done, done[1:]))
    if periods:
        q = [periods[int(f * (len(periods) - 1))] * 1e3
             for f in (0.1, 0.5, 0.9)]
        print(f"portbench: rank {rank}: {len(window)} rounds in "
              f"{hook.t1 - hook.t0:.3f} s; round to round ms p10 {q[0]:.1f} "
              f"p50 {q[1]:.1f} p90 {q[2]:.1f}", file=sys.stderr)
    out = {"rank": rank, "t0_epoch": hook.t0_epoch,
           "window_s": hook.t1 - hook.t0, "timed_rounds": hook.timed,
           "memory_peak_bytes": int(peak), "failed": failed,
           "device_name": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu")}
    if hook.profile is not None:
        prof = hook.profile
        busy_us, gaps = devtime.busy_and_gaps(prof.events, prof.t0, prof.t1)
        out["busy_s"] = busy_us / 1e6
        out["trace_window_s"] = (prof.t1 - prof.t0) / 1e6
    if rank != 0:
        out["forbidden"] = forbidden_modules()
        return out

    ctx = SimpleNamespace(
        cell=cell, config=cell.config, traffic=cell.traffic, world=world,
        device=dev, device_name=out["device_name"], records=window,
        window_s=out["window_s"], timed_rounds=hook.timed,
        images=world * hook.timed * tau * lb,
        setup_s=hook.t0_epoch - t_start_epoch, profile=hook.profile)
    names = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for name in names:
        value = load.metric_reader(name)(ctx)
        if value is not None:
            metrics[name] = {"value": float(value),
                             "unit": cell.units[name]}
    out["metrics"] = metrics
    if hook.profile is not None:
        prof = hook.profile
        out["breakdown"] = {"device_ops": devtime.by_name(prof.events)}
        if host_trace is not None and prof.host_shift is not None \
                and os.path.exists(host_trace):
            spans = devtime.main_thread_spans(devtime.load_trace(host_trace))
            out["breakdown"]["idle_gaps"] = devtime.label_gaps(
                gaps, spans, -prof.host_shift)
    if host_trace is not None and os.path.exists(host_trace):
        os.remove(host_trace)

    from .reference.train import follow
    ref = follow(cell.config, cell.traffic, seed, world, CHECK_ROUNDS, dev)
    nums = compare.numbers(_program_side(log, hook), ref,
                           compare.unit_axes(cell.config, ref["first"]))
    out["checks"] = compare.report(nums, cell.limits)
    out["correct"] = compare.decide(nums, cell.limits) and failed == 0
    out["forbidden"] = forbidden_modules()
    return out


def _program_side(log: CaptureLog, hook: Rounds) -> dict:
    losses = {r["round"]: r["loss"] for r in log.records if "loss" in r}
    return {"loss": [losses[r] for r in range(CHECK_ROUNDS)],
            "first": hook.first, "momentum": hook.momentum0,
            "params": hook.params_after}


def _check_only(cell, seed, world, rank, dev, log, hook, state) -> dict:
    del state
    if rank != 0:
        return {"rank": rank}
    from .reference.train import follow
    ref = follow(cell.config, cell.traffic, seed, world, CHECK_ROUNDS, dev)
    return {"rank": rank, "numbers": compare.numbers(
        _program_side(log, hook), ref,
        compare.unit_axes(cell.config, ref["first"]))}


def rank_main(rank: int, world: int, args: dict, queue) -> None:
    """A spawned rank of a several-card cell: joins the group over a file
    store, runs `run_rank`, and puts its result (or its error) on
    `queue`."""
    import traceback

    import torch.distributed as dist
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    try:
        cell = args["cell"]
        device = (f"cuda:{rank}" if args["device"] == "cuda" else "cpu")
        if device != "cpu":
            torch.cuda.set_device(rank)
        dist.init_process_group(
            "nccl" if device != "cpu" else "gloo",
            store=dist.FileStore(args["store"], world), rank=rank,
            world_size=world,
            **({"device_id": torch.device(device)} if device != "cpu"
               else {}))
        try:
            res = run_rank(cell, args["seed"], args["seconds"],
                           args["trace"], rank, world, device,
                           args["t_start_epoch"], args["tmp"][rank],
                           args["cache_dir"])
        finally:
            dist.destroy_process_group()
        queue.put(("ok", rank, res))
    except BaseException:
        queue.put(("error", rank, traceback.format_exc()))
        raise


def spawn(cell, seed: int, seconds: float, trace: bool, device: str,
          t_start_epoch: float, tmp: str, cache_dir: str,
          deadline_s: float = 1100.0, target=None) -> list:
    """Run the cell's ranks, one process a card ("cuda") or `cell.chips`
    gloo processes ("cpu"); their results by rank. A rank that fails or
    dies ends the others. `target` replaces `rank_main` (the tests plant
    faults in their ranks through it)."""
    import multiprocessing as mp
    import queue as queue_mod
    n = cell.chips
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    tmps = []
    for r in range(n):
        tmps.append(os.path.join(tmp, f"rank{r}"))
        os.makedirs(tmps[-1])
    shared = {"cell": cell, "seed": seed, "seconds": seconds,
              "trace": trace, "device": device,
              "store": os.path.join(tmp, "store"),
              "t_start_epoch": t_start_epoch, "tmp": tmps,
              "cache_dir": cache_dir}
    procs = [ctx.Process(target=target or rank_main,
                         args=(r, n, shared, queue))
             for r in range(n)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.time() + deadline_s
    try:
        while len(results) < n and not errors:
            left = deadline - time.time()
            if left <= 0:
                errors.append("the ranks did not finish in time")
                break
            try:
                status, rank, payload = queue.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    errors.append(f"a rank exited with {dead[0]} before "
                                  f"reporting")
                continue
            if status == "ok":
                results[rank] = payload
            else:
                errors.append(f"rank {rank}:\n{payload}")
    finally:
        for p in procs:
            p.join(timeout=5 if errors else 120)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return [results[r] for r in range(n)]
