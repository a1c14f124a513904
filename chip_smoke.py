#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: does the port serve and train
CaffeNet on the card, through the ImageNet app from JPEG shards too,
cached and streamed, from a directory and from a bucket, watched by its
telemetry, through the loss of a worker, and behind an HTTP port that
hot-reloads a training step under traffic?

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. Environment: the card's name and power limit (nvidia-smi), the torch and
   CUDA versions; then every CUDA kernel of the port is built from
   `sparknet_tpu_torch/csrc/` (one nvcc per source, all at once: lrn_fwd,
   lrn_bwd, maxpool_bwd), with each kernel's ptxas line.
2. Kernel vs plain: `lrn_fwd` at CaffeNet's serve shapes (norm1 27x27x96,
   norm2 13x13x256, buckets 1, 8 and 128, float32 and bfloat16) against the
   plain PyTorch version on the same inputs, bit for bit (the kernel repeats
   the plain version's operations in its order). Each case prints its max
   abs error and its times (CUDA events over many launches after warm-up,
   cycling through enough inputs to exceed the 50 MB L2): kernel, plain
   version, `F.local_response_norm` (the library yardstick, which the port
   never calls) and the bound (bytes over 3.35 TB/s vs operations over 67
   TFLOP/s f32, whichever is larger). These times are host-paced, so a call shorter
   than its wrapper's Python shows the host's launch rate; the kernel is
   also timed with its calls back to back on the card (`device_ms`: calls
   queued while a sleep kernel holds the stream), and the host's time to
   queue one of those calls is `host_ms`.
2b. The training kernels against their plain versions, same inputs, one
   line per case with the same timings (the library yardstick of a
   backward is a backward-only `torch.autograd.grad` over a graph of
   `F.local_response_norm` / `F.max_pool2d` built once):
   - `lrn_fwd` with the scale output at norm1/norm2 for batches 100 and
     256, float32 and bfloat16: y bit-equal to the y-only call and to the
     plain version, the scale bit-equal to the plain version's;
   - `lrn_bwd` in both modes (saved scale, recomputed scale) at the same
     shapes: bit-equal to its plain version;
   - `maxpool_bwd` at CaffeNet's pool1/pool2/pool5 for batch 256,
     cifar10_quick's ceil-mode pool1 (100, 32, 32, 32) -> 16x16 and one
     pad > 0 shape, float32 and bfloat16, on tie-heavy inputs (a few
     integer levels, clipped at 0), and pool1/2/5 in bfloat16 also on
     dense ones (ReLU of a Gaussian): bit-equal to its plain version, and
     the positions that receive gradient equal the plain version's.
   No tolerance is needed: each kernel repeats its plain version's
   operations in the same order, so any difference fails.
3. Serve: full-width CaffeNet (crop 227, 1000 classes) with seeded random
   weights on the card behind the port's InferenceServer, buckets
   (1, 8, 64, 128), outputs ("prob",). Launch counters are zeroed, then a
   lone request, a burst of 128, a burst of 40 and four steady bursts of
   128 are served; the counters are read after. Checks: every future
   resolves; every prob row is finite, of shape (1000,) and sums to 1
   within 1e-4; buckets 1 and 128 were served; lrn_fwd launched twice per
   forward; the burst of 128 matches a forward of the same rows with the
   plain LRN selected (OpsImpl(lrn="plain")) within atol 1e-6 / rtol 1e-4;
   and two requests match a CPU forward of the same net and weights within
   atol 1e-5 (convolution sum order differs between cuDNN and the CPU).
   Then one bucket-128 forward is profiled (host stacking, host->device
   copy, device kernels by name, the share of the forward's wall time in
   which no kernel ran).
4. Train: `apps.train_loop.train` on the card in a world of one, with
   full-width CaffeNet (`zoo.caffenet(batch=256, crop=227,
   n_classes=1000)`) under the ImageNet app's solver and bfloat16, τ = 5,
   6 rounds, on seeded int8 images (mean-subtracted pixel range), one
   evaluation at round 0. Launch counters are zeroed before and read
   after. Checks: every round's loss and health finite, nonfinite == 0;
   the params moved; lrn_fwd, lrn_bwd (recompute mode) and maxpool_bwd
   launched exactly 2, 2 and 3 times per step (plus lrn_fwd's 2 for the
   evaluation forward), no scale output written. Then one float32 round
   at local batch 100, where the saved-scale route runs (2 scale-writing
   lrn_fwd and 2 lrn_bwd per step); then the same 6 bfloat16 rounds with
   pool_impl="plain" for the pool route A/B (each route's first round is
   its warm-up; the median of the other 5 and their spread); then, on one
   fixed float32 batch of 256 and the dropout-free net, the gradients of
   the kernel
   route (OpsImpl()) against the plain route (OpsImpl(lrn="plain",
   pool="plain")), with cuDNN's deterministic algorithms for this
   comparison: per tensor, a relative L2 error within 1e-6 plus twice
   that of two runs of the plain route (cuDNN and cuBLAS may still sum in
   another order from run to run; the kernels themselves are bit-equal to
   their plain versions). Prints per-round wall time, img/s, peak device
   memory, the pool route A/B, and one profiled training step.
5. Checkpoint: the same CaffeNet, solver, bfloat16 and τ = 5 through
   `apps.train_loop.train` with `checkpoint_dir` (every 2 rounds) in a
   world of one, on other seeded images, with cuDNN's deterministic
   algorithms for the whole phase:
   - 4 rounds with synchronous writes;
   - 2 rounds with async writes, then a second `train()` that resumes
     to round 4: every param and momentum tensor torch.equal to the
     first run's, equal step-4 digests, every step verifies;
   - a `.caffemodel` of the first run's params through
     `TorchNet.save_weights` and `load_weights` into a fresh net: its
     bucket-128 float32 forward equal to the source net's bit for bit;
   - 6 rounds with the health supervisor and a NaN injected at round 3:
     exactly one rollback (to step 2, retry 1, lr_scale = lr_backoff),
     every later round finite with nonfinite 0, finite final params,
     and the steps written after it untagged (the monitor clears its
     anomaly window when it rolls back) and carrying the health state.
   Each run's launch counts are zeroed before and read after: lrn_fwd,
   lrn_bwd and maxpool_bwd 2, 2 and 3 per executed step, a retried round
   counted again. Prints each round's wall time, each save's, restore's
   and stage-1 snapshot's seconds and bytes, and the step sizes on disk.
6. ImageNet: full-width CaffeNet (crop 227, 1000 classes, b256, τ = 5,
   bfloat16, the app's solver) through the ImageNet app in a world of one,
   with cuDNN's deterministic algorithms. A corpus of 2560 train JPEGs in
   8 tar shards and 256 val JPEGs (256x256, `data/imagenet.py:
   write_synthetic_shards`, PIL) is written to a temporary directory.
   - The app's own `main()` trains one round (the warm-up) and evaluates
     once: the round's loss finite with nonfinite 0, the eval accuracy line
     present, lrn_fwd / lrn_bwd / maxpool_bwd 2 / 2 / 3 per step plus
     lrn_fwd's 2 per eval forward.
   - `prepare_data` (the app's decode and mean image, timed), then the
     same `train()` that `main()` calls on that data, 4 rounds a run:
     levers on (the defaults: the round-prep thread, h2d_prefetch,
     donate_batches, collect_async; log_every 1, telemetry on) and levers
     off (those three off and each round prepared on the main thread:
     the synchronous loop), in 2 alternating pairs. Per round: loss,
     round_s, the breakdown (t_data_ms, t_h2d_ms, t_round_ms,
     t_collect_ms / t_collect_bg_ms, the round prep's own t_prep_ms) and
     the H2D bytes; per run: their medians and ranges over the warm rounds,
     img/s and the preprocessing route (native or numpy). Checks: every
     loss finite with nonfinite 0; every run's losses and final flat
     params torch.equal to the first run's; launches 2 / 2 / 3 per step;
     each run's first round, as `train_round` received it (placed on the
     card when the levers are on), torch.equal to `prepare_round_batches`
     on the host.
7. Stream: the same CaffeNet, solver, bfloat16, b256 and τ = 5 through
   the ImageNet app's streaming ingest (`--stream always`,
   `data/streaming.py`) on phase 6's corpus, in a world of one, with
   cuDNN's deterministic algorithms:
   - the app's own `main()`: one round and one evaluation, with
     `checkpoint_dir` for the mean sidecar: the round's loss finite with
     nonfinite 0, the eval line present, launches 2 / 2 / 3 per step plus
     lrn_fwd's 2 per eval forward; the streamed mean image within 1
     float32 ulp of phase 6's cached mean;
   - resume through the stream cursor with `ingest_sources=2` (two shard
     readers, shards j::2), `checkpoint_every=2` (async writes): 6 rounds
     uninterrupted; 4 rounds, then a second `train()` that resumes to
     round 6. Every param and momentum tensor and every loss equal
     (`torch.equal`); step 4's `extra["stream"]` is the cursor after
     round 4's data (both runs), not the prefetched round 5's; the
     uninterrupted run's first round, as `train_round` received it on the
     card, torch.equal to the host's `prepare_round_batches` on a fresh
     source;
   - the same shards served as `gs://` by `tests/fake_stores.py:
     serve_dir_for_ingest` on localhost: two rounds' raw batches and
     cursors equal the local stream's bit for bit; the uninterrupted
     run's last step saved to `gs://` restores equal, tensor for tensor.
   Prints per round loss, round_s, t_data_ms, t_prep_ms, img/s with the
   data wait and the streaming thread's decode seconds; per run its
   launches and the process's peak RSS; the stream cursor of every step.
8. Elastic: the same CaffeNet, solver, bfloat16, b256 and τ = 5 through
   `apps.train_loop.train` in a world of one, on seeded int8 images, with
   cuDNN's deterministic algorithms:
   - run "watched": `status_port=0`, `pod_port=0`, `heartbeat_path`,
     `pod_dir`, `checkpoint_dir` every 2 rounds, and `elastic`
     (`expected_workers=2`, `min_workers=1`, `tau_adapt`, no poll
     interval, no re-probe backoff, `dead_probes=2`). The round hook beats
     a nominal worker 1 with a small `round_s` — so this rank is the slow
     one and runs a shorter τ — and backdates that beat after round 3.
     While the run is live the hook scrapes `/metrics` (the train
     families, the membership gauges, the card's memory gauges) and
     `/pod/status` (workers 0 and 1, epoch 0). After it: the run left by
     ElasticRelaunch, exit code 75, at round 6 (suspected at 4, probed at
     5 and 6), with one `resize` event with dead ["1"]; the boundary step
     6 was written by the loop's main thread and verifies; both heartbeat
     files have the JAX package's schema and say "resize" at epoch 1;
     every round launched lrn_fwd / lrn_bwd / maxpool_bwd 2 / 2 / 3 times
     per executed step (a round under a τ vector runs fewer steps; at
     least one did), and every loss is finite.
   - run "resume 4 -> 1": step 6 is written again as a 4-rank replica
     step (params rows the run's, momentum rows the run's times four
     seeded factors, `n_devices` 4) and `train(resume=True)` runs 2
     rounds at a world of one: the log says "ELASTIC resume", the
     restored params are torch.equal to the step's row 0 and the
     restored momentum to numpy `reduce_momentum_rows(rows,
     "norm_rescale")` uploaded; both rounds finite, launches as above.
   Prints per round the boundary's own cost (the membership poll and
   decision, `t_member_ms`, and the loop's heartbeat writes) beside
   round_s,
   round_s against phase 4's, every save's seconds and bytes (the
   boundary save marked), the 4-row step's bytes and restore seconds, and
   one `/metrics` scrape over HTTP in ms beside the registry's own render.
9. Serve over HTTP: the port's serving replica on the card — full-width
   CaffeNet (crop 227, 1000 classes) with seeded weights, float32,
   `max_batch=128`, buckets (1, 8, 64, 128), outputs ("prob",), a
   `checkpoint_dir` polled every 0.2 s, `status_port=0` and a heartbeat,
   behind an `HttpFrontend` on port 0 with a `TenantAdmission` door.
   Launch counters are zeroed before the server starts and read after its
   traffic. 8 keep-alive client threads send npz requests through
   `http_infer`: a warm-up, a steady pass of 8 x 64 (img/s and the
   client-side p50/p99 beside phase 3's in-process img/s), a traced pass
   (request tracing on: each stage's mean ms on the server), then traffic
   during which step 1 — the weights of seed 1 in the JAX package's
   monolithic format, through the port's checkpoint store — is written,
   installed, and a step 2 with one byte of its arrays flipped is
   published and rejected. Checks: every response 200 with a step, at
   least 1024 requests in all; each client's steps never decrease; after
   the swap a fixed request's prob `torch.equal` to the seed-1 net's
   forward at bucket 1; step 2 rejected as corrupt (swaps_total
   {outcome="rejected"} 1, the heartbeat's rollbacks 1, serving on step
   1); /healthz 200 on the status server and the frontend; /metrics with
   the serve families, `transport="http"`, the swap counters and
   `sparknet_serve_model_freshness_seconds`; lrn_fwd 2 launches per
   traffic forward plus 2 per canary forward, all float32. Then a second
   server with `quant="int8"` installs the same step: its parity canary
   passes, its prob is within QuantConfig's rtol/atol of the f32 lane's on
   the same requests, and its lrn_fwd launches are bfloat16 (2 per traffic
   and quantized canary forward; the parity reference forward is f32).
   Prints the connections opened, commit-to-install seconds, the canary
   ms, freshness_s at install, and the f32 and int8 bucket-128 forward
   times (wall and device).
10. The kernels line, `{"kernels": [...]}`, then the result line
   `{"ok": true, "device": {...}}` as the last line of standard output.

Exits non-zero without a result when no CUDA card is visible or when the
`sparknet_tpu_torch` package is not beside this script.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20

LRN_SHAPES = {"norm1": (27, 27, 96), "norm2": (13, 13, 256)}
LRN_BUCKETS = (1, 8, 128)
LRN_PARAMS = dict(local_size=5, alpha=1e-4, beta=0.75, k=1.0)  # zoo._lrn
SERVE_BUCKETS = (1, 8, 64, 128)
#: phase 9's hold on the int8 lane's fc8 logits against the f32 lane's:
#: max abs difference over the f32 logits' largest magnitude. About 4x
#: the drift of full-width CaffeNet's int8 lane (weight rounding and
#: bfloat16 activations) on random inputs; a stale, zeroed or garbled
#: answer is off by the order of the logits themselves
INT8_FC8_REL = 0.05
TRAIN_LRN_BATCHES = (100, 256)
# (name, NHWC x shape, kernel, stride, pad); the first three are one
# CaffeNet training step's MAX pools at batch 256 (TRAIN_POOLS)
POOL_CASES = (("pool1", (256, 55, 55, 96), 3, 2, 0),
              ("pool2", (256, 27, 27, 256), 3, 2, 0),
              ("pool5", (256, 13, 13, 256), 3, 2, 0),
              ("cifar_pool1", (100, 32, 32, 32), 3, 2, 0),
              ("pad1", (64, 13, 13, 256), 3, 2, 1))
TRAIN_POOLS = ("pool1", "pool2", "pool5")
# apps/imagenet_app.py:default_config — the ImageNet app's solver
IMAGENET_SOLVER = dict(base_lr=0.01, momentum=0.9, weight_decay=0.0005,
                       lr_policy="step", gamma=0.1, stepsize=100000,
                       max_iter=450000)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, inputs, min_iters: int = 20) -> float:
    """Mean ms per call over many calls, CUDA events, after warm-up; the
    calls cycle through `inputs` so repeated calls do not hit in L2."""
    import torch
    for i in range(min(len(inputs), 5)):
        fn(inputs[i])
    torch.cuda.synchronize()
    iters = max(min_iters, len(inputs))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _dev_us(e) -> float:
    """A profiler row's own device time, µs."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_ms(fn, inputs, iters: int = 20):
    """(device ms per call with the calls back to back on the card, or None
    when it cannot be measured; host ms per call): the stream is held by a
    sleep kernel while
    the host queues the calls between two CUDA events, so the host's
    launch overhead (the wrappers' Python) does not pace them as it does
    in `time_ms`. The sleep lasts four times the host's queueing time (at
    2 GHz; the card's clock is at most 1.98 GHz, so at least that long).
    If queueing took more than half of it — the host was slower than
    estimated — it is measured again over half as many calls (at least 2)
    with a longer sleep; after 8 tries the host could not get ahead of the
    card, and the time is reported as not measured. The host time is the
    queueing time of the last try over its calls: the wrapper's Python and
    the launch, unpaced by the card. Warm-up first; the calls cycle through
    `inputs` as `time_ms`'s do."""
    import torch
    for i in range(min(len(inputs), 5)):
        fn(inputs[i])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(inputs[0])
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(8):
        torch.cuda.synchronize()
        sleep_s = min(max(5e-3, 4 * iters * host_s), 2.0)
        torch.cuda._sleep(int(sleep_s * 2e9))
        t0 = time.perf_counter()
        start.record()
        for i in range(iters):
            fn(inputs[i % len(inputs)])
        end.record()
        queued_s = time.perf_counter() - t0
        end.synchronize()
        host_s = queued_s / iters
        if queued_s <= sleep_s / 2:
            return start.elapsed_time(end) / iters, host_s * 1e3
        iters = max(2, iters // 2)
    print(f"device_ms: not measured: the host could not queue {iters} calls"
          f" ahead of the card ({queued_s:.3f} s to queue)", flush=True)
    return None, host_s * 1e3


#: the times of a row of the kernels line: the kernel, its plain version
#: and the library call, host-paced (`time_ms`); the kernel back to back
#: on the card (`device_ms`, None when not measured) and the host's time
#: to issue one call (`host_ms`)
TIME_KEYS = ("ms", "plain_ms", "library_ms", "device_ms", "host_ms")


def _timings(fns: dict, inputs, kernels=("ms",)) -> dict:
    """`time_ms` of each function in `fns`, under its key; for the keys in
    `kernels`, also `device_ms` under device_<key> and host_<key>."""
    out = {key: time_ms(fn, inputs) for key, fn in fns.items()}
    for key in kernels:
        out[f"device_{key}"], out[f"host_{key}"] = device_ms(fns[key],
                                                            inputs)
    return out


def _add(a, b):
    """a + b, None (not measured) if either is."""
    return None if a is None or b is None else a + b


def _fmt_times(t: dict) -> str:
    dev = t["device_ms"]
    return (f"kernel_ms={t['ms']:.5f} plain_ms={t['plain_ms']:.5f} "
            f"library_ms={t['library_ms']:.5f} kernel_device_ms="
            f"{'not measured' if dev is None else f'{dev:.5f}'} "
            f"kernel_host_ms={t['host_ms']:.5f}")


def lrn_bound(n: int, h: int, w: int, c: int, itemsize: int,
              local_size: int) -> dict:
    """Least time for one LRN forward: bytes (x read once, y written once)
    over HBM bandwidth vs f32 operations over the f32 peak. Operations per
    element: one multiply per window term, one add between terms, two for
    the scale, three for scale^-0.75 (rsqrt, sqrt, multiply), one for the
    output multiply — with the window clipped at the channel edges."""
    half = (local_size - 1) // 2
    per_row = sum(2 * (min(ch + half, c - 1) - max(ch - half, 0) + 1) + 5
                  for ch in range(c))
    rows = n * h * w
    nbytes = 2 * rows * c * itemsize
    ops = rows * per_row
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_kernels(card: str) -> dict:
    """lrn_fwd vs its plain version at the serve shapes; returns the
    aggregate row of the kernels line."""
    import torch
    import torch.nn.functional as F

    from sparknet_tpu_torch.ops.cuda_lrn import lrn_fwd
    from sparknet_tpu_torch.ops.lrn import lrn_plain

    p = LRN_PARAMS
    gen = torch.Generator(device="cuda").manual_seed(0)
    agg = {**dict.fromkeys(TIME_KEYS, 0.0), "bound_ms": 0.0,
           "max_abs_err": 0.0, "bound_by": "bytes"}
    for layer, (h, w, c) in LRN_SHAPES.items():
        for n in LRN_BUCKETS:
            for dtype in (torch.float32, torch.bfloat16):
                itemsize = torch.finfo(dtype).bits // 8
                one = n * h * w * c * itemsize
                nbuf = max(2, min(512, math.ceil(2.5 * L2_BYTES / one)))
                xs = (50.0 * torch.randn((nbuf, n, h, w, c), generator=gen,
                                         device="cuda")).to(dtype)
                x = xs[0]
                yk = lrn_fwd(x, **p)
                yp = lrn_plain(x, **p)
                torch.cuda.synchronize()
                max_err = float((yk.float() - yp.float()).abs().max())
                ok = torch.equal(yk, yp)
                fns = {"ms": lambda t: lrn_fwd(t, **p),
                       "plain_ms": lambda t: lrn_plain(t, **p),
                       "library_ms": lambda t: F.local_response_norm(
                           t.permute(0, 3, 1, 2), p["local_size"],
                           alpha=p["alpha"], beta=p["beta"], k=p["k"])}
                t = _timings(fns, xs)
                b = lrn_bound(n, h, w, c, itemsize, p["local_size"])
                dname = str(dtype).replace("torch.", "")
                print(f"lrn_fwd {layer} n={n} {dname} shape=({n},{h},{w},"
                      f"{c}) max_abs_err={max_err:.3e} tol=[bitwise] "
                      f"{'PASS' if ok else 'FAIL'} {_fmt_times(t)} "
                      f"bound_ms={b['bound_ms']:.5f} ({b['bound_by']}, "
                      f"{b['bytes']} B) achieved_GBps="
                      f"{b['bytes'] / t['ms'] / 1e6:.1f} [{card}]",
                      flush=True)
                if not ok:
                    fail(f"lrn_fwd disagrees with the plain version at "
                         f"{layer} n={n} {dname}: max abs err {max_err}")
                agg["max_abs_err"] = max(agg["max_abs_err"], max_err)
                if dtype == torch.float32 and n == 128:
                    # one bucket-128 forward's LRN work
                    if b["bound_by"] != "bytes":
                        agg["bound_by"] = b["bound_by"]
                    for key in TIME_KEYS:
                        agg[key] = _add(agg[key], t[key])
                    agg["bound_ms"] += b["bound_ms"]
                del xs, yk, yp
    return agg


def _window_terms(c: int, local_size: int) -> list:
    """Each channel's clipped LRN window size."""
    half = (local_size - 1) // 2
    return [min(ch + half, c - 1) - max(ch - half, 0) + 1 for ch in range(c)]


def _bound(nbytes: int, ops: int) -> dict:
    """The larger of bytes over HBM bandwidth and f32 operations over the
    f32 peak, in ms."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def lrn_fwd_scale_bound(rows: int, c: int, itemsize: int,
                        local_size: int) -> dict:
    """lrn_fwd with the scale: x read once, y and the scale written once;
    operations as `lrn_bound`."""
    ops = rows * sum(2 * t + 5 for t in _window_terms(c, local_size))
    return _bound(3 * rows * c * itemsize, ops)


def lrn_bwd_bound(rows: int, c: int, itemsize: int, local_size: int,
                  saved: bool) -> dict:
    """lrn_bwd: x, dy (and the saved scale) read once, dx written once.
    Operations per element: scale^-beta 3, ratio 3 (saved: two products
    and a division) or 5 (recompute: three products, rsqrt and its
    square), the ratio window's adds, 4 for dx; recompute adds the x^2
    window (one product per term, the adds between them) and 2 for the
    scale."""
    terms = _window_terms(c, local_size)
    if saved:
        per_row = sum(3 + 3 + (t - 1) + 4 for t in terms)
    else:
        per_row = sum((2 * t - 1) + 2 + 3 + 5 + (t - 1) + 4 for t in terms)
    return _bound((4 if saved else 3) * rows * c * itemsize, rows * per_row)


def maxpool_bwd_bound(x_shape, y_shape, kernel: int, itemsize: int) -> dict:
    """maxpool_bwd: x, y and dy read once, dx written once. Operations:
    each window's first-max search over its k*k positions and one add of
    its dy."""
    nx = math.prod(x_shape)
    ny = math.prod(y_shape)
    return _bound(2 * (nx + ny) * itemsize, ny * (kernel * kernel + 1))


def _nbuf(one_bytes: int, cap: int = 64) -> int:
    """Input copies to cycle through so repeated calls miss in L2."""
    return max(2, min(cap, math.ceil(2.5 * L2_BYTES / one_bytes)))


def _dname(dtype) -> str:
    return str(dtype).replace("torch.", "")


def phase_lrn_train_kernels(card: str) -> dict:
    """lrn_fwd with the scale output and lrn_bwd in both modes against
    their plain versions at the training shapes; returns the rows of the
    kernels line (keyed by what they time)."""
    import torch
    import torch.nn.functional as F

    from sparknet_tpu_torch.ops.cuda_lrn import lrn_bwd, lrn_fwd
    from sparknet_tpu_torch.ops.lrn import (lrn_bwd_plain, lrn_plain,
                                            lrn_plain_with_scale)

    p = LRN_PARAMS
    ls, a, b, k = p["local_size"], p["alpha"], p["beta"], p["k"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {"max_abs_err": 0.0, "cases": {}}
    for layer, (h, w, c) in LRN_SHAPES.items():
        for n in TRAIN_LRN_BATCHES:
            for dtype in (torch.float32, torch.bfloat16):
                itemsize = torch.finfo(dtype).bits // 8
                rows = n * h * w
                nbuf = _nbuf(rows * c * itemsize)
                xs = (50.0 * torch.randn((nbuf, n, h, w, c), generator=gen,
                                         device="cuda")).to(dtype)
                dys = torch.randn((nbuf, n, h, w, c), generator=gen,
                                  device="cuda").to(dtype)
                x, dy = xs[0], dys[0]
                y, scale = lrn_fwd(x, **p, with_scale=True)
                y_only = lrn_fwd(x, **p)
                py, pscale = lrn_plain_with_scale(x, **p)
                dx_saved = lrn_bwd(x, dy, scale, ls, a, b, k)
                dx_re = lrn_bwd(x, dy, None, ls, a, b, k)
                pdx_saved = lrn_bwd_plain(x, dy, pscale, ls, a, b, k)
                pdx_re = lrn_bwd_plain(x, dy, None, ls, a, b, k)
                torch.cuda.synchronize()
                pairs = {"y": (y, py), "y_only": (y_only, py),
                         "scale": (scale, pscale),
                         "dx_saved": (dx_saved, pdx_saved),
                         "dx_recompute": (dx_re, pdx_re)}
                errs = {name: float((g.float() - w_.float()).abs().max())
                        for name, (g, w_) in pairs.items()}
                ok = all(torch.equal(g, w_) for g, w_ in pairs.values())
                out["max_abs_err"] = max([out["max_abs_err"]]
                                         + list(errs.values()))
                idx = list(range(nbuf))
                scales = [lrn_fwd(xs[i], **p, with_scale=True)[1]
                          for i in idx]
                xg = [xs[i].permute(0, 3, 1, 2).detach().requires_grad_()
                      for i in idx]
                ylib = [F.local_response_norm(t, ls, alpha=a, beta=b, k=k)
                        for t in xg]
                fns = {
                    "fwd_scale": lambda i: lrn_fwd(xs[i], **p,
                                                   with_scale=True),
                    "fwd_y": lambda i: lrn_fwd(xs[i], **p),
                    "plain_fwd_scale": lambda i: lrn_plain_with_scale(
                        xs[i], **p),
                    "plain_fwd_y": lambda i: lrn_plain(xs[i], **p),
                    "lib_fwd": lambda i: F.local_response_norm(
                        xs[i].permute(0, 3, 1, 2), ls, alpha=a, beta=b, k=k),
                    "bwd_saved": lambda i: lrn_bwd(xs[i], dys[i], scales[i],
                                                   ls, a, b, k),
                    "bwd_recompute": lambda i: lrn_bwd(xs[i], dys[i], None,
                                                       ls, a, b, k),
                    "plain_bwd_saved": lambda i: lrn_bwd_plain(
                        xs[i], dys[i], scales[i], ls, a, b, k),
                    "plain_bwd_recompute": lambda i: lrn_bwd_plain(
                        xs[i], dys[i], None, ls, a, b, k),
                    "lib_bwd": lambda i: torch.autograd.grad(
                        ylib[i], xg[i], dys[i].permute(0, 3, 1, 2),
                        retain_graph=True),
                }
                t = _timings(fns, idx, kernels=("fwd_scale", "fwd_y",
                                                "bwd_saved", "bwd_recompute"))
                bounds = {
                    "fwd_scale": lrn_fwd_scale_bound(rows, c, itemsize, ls),
                    "fwd_y": lrn_bound(n, h, w, c, itemsize, ls),
                    "bwd_saved": lrn_bwd_bound(rows, c, itemsize, ls, True),
                    "bwd_recompute": lrn_bwd_bound(rows, c, itemsize, ls,
                                                   False)}
                dn = _dname(dtype)
                print(f"lrn_train {layer} n={n} {dn} shape=({n},{h},{w},{c})"
                      f" bitwise={'PASS' if ok else 'FAIL'} max_abs_err "
                      f"y={errs['y']:.1e} y_vs_y_only={errs['y_only']:.1e} "
                      f"scale={errs['scale']:.1e} dx_saved="
                      f"{errs['dx_saved']:.1e} dx_recompute="
                      f"{errs['dx_recompute']:.1e} tol=[bitwise] [{card}]",
                      flush=True)
                for kind, plain_key, lib_key in (
                        ("fwd_scale", "plain_fwd_scale", "lib_fwd"),
                        ("fwd_y", "plain_fwd_y", "lib_fwd"),
                        ("bwd_saved", "plain_bwd_saved", "lib_bwd"),
                        ("bwd_recompute", "plain_bwd_recompute", "lib_bwd")):
                    bd = bounds[kind]
                    row = {"ms": t[kind], "plain_ms": t[plain_key],
                           "library_ms": t[lib_key],
                           "device_ms": t[f"device_{kind}"],
                           "host_ms": t[f"host_{kind}"]}
                    print(f"lrn_train   {kind:13s} {layer} n={n} {dn} "
                          f"{_fmt_times(row)} bound_ms={bd['bound_ms']:.5f} "
                          f"({bd['bound_by']}, {bd['bytes']} B) "
                          f"achieved_GBps={bd['bytes'] / row['ms'] / 1e6:.1f}"
                          f" [{card}]", flush=True)
                    out["cases"][(kind, layer, n, dn)] = {**row, **bd}
                if not ok:
                    fail(f"LRN training kernels disagree with their plain "
                         f"versions at {layer} n={n} {dn}: {errs}")
                del xs, dys, scales, xg, ylib
    return out


def phase_pool_kernels(card: str) -> dict:
    """maxpool_bwd against its plain version on tie-heavy inputs, and at
    the training step's pools (pool1/2/5, batch 256, bfloat16) also on
    dense ones; returns the rows of the kernels line, keyed by (case,
    dtype, input)."""
    import torch

    from sparknet_tpu_torch.ops.cuda_pool import maxpool_bwd
    from sparknet_tpu_torch.ops.pooling import (_max_forward,
                                                maxpool_bwd_plain)

    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {"max_abs_err": 0.0, "cases": {}}
    for name, shape, kern, stride, pad in POOL_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            dn = _dname(dtype)
            kinds = ("ties", "dense") if name in TRAIN_POOLS and \
                dtype == torch.bfloat16 else ("ties",)
            for kind in kinds:
                itemsize = torch.finfo(dtype).bits // 8
                nbuf = _nbuf(math.prod(shape) * itemsize, cap=8)
                if kind == "ties":
                    # a few integer levels, clipped at 0 (post-ReLU)
                    xs = torch.randint(-2, 4, (nbuf,) + shape, generator=gen,
                                       device="cuda").clamp_(min=0)
                else:
                    # ReLU of a Gaussian: ties only among the zeros
                    xs = torch.randn((nbuf,) + shape, generator=gen,
                                     device="cuda").clamp_(min=0)
                xs = xs.to(dtype)
                x_nchw = [xs[i].permute(0, 3, 1, 2) for i in range(nbuf)]
                ys = [_max_forward(t, kern, stride, pad).permute(0, 2, 3, 1)
                      .contiguous() for t in x_nchw]
                dys = [torch.randn(ys[0].shape, generator=gen,
                                   device="cuda").to(dtype)
                       for _ in range(nbuf)]
                got = maxpool_bwd(xs[0], ys[0], dys[0], kern, stride, pad)
                want = maxpool_bwd_plain(xs[0], ys[0], dys[0], kern, stride,
                                         pad)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                same_pos = torch.equal(got != 0, want != 0)
                ok = torch.equal(got, want) and same_pos
                out["max_abs_err"] = max(out["max_abs_err"], err)
                idx = list(range(nbuf))
                xg = [t.detach().requires_grad_() for t in x_nchw]
                ylib = [_max_forward(t, kern, stride, pad) for t in xg]
                t = _timings({
                    "ms": lambda i: maxpool_bwd(xs[i], ys[i], dys[i], kern,
                                                stride, pad),
                    "plain_ms": lambda i: maxpool_bwd_plain(
                        xs[i], ys[i], dys[i], kern, stride, pad),
                    "library_ms": lambda i: torch.autograd.grad(
                        ylib[i], xg[i], dys[i].permute(0, 3, 1, 2),
                        retain_graph=True)}, idx)
                bd = maxpool_bwd_bound(shape, tuple(ys[0].shape), kern,
                                       itemsize)
                print(f"maxpool_bwd {name} {dn} {kind} x={shape} -> y="
                      f"{tuple(ys[0].shape)} k={kern} s={stride} pad={pad} "
                      f"max_abs_err={err:.1e} same_positions={same_pos} "
                      f"tol=[bitwise] {'PASS' if ok else 'FAIL'} "
                      f"{_fmt_times(t)} bound_ms={bd['bound_ms']:.5f} "
                      f"({bd['bound_by']}, {bd['bytes']} B) achieved_GBps="
                      f"{bd['bytes'] / t['ms'] / 1e6:.1f} [{card}]",
                      flush=True)
                out["cases"][(name, dn, kind)] = {**t, **bd}
                if not ok:
                    fail(f"maxpool_bwd disagrees with its plain version at "
                         f"{name} {dn} {kind}: max abs err {err}, same "
                         f"positions {same_pos}")
                del xs, x_nchw, ys, dys, xg, ylib
    return out


def phase_serve(card: str, device: str = "cuda", crop: int = 227) -> dict:
    """Full-width CaffeNet through the port's InferenceServer; returns the
    lrn_fwd launch count of the run. (`device` and `crop` let the serve
    phase be rehearsed on the CPU at a small crop.)"""
    import numpy as np
    import torch

    from sparknet_tpu_torch import precision, zoo
    from sparknet_tpu_torch.model.layers import OpsImpl
    from sparknet_tpu_torch.net_api import TorchNet
    from sparknet_tpu_torch.ops.cuda_lrn import lrn_fwd
    from sparknet_tpu_torch.serve.server import InferenceServer, ServeConfig

    precision.set_policy("float32")
    spec = zoo.caffenet(batch=128, crop=crop, n_classes=1000)
    t0 = time.perf_counter()
    net = TorchNet(spec, seed=0, device=device)
    print(f"serve: TorchNet(caffenet {crop}/1000) on {net.device} built in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    rng = np.random.default_rng(1)
    # mean-subtracted pixel scale; 169 distinct requests
    payloads = [{"data": (50.0 * rng.standard_normal((crop, crop, 3))
                          ).astype(np.float32)} for _ in range(169)]
    cfg = ServeConfig(model_name="caffenet", max_batch=128,
                      buckets=SERVE_BUCKETS, outputs=("prob",),
                      max_wait_ms=50.0)
    server = InferenceServer(net, cfg).start()
    try:
        lrn_fwd.launches = 0
        t0 = time.perf_counter()
        lone = server.submit(payloads[0]).result(timeout=300)
        burst = [server.submit(p) for p in payloads[1:129]]
        burst_out = [f.result(timeout=300) for f in burst]
        tail = [server.submit(p) for p in payloads[129:169]]
        tail_out = [f.result(timeout=300) for f in tail]
        cold_s = time.perf_counter() - t0
        cold = server.status()
        server.reset_counters()
        t1 = time.perf_counter()
        steady = []
        for _ in range(4):
            futs = [server.submit(p) for p in payloads[1:129]]
            steady += [f.result(timeout=300) for f in futs]
        steady_s = time.perf_counter() - t1
        launches = lrn_fwd.launches
        warm = server.status()
        batch_log = list(server.batch_log)
    finally:
        server.stop()

    results = [lone] + burst_out + tail_out + steady
    for i, r in enumerate(results):
        prob = r["prob"]
        if prob.shape != (1000,) or not np.isfinite(prob).all():
            fail(f"request {i}: prob shape {prob.shape}, finite "
                 f"{np.isfinite(prob).all()}")
        if abs(float(prob.sum(dtype=np.float64)) - 1.0) > 1e-4:
            fail(f"request {i}: prob sums to {prob.sum()}")
    buckets = sorted({b for _, b in batch_log})
    if not {1, 128} <= set(buckets):
        fail(f"buckets 1 and 128 must both serve, served {buckets}")
    forwards = len(batch_log)
    if launches != 2 * forwards:
        fail(f"lrn_fwd launched {launches} times over {forwards} forwards "
             f"(want 2 per forward)")
    print(f"serve: {len(results)} requests answered in {forwards} forwards, "
          f"buckets served {buckets}, lrn_fwd launches {launches} "
          f"(2 per forward) [{card}]", flush=True)
    print(f"serve: cold pass (1 + 128 + 40 requests, first forward of each "
          f"bucket included): {169 / cold_s:.1f} img/s, p50 "
          f"{cold['p50_ms']} ms, p99 {cold['p99_ms']} ms [{card}]",
          flush=True)
    print(f"serve: steady pass (4 bursts of 128): {512 / steady_s:.1f} "
          f"img/s, p50 {warm['p50_ms']} ms, p99 {warm['p99_ms']} ms "
          f"[{card}]", flush=True)
    if device == "cuda":
        print(f"serve: peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
              f"[{card}]", flush=True)

    # the served burst vs the same rows through the plain LRN
    batch = {"data": np.stack([p["data"] for p in payloads[1:129]]),
             "label": np.zeros((128, 1), np.int32)}
    plain = net.forward(batch, ["prob"], ops=OpsImpl(lrn="plain"))["prob"]
    served = np.stack([r["prob"] for r in burst_out])
    err = float(np.abs(served - plain).max())
    print(f"serve: bucket-128 prob vs plain-LRN forward: max abs err "
          f"{err:.3e} (tol atol 1e-6 rtol 1e-4)", flush=True)
    if not np.allclose(served, plain, rtol=1e-4, atol=1e-6):
        fail(f"served prob disagrees with the plain-LRN forward ({err})")

    # the served answers vs a CPU forward of the same net and weights
    cpu = TorchNet(spec, seed=0, device="cpu")
    ref = cpu.forward({"data": batch["data"][:2],
                       "label": batch["label"][:2]}, ["prob"])["prob"]
    err = float(np.abs(served[:2] - ref).max())
    print(f"serve: prob vs CPU forward (same seed, 2 requests): max abs err "
          f"{err:.3e} (tol atol 1e-5)", flush=True)
    if not np.allclose(served[:2], ref, rtol=0, atol=1e-5):
        fail(f"served prob disagrees with the CPU forward ({err})")
    if device == "cuda":
        profile_forward(net, [p["data"] for p in payloads[1:129]], card)
    return {"launches": launches, "steady_img_s": 512 / steady_s}


def profile_forward(net, rows, card: str, top: int = 12) -> None:
    """Where one bucket-128 batch's time goes: the host stacking the
    request rows, the synchronous host->device copy, and the device
    kernels of one `TorchNet.forward` by name (torch.profiler), with the
    share of the forward's wall time in which no kernel ran (copies do not
    count as kernel time)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    stacked = np.stack(rows)
    t_stack = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.from_numpy(stacked).to("cuda")
    torch.cuda.synchronize()
    t_h2d = time.perf_counter() - t0
    batch = {"data": stacked, "label": np.zeros((len(rows), 1), np.int32)}
    net.forward(batch, ["prob"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.forward(batch, ["prob"])
        wall = time.perf_counter() - t0

    # device-side events only: a CPU op's self device time repeats the
    # time of the kernels it launched
    rows_ = sorted((e for e in prof.key_averages()
                    if str(e.device_type).endswith("CUDA") and _dev_us(e) > 0),
                   key=_dev_us, reverse=True)
    copies = sum(_dev_us(e) for e in rows_
                 if e.key.startswith(("Memcpy", "Memset"))) / 1e3
    kernels = sum(_dev_us(e) for e in rows_) / 1e3 - copies
    print(f"profile: bucket-128 batch: host stack {t_stack * 1e3:.2f} ms, "
          f"H2D copy {t_h2d * 1e3:.2f} ms ({stacked.nbytes} B), forward "
          f"wall {wall * 1e3:.2f} ms, device kernels {kernels:.2f} ms, "
          f"device copies {copies:.2f} ms, kernel idle share "
          f"{max(0.0, 1 - kernels / (wall * 1e3)):.3f} [{card}]",
          flush=True)
    for e in rows_[:top]:
        print(f"profile:   {_dev_us(e) / 1e3:9.3f} ms  x{e.count:<4d} "
              f"{e.key[:90]}", flush=True)


def _zero_counts() -> None:
    from sparknet_tpu_torch.ops.cuda_lrn import lrn_bwd, lrn_fwd
    from sparknet_tpu_torch.ops.cuda_pool import maxpool_bwd
    lrn_fwd.launches = lrn_fwd.scale_launches = lrn_fwd.bf16_launches = 0
    lrn_bwd.launches = maxpool_bwd.launches = 0


def _read_counts() -> dict:
    from sparknet_tpu_torch.ops.cuda_lrn import lrn_bwd, lrn_fwd
    from sparknet_tpu_torch.ops.cuda_pool import maxpool_bwd
    return {"lrn_fwd": lrn_fwd.launches,
            "lrn_fwd_scale": lrn_fwd.scale_launches,
            "lrn_bwd": lrn_bwd.launches, "maxpool_bwd": maxpool_bwd.launches}


def _capture_logger():
    """A Logger that keeps every metrics record (rounds and events) in
    memory, in `.records`."""
    from sparknet_tpu_torch.utils.logger import Logger

    class Capture(Logger):
        def __init__(self):
            super().__init__(echo=False)
            self.records = []
            self.lines = []

        def log(self, message, i=None):
            self.lines.append(message)

        def metrics(self, step, **kv):
            self.records.append(dict(kv, round=step))

    return Capture()


def _train_run(card: str, cfg, spec, train_ds, test_ds, label: str,
               device: str) -> dict:
    """One `train()` call with its launch counts zeroed before and read
    after; returns the per-round records, counts, final state and peak
    device memory."""
    import torch

    from sparknet_tpu_torch.apps.train_loop import train

    log = _capture_logger()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    state = train(cfg, spec, train_ds, test_ds, logger=log, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if device == "cuda" else 0.0)
    rounds = [r for r in log.records if "loss" in r]
    for r in rounds:
        print(f"train[{label}]: round {r['round']} loss {r['loss']:.6f} "
              f"grad_norm {r.get('grad_norm')} nonfinite {r.get('nonfinite')}"
              f" round_s {r['round_s']:.4f} img/s {r['images_per_sec']:.1f} "
              f"(the round; the data wait t_data_ms {r.get('t_data_ms')} "
              f"comes before it) [{card}]", flush=True)
    print(f"train[{label}]: {len(rounds)} rounds in {wall:.2f}s wall "
          f"(set-up included), launches {counts}, peak device memory "
          f"{peak:.2f} GiB [{card}]", flush=True)
    for r in rounds:
        vals = [r["loss"], r.get("grad_norm", 0.0)]
        if not all(math.isfinite(v) for v in vals) or r.get("nonfinite"):
            fail(f"train[{label}] round {r['round']}: loss {r['loss']}, "
                 f"grad_norm {r.get('grad_norm')}, nonfinite "
                 f"{r.get('nonfinite')}")
    if len(rounds) != cfg.max_rounds:
        fail(f"train[{label}]: {len(rounds)} rounds logged, want "
             f"{cfg.max_rounds}")
    return {"rounds": rounds, "counts": counts, "state": state,
            "peak_gib": peak}


def _expect_counts(label: str, counts: dict, want: dict) -> None:
    if counts != want:
        fail(f"train[{label}]: launches {counts}, want {want}")


def phase_train(card: str, device: str = "cuda", crop: int = 227,
                batch: int = 256, small_batch: int = 100, tau: int = 5,
                rounds: int = 6, n_classes: int = 1000) -> dict:
    """Full-width CaffeNet through `apps.train_loop.train` (module
    docstring, phase 4); returns the launch counts of the main run. The
    arguments let the phase be rehearsed on the CPU at a small size, where
    the counts are those of kernel launches, so all zero."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from sparknet_tpu_torch import precision, zoo
    from sparknet_tpu_torch.data.dataset import ArrayDataset
    from sparknet_tpu_torch.model.layers import OpsImpl
    from sparknet_tpu_torch.model.net import CompiledNet
    from sparknet_tpu_torch.solver import SolverConfig, value_and_grad
    from sparknet_tpu_torch.utils.config import RunConfig

    r = np.random.default_rng(0)
    n = tau * batch
    # int8 pixels: a mean-subtracted range at a quarter of f32's host bytes
    data = r.integers(-128, 128, (n, crop, crop, 3), dtype=np.int8)
    labels = r.integers(0, n_classes, (n, 1)).astype(np.int32)
    train_ds = ArrayDataset({"data": data, "label": labels})
    test_ds = ArrayDataset({"data": data[:batch], "label": labels[:batch]})
    solver = SolverConfig(**IMAGENET_SOLVER)
    kernels = device == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        base = RunConfig(model="caffenet", n_classes=n_classes, crop=crop,
                         solver=solver, tau=tau, local_batch=batch,
                         max_rounds=rounds, eval_every=rounds,
                         eval_batch=batch, precision="bfloat16", seed=0,
                         workdir=tmp)
        spec = zoo.caffenet(batch=batch, crop=crop, n_classes=n_classes)
        main = _train_run(card, base, spec, train_ds, test_ds,
                          f"caffenet {crop}/{n_classes} b{batch} bf16 "
                          f"tau{tau}", device)
        steps = tau * rounds
        if kernels:
            _expect_counts("main", main["counts"], {
                "lrn_fwd": 2 * steps + 2, "lrn_fwd_scale": 0,
                "lrn_bwd": 2 * steps, "maxpool_bwd": 3 * steps})
        init = CompiledNet.compile(spec).init_params(
            torch.Generator().manual_seed(base.seed), torch.device("cpu"))
        still = [f"{l}/{p}" for l, lp in init.items() for p, w in lp.items()
                 if torch.equal(w, main["state"].params[l][p].detach()
                                .cpu())]
        if still:
            fail(f"train: params did not move: {still}")
        print(f"train: every param tensor moved from its seeded init; "
              f"launches per step lrn_fwd "
              f"{(main['counts']['lrn_fwd'] - 2) / steps:g} (+2 for the "
              f"round-0 evaluation forward), lrn_bwd "
              f"{main['counts']['lrn_bwd'] / steps:g} (recompute), "
              f"maxpool_bwd {main['counts']['maxpool_bwd'] / steps:g}",
              flush=True)
        warm = [x["round_s"] for x in main["rounds"][1:]]

        # the saved-scale route: a batch that is not a multiple of 128
        small = dataclasses.replace(base, local_batch=small_batch,
                                    max_rounds=1, eval_every=0,
                                    precision="float32")
        sub = ArrayDataset({"data": data[:tau * small_batch],
                            "label": labels[:tau * small_batch]})
        saved = _train_run(card, small, zoo.caffenet(
            batch=small_batch, crop=crop, n_classes=n_classes), sub, None,
            f"b{small_batch} f32 saved-scale", device)
        if kernels:
            _expect_counts("saved-scale", saved["counts"], {
                "lrn_fwd": 2 * tau, "lrn_fwd_scale": 2 * tau,
                "lrn_bwd": 2 * tau, "maxpool_bwd": 3 * tau})

        # the pool route A/B: the same rounds with the plain MAX-pool
        # backward; each route's first round is its warm-up
        plain = _train_run(card, dataclasses.replace(
            base, eval_every=0, pool_impl="plain"), spec, train_ds, None,
            "pool=plain", device)
        if kernels:
            _expect_counts("pool=plain", plain["counts"], {
                "lrn_fwd": 2 * steps, "lrn_fwd_scale": 0,
                "lrn_bwd": 2 * steps, "maxpool_bwd": 0})
        plain_warm = [x["round_s"] for x in plain["rounds"][1:]]

        def spread(xs):
            return (f"median {statistics.median(xs) * 1e3:.2f} ms [min "
                    f"{min(xs) * 1e3:.2f}, max {max(xs) * 1e3:.2f}] over "
                    f"{len(xs)} warm rounds")

        print(f"train: pool route A/B, rounds of {tau} steps at batch "
              f"{batch}: auto (kernel) {spread(warm)} = "
              f"{tau * batch / statistics.median(warm):.1f} img/s; plain "
              f"{spread(plain_warm)} = "
              f"{tau * batch / statistics.median(plain_warm):.1f} img/s "
              f"[{card}]", flush=True)

    # kernel route vs plain route gradients, one fixed f32 batch
    precision.set_policy("float32")
    free = spec.replace(layers=tuple(
        dataclasses.replace(l, dropout=dataclasses.replace(
            l.dropout, dropout_ratio=0.0)) if l.type == "Dropout" else l
        for l in spec.layers))
    net = CompiledNet.compile(free)
    params = net.init_params(torch.Generator().manual_seed(0),
                             torch.device(device))
    for lp in params.values():
        for w in lp.values():
            w.requires_grad_(True)
    xb = {"data": torch.from_numpy(np.ascontiguousarray(data[:batch])).to(
              device).float(),
          "label": torch.from_numpy(labels[:batch]).to(device)}
    # cuDNN's deterministic algorithms for this comparison only: the
    # routes then differ only where the kernels would
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    grads = {}
    try:
        for route, ops in (("kernel", OpsImpl()),
                           ("plain", OpsImpl(lrn="plain", pool="plain")),
                           ("plain again", OpsImpl(lrn="plain",
                                                   pool="plain"))):
            _zero_counts()
            loss, grads[route] = value_and_grad(net.loss_fn(ops=ops), params,
                                                xb)
            print(f"grads[{route}]: loss {float(loss):.6f}, launches "
                  f"{_read_counts()}", flush=True)
    finally:
        torch.backends.cudnn.deterministic = det

    def rel_errors(a, b):
        return sorted(((float(torch.linalg.vector_norm(
            (a[l][p] - g).double()) / max(float(torch.linalg.vector_norm(
                g.double())), 1e-30)), f"{l}/{p}")
            for l, lp in b.items() for p, g in lp.items()), reverse=True)

    kp = rel_errors(grads["kernel"], grads["plain"])
    pp = rel_errors(grads["plain again"], grads["plain"])
    worst, spread = kp[0][0], pp[0][0]
    print(f"grads: kernel route vs plain route, f32 batch {batch}, "
          f"dropout-free, cuDNN deterministic: worst relative L2 error "
          f"{worst:.3e} ({', '.join(f'{n} {e:.1e}' for e, n in kp[:3])}); "
          f"plain vs plain {spread:.3e} ({', '.join(f'{n} {e:.1e}' for e, n in pp[:3])}); "
          f"tol 1e-6 + 2 x plain-vs-plain [{card}]", flush=True)
    if not worst <= 1e-6 + 2 * spread:
        fail(f"kernel-route gradients disagree with the plain route: "
             f"relative L2 {worst} (plain vs plain {spread})")
    if device == "cuda":
        precision.set_policy("bfloat16")
        profile_step(net, params, xb, solver, card)
    precision.set_policy("float32")
    return {"launches": main["counts"], "steps": steps,
            "saved_launches": saved["counts"], "warm_round_s": warm,
            "plain_pool_round_s": plain_warm, "peak_gib": main["peak_gib"],
            "grad_rel_l2": worst}


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def phase_checkpoint(card: str, device: str = "cuda", crop: int = 227,
                     batch: int = 256, tau: int = 5,
                     n_classes: int = 1000) -> dict:
    """Checkpoints, resume and rollback of full-width CaffeNet through
    `apps.train_loop.train` (module docstring, phase 5); returns the
    launch counts and the save and restore times. The arguments let the
    phase be rehearsed on the CPU at a small size (counts then 0)."""
    import dataclasses
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    from sparknet_tpu_torch import precision, zoo
    from sparknet_tpu_torch.apps.train_loop import train
    from sparknet_tpu_torch.data.dataset import ArrayDataset
    from sparknet_tpu_torch.net_api import TorchNet
    from sparknet_tpu_torch.parallel.trainer import ParallelTrainer
    from sparknet_tpu_torch.solver import SolverConfig
    from sparknet_tpu_torch.utils import checkpoint as ckpt
    from sparknet_tpu_torch.utils.config import RunConfig
    from sparknet_tpu_torch.utils.health import HealthConfig

    r = np.random.default_rng(1)
    n = tau * batch
    data = r.integers(-128, 128, (n, crop, crop, 3), dtype=np.int8)
    labels = r.integers(0, n_classes, (n, 1)).astype(np.int32)
    train_ds = ArrayDataset({"data": data, "label": labels})
    spec = zoo.caffenet(batch=batch, crop=crop, n_classes=n_classes)
    kernels = device == "cuda"
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    # every save, restore and stage-1 snapshot of this phase, timed
    timed = []
    lock = threading.Lock()
    originals = (ckpt.save, ckpt.restore_flat, ckpt.restore_newest_verified,
                 ParallelTrainer.checkpoint_tree)

    def note(what, t0, nbytes, step):
        with lock:
            timed.append({"what": what, "s": time.perf_counter() - t0,
                          "bytes": nbytes, "step": step,
                          "thread": threading.current_thread().name})

    def flat_bytes(flat):
        return sum(int(a.numel() * a.element_size())
                   if isinstance(a, torch.Tensor) else int(a.nbytes)
                   for a in flat.values())

    def save(directory, tree, *, step, extra=None):
        t0 = time.perf_counter()
        path = originals[0](directory, tree, step=step, extra=extra)
        note("save", t0, _dir_bytes(path), step)
        return path

    def restore_flat(directory, step=None):
        t0 = time.perf_counter()
        out = originals[1](directory, step)
        note("restore", t0, flat_bytes(out[0]), out[1])
        return out

    def restore_newest_verified(directory, skip_anomalous=False):
        t0 = time.perf_counter()
        out = originals[2](directory, skip_anomalous=skip_anomalous)
        if out is not None:
            note("rollback restore", t0, flat_bytes(out[0]), out[1])
        return out

    def checkpoint_tree(self, state):
        t0 = time.perf_counter()
        tree = originals[3](self, state)
        note("stage 1 (gather + host copy)", t0, None, None)
        return tree

    ckpt.save, ckpt.restore_flat = save, restore_flat
    ckpt.restore_newest_verified = restore_newest_verified
    ParallelTrainer.checkpoint_tree = checkpoint_tree
    # cuDNN's deterministic algorithms: the resumed run must be bit-equal
    # to the uninterrupted one (the kernels are deterministic already)
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    steps_of = {}

    def run(label, cfg, n_rounds):
        log = _capture_logger()
        if device == "cuda":
            torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        state = train(cfg, spec, train_ds, None, logger=log, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts()
        rounds = [x for x in log.records if "loss" in x]
        for x in rounds:
            print(f"checkpoint[{label}]: round {x['round']} loss "
                  f"{x['loss']} nonfinite {x.get('nonfinite')} round_s "
                  f"{x['round_s']:.4f} [{card}]", flush=True)
        print(f"checkpoint[{label}]: {len(rounds)} rounds in {wall:.2f}s "
              f"wall (set-up and checkpoints included), launches {counts} "
              f"[{card}]", flush=True)
        if len(rounds) != n_rounds:
            fail(f"checkpoint[{label}]: {len(rounds)} rounds run, want "
                 f"{n_rounds}")
        executed = n_rounds * tau  # a retried round runs its steps again
        steps_of[label] = executed
        if kernels:
            _expect_counts(label, counts, {
                "lrn_fwd": 2 * executed, "lrn_fwd_scale": 0,
                "lrn_bwd": 2 * executed, "maxpool_bwd": 3 * executed})
        return state, log.records, counts

    try:
        base = RunConfig(model="caffenet", n_classes=n_classes, crop=crop,
                         solver=SolverConfig(**IMAGENET_SOLVER), tau=tau,
                         local_batch=batch, eval_every=0,
                         precision="bfloat16", seed=0, workdir=root,
                         checkpoint_every=2)
        dir_a, dir_b, dir_c = (os.path.join(root, d) for d in "abc")
        # 1. uninterrupted, synchronous writes
        full, _, c1 = run("uninterrupted", dataclasses.replace(
            base, max_rounds=4, checkpoint_dir=dir_a,
            checkpoint_async=False), 4)
        # 2. interrupted after round 2 and resumed, async writes
        _, _, c2a = run("first half", dataclasses.replace(
            base, max_rounds=2, checkpoint_dir=dir_b), 2)
        resumed, _, c2b = run("resumed", dataclasses.replace(
            base, max_rounds=4, checkpoint_dir=dir_b, resume=True), 2)
        for kind in ("params", "momentum"):
            a, b = getattr(full, kind), getattr(resumed, kind)
            bad = [f"{l}/{p}" for l in a for p in a[l]
                   if not torch.equal(a[l][p], b[l][p])]
            if bad:
                fail(f"checkpoint: the resumed run's {kind} differ from the "
                     f"uninterrupted run's: {bad}")
        if resumed.it != full.it:
            fail(f"checkpoint: resumed it {resumed.it} != {full.it}")
        sizes = {}
        for d in (dir_a, dir_b):
            for name in sorted(os.listdir(d)):
                path = os.path.join(d, name)
                if not ckpt.verify(path):
                    fail(f"checkpoint: {path} does not verify")
                sizes[f"{os.path.basename(d)}/{name}"] = _dir_bytes(path)
        metas = [json.load(open(os.path.join(d, "step-4", "meta.json")))
                 for d in (dir_a, dir_b)]
        if metas[0]["digests"] != metas[1]["digests"]:
            fail("checkpoint: step-4 digests of the uninterrupted and the "
                 "resumed run differ")
        print(f"checkpoint: the resumed run equals the uninterrupted one "
              f"(torch.equal on every param and momentum tensor, it "
              f"{full.it}); step-4 digests equal; every step verifies; "
              f"step sizes on disk in bytes {sizes} [{card}]", flush=True)

        # 4. weights: .caffemodel out of run 1's params, into a fresh net
        precision.set_policy("float32")
        spec128 = zoo.caffenet(batch=128, crop=crop, n_classes=n_classes)
        src = TorchNet(spec128, seed=0, device=device)
        src.params = {l: {p: t.detach().clone() for p, t in lp.items()}
                      for l, lp in full.params.items()}
        path = os.path.join(root, "caffenet.caffemodel")
        t0 = time.perf_counter()
        src.save_weights(path)
        t_save = time.perf_counter() - t0
        dst = TorchNet(spec128, seed=1, device=device)
        t0 = time.perf_counter()
        dst.load_weights(path)
        t_load = time.perf_counter() - t0
        rows = {"data": data[:128], "label": labels[:128]}
        a, b = src.forward(rows)["prob"], dst.forward(rows)["prob"]
        if not (np.array_equal(a, b) and np.isfinite(a).all()):
            fail(f"checkpoint: the .caffemodel round trip's bucket-128 "
                 f"forward differs (max abs {np.abs(a - b).max()})")
        print(f"checkpoint: .caffemodel of run 1's params "
              f"({os.path.getsize(path)} bytes) saved in {t_save:.3f}s, "
              f"loaded into a fresh net in {t_load:.3f}s; its bucket-128 "
              f"float32 forward equals the source net's bit for bit "
              f"[{card}]", flush=True)
        shutil.rmtree(dir_a)
        shutil.rmtree(dir_b)

        # 3. rollback: a NaN injected at round 3 (injection poisons float
        # inputs only, so this run's images are float32; the default
        # min_history keeps spike classification off for its 6 rounds)
        health = HealthConfig(inject_nan_rounds=(3,))
        train_ds = ArrayDataset({"data": data.astype(np.float32),
                                 "label": labels})
        roll, recs, c3 = run("rollback", dataclasses.replace(
            base, max_rounds=6, checkpoint_dir=dir_c, health=health), 8)
        events = [x for x in recs if x.get("event") == "rollback"]
        if len(events) != 1 or (events[0]["target_step"], events[0]["retry"],
                                events[0]["lr_scale"]) != \
                (2, 1, health.lr_backoff):
            fail(f"checkpoint: rollback events {events}, want one with "
                 f"target_step 2, retry 1, lr_scale {health.lr_backoff}")
        order = [x for x in recs if "loss" in x or x.get("event")]
        after = order[order.index(events[0]) + 1:]
        later = [x for x in after if "loss" in x]
        if [x["round"] for x in later] != [2, 3, 4, 5] or not all(
                x["loss"] is not None and math.isfinite(x["loss"])
                and x.get("nonfinite") == 0 for x in later):
            fail(f"checkpoint: rounds after the rollback {later}")
        if not all(bool(torch.isfinite(t).all()) for lp in
                   roll.params.values() for t in lp.values()):
            fail("checkpoint: the final params after the rollback are not "
                 "finite")
        tags = {}
        for name in sorted(os.listdir(dir_c)):
            extra = json.load(open(os.path.join(
                dir_c, name, "meta.json"))).get("extra", {})
            tags[name] = {"anomalous": extra.get("anomalous", False),
                          "health": extra.get("health")}
        # the monitor clears its anomaly window when it rolls back, so
        # the steps written after the incident are not tagged
        if tags.get("step-4") != {"anomalous": False, "health": {
                "retry": 1, "lr_scale": health.lr_backoff,
                "rollbacks": 1}} or tags.get("step-6", {}).get("anomalous"):
            fail(f"checkpoint: step tags after the rollback {tags}")
        print(f"checkpoint: one rollback to step 2 (retry 1, lr_scale "
              f"{health.lr_backoff}); rounds 2-5 after it finite with "
              f"nonfinite 0; final params finite; steps {tags} [{card}]",
              flush=True)
        ckpt.retain(dir_c, keep=2)
    finally:
        ckpt.save, ckpt.restore_flat, ckpt.restore_newest_verified = \
            originals[:3]
        ParallelTrainer.checkpoint_tree = originals[3]
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            det
        precision.set_policy("float32")
        shutil.rmtree(root, ignore_errors=True)
    for t in timed:
        print(f"checkpoint: {t['what']}"
              + (f" step {t['step']}" if t["step"] is not None else "")
              + f": {t['s']:.3f}s"
              + (f", {t['bytes']} bytes" if t["bytes"] is not None else "")
              + f" (thread {t['thread']}) [{card}]", flush=True)
    return {"launches": {"uninterrupted": c1, "first half": c2a,
                         "resumed": c2b, "rollback": c3},
            "steps": steps_of, "timed": timed}


def _stats(xs) -> str:
    if not xs:
        return "n/a"
    return (f"median {statistics.median(xs):.3f} [min {min(xs):.3f}, max "
            f"{max(xs):.3f}]")


def write_corpus(data_dir: str, n_train: int = 2560, n_val: int = 256,
                 shards: int = 8, size: int = 256,
                 n_classes: int = 1000) -> None:
    """The ImageNet phases' corpus (module docstring, phase 6): JPEG tar
    shards of random pixels by `write_synthetic_shards` (PIL)."""
    from sparknet_tpu_torch.data.imagenet import write_synthetic_shards

    t0 = time.perf_counter()
    write_synthetic_shards(data_dir, n_shards=shards,
                           per_shard=n_train // shards,
                           n_classes=n_classes, size=size, seed=0)
    write_synthetic_shards(data_dir, n_shards=1, per_shard=n_val,
                           n_classes=n_classes, size=size, seed=1,
                           prefix="val")
    print(f"imagenet: corpus of {n_train} train JPEGs in {shards} "
          f"shards and {n_val} val JPEGs, {size}x{size}, written in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)


def phase_imagenet(card: str, data_dir: str, device: str = "cuda",
                   crop: int = 227, batch: int = 256, tau: int = 5,
                   n_classes: int = 1000, n_val: int = 256, pairs: int = 2,
                   rounds: int = 4) -> dict:
    """Full-width CaffeNet through the ImageNet app on the JPEG shards of
    `write_corpus` in `data_dir` (module docstring, phase 6); returns each
    run's launch counts and steps, and the cached mean image. The
    arguments let the phase be rehearsed on the CPU at a small size
    (counts then 0)."""
    import argparse
    import dataclasses
    import glob
    import shutil
    import tempfile

    import numpy as np
    import torch

    from sparknet_tpu_torch.apps import imagenet_app
    from sparknet_tpu_torch.apps.train_loop import (prepare_round_batches,
                                                    resolve_spec, train)
    from sparknet_tpu_torch.data.dataset import RoundSampler
    from sparknet_tpu_torch.parallel.trainer import ParallelTrainer

    kernels = device == "cuda"
    root = tempfile.mkdtemp(prefix="chip_smoke_imagenet_")
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    # the levers-on and levers-off runs must be bit-equal
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    launches, steps_of = {}, {}
    orig_round = ParallelTrainer.train_round
    try:
        common = [f"n_classes={n_classes}", f"crop={crop}",
                  f"local_batch={batch}", f"tau={tau}", "seed=0"]
        dev_args = ["--device", "cpu"] if device == "cpu" else []

        # 1. the app's own main(): one warm-up round and one evaluation
        work = os.path.join(root, "main")
        _zero_counts()
        t0 = time.perf_counter()
        imagenet_app.main(["--data-dir", data_dir, *dev_args, *common,
                           f"workdir={work}", "max_rounds=1",
                           "eval_every=1"])
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts()
        (jsonl,) = glob.glob(os.path.join(work, "training_metrics_*.jsonl"))
        recs = [json.loads(line) for line in open(jsonl)]
        losses = [x for x in recs if "loss" in x]
        accs = [x for x in recs if "test_accuracy" in x]
        print(f"imagenet[main]: {len(losses)} round in {wall:.2f}s wall "
              f"(decode, mean and set-up included): loss "
              f"{[x['loss'] for x in losses]}, test accuracy "
              f"{[x['test_accuracy'] for x in accs]}, launches {counts} "
              f"[{card}]", flush=True)
        if len(losses) != 1 or not all(
                x["loss"] is not None and math.isfinite(x["loss"])
                and x.get("nonfinite") == 0 for x in losses):
            fail(f"imagenet[main]: round records {losses}")
        if len(accs) != 1:
            fail(f"imagenet[main]: no eval accuracy line in {recs}")
        evals = -(-n_val // min(1000, n_val))  # eval_batch 1000
        launches["main"], steps_of["main"] = counts, tau
        if kernels:
            _expect_counts("imagenet main", counts, {
                "lrn_fwd": 2 * tau + 2 * evals, "lrn_fwd_scale": 0,
                "lrn_bwd": 2 * tau, "maxpool_bwd": 3 * tau})

        # 2. the same prepared data through the same train(): levers on
        # (the defaults, the round-prep thread) and off (the synchronous
        # loop) in alternating pairs
        p = argparse.ArgumentParser()
        imagenet_app.add_data_args(p)
        args = p.parse_args(["--data-dir", data_dir])
        cfg = imagenet_app.default_config().with_overrides(
            *common, f"data_dir={data_dir}", f"max_rounds={rounds}",
            "eval_every=0", "log_every=1", "telemetry=true")
        train_ds, test_ds, pp_train, _, info = imagenet_app.prepare_data(
            cfg, args)
        print(f"imagenet: decode {info['decode_s']:.3f}s, mean image "
              f"{info['mean_s']:.3f}s for {len(train_ds)} images; "
              f"preprocessing route {info['route']} [{card}]", flush=True)
        spec = resolve_spec(cfg, data=(batch, 3, crop, crop),
                            label=(batch, 1))
        want = prepare_round_batches(
            RoundSampler(train_ds, 1, batch, tau, seed=cfg.seed), 0, tau,
            cfg.seed, pp_train, torch.bfloat16)
        settings = {
            "on": (dict(h2d_prefetch=True, donate_batches=True,
                        collect_async=True), True),
            "off": (dict(h2d_prefetch=False, donate_batches=False,
                         collect_async=False), False)}
        first = []

        def capture(self, state, batches, rng, lr_scale=1.0):
            out = orig_round(self, state, batches, rng, lr_scale)
            if not first:
                # synchronous copies: the round's slot is not reused yet
                first.append({k: (v.cpu() if isinstance(v, torch.Tensor)
                                  else torch.from_numpy(np.asarray(v)))
                              for k, v in batches.items()})
            return out

        ParallelTrainer.train_round = capture
        ref = None
        order = [("on", "off") if i % 2 == 0 else ("off", "on")
                 for i in range(pairs)]
        for i, (a, b) in enumerate(order):
            for name in (a, b):
                levers, prefetch = settings[name]
                label = f"{name} {i}"
                run_cfg = dataclasses.replace(
                    cfg, workdir=os.path.join(root, label.replace(" ", "_")),
                    **levers)
                log = _capture_logger()
                first.clear()
                if device == "cuda":
                    torch.cuda.synchronize()
                _zero_counts()
                t0 = time.perf_counter()
                state = train(run_cfg, spec, train_ds, None, logger=log,
                              batch_transform=pp_train, device=device,
                              prefetch=prefetch)
                if device == "cuda":
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = _read_counts()
                launches[label], steps_of[label] = counts, rounds * tau
                recs = [x for x in log.records if "loss" in x]
                if len(recs) != rounds or not all(
                        x["loss"] is not None and math.isfinite(x["loss"])
                        and x.get("nonfinite") == 0 for x in recs):
                    fail(f"imagenet[{label}]: round records {recs}")
                for x in recs:
                    print(f"imagenet[{label}]: round {x['round']} loss "
                          f"{x['loss']:.6f} round_s {x['round_s']:.4f} "
                          f"data {x['t_data_ms']:.2f} h2d "
                          f"{x['t_h2d_ms']:.2f} round {x['t_round_ms']:.2f} "
                          f"collect {x['t_collect_ms']:.2f} collect_bg "
                          f"{x.get('t_collect_bg_ms', 0.0):.2f} prep "
                          f"{x['t_prep_ms']:.2f} ms; h2d_bytes "
                          f"{int(x['h2d_bytes'])} [{card}]", flush=True)
                warm = recs[1:]
                ms = {k: [x[k] for x in warm if k in x] for k in (
                    "t_data_ms", "t_h2d_ms", "t_round_ms", "t_collect_ms",
                    "t_collect_bg_ms", "t_prep_ms")}
                rs = [x["round_s"] for x in warm]
                # what a round costs the loop: its own time and the wait
                # for round prep before it
                period = [x["round_s"] + x["t_data_ms"] / 1e3 for x in warm]
                print(f"imagenet[{label}]: levers {levers} prep thread "
                      f"{'on' if prefetch else 'off'}; {rounds} rounds in "
                      f"{wall:.2f}s wall; warm rounds: round_s "
                      f"{_stats(rs)}, "
                      + ", ".join(f"{k} {_stats(v)}" for k, v in ms.items())
                      + f"; {tau * batch / statistics.median(rs):.1f} img/s "
                      f"a round, {tau * batch / statistics.median(period):.1f}"
                      f" img/s a round and its data wait (median); route "
                      f"{info['route']}; launches "
                      f"{counts} [{card}]", flush=True)
                if kernels:
                    steps = rounds * tau
                    _expect_counts(f"imagenet {label}", counts, {
                        "lrn_fwd": 2 * steps, "lrn_fwd_scale": 0,
                        "lrn_bwd": 2 * steps, "maxpool_bwd": 3 * steps})
                got = first[0]
                bad = [k for k in want if not torch.equal(
                    got[k].reshape(-1), torch.as_tensor(
                        np.asarray(want[k]) if not isinstance(
                            want[k], torch.Tensor) else want[k]).reshape(-1))
                    or tuple(got[k].shape) != tuple(want[k].shape)]
                if bad:
                    fail(f"imagenet[{label}]: the first round's {bad} "
                         f"differ from prepare_round_batches on the host")
                mine = ([x["loss"] for x in recs],
                        state.flat_params.detach().clone())
                if ref is None:
                    ref = mine
                elif mine[0] != ref[0] or not torch.equal(mine[1], ref[1]):
                    fail(f"imagenet[{label}]: losses {mine[0]} or final "
                         f"params differ from the first run's {ref[0]}")
                del state
        print(f"imagenet: every run's losses and final flat params are "
              f"equal (torch.equal), and each run's first round equals "
              f"prepare_round_batches on the host [{card}]", flush=True)
    finally:
        ParallelTrainer.train_round = orig_round
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            det
        shutil.rmtree(root, ignore_errors=True)
    return {"launches": launches, "steps": steps_of,
            "mean": pp_train.mean_image}


def _ulps(a, b) -> int:
    """The largest distance in float32 ulps between two float32 arrays of
    one sign (pixel means are positive)."""
    import numpy as np
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


def _rss_mib() -> float:
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def _as_tensor(v):
    import numpy as np
    import torch
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.asarray(v))


def phase_stream(card: str, data_dir: str, cached_mean=None,
                 device: str = "cuda", crop: int = 227, batch: int = 256,
                 tau: int = 5, n_classes: int = 1000, n_val: int = 256,
                 rounds: int = 6, resume_at: int = 4,
                 bucket_rounds: int = 2) -> dict:
    """Full-width CaffeNet through the ImageNet app's streaming ingest on
    phase 6's corpus (module docstring, phase 7); returns each run's
    launch counts and steps. The arguments let the phase be rehearsed on
    the CPU at a small size (counts then 0)."""
    import argparse
    import dataclasses
    import glob
    import shutil
    import tempfile

    import numpy as np
    import torch

    from sparknet_tpu_torch.apps import imagenet_app
    from sparknet_tpu_torch.apps.train_loop import (prepare_round_batches,
                                                    resolve_spec, train)
    from sparknet_tpu_torch.data import imagenet
    from sparknet_tpu_torch.data.streaming import StreamingRoundSource
    from sparknet_tpu_torch.parallel.trainer import ParallelTrainer
    from sparknet_tpu_torch.utils import checkpoint as ckpt

    kernels = device == "cuda"
    root = tempfile.mkdtemp(prefix="chip_smoke_stream_")
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    # the resumed run must be bit-equal to the uninterrupted one
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    launches, steps_of = {}, {}
    orig_round = ParallelTrainer.train_round
    common = [f"n_classes={n_classes}", f"crop={crop}",
              f"local_batch={batch}", f"tau={tau}", "seed=0"]
    per_round = tau * batch
    n_train = len(imagenet.ShardedTarLoader(
        imagenet.list_shards(data_dir, "train."),
        imagenet.load_label_map(os.path.join(data_dir, "train.txt")))
        .label_map)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def round_lines(label, recs, decode=None):
        for i, x in enumerate(recs):
            period = x["round_s"] + x["t_data_ms"] / 1e3
            dec = (f" decode {decode[i]:.3f}s on the streaming thread"
                   if decode and i < len(decode) else "")
            print(f"stream[{label}]: round {x['round']} loss "
                  f"{x['loss']:.6f} round_s {x['round_s']:.4f} t_data_ms "
                  f"{x['t_data_ms']:.2f} t_prep_ms {x['t_prep_ms']:.2f} "
                  f"{per_round / period:.1f} img/s with the data wait"
                  f"{dec} [{card}]", flush=True)
        bad = [x for x in recs if x["loss"] is None
               or not math.isfinite(x["loss"]) or x.get("nonfinite") != 0]
        if bad:
            fail(f"stream[{label}]: round records {bad}")

    try:
        dev_args = ["--device", "cpu"] if device == "cpu" else []
        # 1. the app's own main(), streaming: one round and one evaluation
        work, ck_main = os.path.join(root, "main"), os.path.join(root, "ckm")
        _zero_counts()
        t0 = time.perf_counter()
        imagenet_app.main(["--data-dir", data_dir, "--stream", "always",
                           *dev_args, *common, f"workdir={work}",
                           "max_rounds=1", "eval_every=1",
                           f"checkpoint_dir={ck_main}", "checkpoint_every=0"])
        sync()
        wall = time.perf_counter() - t0
        counts = _read_counts()
        (jsonl,) = glob.glob(os.path.join(work, "training_metrics_*.jsonl"))
        recs = [json.loads(line) for line in open(jsonl)]
        losses = [dict(x, round=x["step"]) for x in recs if "loss" in x]
        accs = [x for x in recs if "test_accuracy" in x]
        round_lines("main", losses)
        with np.load(os.path.join(ck_main, "mean_image.npz")) as z:
            mean = z["mean"]
        ulps = _ulps(mean, cached_mean) if cached_mean is not None else None
        print(f"stream[main]: {len(losses)} round in {wall:.2f}s wall "
              f"(the streamed mean pass and set-up included), test accuracy "
              f"{[x['test_accuracy'] for x in accs]}, launches {counts}; "
              f"streamed mean image vs phase 6's cached mean: {ulps} "
              f"float32 ulp at most; peak RSS {_rss_mib():.0f} MiB (the "
              f"process so far) [{card}]", flush=True)
        if len(losses) != 1 or len(accs) != 1:
            fail(f"stream[main]: records {recs}")
        if ulps is not None and ulps > 1:
            fail(f"stream[main]: the streamed mean image is {ulps} ulp from "
                 f"the cached one (limit 1)")
        evals = -(-n_val // min(1000, n_val))  # eval_batch 1000
        launches["main"], steps_of["main"] = counts, tau
        if kernels:
            _expect_counts("stream main", counts, {
                "lrn_fwd": 2 * tau + 2 * evals, "lrn_fwd_scale": 0,
                "lrn_bwd": 2 * tau, "maxpool_bwd": 3 * tau})
        shutil.rmtree(os.path.join(ck_main, "step-1"), ignore_errors=True)

        # 2. resume through the stream cursor
        p = argparse.ArgumentParser()
        imagenet_app.add_data_args(p)
        args = p.parse_args(["--data-dir", data_dir, "--stream", "always"])
        cfg = imagenet_app.default_config().with_overrides(
            *common, f"data_dir={data_dir}", "eval_every=0", "log_every=1",
            "telemetry=true", "checkpoint_every=2")
        spec = resolve_spec(cfg, data=(batch, 3, crop, crop),
                            label=(batch, 1))
        first = []

        def stream_run(label, max_rounds, ckdir=None, ingest=2):
            if ckdir:  # the mean sidecar: no second corpus pass
                os.makedirs(ckdir, exist_ok=True)
                shutil.copy(os.path.join(ck_main, "mean_image.npz"), ckdir)
            run_cfg = dataclasses.replace(
                cfg, workdir=os.path.join(root, label),
                max_rounds=max_rounds, checkpoint_dir=ckdir,
                ingest_sources=ingest)
            src, _, pp, _, _ = imagenet_app.prepare_data(run_cfg, args)
            loaders = getattr(src, "loaders", None) or [src.loader]
            dec_at = []

            def capture(self, state, batches, rng, lr_scale=1.0):
                dec_at.append(sum(ld.decode_s for ld in loaders))
                out = orig_round(self, state, batches, rng, lr_scale)
                if not first:
                    first.append({k: _as_tensor(v).cpu()
                                  for k, v in batches.items()})
                return out

            ParallelTrainer.train_round = capture
            log = _capture_logger()
            first.clear()
            sync()
            _zero_counts()
            t0 = time.perf_counter()
            try:
                state = train(run_cfg, spec, src, None, logger=log,
                              batch_transform=pp, device=device)
            finally:
                ParallelTrainer.train_round = orig_round
                src.close()
            sync()
            wall = time.perf_counter() - t0
            counts = _read_counts()
            recs = [x for x in log.records if "loss" in x]
            decode = [b - a for a, b in zip([0.0] + dec_at, dec_at)]
            round_lines(label, recs, decode)
            n_steps = len(recs) * tau
            launches[label], steps_of[label] = counts, n_steps
            print(f"stream[{label}]: {len(recs)} rounds in {wall:.2f}s wall, "
                  f"{len(loaders)} reader(s), decode "
                  f"{sum(ld.decode_s for ld in loaders):.2f}s in all on the "
                  f"streaming thread(s), launches {counts}; peak RSS "
                  f"{_rss_mib():.0f} MiB [{card}]", flush=True)
            if kernels:
                _expect_counts(f"stream {label}", counts, {
                    "lrn_fwd": 2 * n_steps, "lrn_fwd_scale": 0,
                    "lrn_bwd": 2 * n_steps, "maxpool_bwd": 3 * n_steps})
            return state, recs, pp

        ck_full, ck_part = (os.path.join(root, "ck_full"),
                            os.path.join(root, "ck_part"))
        full, full_recs, _ = stream_run("full", rounds, ck_full)
        got = first[0]  # the first round as train_round received it
        _, part_recs, _ = stream_run("part", resume_at, ck_part)
        resumed, res_recs, _ = stream_run("resumed", rounds, ck_part)
        for name, d in (("full", ck_full), ("part", ck_part)):
            for step in ckpt._list_steps(d):
                extra = ckpt.restore_flat(d, step=step)[2]
                print(f"stream[{name}]: step {step} stream cursor "
                      f"{extra.get('stream')} [{card}]", flush=True)
        # the cursor after round resume_at's data, per reader (shards
        # j::2): whole passes over its shards and the entry of the last
        # image it took
        readers = 2
        seen = resume_at * per_round // readers
        ep, rem = divmod(seen - 1, n_train // readers)
        per_shard = n_train // len(imagenet.list_shards(data_dir, "train."))
        want_rows = [[[rem // per_shard, rem % per_shard + 1, ep]]
                     * readers]
        got_rows = ckpt.restore_flat(ck_part, step=resume_at)[2]["stream"]
        full_rows = ckpt.restore_flat(ck_full, step=resume_at)[2]["stream"]
        if not got_rows == full_rows == want_rows:
            fail(f"stream: step {resume_at} cursor {got_rows} (uninterrupted "
                 f"{full_rows}), want the cursor after round {resume_at}'s "
                 f"data {want_rows}")
        same = (torch.equal(resumed.flat_params, full.flat_params)
                and torch.equal(resumed.flat_momentum, full.flat_momentum)
                and [x["loss"] for x in res_recs]
                == [x["loss"] for x in full_recs][resume_at:])
        if not same:
            fail("stream: the resumed run's params, momentum or losses "
                 "differ from the uninterrupted run's")
        print(f"stream: the run resumed at step {resume_at} equals the "
              f"uninterrupted one (torch.equal, params and momentum; equal "
              f"losses); step {resume_at}'s cursor {got_rows} is the one "
              f"after round {resume_at}'s data [{card}]", flush=True)

        # 3. two readers (the runs above): the first round as train_round
        # received it, against the host's prepare_round_batches
        cfg2 = dataclasses.replace(cfg, ingest_sources=2,
                                   checkpoint_dir=ck_full)
        src2, _, pp2, _, _ = imagenet_app.prepare_data(cfg2, args)
        with src2:
            want = prepare_round_batches(src2, 0, tau, cfg.seed, pp2,
                                         torch.bfloat16)
        bad = [k for k in want if not torch.equal(
            got[k].reshape(-1), _as_tensor(want[k]).reshape(-1))
            or tuple(got[k].shape) != tuple(want[k].shape)]
        if bad or len(src2.loaders) != 2:
            fail(f"stream[full]: the first round's {bad} differ from "
                 f"prepare_round_batches on the host ({len(src2.loaders)} "
                 f"readers)")
        print(f"stream[full]: 2 readers; the first round on the card "
              f"equals prepare_round_batches on the host [{card}]",
              flush=True)

        # 4. the same shards from a gs:// bucket (the fake GCS of
        # tests/fake_stores.py on localhost) and a checkpoint there
        sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tests"))
        from fake_stores import serve_dir_for_ingest, stop_serving
        t0 = time.perf_counter()
        srv, url = serve_dir_for_ingest(data_dir)
        try:
            labels = imagenet.load_label_map(f"{url}/train.txt")

            def source(where):
                return StreamingRoundSource(imagenet.ShardedTarLoader(
                    imagenet.list_shards(where, "train."), labels), 1,
                    batch, tau)

            with source(url) as g, source(data_dir) as l:
                for r in range(bucket_rounds):
                    gr, lr = (g.next_round(round_index=r),
                              l.next_round(round_index=r))
                    if not (all(np.array_equal(gr[k], lr[k]) for k in lr)
                            and g.cursor_at(r) == l.cursor_at(r)):
                        fail(f"stream[gs]: round {r} over gs:// differs "
                             f"from the local stream's")
            read_s = time.perf_counter() - t0
            flat, step, extra = ckpt.restore_flat(ck_full)
            t0 = time.perf_counter()
            ckpt.save("gs://bkt/ck", flat, step=step, extra=extra)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            gflat, gstep, gextra = ckpt.restore_flat("gs://bkt/ck")
            load_s = time.perf_counter() - t0
            diff = [k for k in flat if not torch.equal(
                _as_tensor(flat[k]), _as_tensor(gflat[k]))]
            if gstep != step or diff or sorted(gflat) != sorted(flat) or \
                    gextra.get("stream") != extra.get("stream"):
                fail(f"stream[gs]: the bucket step differs: {diff[:5]}")
            print(f"stream[gs]: {bucket_rounds} rounds over gs:// equal the "
                  f"local stream's bit for bit ({read_s:.2f}s with the "
                  f"server's start); step {step} saved to gs:// in "
                  f"{save_s:.2f}s, restored in {load_s:.2f}s, every tensor "
                  f"equal to the local step's; peak RSS {_rss_mib():.0f} MiB "
                  f"[{card}]", flush=True)
        finally:
            stop_serving(srv)
    finally:
        ParallelTrainer.train_round = orig_round
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            det
        shutil.rmtree(root, ignore_errors=True)
    return {"launches": launches, "steps": steps_of}

#: the heartbeat schema both packages write (`utils/heartbeat.py`): every
#: beat's own keys, the elastic loop's, and the pod heartbeat's
HEARTBEAT_KEYS = {"t", "pid", "role", "step", "status", "rollbacks"}
ELASTIC_BEAT_KEYS = {"membership_epoch", "n_members"}
POD_BEAT_KEYS = {"worker", "n_workers", "round_s", "data_wait_s"}


def phase_elastic(card: str, phase4_round_s=None, device: str = "cuda",
                  crop: int = 227, batch: int = 256, tau: int = 5,
                  n_classes: int = 1000, kill_after: int = 3) -> dict:
    """A watched elastic run and the 4 -> 1 resume of full-width CaffeNet
    (module docstring, phase 8); returns each run's launch counts and
    executed steps. The arguments let the phase be rehearsed on the CPU
    at a small size (counts then 0)."""
    import dataclasses
    import shutil
    import tempfile
    import threading
    import urllib.request

    import numpy as np
    import torch

    from sparknet_tpu_torch import zoo
    from sparknet_tpu_torch.apps.train_loop import train
    from sparknet_tpu_torch.data.dataset import ArrayDataset
    from sparknet_tpu_torch.model.net import CompiledNet, params_from_jax
    from sparknet_tpu_torch.obs.pod import worker_heartbeat_path
    from sparknet_tpu_torch.obs.registry import MetricsRegistry
    from sparknet_tpu_torch.parallel.elastic import ElasticRelaunch
    from sparknet_tpu_torch.parallel.trainer import (ParallelTrainer,
                                                     reduce_momentum_rows)
    from sparknet_tpu_torch.solver import SolverConfig
    from sparknet_tpu_torch.utils import checkpoint as ckpt
    from sparknet_tpu_torch.utils.config import ElasticConfig, RunConfig
    from sparknet_tpu_torch.utils.heartbeat import HeartbeatWriter

    r = np.random.default_rng(8)
    n = tau * batch
    data = r.integers(-128, 128, (n, crop, crop, 3), dtype=np.int8)
    labels = r.integers(0, n_classes, (n, 1)).astype(np.int32)
    train_ds = ArrayDataset({"data": data, "label": labels})
    spec = zoo.caffenet(batch=batch, crop=crop, n_classes=n_classes)
    kernels = device == "cuda"
    root = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    pod_dir = os.path.join(root, "pod")
    ck_a, ck_b = os.path.join(root, "ck_watched"), os.path.join(root, "ck4")
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    originals = (ckpt.save, ckpt.restore_flat, HeartbeatWriter.beat,
                 ParallelTrainer.train_round,
                 ParallelTrainer.state_from_checkpoint,
                 MetricsRegistry.render_prometheus)
    saves, beats, budgets, restored, renders = [], [], [], [], []
    lock = threading.Lock()

    def save(directory, tree, *, step, extra=None):
        t0 = time.perf_counter()
        path = originals[0](directory, tree, step=step, extra=extra)
        with lock:
            saves.append({"step": step, "s": time.perf_counter() - t0,
                          "bytes": _dir_bytes(path), "dir": directory,
                          "thread": threading.current_thread().name})
        return path

    def beat(self, step, *a, **kw):
        t0 = time.perf_counter()
        wrote = originals[2](self, step, *a, **kw)
        with lock:
            beats.append({"step": step, "s": time.perf_counter() - t0,
                          "path": self.path})
        return wrote

    def train_round(self, state, batches, rng, lr_scale=1.0,
                    tau_by_worker=None):
        budgets.append(None if tau_by_worker is None
                       else list(tau_by_worker))
        return originals[3](self, state, batches, rng, lr_scale=lr_scale,
                            tau_by_worker=tau_by_worker)

    def render_prometheus(self):
        t0 = time.perf_counter()
        text = originals[5](self)
        renders.append((time.perf_counter() - t0) * 1e3)
        return text

    def state_from_checkpoint(self, flat, *a, **kw):
        st = originals[4](self, flat, *a, **kw)
        restored.append({kind: {l: {p: t.detach().clone()
                                    for p, t in lp.items()}
                                for l, lp in getattr(st, kind).items()}
                         for kind in ("params", "momentum")})
        return st

    ckpt.save = save
    HeartbeatWriter.beat = beat
    ParallelTrainer.train_round = train_round
    ParallelTrainer.state_from_checkpoint = state_from_checkpoint
    MetricsRegistry.render_prometheus = render_prometheus

    #: the loop's own heartbeats (the nominal worker 1's are the smoke's)
    own_beats = {os.path.join(root, "hb.json"),
                 worker_heartbeat_path(pod_dir, 0)}

    def per_round_counts(label, log, counts_by_round):
        """Each round's launches against its executed steps."""
        rounds = [x for x in log.records if "loss" in x]
        out = []
        for x in rounds:
            rnd = x["round"]
            vec = budgets[rnd - rounds[0]["round"]]
            executed = tau if vec is None else vec[0]
            got = counts_by_round[rnd]
            mine = [b for b in beats if b["step"] == rnd
                    and b["path"] in own_beats]
            print(f"elastic[{label}]: round {rnd} loss {x['loss']:.6f} "
                  f"tau vector {vec} (executed {executed} steps) round_s "
                  f"{x['round_s'] * 1e3:.2f} ms t_round_ms "
                  f"{x.get('t_round_ms')} boundary: t_member_ms "
                  f"{x.get('t_member_ms')} + the loop's beats "
                  f"{sum(b['s'] for b in mine) * 1e3:.3f} ms "
                  f"({len(mine)} beats) launches {got} [{card}]",
                  flush=True)
            if not (math.isfinite(x["loss"]) and x.get("nonfinite") == 0):
                fail(f"elastic[{label}] round {rnd}: loss {x['loss']}, "
                     f"nonfinite {x.get('nonfinite')}")
            if kernels and got != {"lrn_fwd": 2 * executed,
                                   "lrn_fwd_scale": 0,
                                   "lrn_bwd": 2 * executed,
                                   "maxpool_bwd": 3 * executed}:
                fail(f"elastic[{label}] round {rnd}: launches {got} for "
                     f"{executed} executed steps")
            out.append({"round": rnd, "executed": executed,
                        "round_s": x["round_s"],
                        "member_ms": x.get("t_member_ms"),
                        "beat_ms": sum(b["s"] for b in mine) * 1e3})
        return rounds, out

    def counting_hook(counts_by_round, extra=None):
        last = [_read_counts()]

        def hook(rnd, state):
            now = _read_counts()
            counts_by_round[rnd] = {k: now[k] - last[0][k] for k in now}
            last[0] = now
            if extra is not None:
                extra(rnd, state)
        return hook

    try:
        base = RunConfig(model="caffenet", n_classes=n_classes, crop=crop,
                         solver=SolverConfig(**IMAGENET_SOLVER), tau=tau,
                         local_batch=batch, eval_every=0,
                         precision="bfloat16", seed=0, workdir=root,
                         heartbeat_every_s=0.0, pod_dir=pod_dir)
        elastic = ElasticConfig(enabled=True, expected_workers=2,
                                min_workers=1, tau_adapt=True,
                                poll_interval_s=0.0, reprobe_backoff_s=0.0,
                                dead_probes=2)
        # run "watched": a nominal worker 1 beats a small round_s (so
        # this rank is the slow one and gets a shorter τ) until
        # kill_after, then its beat is backdated
        hb1 = HeartbeatWriter(worker_heartbeat_path(pod_dir, 1),
                              interval_s=0.0)
        hb1.beat(0, status="ok", round_s=0.001, force=True)
        cfg = dataclasses.replace(
            base, max_rounds=kill_after + 8, status_port=0, pod_port=0,
            heartbeat_path=os.path.join(root, "hb.json"),
            checkpoint_dir=ck_a, checkpoint_every=2, elastic=elastic)
        scraped = {}

        def watch(rnd, state):
            if rnd < kill_after:
                hb1.beat(rnd, status="ok", round_s=0.001, force=True)
            elif rnd == kill_after:
                p = worker_heartbeat_path(pod_dir, 1)
                rec = json.load(open(p))
                rec["t"] = time.time() - 1e4
                json.dump(rec, open(p, "w"))
            if rnd == 2:
                host, port = cfg.status_address
                t0 = time.perf_counter()
                scraped["metrics"] = urllib.request.urlopen(
                    f"http://{host}:{port}/metrics", timeout=30
                ).read().decode()
                scraped["metrics_ms"] = (time.perf_counter() - t0) * 1e3
                scraped["render_ms"] = renders[-1]
                host, port = cfg.pod_address
                scraped["pod"] = json.loads(urllib.request.urlopen(
                    f"http://{host}:{port}/pod/status", timeout=30).read())

        log = _capture_logger()
        counts_a = {}
        _zero_counts()
        t0 = time.perf_counter()
        try:
            train(cfg, spec, train_ds, None, logger=log, device=device,
                  round_hook=counting_hook(counts_a, watch))
            fail("elastic[watched]: the run ended without a relaunch")
        except ElasticRelaunch as e:
            code, reason = e.code, e.reason
        wall = time.perf_counter() - t0
        rounds_a, table_a = per_round_counts("watched", log, counts_a)
        events = [x for x in log.records if x.get("event") == "resize"]
        boundary = kill_after + 3  # suspected, probed twice, evicted
        if code != 75 or len(events) != 1 or events[0]["dead"] != ["1"] \
                or events[0]["round"] != boundary:
            fail(f"elastic[watched]: exit code {code}, resize events "
                 f"{events}; want 75 and one eviction of worker 1 at round "
                 f"{boundary}")
        if [x["round"] for x in rounds_a] != list(range(boundary)):
            fail(f"elastic[watched]: rounds {[x['round'] for x in rounds_a]}")
        short = [x for x in table_a if x["executed"] < tau]
        if not short:
            fail(f"elastic[watched]: no round ran under a τ vector below "
                 f"{tau}: {budgets}")
        step_dir = os.path.join(ck_a, f"step-{boundary}")
        boundary_saves = [s for s in saves if s["dir"] == ck_a
                          and s["step"] == boundary
                          and s["thread"] == "MainThread"]
        if not (ckpt.verify(step_dir) and boundary_saves):
            fail(f"elastic[watched]: no verified boundary step {step_dir} "
                 f"written by the loop at the boundary ({saves})")
        families = {line.split()[2] for line in
                    scraped.get("metrics", "").splitlines()
                    if line.startswith("# TYPE ")}
        want_fams = {"sparknet_train_round", "sparknet_train_loss",
                     "sparknet_train_rounds_total",
                     "sparknet_train_round_seconds",
                     "sparknet_train_data_wait_seconds",
                     "sparknet_pod_membership_epoch", "sparknet_pod_members",
                     "sparknet_device_hbm_bytes_in_use",
                     "sparknet_heartbeat_beats_total",
                     "sparknet_build_info"}
        pod = scraped.get("pod", {})
        if not want_fams <= families or \
                [w["worker"] for w in pod.get("workers", [])] != ["0", "1"] \
                or pod.get("membership_epoch") != 0:
            fail(f"elastic[watched]: /metrics lacks "
                 f"{sorted(want_fams - families)} or /pod/status {pod}")
        hbm = [line for line in scraped["metrics"].splitlines()
               if line.startswith("sparknet_device_hbm_")]
        beats_on_disk = {
            "heartbeat_path": json.load(open(cfg.heartbeat_path)),
            "pod worker 0": json.load(open(worker_heartbeat_path(pod_dir,
                                                                 0)))}
        for name, rec in beats_on_disk.items():
            want = HEARTBEAT_KEYS | ELASTIC_BEAT_KEYS | (
                POD_BEAT_KEYS if name.startswith("pod") else set())
            if not want <= set(rec) or rec["status"] != "resize" or \
                    rec["membership_epoch"] != 1 or rec["step"] != boundary:
                fail(f"elastic[watched]: {name} heartbeat {rec}")
        print(f"elastic[watched]: exit code {code} at round {boundary} "
              f"({reason}); {len(rounds_a)} rounds in {wall:.2f}s wall, "
              f"{len(short)} under a shorter τ "
              f"({sorted({x['executed'] for x in short})} steps); "
              f"verified boundary step {boundary}; /metrics over HTTP "
              f"from the round hook {scraped['metrics_ms']:.2f} ms, of "
              f"which the registry's render "
              f"{scraped['render_ms']:.3f} ms ({len(families)} families; "
              f"{hbm}); /pod/status workers "
              f"{[(w['worker'], w['round_s']) for w in pod['workers']]} "
              f"epoch {pod['membership_epoch']}; heartbeats "
              f"{ {k: sorted(v) for k, v in beats_on_disk.items()} } "
              f"[{card}]", flush=True)
        warm = [x["round_s"] for x in table_a[1:]]
        print(f"elastic[watched]: round_s {_stats(warm)} s over "
              f"{len(warm)} rounds (τ vector rounds included) against "
              f"phase 4's {_stats(phase4_round_s or [])} s; the boundary "
              f"(poll + decision) t_member_ms "
              f"{_stats([x['member_ms'] for x in table_a[1:]])}, beats "
              f"{_stats([x['beat_ms'] for x in table_a[1:]])} ms a round "
              f"[{card}]", flush=True)

        # run "resume 4 -> 1": the boundary step rewritten as a 4-rank
        # replica step, momentum rows the run's times seeded factors
        flat, step, extra = originals[1](ck_a)
        net = CompiledNet.compile(spec)
        fr = np.random.default_rng(9)
        factors = fr.uniform(0.5, 1.5, 4).astype(np.float32)
        tree = {"params": {}, "momentum": {}, "it": np.full(
            (4,), int(np.asarray(flat["it"])[0]), np.int32)}
        expect = {"params": {}, "momentum": {}}
        for key, a in flat.items():
            if key == "it":
                continue
            kind, l, p = key.split("/")
            a = np.asarray(a)
            rows = (np.broadcast_to(a[:1], (4,) + a.shape[1:])
                    if kind == "params" else
                    np.stack([a[0] * f for f in factors]))
            tree[kind].setdefault(l, {})[p] = rows
            expect[kind].setdefault(l, {})[p] = (
                rows[0] if kind == "params"
                else reduce_momentum_rows(rows, "norm_rescale"))
        t0 = time.perf_counter()
        path4 = originals[0](ck_b, tree, step=step,
                             extra=dict(extra, n_devices=4))
        t_save4 = time.perf_counter() - t0
        bytes4 = _dir_bytes(path4)
        del tree, flat
        t0 = time.perf_counter()
        originals[1](ck_b)
        t_restore4 = time.perf_counter() - t0
        budgets.clear()
        restored.clear()
        log = _capture_logger()
        counts_b = {}
        _zero_counts()
        t0 = time.perf_counter()
        train(dataclasses.replace(base, max_rounds=step + 2,
                                  checkpoint_dir=ck_b, checkpoint_every=0,
                                  resume=True, elastic=elastic),
              spec, train_ds, None, logger=log, device=device,
              round_hook=counting_hook(counts_b))
        wall_b = time.perf_counter() - t0
        rounds_b, table_b = per_round_counts("resume 4->1", log, counts_b)
        resumed = [m for m in log.lines if "ELASTIC resume" in m]
        if not resumed or [x["round"] for x in rounds_b] != \
                [step, step + 1] or len(restored) != 1:
            fail(f"elastic[resume 4->1]: log {resumed}, rounds "
                 f"{[x['round'] for x in rounds_b]}, restores "
                 f"{len(restored)}")
        dev = torch.device(device)
        for kind in ("params", "momentum"):
            want = params_from_jax(net, expect[kind], dev)
            bad = [f"{l}/{p}" for l, lp in want.items() for p, w in lp.items()
                   if not torch.equal(restored[0][kind][l][p], w)]
            if bad:
                fail(f"elastic[resume 4->1]: restored {kind} differ from "
                     f"{'row 0' if kind == 'params' else 'reduce_momentum_rows(rows, norm_rescale)'}: {bad}")
        print(f"elastic[resume 4->1]: {resumed[0]}; restored params "
              f"torch.equal to the step's row 0, momentum torch.equal to "
              f"reduce_momentum_rows(4 rows, norm_rescale) (factors "
              f"{factors.tolist()}); the 4-row step {bytes4} bytes, saved "
              f"in {t_save4:.3f}s, restored in {t_restore4:.3f}s; "
              f"{len(rounds_b)} rounds in {wall_b:.2f}s wall [{card}]",
              flush=True)
        for s in saves:
            print(f"elastic: save step {s['step']} of "
                  f"{os.path.basename(s['dir'])} on {s['thread']}: "
                  f"{s['s']:.3f}s, {s['bytes']} bytes"
                  + (" (the boundary save)" if s in boundary_saves else "")
                  + f" [{card}]", flush=True)
    finally:
        ckpt.save = originals[0]
        HeartbeatWriter.beat = originals[2]
        ParallelTrainer.train_round = originals[3]
        ParallelTrainer.state_from_checkpoint = originals[4]
        MetricsRegistry.render_prometheus = originals[5]
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            det
        shutil.rmtree(root, ignore_errors=True)
    launches_a = {k: sum(c[k] for c in counts_a.values())
                  for k in _read_counts()}
    launches_b = {k: sum(c[k] for c in counts_b.values())
                  for k in _read_counts()}
    return {"launches": {"watched": launches_a, "resume 4->1": launches_b},
            "steps": {"watched": sum(x["executed"] for x in table_a),
                      "resume 4->1": sum(x["executed"] for x in table_b)},
            "rounds": {"watched": table_a, "resume 4->1": table_b},
            "boundary_save_s": boundary_saves[0]["s"],
            "boundary_save_bytes": boundary_saves[0]["bytes"],
            "step4_bytes": bytes4, "step4_restore_s": t_restore4,
            "metrics_ms": scraped["metrics_ms"],
            "render_ms": scraped["render_ms"]}


def _quantiles_ms(xs) -> str:
    ys = sorted(xs)
    if not ys:
        return "p50 - ms, p99 - ms"
    return (f"p50 {ys[len(ys) // 2] * 1e3:.2f} ms, p99 "
            f"{ys[min(len(ys) - 1, int(0.99 * len(ys)))] * 1e3:.2f} ms")


def _forward_ms(net, batch, device: str, iters: int = 10):
    """(wall ms, device ms) of one bucket forward of `net`: wall is
    `TorchNet.forward` end to end (host->device copy, kernels, the blocking
    fetch of prob); device is CUDA events around the net's apply on inputs
    already on the card (None on the CPU). Medians over `iters` after one
    warm-up."""
    import torch
    net.forward(batch, ["prob"])
    walls = []
    for _ in range(iters):
        t0 = time.perf_counter()
        net.forward(batch, ["prob"])
        walls.append((time.perf_counter() - t0) * 1e3)
    if device != "cuda":
        return statistics.median(walls), None
    prepped = net._prep(batch)
    devs = []
    with torch.inference_mode():
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            net.net.apply(net.params, prepped, quant=net.quant)
            end.record()
            end.synchronize()
            devs.append(start.elapsed_time(end))
    return statistics.median(walls), statistics.median(devs)


#: a client process for phase 9: `clients` keep-alive threads, each
#: sending `n` npz requests through http_infer; prints one JSON line with
#: the wall seconds and every request's latency
_CLIENT_SRC = r"""
import json, sys, threading, time
import numpy as np
sys.path.insert(0, sys.argv[5])
from sparknet_tpu_torch.serve.http_frontend import http_infer
url, clients, n, crop = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
    int(sys.argv[4])
rng = np.random.default_rng(9)
payloads = [{"data": (50.0 * rng.standard_normal((crop, crop, 3))
                      ).astype(np.float32)} for _ in range(128)]
lat, errors = [], []

def client(c):
    for i in range(n):
        t0 = time.perf_counter()
        try:
            http_infer(url, "caffenet", payloads[(c * 17 + i) % 128],
                       deadline_s=120.0, timeout=180.0,
                       tenant=f"proc{c}")
        except Exception as e:
            errors.append(repr(e))
            return
        lat.append(time.perf_counter() - t0)

for warm in (True, False):
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if warm:
        lat.clear()
print(json.dumps({"wall": wall, "lat": lat, "errors": errors[:3]}))
"""


def _client_process(url: str, clients: int, n: int, crop: int) -> dict:
    """Run `_CLIENT_SRC` in a child process (its own interpreter lock);
    returns its JSON result."""
    root = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run([sys.executable, "-c", _CLIENT_SRC, url,
                        str(clients), str(n), str(crop), root],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        fail(f"serve http: the client process failed: {r.stderr[-2000:]}")
    res = json.loads(r.stdout.strip().splitlines()[-1])
    if res["errors"]:
        fail(f"serve http: the client process saw errors {res['errors']}")
    return res


def phase_serve_http(card: str, phase3_img_s=None, device: str = "cuda",
                     crop: int = 227, clients: int = 8,
                     per_client: int = 64) -> dict:
    """Full-width CaffeNet served over HTTP by the port's replica, with a
    hot reload under traffic and the int8 lane (module docstring, phase
    9); returns the launch counts of both lanes. The arguments let the
    phase be rehearsed on the CPU at a small crop (counts then 0)."""
    import shutil
    import tempfile
    import threading
    import urllib.request

    import numpy as np
    import torch

    from sparknet_tpu_torch import precision, zoo
    from sparknet_tpu_torch.model.net import params_to_jax
    from sparknet_tpu_torch.model.quant import QuantConfig, is_quantized
    from sparknet_tpu_torch.net_api import TorchNet
    from sparknet_tpu_torch.obs import reqtrace
    from sparknet_tpu_torch.ops.cuda_lrn import lrn_fwd
    from sparknet_tpu_torch.serve.admission import TenantAdmission
    from sparknet_tpu_torch.serve.http_frontend import (HttpFrontend,
                                                        http_infer)
    from sparknet_tpu_torch.serve.server import (InferenceServer,
                                                 ServeConfig, zeros_batch)
    from sparknet_tpu_torch.utils import checkpoint as ckpt
    from sparknet_tpu_torch.utils.heartbeat import read_heartbeat

    precision.set_policy("float32")
    # the steady traffic and the bucket-128 forwards are timed under
    # cuDNN's default settings, as phase 3 and the serve CLI run; from the
    # swap on, cuDNN's deterministic algorithms, so that a served answer
    # can be held to a direct forward bit for bit
    det = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
    spec = zoo.caffenet(batch=128, crop=crop, n_classes=1000)
    root = tempfile.mkdtemp(prefix="chip_smoke_serve_http_")
    ck = os.path.join(root, "ck")
    hb_path = os.path.join(root, "hb.json")
    rng = np.random.default_rng(9)
    payloads = [{"data": (50.0 * rng.standard_normal((crop, crop, 3))
                          ).astype(np.float32)} for _ in range(128)]
    fixed = {"data": (50.0 * np.random.default_rng(99).standard_normal(
        (crop, crop, 3))).astype(np.float32)}
    out: dict = {}

    def wait_for(cond, what: str, timeout: float = 120.0) -> float:
        t0 = time.perf_counter()
        while not cond():
            if time.perf_counter() - t0 > timeout:
                fail(f"serve http: {what} did not happen within "
                     f"{timeout:.0f} s")
            time.sleep(0.002)
        return time.perf_counter() - t0

    def traffic(url: str, n_each: int, stop=None, tag: str = ""):
        """`clients` keep-alive client threads through http_infer; each
        sends n_each requests (or until `stop` once it has). Returns per
        client [(latency s, step, status)] and the wall seconds."""
        results = [[] for _ in range(clients)]
        errors = []

        def client(c: int) -> None:
            i = 0
            while i < n_each or (stop is not None and not stop.is_set()):
                meta: dict = {}
                t0 = time.perf_counter()
                try:
                    r = http_infer(url, "caffenet",
                                   payloads[(c * 17 + i) % len(payloads)],
                                   deadline_s=120.0, timeout=180.0,
                                   tenant=f"client{c}", meta=meta)
                except Exception as e:  # every one must answer 200
                    errors.append(f"client {c} request {i}: {e!r}")
                    return
                dt = time.perf_counter() - t0
                prob = r["prob"]
                if prob.shape != (1000,) or not np.isfinite(prob).all():
                    errors.append(f"client {c} request {i}: prob "
                                  f"{prob.shape}")
                    return
                results[c].append((dt, meta.get("step"),
                                   meta.get("status")))
                i += 1

        threads = [threading.Thread(target=client, args=(c,),
                                    name=f"http-client-{c}")
                   for c in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            if t.is_alive():
                fail(f"serve http{tag}: a client thread hung")
        wall = time.perf_counter() - t0
        if errors:
            fail(f"serve http{tag}: {errors[:3]}")
        return results, wall

    # the weights a trainer would commit: seeds 1 and 2, in the JAX
    # package's layouts (its monolithic format), built before any traffic
    trees = {}
    for seed in (1, 2):
        src = TorchNet(spec, seed=seed, device="cpu")
        trees[seed] = {"params": params_to_jax(src.net, src.params)}
        del src

    def save_seed(directory: str, seed: int, step: int) -> str:
        return ckpt.save(directory, trees[seed], step=step)

    try:
        # -- the f32 lane -----------------------------------------------------
        net = TorchNet(spec, seed=0, device=device)
        cfg = ServeConfig(model_name="caffenet", max_batch=128,
                          buckets=SERVE_BUCKETS, outputs=("prob",),
                          max_wait_ms=5.0, checkpoint_dir=ck,
                          poll_interval_s=0.2, status_port=0,
                          heartbeat_path=hb_path, heartbeat_every_s=0.5,
                          metrics_every_batches=0)
        os.makedirs(ck)
        _zero_counts()
        server = InferenceServer(net, cfg).start()
        fe = HttpFrontend(server, port=0,
                          tenants=TenantAdmission(rate_rps=1e6, burst=1e6))
        url = f"http://{fe.address[0]}:{fe.address[1]}"
        try:
            # warm-up: every bucket's first forward, keep-alive set up
            traffic(url, 16, tag=" warm-up")
            server.reset_counters()
            # steady traffic, no swap
            steady, steady_s = traffic(url, per_client, tag=" steady")
            lat = [x[0] for rows in steady for x in rows]
            n_steady = len(lat)
            img_s = n_steady / steady_s
            st = server.status()
            print(f"serve http: steady, {clients} keep-alive clients x "
                  f"{per_client}: {n_steady} requests in {steady_s:.3f} s ="
                  f" {img_s:.1f} img/s; client-side {_quantiles_ms(lat)};"
                  f" server-side p50 {st['p50_ms']} ms, p99 {st['p99_ms']}"
                  f" ms; batch fill {st['batch_fill_ratio']}, batch sizes "
                  f"{st['batch_size_hist']}; phase 3 in process: "
                  + (f"{phase3_img_s:.1f}" if phase3_img_s else "-")
                  + f" img/s; both with cuDNN's default settings [{card}]",
                  flush=True)
            out["http_img_s"], out["n_steady"] = img_s, n_steady
            # the same steady traffic from a client process of its own:
            # the server's threads no longer share the interpreter lock
            # with the clients' encoding and decoding
            server.reset_counters()
            sub = _client_process(url, clients, per_client, crop)
            st = server.status()
            print(f"serve http: steady, the same {clients} x {per_client} "
                  f"from a client process: {len(sub['lat']) / sub['wall']:.1f}"
                  f" img/s; client-side {_quantiles_ms(sub['lat'])}; "
                  f"server-side p50 {st['p50_ms']} ms, p99 {st['p99_ms']} "
                  f"ms; batch sizes {st['batch_size_hist']} [{card}]",
                  flush=True)
            out["http_img_s_client_process"] = len(sub["lat"]) / sub["wall"]

            # where a request's time goes: request tracing on, every
            # request kept (head sample 1.0), in memory
            tr = reqtrace.start_request_tracing(head_sample=1.0)
            try:
                traffic(url, 16, tag=" traced")
            finally:
                reqtrace.stop_request_tracing()
            rows = [r for r in tr.drain_rows() if r["k"] == "r"]
            stages: dict = {}
            for r in rows:
                for k, v in r["stages"].items():
                    stages.setdefault(k, []).append(v)
            totals = [r["dur"] / 1e3 for r in rows]
            print(f"serve http: traced ({len(rows)} requests, server side,"
                  f" mean ms): total {statistics.mean(totals):.2f}; "
                  + ", ".join(f"{k} {statistics.mean(v):.3f}"
                              for k, v in sorted(stages.items()))
                  + f" [{card}]", flush=True)
            t0 = time.perf_counter()
            from sparknet_tpu_torch.serve.http_frontend import _encode_npz
            for p in payloads[:32]:
                _encode_npz(p)
            print(f"serve http: client npz encode {len(_encode_npz(fixed))}"
                  f" B in {(time.perf_counter() - t0) / 32 * 1e3:.3f} ms a "
                  f"request [{card}]", flush=True)

            # the swap under traffic: step 1 (seed 1) written mid-traffic
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
            stop = threading.Event()
            box: dict = {}

            def run_traffic():
                box["res"], box["wall"] = traffic(url, per_client, stop,
                                                  tag=" swap")

            before = server.requests_ok
            drv = threading.Thread(target=run_traffic, name="http-traffic")
            drv.start()
            wait_for(lambda: server.requests_ok >= before
                     + per_client * clients // 4, "mid-traffic point")
            t0 = time.perf_counter()
            save_seed(ck, 1, 1)
            save_s = time.perf_counter() - t0
            wait_for(lambda: server.manager.step == 1, "the step-1 install")
            m = server.manager
            commit_ts = float(json.load(open(os.path.join(
                ck, "step-1", "meta.json")))["commit_ts"])
            commit_to_install = m.install_ts - commit_ts
            fresh_at_install = m.freshness_s(now=m.install_ts)
            canary_ms = (m.last_canary_s or 0.0) * 1e3
            # step 2: one byte of its arrays flipped, staged outside the
            # watched dir, then published whole
            stage = os.path.join(root, "stage")
            path = save_seed(stage, 2, 2)
            npz = os.path.join(path, "state.npz")
            raw = bytearray(open(npz, "rb").read())
            raw[len(raw) // 2] ^= 0x01
            open(npz, "wb").write(bytes(raw))
            os.rename(path, os.path.join(ck, "step-2"))
            wait_for(lambda: m.swap_failures >= 1, "the step-2 rejection")
            stop.set()
            drv.join(timeout=600)
            if drv.is_alive() or "res" not in box:
                fail("serve http: the swap traffic did not finish")
            swap_rows = box["res"]
            n_swap = sum(len(r) for r in swap_rows)
            print(f"serve http: step 1 saved in {save_s:.3f} s; commit to "
                  f"install {commit_to_install:.3f} s, freshness_s at "
                  f"install {fresh_at_install}, the canary forward "
                  f"{canary_ms:.2f} ms; {n_swap} requests during the swap "
                  f"in {box['wall']:.3f} s [{card}]", flush=True)
            out.update(commit_to_install_s=commit_to_install,
                       canary_ms=canary_ms,
                       freshness_at_install_s=fresh_at_install)
            if m.step != 1 or "corrupt" not in (m.last_error or ""):
                fail(f"serve http: step 2 not rejected as corrupt (step "
                     f"{m.step}, last_error {m.last_error})")
            total = n_steady + n_swap + 32 * clients
            steps_seen = set()
            for c, rows_c in enumerate(swap_rows):
                steps = [s for _, s, _ in rows_c]
                if any(code != 200 for _, _, code in rows_c) or \
                        any(s is None for s in steps):
                    fail(f"serve http: client {c}: a response without 200 "
                         f"and a step")
                if any(b < a for a, b in zip(steps, steps[1:])):
                    fail(f"serve http: client {c}'s steps decreased: "
                         f"{steps}")
                steps_seen.update(steps)
            if total < 2 * clients * per_client or steps_seen != {-1, 1}:
                fail(f"serve http: {total} requests (want >= "
                     f"{2 * clients * per_client}), steps "
                     f"{sorted(steps_seen)} (want -1 then 1)")
            print(f"serve http: {total} requests over HTTP in all, every "
                  f"one 200 with a step; each client's steps never "
                  f"decrease (-1 = initial weights, then 1) [{card}]",
                  flush=True)
            # a fixed request after the swap vs the seed-1 net
            meta: dict = {}
            served = http_infer(url, "caffenet", fixed, deadline_s=60.0,
                                meta=meta)["prob"]
            if meta.get("step") != 1:
                fail(f"serve http: fixed request served by step "
                     f"{meta.get('step')}, want 1")
            launches = lrn_fwd.launches
            bf16 = lrn_fwd.bf16_launches
            traffic_forwards = len(server.batch_log)
            manager_forwards = m.forwards
            # the status surfaces
            host, port = server.status_address
            health = urllib.request.urlopen(
                f"http://{host}:{port}/healthz", timeout=30)
            fe_health = urllib.request.urlopen(f"{url}/healthz", timeout=30)
            text = urllib.request.urlopen(
                f"http://{host}:{port}/metrics", timeout=30).read().decode()
            hb = read_heartbeat(hb_path)
            swaps_rejected = server.registry.counter(
                "sparknet_serve_swaps_total",
                labels=("model", "outcome")).value(model="caffenet",
                                                   outcome="rejected")
            connections = fe.connections
            requests = fe.requests
        finally:
            fe.stop()
            server.stop()
        if health.status != 200 or fe_health.status != 200:
            fail(f"serve http: /healthz {health.status} (status server), "
                 f"{fe_health.status} (frontend)")
        for fam in ('sparknet_serve_http_requests_total{code="200",'
                    'transport="http"}',
                    'sparknet_serve_http_connections_total{transport="http"}',
                    'sparknet_serve_swaps_total{model="caffenet",'
                    'outcome="ok"} 1',
                    'sparknet_serve_swaps_total{model="caffenet",'
                    'outcome="rejected"} 1',
                    "sparknet_serve_model_freshness_seconds{",
                    "sparknet_serve_model_step{", "sparknet_build_info{",
                    'sparknet_serve_requests_total{model="caffenet",'
                    'outcome="ok"}'):
            if fam not in text:
                fail(f"serve http: /metrics lacks {fam}")
        if hb is None or not HEARTBEAT_KEYS <= set(hb) or \
                hb["role"] != "serve" or hb["rollbacks"] != 1 or \
                hb["step"] != 1 or swaps_rejected != 1:
            fail(f"serve http: heartbeat {hb}, swaps rejected "
                 f"{swaps_rejected} (want role serve, step 1, rollbacks 1)")
        print(f"serve http: /healthz 200 (status server and frontend); "
              f"/metrics has the serve, http (transport=\"http\"), swap and "
              f"freshness families; heartbeat step {hb['step']} rollbacks "
              f"{hb['rollbacks']}; {requests} requests on {connections} "
              f"connections [{card}]", flush=True)
        ref_net = TorchNet(spec, seed=1, device=device)
        # bucket 1 built as the server builds it (a padded host buffer:
        # a `x[None]` view has batch stride 0, which cuDNN runs by
        # another algorithm, close but not bit-equal)
        one = zeros_batch(ref_net, 1)
        one["data"][0] = fixed["data"]
        direct = ref_net.forward(one, ["prob"])["prob"][0]
        same_w = all(torch.equal(t, ref_net.params[l][p])
                     for l, lp in net.params.items() for p, t in lp.items())
        if not same_w or not torch.equal(torch.from_numpy(served),
                                         torch.from_numpy(direct)):
            again = ref_net.forward(one, ["prob"])["prob"][0]
            own = net.forward(one, ["prob"])["prob"][0]
            fail(f"serve http: the fixed request's prob differs from the "
                 f"seed-1 net's forward at bucket 1 (max abs err "
                 f"{np.abs(served - direct).max():.3e}; installed weights "
                 f"equal seed 1's: {same_w}; the seed-1 net again: "
                 f"{np.abs(again - direct).max():.3e}; the serving net "
                 f"on this thread: {np.abs(own - served).max():.3e})")
        print("serve http: after the swap, a fixed request's prob "
              "torch.equal to the seed-1 net's forward at bucket 1",
              flush=True)
        if device == "cuda" and (
                launches != 2 * (traffic_forwards + manager_forwards)
                or bf16 != 0):
            fail(f"serve http: lrn_fwd launched {launches} times ({bf16} "
                 f"bf16) over {traffic_forwards} traffic and "
                 f"{manager_forwards} canary forwards (want 2 per forward,"
                 f" f32)")
        print(f"serve http: f32 lane: lrn_fwd launches {launches} = 2 x "
              f"({traffic_forwards} traffic forwards + {manager_forwards} "
              f"canary forward) [{card}]", flush=True)
        out["launches"] = {"f32": launches}
        out["forwards"] = {"f32": traffic_forwards}
        f32_net = net

        # -- the int8 lane: the same step, quantized ------------------------
        shutil.rmtree(os.path.join(ck, "step-2"))
        qnet = TorchNet(spec, seed=0, device=device)
        qcfg = ServeConfig(model_name="caffenet", max_batch=128,
                           buckets=SERVE_BUCKETS, outputs=("prob",),
                           max_wait_ms=5.0, checkpoint_dir=ck,
                           poll_interval_s=0.2, quant="int8",
                           metrics_every_batches=0)
        _zero_counts()
        t0 = time.perf_counter()
        qserver = InferenceServer(qnet, qcfg).start()
        q_start_s = time.perf_counter() - t0
        qfe = HttpFrontend(qserver, port=0)
        qurl = f"http://{qfe.address[0]}:{qfe.address[1]}"
        try:
            qm = qserver.manager
            if qm.step != 1 or qm.last_parity_drift is None or \
                    not is_quantized(qnet.params):
                fail(f"serve http: the int8 lane did not install step 1 "
                     f"quantized (step {qm.step}, drift "
                     f"{qm.last_parity_drift})")
            qres, q_wall = traffic(qurl, 16, tag=" int8")
            q_lat = [x[0] for rows in qres for x in rows]
            qlaunches = lrn_fwd.launches
            qbf16 = lrn_fwd.bf16_launches
            q_forwards = len(qserver.batch_log)
            q_manager = qm.forwards
            q_ref = qm.reference_forwards
            # the same requests through both lanes, one at a time (bucket
            # 1 in both). Three holds on each answer of the int8 lane:
            # its prob within QuantConfig's gate of the f32 lane's (the
            # install canary's limit); its fc8 logits within
            # INT8_FC8_REL of the f32 lane's, relative to their largest
            # magnitude, where the seed-0 net's logits (the weights
            # before the swap) must fall outside that limit, so the hold
            # can fail; and prob and fc8 torch.equal to a direct forward
            # of the int8 net on a bfloat16 bucket-1 batch built as its
            # server builds it
            qc = QuantConfig()
            stale = TorchNet(spec, seed=0, device=device)
            worst = worst_fc8 = 0.0
            stale_fc8 = float("inf")
            for i, p in enumerate(payloads[:16]):
                one = zeros_batch(f32_net, 1)
                one["data"][0] = p["data"]
                fo = f32_net.forward(one, ["prob", "fc8"])
                a = {k: fo[k][0] for k in ("prob", "fc8")}
                s0 = stale.forward(one, ["fc8"])["fc8"][0]
                b = http_infer(qurl, "caffenet", p, deadline_s=60.0,
                               outputs=("prob", "fc8"))
                qone = zeros_batch(qnet, 1, bf16=True)
                qone["data"][0] = torch.from_numpy(p["data"])
                d = qnet.forward(qone, ["prob", "fc8"])
                mag = float(np.abs(a["fc8"]).max())
                worst = max(worst, float(np.abs(a["prob"] - b["prob"]).max()))
                worst_fc8 = max(worst_fc8, float(
                    np.abs(a["fc8"] - b["fc8"]).max()) / mag)
                stale_fc8 = min(stale_fc8, float(
                    np.abs(s0 - b["fc8"]).max()) / mag)
                if not np.allclose(b["prob"], a["prob"], rtol=qc.rtol,
                                   atol=qc.atol):
                    fail(f"serve http: int8 prob outside rtol {qc.rtol} / "
                         f"atol {qc.atol} of the f32 lane's ({worst:.3e})")
                if worst_fc8 > INT8_FC8_REL or stale_fc8 <= INT8_FC8_REL:
                    fail(f"serve http: request {i}: int8 fc8 vs the f32 "
                         f"lane's {worst_fc8:.4f} of its magnitude, the "
                         f"seed-0 net's {stale_fc8:.4f} (want <= and > "
                         f"{INT8_FC8_REL})")
                for k in ("prob", "fc8"):
                    if not torch.equal(torch.from_numpy(b[k]),
                                       torch.from_numpy(d[k][0])):
                        fail(f"serve http: request {i}: the int8 lane's "
                             f"{k} over HTTP differs from the int8 net's "
                             f"direct bucket-1 forward (max abs err "
                             f"{np.abs(b[k] - d[k][0]).max():.3e})")
            del stale
        finally:
            qfe.stop()
            qserver.stop()
        if device == "cuda" and (
                qlaunches != 2 * (q_forwards + q_manager)
                or qbf16 != 2 * (q_forwards + q_manager - q_ref)):
            fail(f"serve http: int8 lane lrn_fwd {qlaunches} launches, "
                 f"{qbf16} bf16, over {q_forwards} traffic, {q_manager} "
                 f"canary/parity forwards ({q_ref} f32 references)")
        print(f"serve http: int8 lane: step 1 installed quantized in "
              f"{q_start_s:.3f} s (parity drift {qm.last_parity_drift:.4f},"
              f" tol rtol {qc.rtol} atol {qc.atol}); {len(q_lat)} requests "
              f"in {q_wall:.3f} s, client-side {_quantiles_ms(q_lat)} "
              f"(deterministic cuDNN); "
              f"vs the f32 lane: prob max abs err {worst:.3e}, fc8 max "
              f"abs err {worst_fc8:.4f} of its magnitude (limit "
              f"{INT8_FC8_REL}; the seed-0 net's fc8 {stale_fc8:.4f}); "
              f"prob and fc8 torch.equal to the int8 net's direct "
              f"forward; lrn_fwd "
              f"{qlaunches} launches, {qbf16} bfloat16 = 2 x ({q_forwards} "
              f"traffic + {q_manager - q_ref} quantized canary/parity); "
              f"{2 * q_ref} f32 for the parity reference [{card}]",
              flush=True)
        out.update(int8_prob_err=worst, int8_fc8_rel=worst_fc8,
                   stale_fc8_rel=stale_fc8)
        out["launches"]["int8"] = qlaunches
        out["launches"]["int8_bf16"] = qbf16
        out["forwards"]["int8"] = q_forwards
        big = {"data": np.stack([p["data"] for p in payloads]),
               "label": np.zeros((128, 1), np.int32)}
        # the int8 lane's host batch as its server builds it: bfloat16
        qbig = zeros_batch(qnet, 128, bf16=True)
        qbig["data"][:] = torch.from_numpy(big["data"])
        # timed under cuDNN's default settings again
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            det
        f_wall, f_dev = _forward_ms(f32_net, big, device)
        q_wall_ms, q_dev = _forward_ms(qnet, qbig, device)
        fmt = (lambda v: "-" if v is None else f"{v:.3f}")
        print(f"serve http: bucket-128 forward (cuDNN defaults), wall / "
              f"device ms: f32 "
              f"{f_wall:.3f} / {fmt(f_dev)}, int8 {q_wall_ms:.3f} / "
              f"{fmt(q_dev)} [{card}]", flush=True)
        out.update(f32_forward_ms=(f_wall, f_dev),
                   int8_forward_ms=(q_wall_ms, q_dev))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            det
        shutil.rmtree(root, ignore_errors=True)
    return out


def profile_step(net, params, batch, solver_cfg, card: str,
                 top: int = 14) -> None:
    """One training step (forward, autograd, SGD update) at the main
    path's batch in bfloat16, traced: device kernels by name and the share
    of the step's wall time in which no kernel ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sparknet_tpu_torch.solver import SgdSolver, value_and_grad

    solver = SgdSolver(net, solver_cfg)
    state = solver.init_state(params)
    loss_fn = net.loss_fn()

    def step():
        _, g = value_and_grad(loss_fn, params, batch)
        solver.update(params, state, g)

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    rows = sorted((e for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA") and _dev_us(e) > 0),
                  key=_dev_us, reverse=True)
    kernels = sum(_dev_us(e) for e in rows) / 1e3
    print(f"profile: one training step, caffenet b{batch['data'].shape[0]}"
          f" bf16: wall {wall * 1e3:.2f} ms, device kernels {kernels:.2f} "
          f"ms, kernel idle share {max(0.0, 1 - kernels / (wall * 1e3)):.3f}"
          f" [{card}]", flush=True)
    for e in rows[:top]:
        print(f"profile:   {_dev_us(e) / 1e3:9.3f} ms  x{e.count:<4d} "
              f"{e.key[:90]}", flush=True)
    ours = [e for e in rows if any(k in e.key for k in (
        "lrn_fwd_kernel", "lrn_bwd_kernel", "maxpool_bwd_kernel"))]
    print(f"profile:   the port's kernels: "
          f"{sum(_dev_us(e) for e in ours) / 1e3:.3f} ms of {kernels:.2f} ms"
          f" ({', '.join(f'{e.key[:40]} x{e.count}' for e in ours)})",
          flush=True)


def _sum_rows(cases: dict, keys) -> dict:
    """The per-step sum of timed rows (`TIME_KEYS`, bound_ms) over
    `keys`."""
    out = {}
    for f in TIME_KEYS + ("bound_ms",):
        out[f] = 0.0
        for key in keys:
            out[f] = _add(out[f], cases[key][f])
    out["bound_by"] = ("bytes" if all(cases[key]["bound_by"] == "bytes"
                                      for key in keys) else "operations")
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA "
             "card")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "sparknet_tpu_torch")):
        fail(f"no sparknet_tpu_torch package beside {__file__}")
    sys.path.insert(0, root)
    from sparknet_tpu_torch.ops import _build

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all(["lrn_fwd", "lrn_bwd", "maxpool_bwd"])
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f}s",
          flush=True)
    for name, path in libs.items():
        log = path.with_suffix(".log")
        if log.exists():
            # per kernel instantiation: its registers, spills, stack
            for line in log.read_text().splitlines():
                if "Used" in line or "spill" in line:
                    print(f"build: {name}: {line.split(':', 1)[-1].strip()}",
                          flush=True)

    agg = phase_kernels(card)
    lrn_train = phase_lrn_train_kernels(card)
    pool = phase_pool_kernels(card)
    serve = phase_serve(card)
    train = phase_train(card)
    ckp = phase_checkpoint(card)
    import shutil
    import tempfile
    corpus = tempfile.mkdtemp(prefix="chip_smoke_corpus_")
    try:
        write_corpus(corpus)
        inet = phase_imagenet(card, corpus)
        stream = phase_stream(card, corpus, inet["mean"])
    finally:
        shutil.rmtree(corpus, ignore_errors=True)
    elastic = phase_elastic(card, train["warm_round_s"])
    http = phase_serve_http(card, serve["steady_img_s"])

    # the main training path's shapes: batch 256, bfloat16
    lc, pc = lrn_train["cases"], pool["cases"]
    fwd = _sum_rows(lc, [("fwd_y", l, 256, "bfloat16") for l in LRN_SHAPES])
    bwd = _sum_rows(lc, [("bwd_recompute", l, 256, "bfloat16")
                         for l in LRN_SHAPES])
    saved = {k: _sum_rows(lc, [(k, l, 100, "float32") for l in LRN_SHAPES])
             for k in ("fwd_scale", "bwd_saved")}
    mp = {kind: _sum_rows(pc, [(n, "bfloat16", kind) for n in TRAIN_POOLS])
          for kind in ("ties", "dense")}
    common = {"route": "cuda", "passed": True, "card": card,
              "timing": "ms, plain_ms, library_ms: CUDA events over "
                        "host-paced calls, launch overhead included; "
                        "device_ms: the kernel's calls queued behind a sleep "
                        "kernel, back to back on the card (null: not "
                        "measured); host_ms: the host's time to queue one "
                        "call there (the wrapper and the launch)"}
    print(json.dumps({"kernels": [
        {"name": "lrn_fwd",
         "source": "sparknet_tpu_torch/csrc/lrn_fwd.cu",
         "replaces": "sparknet_tpu/ops/pallas_lrn.py:51",
         "also_replaces": "sparknet_tpu/ops/pallas_lrn.py:206",
         "launches": train["launches"]["lrn_fwd"],
         "checkpoint_phase_launches": {
             k: c["lrn_fwd"] for k, c in ckp["launches"].items()},
         "imagenet_phase_launches": {
             k: c["lrn_fwd"] for k, c in inet["launches"].items()},
         "stream_phase_launches": {
             k: c["lrn_fwd"] for k, c in stream["launches"].items()},
         "elastic_phase_launches": {
             k: c["lrn_fwd"] for k, c in elastic["launches"].items()},
         "max_abs_err": max(agg["max_abs_err"], lrn_train["max_abs_err"]),
         **fwd, "timed_at": "norm1 + norm2, batch 256, bfloat16, y only "
                            "(the training step's forward)",
         "serve_launches": serve["launches"],
         "serve_http_phase_launches": http["launches"],
         "serve_http_phase_forwards": http["forwards"],
         "serve": {k: v for k, v in agg.items() if k.endswith("_ms")
                   or k == "ms"},
         "serve_timed_at": "norm1 + norm2, bucket 128, float32",
         "saved_scale_route_launches": train["saved_launches"][
             "lrn_fwd_scale"],
         "with_scale": saved["fwd_scale"],
         "with_scale_timed_at": "norm1 + norm2, batch 100, float32",
         **common},
        {"name": "lrn_bwd",
         "source": "sparknet_tpu_torch/csrc/lrn_bwd.cu",
         "replaces": "sparknet_tpu/ops/pallas_lrn.py:216",
         "also_replaces": "sparknet_tpu/ops/pallas_lrn.py:62",
         "launches": train["launches"]["lrn_bwd"],
         "checkpoint_phase_launches": {
             k: c["lrn_bwd"] for k, c in ckp["launches"].items()},
         "imagenet_phase_launches": {
             k: c["lrn_bwd"] for k, c in inet["launches"].items()},
         "stream_phase_launches": {
             k: c["lrn_bwd"] for k, c in stream["launches"].items()},
         "elastic_phase_launches": {
             k: c["lrn_bwd"] for k, c in elastic["launches"].items()},
         "max_abs_err": lrn_train["max_abs_err"], **bwd,
         "timed_at": "norm1 + norm2, batch 256, bfloat16, recompute mode",
         "saved_scale_route_launches": train["saved_launches"]["lrn_bwd"],
         "saved_mode": saved["bwd_saved"],
         "saved_mode_timed_at": "norm1 + norm2, batch 100, float32",
         **common},
        {"name": "maxpool_bwd",
         "source": "sparknet_tpu_torch/csrc/maxpool_bwd.cu",
         "replaces": "sparknet_tpu/ops/pallas_pool.py:61",
         "launches": train["launches"]["maxpool_bwd"],
         "checkpoint_phase_launches": {
             k: c["maxpool_bwd"] for k, c in ckp["launches"].items()},
         "imagenet_phase_launches": {
             k: c["maxpool_bwd"] for k, c in inet["launches"].items()},
         "stream_phase_launches": {
             k: c["maxpool_bwd"] for k, c in stream["launches"].items()},
         "elastic_phase_launches": {
             k: c["maxpool_bwd"] for k, c in elastic["launches"].items()},
         "max_abs_err": pool["max_abs_err"], **mp["ties"],
         "timed_at": "pool1 + pool2 + pool5, batch 256, bfloat16, "
                     "tie-heavy input",
         "dense": mp["dense"],
         "dense_timed_at": "the same, ReLU-of-Gaussian input",
         **common}],
        "train_steps": train["steps"],
        "checkpoint_phase_steps": ckp["steps"],
        "imagenet_phase_steps": inet["steps"],
        "stream_phase_steps": stream["steps"],
        "elastic_phase_steps": elastic["steps"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
