#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: does the port serve and train
CaffeNet on the card?

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
5. The kernels line, `{"kernels": [...]}`, then the result line
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
    return {"launches": launches}


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
    lrn_fwd.launches = lrn_fwd.scale_launches = 0
    lrn_bwd.launches = maxpool_bwd.launches = 0


def _read_counts() -> dict:
    from sparknet_tpu_torch.ops.cuda_lrn import lrn_bwd, lrn_fwd
    from sparknet_tpu_torch.ops.cuda_pool import maxpool_bwd
    return {"lrn_fwd": lrn_fwd.launches,
            "lrn_fwd_scale": lrn_fwd.scale_launches,
            "lrn_bwd": lrn_bwd.launches, "maxpool_bwd": maxpool_bwd.launches}


def _train_run(card: str, cfg, spec, train_ds, test_ds, label: str,
               device: str) -> dict:
    """One `train()` call with its launch counts zeroed before and read
    after; returns the per-round records, counts, final state and peak
    device memory."""
    import torch

    from sparknet_tpu_torch.apps.train_loop import train
    from sparknet_tpu_torch.utils.logger import Logger

    class Capture(Logger):
        def __init__(self):
            super().__init__(echo=False)
            self.rounds = []

        def metrics(self, step, **kv):
            if "loss" in kv:
                self.rounds.append(dict(kv, round=step))

    log = Capture()
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
    for r in log.rounds:
        print(f"train[{label}]: round {r['round']} loss {r['loss']:.6f} "
              f"grad_norm {r.get('grad_norm')} nonfinite {r.get('nonfinite')}"
              f" round_s {r['round_s']:.4f} img/s {r['images_per_sec']:.1f} "
              f"[{card}]", flush=True)
    print(f"train[{label}]: {len(log.rounds)} rounds in {wall:.2f}s wall "
          f"(set-up included), launches {counts}, peak device memory "
          f"{peak:.2f} GiB [{card}]", flush=True)
    for r in log.rounds:
        vals = [r["loss"], r.get("grad_norm", 0.0)]
        if not all(math.isfinite(v) for v in vals) or r.get("nonfinite"):
            fail(f"train[{label}] round {r['round']}: loss {r['loss']}, "
                 f"grad_norm {r.get('grad_norm')}, nonfinite "
                 f"{r.get('nonfinite')}")
    if len(log.rounds) != cfg.max_rounds:
        fail(f"train[{label}]: {len(log.rounds)} rounds logged, want "
             f"{cfg.max_rounds}")
    return {"rounds": log.rounds, "counts": counts, "state": state,
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
         "max_abs_err": max(agg["max_abs_err"], lrn_train["max_abs_err"]),
         **fwd, "timed_at": "norm1 + norm2, batch 256, bfloat16, y only "
                            "(the training step's forward)",
         "serve_launches": serve["launches"],
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
         "max_abs_err": pool["max_abs_err"], **mp["ties"],
         "timed_at": "pool1 + pool2 + pool5, batch 256, bfloat16, "
                     "tie-heavy input",
         "dense": mp["dense"],
         "dense_timed_at": "the same, ReLU-of-Gaussian input",
         **common}],
        "train_steps": train["steps"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
