#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: does the port serve CaffeNet on the card?

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. Environment: the card's name and power limit (nvidia-smi), the torch and
   CUDA versions; then every CUDA kernel of the port is built from
   `sparknet_tpu_torch/csrc/` (one nvcc per source, all at once).
2. Kernel vs plain: `lrn_fwd` at CaffeNet's serve shapes (norm1 27x27x96,
   norm2 13x13x256, buckets 1, 8 and 128, float32 and bfloat16) against the
   plain PyTorch version on the same inputs. Tolerances: float32 within
   rtol 1e-5 / atol 1e-6; bfloat16 within one bf16 ulp of the plain version
   computed from the same bf16 input. Each case prints its max abs error
   and its times (CUDA events over many launches after warm-up, cycling
   through enough inputs to exceed the 50 MB L2): kernel, plain version,
   `F.local_response_norm` (the library yardstick, which the port never
   calls) and the bound (bytes over 3.35 TB/s vs operations over 67 TFLOP/s
   f32, whichever is larger).
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
4. The kernels line, `{"kernels": [...]}`, then the result line
   `{"ok": true, "device": {...}}` as the last line of standard output.

Exits non-zero without a result when no CUDA card is visible or when the
`sparknet_tpu_torch` package is not beside this script.
"""
from __future__ import annotations

import json
import math
import os
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


def bf16_ulp(y):
    """One bf16 ulp of each element of y (0 where y is 0)."""
    import torch
    yf = y.float()
    _, e = torch.frexp(yf)
    return torch.where(yf == 0, torch.zeros_like(yf),
                       torch.ldexp(torch.ones_like(yf), e - 8))


def phase_kernels(card: str) -> dict:
    """lrn_fwd vs its plain version at the serve shapes; returns the
    aggregate row of the kernels line."""
    import torch
    import torch.nn.functional as F

    from sparknet_tpu_torch.ops.cuda_lrn import lrn_fwd
    from sparknet_tpu_torch.ops.lrn import lrn_plain

    p = LRN_PARAMS
    gen = torch.Generator(device="cuda").manual_seed(0)
    agg = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "max_abs_err": 0.0, "max_abs_err_bf16": 0.0, "bound_by": "bytes"}
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
                err = (yk.float() - yp.float()).abs()
                max_err = float(err.max())
                if dtype == torch.float32:
                    ok = torch.allclose(yk, yp, rtol=1e-5, atol=1e-6)
                    tol = "rtol 1e-5 atol 1e-6"
                else:
                    ok = bool((err <= bf16_ulp(yp)).all())
                    tol = "1 bf16 ulp"
                kernel_ms = time_ms(lambda t: lrn_fwd(t, **p), xs)
                plain_ms = time_ms(lambda t: lrn_plain(t, **p), xs)
                library_ms = time_ms(
                    lambda t: F.local_response_norm(
                        t.permute(0, 3, 1, 2), p["local_size"],
                        alpha=p["alpha"], beta=p["beta"], k=p["k"]), xs)
                b = lrn_bound(n, h, w, c, itemsize, p["local_size"])
                dname = str(dtype).replace("torch.", "")
                print(f"lrn_fwd {layer} n={n} {dname} shape=({n},{h},{w},"
                      f"{c}) max_abs_err={max_err:.3e} tol=[{tol}] "
                      f"{'PASS' if ok else 'FAIL'} kernel_ms={kernel_ms:.5f}"
                      f" plain_ms={plain_ms:.5f} library_ms={library_ms:.5f}"
                      f" bound_ms={b['bound_ms']:.5f} ({b['bound_by']}, "
                      f"{b['bytes']} B) achieved_GBps="
                      f"{b['bytes'] / kernel_ms / 1e6:.1f} [{card}]",
                      flush=True)
                if not ok:
                    fail(f"lrn_fwd disagrees with the plain version at "
                         f"{layer} n={n} {dname}: max abs err {max_err}")
                if dtype == torch.float32:
                    agg["max_abs_err"] = max(agg["max_abs_err"], max_err)
                    if n == 128:  # one bucket-128 forward's LRN work
                        if b["bound_by"] != "bytes":
                            agg["bound_by"] = b["bound_by"]
                        agg["ms"] += kernel_ms
                        agg["plain_ms"] += plain_ms
                        agg["library_ms"] += library_ms
                        agg["bound_ms"] += b["bound_ms"]
                else:
                    agg["max_abs_err_bf16"] = max(agg["max_abs_err_bf16"],
                                                  max_err)
                del xs, yk, yp
    return agg


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

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only: a CPU op's self device time repeats the
    # time of the kernels it launched
    rows_ = sorted((e for e in prof.key_averages()
                    if str(e.device_type).endswith("CUDA") and dev_us(e) > 0),
                   key=dev_us, reverse=True)
    copies = sum(dev_us(e) for e in rows_
                 if e.key.startswith(("Memcpy", "Memset"))) / 1e3
    kernels = sum(dev_us(e) for e in rows_) / 1e3 - copies
    print(f"profile: bucket-128 batch: host stack {t_stack * 1e3:.2f} ms, "
          f"H2D copy {t_h2d * 1e3:.2f} ms ({stacked.nbytes} B), forward "
          f"wall {wall * 1e3:.2f} ms, device kernels {kernels:.2f} ms, "
          f"device copies {copies:.2f} ms, kernel idle share "
          f"{max(0.0, 1 - kernels / (wall * 1e3)):.3f} [{card}]",
          flush=True)
    for e in rows_[:top]:
        print(f"profile:   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<4d} "
              f"{e.key[:90]}", flush=True)


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
    libs = _build.build_all(["lrn_fwd"])
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f}s",
          flush=True)
    for name, path in libs.items():
        log = path.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "ptxas info" in line:
                    print(f"build: {name}: {line.strip()}", flush=True)

    agg = phase_kernels(card)
    serve = phase_serve(card)

    print(json.dumps({"kernels": [{
        "name": "lrn_fwd", "route": "cuda",
        "source": "sparknet_tpu_torch/csrc/lrn_fwd.cu",
        "replaces": "sparknet_tpu/ops/pallas_lrn.py:51",
        "also_replaces": "sparknet_tpu/ops/pallas_lrn.py:206",
        "launches": serve["launches"],
        "max_abs_err": agg["max_abs_err"],
        "max_abs_err_bf16": agg["max_abs_err_bf16"],
        "ms": agg["ms"], "plain_ms": agg["plain_ms"],
        "bound_ms": agg["bound_ms"], "bound_by": agg["bound_by"],
        "library_ms": agg["library_ms"],
        "timed_at": "norm1 + norm2, bucket 128, float32",
        "passed": True, "card": card}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
