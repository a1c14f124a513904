"""The serve CLI of the PyTorch port: one model, or several behind a router.

The counterpart of `sparknet_tpu/serve/app.py`. Builds a zoo net or a
`.prototxt` net on the device (the CUDA card unless `--device cpu`) with
`--weights` (`.npz` or `.caffemodel`) or seeded random ones, starts the
dynamic-batching server — with checkpoint hot reload (`--checkpoint-dir`,
local or gs://|s3://), int8 weight-only serving (`--quant int8`), a
traffic-derived bucket ladder (`--buckets-from`), /metrics, /healthz and
/status (`--status-port`) and a heartbeat (`--heartbeat`) — and either
self-drives `--demo N` synthetic requests through submit -> batch ->
forward -> de-pad and prints the status JSON, or serves until interrupted.

`--models name=source[,...]` switches to multi-model mode: a `ModelRouter`
serving each model as a lane over one shared pool of `--router-workers`
threads, each lane hot-reloading its own `--checkpoint-dir` (a template
with `{model}` substituted), with `--hedge` (budget `--hedge-budget`) and
`--coalesce`. `--http-port` opens the HTTP/1.1 data plane
(`serve/http_frontend.py`) and `--binary-port` the binary frame data plane
(`serve/binary_frontend.py`, `--io-threads` event loops, the shared-memory
transport for same-host clients unless `--no-shm`), behind one tenant and
priority admission door when `--tenant-rate` is given.

`--history` runs the SLO ledger (the metrics-history sampler, the
`/timeseries` route, shards in `--history-dir`) and, with an objective
(`--slo-p99-ms`, `--slo-availability`), the burn-rate alerter
(`/slo/status`). `--autoscale` (with `--models`) runs the fleet control
plane (`sparknet_tpu_torch.fleet`): SLO-burn admission pressure through
a priority door, floored while the alerter pages; replicas grown and
retired through `--fleet-provider` (`subprocess`: serve children of this
CLI over spkn:// with this process's device and net flags; `pod`: the
`tpu_pod_launch.sh` stub, `--pod-zone` and `--pod-accel-type`; `none`);
the pool lever up to `--pool-max`; and staggered checkpoint adoption
through `--rollout-gate` (a `{model}` template in `--models` mode).

`--compile-cache DIR` is the warm-up cache (`utils/compile_cache.py`):
the kernel-build directory the lanes and the fleet's children share, so a
warm replica's cold start runs no nvcc (default `$SPARKNET_COMPILE_CACHE`,
else `sparknet_tpu_torch/_build/`).

`--graph g.json|g.pb` serves a serialized graph instead of `--model`
(the second backend, `backend/graph_net.py:GraphNet`), with `--weights`
a `WeightCollection` npz assigned by variable name; a graph net serves
f32 from its weights file (no `--checkpoint-dir` hot reload, no
`--quant`, as in the JAX CLI).

Examples:
    python -m sparknet_tpu_torch.serve.app --model caffenet --max-batch 128 \
        --outputs prob --demo 256
    python -m sparknet_tpu_torch.serve.app --models caffenet=caffenet,lenet=lenet \
        --router-workers 2 --http-port 0 --binary-port 0 --hedge --coalesce \
        --demo 16
    python -m sparknet_tpu_torch.serve.app --model lenet --device cpu \
        --http-port 8080 --binary-port 9000 --checkpoint-dir DIR --status-port 8081
    python -m sparknet_tpu_torch.serve.app --model lenet --device cpu \
        --quant int8 --buckets-from run/serving_metrics_*.jsonl --demo 8
    python -m sparknet_tpu_torch.serve.app --model deploy.prototxt \
        --weights trained.caffemodel --device cpu --demo 8
    python -m sparknet_tpu_torch.serve.app --graph alexnet.json \
        --weights w.npz --outputs prob --demo 8
    python -m sparknet_tpu_torch.serve.app --models m=lenet --autoscale \
        --fleet-provider none --slo-p99-ms 50 --history --history-dir H \
        --device cpu --demo 4
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from typing import Optional

import numpy as np

from .. import zoo
from ..net_api import TorchNet
from ..utils.logger import Logger, default_logger
from .http_frontend import HttpFrontend
from .router import ModelRouter, RouterConfig
from .server import InferenceServer, ServeConfig, net_input_specs


def resolve_spec(model: str, max_batch: int, n_classes: Optional[int],
                 crop: Optional[int]):
    """A `.prototxt` path (at its own input shapes) or a zoo builder name
    at batch max_batch -> NetSpec (the same table as
    `sparknet_tpu/apps/train_loop.py:resolve_spec`)."""
    if model.endswith(".prototxt"):
        from ..model.prototxt import net_from_prototxt_file
        return net_from_prototxt_file(model)
    builders = {
        "cifar10_quick": lambda: zoo.cifar10_quick(batch=max_batch),
        "caffenet": lambda: zoo.caffenet(batch=max_batch, crop=crop or 227,
                                         n_classes=n_classes or 1000),
        "lenet": lambda: zoo.lenet(batch=max_batch),
        "adult_mlp": lambda: zoo.adult_mlp(batch=max_batch),
    }
    if model not in builders:
        raise ValueError(f"unknown model {model!r}: expected a .prototxt "
                         f"path or one of {sorted(builders)}")
    return builders[model]()


def build_net(model: str, weights: Optional[str], max_batch: int,
              n_classes: Optional[int], crop: Optional[int], seed: int,
              device: Optional[str], graph: Optional[str] = None):
    """A zoo name or a `.prototxt` path -> a TorchNet on `device` with
    seeded weights, or those of `weights` (`.npz` or `.caffemodel`); or,
    with `graph` (.json / .pb), a GraphNet whose variables `weights` (a
    `WeightCollection` npz) assigns by name."""
    if graph:
        from ..apps.graph_common import load_graph
        from ..backend import GraphNet
        from ..model.weights import WeightCollection
        gnet = GraphNet(load_graph(graph, None), seed=seed, device=device)
        if weights:
            gnet.set_weights(WeightCollection.load(weights))
        return gnet
    net = TorchNet(resolve_spec(model, max_batch, n_classes, crop),
                   seed=seed, device=device)
    if weights:
        net.load_weights(weights)
    return net


def _demo_payload(net, seed: int = 0) -> dict:
    r = np.random.default_rng(seed)
    name, (shape, dtype) = next(
        (k, v) for k, v in net_input_specs(net).items()
        if np.issubdtype(np.dtype(v[1]), np.floating))
    return {name: r.standard_normal(shape).astype(dtype)}


def run_demo(server: InferenceServer, n: int, seed: int = 0) -> dict:
    """Drive n synthetic requests (random inputs in the net's own schema)
    through the live server and return its status dict."""
    futures = [server.submit(_demo_payload(server.net, seed + i))
               for i in range(n)]
    for f in futures:
        f.result(timeout=120.0)
    return server.status()


def run_router_demo(router: ModelRouter, n: int, seed: int = 0) -> dict:
    """The multi-model smoke: n synthetic requests round-robined across
    every local lane, then the router status."""
    names = sorted(router.lanes)
    futures = [router.submit(
        names[i % len(names)],
        _demo_payload(router.lanes[names[i % len(names)]].net, seed + i))
        for i in range(n)]
    for f in futures:
        f.result(timeout=120.0)
    return router.status()


def parse_models_arg(spec: str):
    """--models 'name=zoo_or_prototxt[,name=...]' -> [(name, source)]."""
    out = []
    for part in spec.split(","):
        name, sep, src = part.partition("=")
        if not sep or not name or not src:
            raise SystemExit(f"--models entry {part!r} is not "
                             f"name=model_source")
        out.append((name.strip(), src.strip()))
    return out


def parse_weights_arg(spec: Optional[str]) -> dict:
    """--tenant-weights 'tenant=weight[,...]' -> {tenant: float}."""
    out = {}
    for part in (spec or "").split(","):
        if not part:
            continue
        name, sep, w = part.partition("=")
        try:
            out[name.strip()] = float(w)
        except ValueError:
            sep = ""
        if not sep or not name:
            raise SystemExit(f"--tenant-weights entry {part!r} is not "
                             f"tenant=weight")
    return out


def _add_fleet_flags(p: argparse.ArgumentParser) -> None:
    """The SLO ledger's and the fleet control plane's flags (the JAX
    CLI's names and defaults; `--fleet-provider pod` and its two flags
    are the port's)."""
    p.add_argument("--slo-availability", type=float, default=None,
                   metavar="FRAC",
                   help="availability objective (e.g. 0.999) evaluated "
                   "by the burn-rate alerter (needs --history)")
    p.add_argument("--history", action="store_true",
                   help="run the SLO ledger: metrics-history sampler "
                   "(multi-resolution rings, /timeseries route) and — "
                   "when an objective is declared — the burn-rate "
                   "alerter (/slo/status, fleet page escalation)")
    p.add_argument("--history-dir", default=None, metavar="DIR",
                   help="persist append-only history shards here "
                   "(python -m sparknet_tpu_torch.obs.slo DIR builds "
                   "retrospective reports)")
    p.add_argument("--rollout-gate", default=None, metavar="PATH",
                   help="obey the fleet rollout duty's ROLLOUT.json at "
                   "this path (local or gs://|s3://): only adopt "
                   "checkpoint steps approved for --replica-name. In "
                   "--models mode: a {model} template. Missing gate = "
                   "ungated polling")
    p.add_argument("--autoscale", action="store_true",
                   help="run the fleet control plane (sparknet_tpu_torch."
                   "fleet): per-model SLO burn (windowed p99 vs "
                   "--slo-p99-ms) + queue/shed pressure drive admission "
                   "tightening (low priority sheds first), replica "
                   "grow/retire through --fleet-provider, and shared-"
                   "pool resizing. Requires --models")
    p.add_argument("--fleet-min", type=int, default=1,
                   help="min replicas per model for --autoscale "
                   "(local lane included; default 1)")
    p.add_argument("--fleet-max", type=int, default=4,
                   help="max replicas per model for --autoscale "
                   "(default 4)")
    p.add_argument("--fleet-interval", type=float, default=1.0,
                   help="control-loop cadence seconds (default 1.0)")
    p.add_argument("--fleet-window", type=float, default=30.0,
                   help="sliding window seconds for the SLO-burn p99 "
                   "(default 30)")
    p.add_argument("--fleet-provider", default="subprocess",
                   choices=("subprocess", "pod", "none"),
                   help="where grown replicas come from: 'subprocess' "
                   "spawns this CLI's children over spkn:// on this "
                   "host (same device and net flags); 'pod' assembles "
                   "the scripts/tpu_pod_launch.sh protocol (--pod-zone, "
                   "--pod-accel-type); 'none' keeps only the admission "
                   "+ pool levers")
    p.add_argument("--pod-zone", default=None,
                   help="with --fleet-provider pod: the launcher's zone")
    p.add_argument("--pod-accel-type", default=None,
                   help="with --fleet-provider pod: the launcher's "
                   "accelerator type")
    p.add_argument("--pool-max", type=int, default=None,
                   help="with --autoscale: let the controller grow the "
                   "router's shared worker pool up to this many "
                   "threads (default: --router-workers, i.e. lever off)")


def _child_args(args) -> list:
    """The net and device flags a subprocess-grown replica needs to
    serve what this process's lanes serve."""
    out = ["--max-wait-ms", str(args.max_wait_ms), "--seed",
           str(args.seed)]
    for flag, v in (("--device", args.device), ("--crop", args.crop),
                    ("--n-classes", args.n_classes),
                    ("--buckets", args.buckets)):
        if v is not None:
            out += [flag, str(v)]
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--model", default="lenet",
                   help="zoo builder name or a .prototxt path")
    p.add_argument("--model-name", default="default",
                   help="serving name for --model (metric label + "
                   "/v1/models/<name>/infer route)")
    p.add_argument("--models", default=None, metavar="N=SRC[,N=SRC...]",
                   help="multi-model mode: comma-separated name=source "
                   "pairs served by one ModelRouter over a shared pool "
                   "(sources are zoo names / .prototxt paths)")
    p.add_argument("--router-workers", type=int, default=2,
                   help="shared pool threads in --models mode (default 2)")
    p.add_argument("--graph", default=None,
                   help="serialized graph (.pb/.json) instead of --model")
    p.add_argument("--weights", default=None,
                   help="weights to load: .npz (WeightCollection) or "
                   ".caffemodel (default: seeded random)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' to run there)")
    p.add_argument("--seed", type=int, default=0,
                   help="weight-init generator seed")
    p.add_argument("--checkpoint-dir", default=None,
                   help="watch this train-checkpoint dir (local or "
                   "gs://|s3://) and hot-swap verified new steps. In "
                   "--models mode: a template with {model} substituted, "
                   "e.g. gs://bkt/runs/{model}/ck")
    p.add_argument("--poll-interval", type=float, default=2.0,
                   help="seconds between checkpoint-dir polls")
    p.add_argument("--poll-jitter", type=float, default=0.1,
                   help="± fraction of --poll-interval each poll deadline "
                   "is jittered by (default 0.1)")
    p.add_argument("--replica-name", default="local",
                   help="the replica label on the freshness gauges")
    p.add_argument("--n-classes", type=int, default=None,
                   help="classifier width of a zoo CaffeNet (default: "
                   "its published 1000)")
    p.add_argument("--crop", type=int, default=None)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--slo-p99-ms", type=float, default=None,
                   help="per-model p99 objective, stamped into /status; "
                   "with --history it becomes a live latency SLO the "
                   "burn-rate alerter pages on")
    p.add_argument("--buckets", default=None,
                   help="comma-separated batch buckets (default: powers "
                   "of 2 up to max-batch)")
    p.add_argument("--buckets-from", default=None, metavar="JSONL",
                   nargs="+",
                   help="derive the bucket ladder from recorded serve "
                   "metrics JSONL(s) (batch_size_hist rows): the ladder "
                   "minimizing padded slots for the traffic they saw")
    p.add_argument("--buckets-k", type=int, default=4,
                   help="max rungs for --buckets-from ladders (default 4)")
    p.add_argument("--quant", default=None, choices=("int8",),
                   help="weight-only quantized serving: int8 per-channel "
                   "weights + bf16 activations, parity-gated against the "
                   "f32 forward at every checkpoint load")
    p.add_argument("--quant-tol", type=float, default=None,
                   help="override the quant parity tolerance (sets both "
                   "rtol and atol of the load-time allclose gate)")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="warm-up cache: the shared kernel-build directory "
                   "(default: $SPARKNET_COMPILE_CACHE if set, else "
                   "sparknet_tpu_torch/_build/) — warm replica cold-starts "
                   "run no nvcc")
    p.add_argument("--outputs", default=None,
                   help="comma-separated blob names to return "
                   "(default: the net's per-row outputs)")
    p.add_argument("--no-canary", action="store_true",
                   help="skip the nonfinite canary forward on hot swaps")
    p.add_argument("--http-port", type=int, default=None,
                   help="serve the HTTP/1.1 inference data plane "
                   "(/v1/infer, /v1/models/<m>/infer) on this port "
                   "(0 = ephemeral)")
    p.add_argument("--http-host", default="127.0.0.1",
                   help='bind host for --http-port ("0.0.0.0" for '
                   "cross-host clients)")
    p.add_argument("--binary-port", type=int, default=None,
                   help="serve the binary frame data plane (length-"
                   "prefixed tensor frames over a selectors event loop; "
                   "serve/wire.py format) on this port (0 = ephemeral)")
    p.add_argument("--binary-host", default="127.0.0.1",
                   help='bind host for --binary-port ("0.0.0.0" for '
                   "cross-host clients)")
    p.add_argument("--no-shm", action="store_true",
                   help="disable the shared-memory transport (spkn-shm) "
                   "on the binary frontend (same-host peers then send "
                   "tensor payloads inline over the socket)")
    p.add_argument("--io-threads", type=int, default=2,
                   help="binary frontend event-loop threads (default 2)")
    p.add_argument("--hedge", action="store_true",
                   help="request hedging in --models mode: after an "
                   "adaptive delay (the model's live routed-latency "
                   "quantile) re-issue an in-flight request to a second "
                   "healthy replica; first answer wins, the loser is "
                   "cancelled best-effort")
    p.add_argument("--hedge-budget", type=float, default=0.05,
                   help="max fraction of routed requests that may hedge "
                   "(default 0.05); hedging also disables itself under "
                   "admission pressure")
    p.add_argument("--coalesce", action="store_true",
                   help="coalesced batch formation (--models mode): when "
                   "every replica of a model reports under-filled "
                   "batches, focus consecutive requests on ONE replica "
                   "per formation window (rotating for fairness)")
    p.add_argument("--request-journal", default=None, metavar="PATH",
                   help="journal every data-plane request as JSONL")
    p.add_argument("--tenant-rate", type=float, default=None,
                   help="per-tenant admission: token-bucket refill rate "
                   "(requests/sec) keyed on the X-Tenant header, shed 429 "
                   "error_kind=tenant_limit ahead of the queue")
    p.add_argument("--tenant-burst", type=float, default=None,
                   help="per-tenant bucket depth (default: 2x the rate)")
    p.add_argument("--tenant-weights", default=None,
                   metavar="T=W[,T=W...]",
                   help="per-tenant budget weights for --tenant-rate")
    p.add_argument("--heartbeat-every", type=float, default=10.0,
                   help="seconds between heartbeat writes for --heartbeat")
    p.add_argument("--status-port", type=int, default=None,
                   help="serve /healthz, /metrics and /status on this "
                   "port (0 = ephemeral)")
    p.add_argument("--heartbeat", default=None,
                   help="write the utils/heartbeat.py liveness file here")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="capture host-side spans (forwards, hot swaps) as "
                   "Chrome-trace-event JSON")
    p.add_argument("--request-trace", default=None, metavar="DIR",
                   help="per-request tracing: tail-sampled request spans "
                   "as JSONL shards in DIR (assemble with python -m "
                   "sparknet_tpu_torch.obs.reqtrace DIR)")
    p.add_argument("--trace-head-sample", type=float, default=0.01,
                   metavar="P",
                   help="with --request-trace: also head-sample this "
                   "fraction of ordinary requests (default 0.01)")
    p.add_argument("--workdir", default=None,
                   help="log/JSONL directory (default $SPARKNET_TPU_HOME)")
    p.add_argument("--demo", type=int, default=None, metavar="N",
                   help="self-drive N synthetic requests, print status "
                   "JSON, exit")
    _add_fleet_flags(p)
    args = p.parse_args(argv)

    if args.quant_tol is not None and not args.quant:
        p.error("--quant-tol requires --quant (no parity gate exists "
                "on the f32 path)")
    if args.tenant_weights and not args.tenant_rate:
        p.error("--tenant-weights requires --tenant-rate (weights "
                "scale the per-tenant budget)")
    if args.autoscale and not args.models:
        p.error("--autoscale requires --models (the fleet controller "
                "acts on a ModelRouter)")
    if args.autoscale and args.fleet_provider == "pod" and \
            not (args.pod_zone and args.pod_accel_type):
        p.error("--fleet-provider pod requires --pod-zone and "
                "--pod-accel-type")

    log = default_logger(args.workdir, name="serving")
    buckets = (tuple(int(b) for b in args.buckets.split(","))
               if args.buckets else None)
    hists: dict = {}
    if args.buckets_from and buckets is None:
        from .buckets import size_hist_from_jsonl
        hists = size_hist_from_jsonl(args.buckets_from)
    derived: dict = {}

    def lane_buckets(name: str):
        """Explicit --buckets win; then the ladder derived from this
        model's recorded traffic when the rows carry its name, else from
        every model's merged."""
        if buckets is not None or not args.buckets_from:
            return buckets
        if name not in derived:
            from .buckets import derive_buckets
            hist = hists.get(name)
            if hist is None:
                hist = {}
                for h in hists.values():
                    for size, n in h.items():
                        hist[size] = hist.get(size, 0) + n
            derived[name] = derive_buckets(hist, args.max_batch,
                                           k=args.buckets_k)
            log.log(f"bucket ladder for {name} derived from "
                    f"{len(args.buckets_from)} JSONL(s): "
                    f"{list(derived[name])}")
        return derived[name]

    quant = args.quant
    if quant and args.quant_tol is not None:
        from ..model.quant import QuantConfig
        quant = QuantConfig(mode=args.quant, rtol=args.quant_tol,
                            atol=args.quant_tol)

    outputs = tuple(args.outputs.split(",")) if args.outputs else None

    def lane_cfg(name: str, checkpoint_dir: Optional[str]) -> ServeConfig:
        gate = (args.rollout_gate.replace("{model}", name)
                if args.rollout_gate else None)
        return ServeConfig(
            model_name=name, max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms, buckets=lane_buckets(name),
            slo_p99_ms=args.slo_p99_ms,
            slo_availability=args.slo_availability, outputs=outputs,
            checkpoint_dir=checkpoint_dir,
            poll_interval_s=args.poll_interval,
            poll_jitter=args.poll_jitter,
            replica_name=args.replica_name, rollout_gate=gate,
            canary=not args.no_canary, quant=quant,
            compile_cache_dir=args.compile_cache)

    # ONE admission door shared by both data planes (a tenant's budget
    # is a property of the tenant, not of the wire it arrived on) AND by
    # the fleet controller (its fast lever sets the pressure); the
    # priority-aware door also reads X-Priority / the frame's priority
    tenants = None
    if args.tenant_rate or args.autoscale:
        from .admission import PriorityAdmission
        tenants = PriorityAdmission(
            args.tenant_rate, args.tenant_burst,
            weights=parse_weights_arg(args.tenant_weights))
    # request journal (off by default): one JSONL row per data-plane
    # request, shared by both frontends — echo off, this is a data file
    journal = (Logger(jsonl_path=args.request_journal, echo=False)
               if args.request_journal else None)

    def make_frontends(backend) -> list:
        """The data planes the flags asked for: HTTP and/or binary."""
        from .binary_frontend import BinaryFrontend
        fes = []
        if args.http_port is not None:
            fes.append(HttpFrontend(backend, args.http_port,
                                    args.http_host, tenants=tenants,
                                    logger=log, journal=journal))
        if args.binary_port is not None:
            fes.append(BinaryFrontend(backend, args.binary_port,
                                      args.binary_host,
                                      io_threads=args.io_threads,
                                      tenants=tenants, logger=log,
                                      enable_shm=not args.no_shm,
                                      journal=journal))
        return fes

    def make_fleet(router, sources):
        """The --autoscale control plane over the router."""
        from ..fleet import (FleetConfig, FleetController,
                             PodReplicaProvider, SubprocessReplicaProvider)
        provider = None
        if args.fleet_provider == "subprocess":
            # grown children join the continuous-learning loop: same
            # checkpoint store + rollout gate as the local lanes, each
            # under its own provider tag (--replica-name)
            provider = SubprocessReplicaProvider(
                dict(sources), max_batch=args.max_batch,
                outputs=outputs or ("prob",),
                checkpoint_dir=args.checkpoint_dir,
                poll_interval_s=args.poll_interval,
                poll_jitter=args.poll_jitter,
                rollout_gate=args.rollout_gate,
                compile_cache_dir=args.compile_cache,
                extra_args=_child_args(args))
        elif args.fleet_provider == "pod":
            provider = PodReplicaProvider(dict(sources), args.pod_zone,
                                          args.pod_accel_type)
        cfg = FleetConfig(interval_s=args.fleet_interval,
                          window_s=args.fleet_window,
                          min_replicas=args.fleet_min,
                          max_replicas=args.fleet_max,
                          pool_max=args.pool_max,
                          slo_p99_ms=args.slo_p99_ms)
        return FleetController(router, provider=provider, cfg=cfg,
                               admission=tenants, logger=log)

    from ..obs import trace as obs_trace

    fleet = None
    with contextlib.ExitStack() as stack:
        if args.trace_out:
            stack.enter_context(obs_trace.tracing(args.trace_out))
        if args.request_trace:
            from ..obs import reqtrace
            stack.enter_context(reqtrace.request_tracing(
                args.request_trace, head_sample=args.trace_head_sample))
        if args.models:
            router = ModelRouter(
                RouterConfig(workers=args.router_workers,
                             status_port=args.status_port,
                             heartbeat_path=args.heartbeat,
                             heartbeat_every_s=args.heartbeat_every,
                             hedge=args.hedge,
                             hedge_budget=args.hedge_budget,
                             coalesce=args.coalesce,
                             history=args.history,
                             history_dir=args.history_dir),
                logger=log)
            if tenants is not None:
                # hedging reads the admission door's pressure: a shedding
                # door must not pay for duplicate requests
                router.attach_admission(tenants)
            sources = parse_models_arg(args.models)
            for name, src in sources:
                ck = (args.checkpoint_dir.format(model=name)
                      if args.checkpoint_dir else None)
                router.add_model(
                    name, build_net(src, None, args.max_batch,
                                    args.n_classes, args.crop, args.seed,
                                    args.device),
                    cfg=lane_cfg(name, ck))
            fleet = make_fleet(router, sources) if args.autoscale \
                else None
            backend = stack.enter_context(router)
            run_fn = (lambda: run_router_demo(router, args.demo))
        else:
            net = build_net(args.model, args.weights, args.max_batch,
                            args.n_classes, args.crop, args.seed,
                            args.device, graph=args.graph)
            cfg = lane_cfg(args.model_name, args.checkpoint_dir)
            cfg.status_port = args.status_port
            cfg.heartbeat_path = args.heartbeat
            cfg.heartbeat_every_s = args.heartbeat_every
            cfg.history = args.history
            cfg.history_dir = args.history_dir
            backend = stack.enter_context(InferenceServer(net, cfg,
                                                          logger=log))
            run_fn = (lambda: run_demo(backend, args.demo))
        frontends = []
        try:
            frontends = make_frontends(backend)
            if fleet is not None:
                if backend.alerter is not None:
                    # the ledger's firing pages become the fleet's fast
                    # admission-pressure input
                    fleet.attach_alerter(backend.alerter)
                fleet.start()
            _serve_until_done(backend.status, args, log, run_fn=run_fn)
        finally:
            if fleet is not None:
                fleet.stop()
            for fe in frontends:
                fe.stop()


def _serve_until_done(status_fn, args, log: Logger, run_fn) -> None:
    if args.demo is not None:
        print(json.dumps(run_fn()))
        return
    log.log("serving; Ctrl-C to stop")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        log.log("interrupted; draining")
        print(json.dumps(status_fn()), file=sys.stderr)


if __name__ == "__main__":
    main()
