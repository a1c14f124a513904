"""The serve CLI of the PyTorch port: one model behind the inference server.

The counterpart of the single-model path of `sparknet_tpu/serve/app.py`.
Builds a zoo net or a `.prototxt` net on the device (the CUDA card unless
`--device cpu`) with `--weights` (`.npz` or `.caffemodel`) or seeded
random ones, starts the dynamic-batching server — with checkpoint hot
reload (`--checkpoint-dir`, local or gs://|s3://), int8 weight-only
serving (`--quant int8`), a traffic-derived bucket ladder
(`--buckets-from`), /metrics, /healthz and /status (`--status-port`) and a
heartbeat (`--heartbeat`) — and either self-drives `--demo N` synthetic
requests through submit -> batch -> forward -> de-pad and prints the
status JSON, or serves until interrupted. `--http-port` opens the HTTP/1.1
inference data plane (`serve/http_frontend.py`), behind one tenant and
priority admission door when `--tenant-rate` is given.

The flags of later slices keep the JAX package's names and stop with an
error naming their ROADMAP item: the router (`--models`,
`--router-workers`), the binary data plane (`--binary-port`, `--no-shm`,
`--io-threads`), hedging and coalescing, the graph backend (`--graph`),
the fleet (`--autoscale`, `--fleet-*`, `--pool-max`, `--rollout-gate`),
the SLO history (`--history*`, `--slo-availability`) and the compile
cache (`--compile-cache`).

Examples:
    python -m sparknet_tpu_torch.serve.app --model caffenet --max-batch 128 \
        --outputs prob --demo 256
    python -m sparknet_tpu_torch.serve.app --model lenet --device cpu \
        --http-port 8080 --checkpoint-dir DIR --status-port 8081
    python -m sparknet_tpu_torch.serve.app --model lenet --device cpu \
        --quant int8 --buckets-from run/serving_metrics_*.jsonl --demo 8
    python -m sparknet_tpu_torch.serve.app --model deploy.prototxt \
        --weights trained.caffemodel --device cpu --demo 8
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
from .server import InferenceServer, ServeConfig, net_input_specs


def resolve_spec(model: str, max_batch: int, n_classes: int,
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
                                         n_classes=n_classes),
        "lenet": lambda: zoo.lenet(batch=max_batch),
        "adult_mlp": lambda: zoo.adult_mlp(batch=max_batch),
    }
    if model not in builders:
        raise ValueError(f"unknown model {model!r}: expected a .prototxt "
                         f"path or one of {sorted(builders)}")
    return builders[model]()


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


#: flags of later slices: (dest, value when unset, ROADMAP item)
LATER_FLAGS = (
    ("models", None, "the router over models (serve/router.py): "
                     "ROADMAP A10a"),
    ("router_workers", None, "the router's shared pool: ROADMAP A10a"),
    ("graph", None, "the graph backend (backend/graph_net.py): "
                    "ROADMAP A12"),
    ("binary_port", None, "the binary frontend (serve/binary_frontend.py):"
                          " ROADMAP A10a"),
    ("binary_host", None, "the binary frontend (serve/binary_frontend.py):"
                          " ROADMAP A10a"),
    ("no_shm", False, "the binary frontend's shared-memory transport "
                      "(serve/shm.py): ROADMAP A10a"),
    ("io_threads", None, "the binary frontend's event loop: ROADMAP A10a"),
    ("hedge", False, "hedged requests in the router: ROADMAP A10a"),
    ("hedge_budget", None, "hedged requests in the router: ROADMAP A10a"),
    ("coalesce", False, "coalesced batch formation in the router: "
                        "ROADMAP A10a"),
    ("autoscale", False, "the fleet controller (fleet/): ROADMAP A10b"),
    ("fleet_min", None, "the fleet controller (fleet/): ROADMAP A10b"),
    ("fleet_max", None, "the fleet controller (fleet/): ROADMAP A10b"),
    ("fleet_interval", None, "the fleet controller (fleet/): "
                             "ROADMAP A10b"),
    ("fleet_window", None, "the fleet controller (fleet/): ROADMAP A10b"),
    ("fleet_provider", None, "the fleet's replica provider (fleet/): "
                             "ROADMAP A10b"),
    ("pool_max", None, "the fleet's pool lever (fleet/): ROADMAP A10b"),
    ("rollout_gate", None, "the fleet rollout gate (fleet/rollout.py): "
                           "ROADMAP A10b"),
    ("history", False, "the SLO history (obs/history.py): ROADMAP A10c"),
    ("history_dir", None, "the SLO history (obs/history.py): "
                          "ROADMAP A10c"),
    ("slo_availability", None, "the SLO burn-rate alerter (obs/slo.py): "
                               "ROADMAP A10c"),
    ("compile_cache", None, "a warm-up cache in place of the XLA compile "
                            "cache: ROADMAP A10d"),
)


def _add_later_flags(p: argparse.ArgumentParser) -> None:
    """The JAX CLI's flags of later slices, parsed so that each can stop
    with its ROADMAP item (defaults None/False = "not given")."""
    p.add_argument("--models", default=None, metavar="N=SRC[,N=SRC...]",
                   help="multi-model mode (not ported: ROADMAP A10a)")
    p.add_argument("--router-workers", type=int, default=None,
                   help="router pool threads (not ported: ROADMAP A10a)")
    p.add_argument("--graph", default=None,
                   help="serialized graph model (not ported: ROADMAP A12)")
    p.add_argument("--binary-port", type=int, default=None,
                   help="binary data plane (not ported: ROADMAP A10a)")
    p.add_argument("--binary-host", default=None,
                   help="bind host for --binary-port (not ported: ROADMAP "
                   "A10a)")
    p.add_argument("--no-shm", action="store_true",
                   help="binary shm transport off (not ported: ROADMAP "
                   "A10a)")
    p.add_argument("--io-threads", type=int, default=None,
                   help="binary event-loop threads (not ported: ROADMAP "
                   "A10a)")
    p.add_argument("--hedge", action="store_true",
                   help="hedge slow requests (not ported: ROADMAP A10a)")
    p.add_argument("--hedge-budget", type=float, default=None,
                   help="hedging budget (not ported: ROADMAP A10a)")
    p.add_argument("--coalesce", action="store_true",
                   help="coalesced formation (not ported: ROADMAP A10a)")
    p.add_argument("--autoscale", action="store_true",
                   help="the fleet control plane (not ported: ROADMAP "
                   "A10b)")
    p.add_argument("--fleet-min", type=int, default=None,
                   help="fleet minimum (not ported: ROADMAP A10b)")
    p.add_argument("--fleet-max", type=int, default=None,
                   help="fleet maximum (not ported: ROADMAP A10b)")
    p.add_argument("--fleet-interval", type=float, default=None,
                   help="fleet cadence (not ported: ROADMAP A10b)")
    p.add_argument("--fleet-window", type=float, default=None,
                   help="fleet window (not ported: ROADMAP A10b)")
    p.add_argument("--fleet-provider", default=None,
                   help="fleet provider (not ported: ROADMAP A10b)")
    p.add_argument("--pool-max", type=int, default=None,
                   help="fleet pool lever (not ported: ROADMAP A10b)")
    p.add_argument("--rollout-gate", default=None, metavar="PATH",
                   help="fleet rollout gate (not ported: ROADMAP A10b)")
    p.add_argument("--history", action="store_true",
                   help="the SLO ledger (not ported: ROADMAP A10c)")
    p.add_argument("--history-dir", default=None, metavar="DIR",
                   help="SLO history shards (not ported: ROADMAP A10c)")
    p.add_argument("--slo-availability", type=float, default=None,
                   metavar="FRAC",
                   help="availability objective (not ported: ROADMAP "
                   "A10c)")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="compile cache (not ported: ROADMAP A10d)")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--model", default="lenet",
                   help="zoo builder name or a .prototxt path")
    p.add_argument("--model-name", default="default",
                   help="serving name for --model (metric label + "
                   "/v1/models/<name>/infer route)")
    p.add_argument("--weights", default=None,
                   help="weights to load: .npz (WeightCollection) or "
                   ".caffemodel (default: seeded random)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' to run there)")
    p.add_argument("--seed", type=int, default=0,
                   help="weight-init generator seed")
    p.add_argument("--checkpoint-dir", default=None,
                   help="watch this train-checkpoint dir (local or "
                   "gs://|s3://) and hot-swap verified new steps")
    p.add_argument("--poll-interval", type=float, default=2.0,
                   help="seconds between checkpoint-dir polls")
    p.add_argument("--poll-jitter", type=float, default=0.1,
                   help="± fraction of --poll-interval each poll deadline "
                   "is jittered by (default 0.1)")
    p.add_argument("--replica-name", default="local",
                   help="the replica label on the freshness gauges")
    p.add_argument("--n-classes", type=int, default=10)
    p.add_argument("--crop", type=int, default=None)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--slo-p99-ms", type=float, default=None,
                   help="advisory p99 objective, stamped into /status")
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
    _add_later_flags(p)
    args = p.parse_args(argv)

    for dest, unset, what in LATER_FLAGS:
        if getattr(args, dest) != unset:
            p.error(f"--{dest.replace('_', '-')} needs {what}, which is "
                    f"not ported yet")
    if args.quant_tol is not None and not args.quant:
        p.error("--quant-tol requires --quant (no parity gate exists "
                "on the f32 path)")
    if args.tenant_weights and not args.tenant_rate:
        p.error("--tenant-weights requires --tenant-rate (weights "
                "scale the per-tenant budget)")

    log = default_logger(args.workdir, name="serving")
    buckets = (tuple(int(b) for b in args.buckets.split(","))
               if args.buckets else None)
    if args.buckets_from and buckets is None:
        from .buckets import derive_buckets, size_hist_from_jsonl
        hists = size_hist_from_jsonl(args.buckets_from)
        # this model's recorded traffic when the rows carry its name,
        # else every model's merged
        hist = hists.get(args.model_name)
        if hist is None:
            hist = {}
            for h in hists.values():
                for s, n in h.items():
                    hist[s] = hist.get(s, 0) + n
        buckets = derive_buckets(hist, args.max_batch, k=args.buckets_k)
        log.log(f"bucket ladder derived from {len(args.buckets_from)} "
                f"JSONL(s): {list(buckets)}")
    quant = args.quant
    if quant and args.quant_tol is not None:
        from ..model.quant import QuantConfig
        quant = QuantConfig(mode=args.quant, rtol=args.quant_tol,
                            atol=args.quant_tol)

    # one admission door for the data plane; the priority-aware door
    # also reads X-Priority
    tenants = None
    if args.tenant_rate:
        from .admission import PriorityAdmission
        tenants = PriorityAdmission(
            args.tenant_rate, args.tenant_burst,
            weights=parse_weights_arg(args.tenant_weights))
    # request journal (off by default): one JSONL row per data-plane
    # request — echo off, this is a data file
    journal = (Logger(jsonl_path=args.request_journal, echo=False)
               if args.request_journal else None)

    net = TorchNet(resolve_spec(args.model, args.max_batch, args.n_classes,
                                args.crop),
                   seed=args.seed, device=args.device)
    if args.weights:
        net.load_weights(args.weights)
    cfg = ServeConfig(
        model_name=args.model_name, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, buckets=buckets,
        slo_p99_ms=args.slo_p99_ms,
        outputs=tuple(args.outputs.split(",")) if args.outputs else None,
        checkpoint_dir=args.checkpoint_dir,
        poll_interval_s=args.poll_interval, poll_jitter=args.poll_jitter,
        replica_name=args.replica_name, canary=not args.no_canary,
        quant=quant, status_port=args.status_port,
        heartbeat_path=args.heartbeat,
        heartbeat_every_s=args.heartbeat_every)

    from ..obs import trace as obs_trace

    with contextlib.ExitStack() as stack:
        if args.trace_out:
            stack.enter_context(obs_trace.tracing(args.trace_out))
        if args.request_trace:
            from ..obs import reqtrace
            stack.enter_context(reqtrace.request_tracing(
                args.request_trace, head_sample=args.trace_head_sample))
        server = stack.enter_context(InferenceServer(net, cfg, logger=log))
        frontend = None
        if args.http_port is not None:
            frontend = HttpFrontend(server, args.http_port, args.http_host,
                                    tenants=tenants, logger=log,
                                    journal=journal)
        try:
            _serve_until_done(server.status, args, log,
                              run_fn=lambda: run_demo(server, args.demo))
        finally:
            if frontend is not None:
                frontend.stop()


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
