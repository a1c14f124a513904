"""Long soak of the composed streaming system.

The port's counterpart of the JAX package's `scripts/soak_stream.py`.
Unit and chaos tests prove the pieces and the crash story; this proves
endurance: thousands of consecutive τ-rounds on the card through the
full ingest path — parallel shard readers (`make_parallel_source`),
bounded ring buffers, per-round preprocessing on the round-prep thread,
periodic checkpoints with per-reader stream cursors — through
`apps/train_loop.train`, while tracking host RSS for leaks (an unbounded
queue, an unfreed buffer or a growing cursor map would show as RSS that
grows with the rounds).

CaffeNet at crop 67 from 72x72 JPEGs (16 classes), b32, τ = 5, bfloat16;
`--device cpu` runs the same loop at the same shapes on the CPU (the
size-matched control).

Writes `--out`: rounds completed, wall time, RSS first / median / last /
max and its least-squares slope in MB a round (over all samples and
over the run's second half), stream epochs, the skipped counter, loss
finiteness, and the card's name and power limit.

Run: python -m sparknet_tpu_torch.scripts.soak_stream --rounds 6000
         [--out SOAK_torch.json] [--store gs] [--device cpu]
(the card by default; without one it raises unless `--device cpu`).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for ln in f:
            if ln.startswith("VmRSS:"):
                return int(ln.split()[1]) / 1024.0
    return -1.0


def rss_slope(samples: list) -> Optional[float]:
    """The least-squares slope of rss_mb against round, MB a round (None
    under two samples)."""
    if len(samples) < 2:
        return None
    x = np.asarray([s["round"] for s in samples], np.float64)
    y = np.asarray([s["rss_mb"] for s in samples], np.float64)
    if np.ptp(x) == 0:
        return None
    return float(np.polyfit(x, y, 1)[0])


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--rounds", type=int, default=6000)
    p.add_argument("--out", default="SOAK_torch.json")
    p.add_argument("--sources", type=int, default=4)
    p.add_argument("--shards", type=int, default=32)
    p.add_argument("--per-shard", type=int, default=256)
    p.add_argument("--keep", action="store_true",
                   help="keep the temp shard/work dirs (default: removed)")
    p.add_argument("--sample-every", type=int, default=50,
                   help="rounds between RSS samples")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu: the same loop at the same "
                   "shapes on the CPU (the size-matched control)")
    p.add_argument("--store", default=None, choices=("gs",),
                   help="serve the shards from a local fake-GCS server "
                   "and stream them as gs:// urls (endurance for the "
                   "ranged-HTTP + member-carve bucket path — connection "
                   "reuse, per-epoch freshness checks, index cache)")
    args = p.parse_args(argv)

    from ..apps.train_loop import train
    from ..data import imagenet
    from ..data.preprocess import ImagePreprocessor
    from ..data.streaming import make_parallel_source
    from ..device import resolve_device
    from ..obs.meta import run_metadata
    from ..schema import Field, Schema
    from ..utils.config import RunConfig
    from ..utils.logger import Logger
    from ..zoo import caffenet
    from .study import card_line

    dev = resolve_device(args.device)  # no card: raise before any work
    crop, size, b, tau = 67, 72, 32, 5
    root = tempfile.mkdtemp(prefix="soak_shards_")
    work = tempfile.mkdtemp(prefix="soak_work_")
    print(f"soak: building {args.shards}x{args.per_shard} synthetic shards "
          f"under {root}", file=sys.stderr)
    label_path = imagenet.write_synthetic_shards(
        root, n_shards=args.shards, per_shard=args.per_shard,
        n_classes=16, size=size)
    labels = imagenet.load_label_map(label_path)
    shards = imagenet.list_shards(root)
    server = None
    if args.store == "gs":
        sys.path.insert(0, os.path.join(_ROOT, "tests"))
        from fake_stores import serve_dir_for_ingest
        server, gs_root = serve_dir_for_ingest(root)
        shards = imagenet.list_shards(gs_root)
        print(f"soak: streaming {gs_root} via the in-process fake server",
              file=sys.stderr)
    src = make_parallel_source(shards, labels, 1, b,
                               tau, args.sources, height=size, width=size)
    schema = Schema(Field("data", "float32", (crop, crop, 3)),
                    Field("label", "int32", (1,)))
    pp = ImagePreprocessor(schema, mean_image=None, crop=crop, seed=0,
                           out_dtype="bfloat16")
    cfg = RunConfig(model="caffenet", n_classes=16, crop=crop, n_devices=1,
                    local_batch=b, tau=tau, max_rounds=args.rounds,
                    eval_every=0, precision="bfloat16", workdir=work,
                    checkpoint_dir=os.path.join(work, "ck"),
                    checkpoint_every=200, log_every=8, seed=0)

    t0 = time.time()
    samples = []
    partial_path = args.out + ".partial.jsonl"

    def hook(rnd, state):
        if rnd % args.sample_every == 0:
            s = {"round": rnd, "rss_mb": round(rss_mb(), 1),
                 "wall_s": round(time.time() - t0, 1),
                 "skipped": int(src.skipped)}
            samples.append(s)
            # incremental persistence: a soak that dies at round 5800 (the
            # very leak or fault it hunts) must still leave its evidence
            with open(partial_path, "a") as f:
                f.write(json.dumps(s) + "\n")
            if rnd % 500 == 0:
                print(f"soak round {rnd}: rss {s['rss_mb']} MB "
                      f"({s['wall_s']:.0f}s)", file=sys.stderr)

    jsonl = os.path.join(work, "metrics.jsonl")
    try:
        train(cfg, caffenet(batch=b, crop=crop, n_classes=16), src, None,
              logger=Logger(os.path.join(work, "log.txt"), echo=False,
                            jsonl_path=jsonl),
              batch_transform=pp, round_hook=hook, device=dev)

        losses = [rec["loss"] for rec in map(json.loads, open(jsonl))
                  if rec.get("loss") is not None]
        rss = [s["rss_mb"] for s in samples]
        half = [s for s in samples if s["round"] >= args.rounds // 2]
        result = {
            "rounds": args.rounds,
            "backend": "cpu-control" if dev.type == "cpu" else "device",
            "card": card_line(dev),
            "store": args.store or "local",
            "round_batch_mb": round(tau * b * crop * crop * 3 * 2 / 1e6, 2),
            "images": args.rounds * b * tau,
            "wall_s": round(time.time() - t0, 1),
            "readers": src.n_sources,
            "stream_epochs": max(ep for (_, _), ep in src.cursors),
            "skipped": int(src.skipped),
            "rss_mb": {"first": rss[0], "median": float(np.median(rss)),
                       "last": rss[-1], "max": max(rss)},
            "rss_slope_mb_per_round": {"all": rss_slope(samples),
                                       "second_half": rss_slope(half)},
            "losses": {"n": len(losses), "first": losses[0],
                       "last": losses[-1],
                       "all_finite": bool(np.isfinite(losses).all())},
            "rss_samples": samples[:: max(1, len(samples) // 60)],
        }
        result["meta"] = run_metadata()
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        if os.path.exists(partial_path):
            os.remove(partial_path)  # superseded by the full artifact
        print(json.dumps({k: v for k, v in result.items()
                          if k != "rss_samples"}))
        return result
    finally:
        src.close()
        if server is not None:
            from fake_stores import stop_serving
            stop_serving(server)
        if not args.keep:
            shutil.rmtree(root, ignore_errors=True)
            shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
