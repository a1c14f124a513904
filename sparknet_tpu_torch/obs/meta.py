"""Run metadata: who, what and where produced an artifact.

The counterpart of `sparknet_tpu/obs/meta.py`. `run_metadata()` is one
flat dict of provenance; the same dict is exported as the
`sparknet_build_info` gauge (value 1, metadata as labels — the Prometheus
*_info idiom) so a scrape identifies its process too. The port names
torch, CUDA and the card where the JAX package names jax and its backend.
"""
from __future__ import annotations

import os
import platform
import subprocess
import time
from typing import Any, Dict

from .registry import MetricsRegistry


def git_rev(cwd: str = None) -> str:
    """Short git revision of the source tree, or 'unknown' outside a
    checkout (an installed wheel, a stripped container)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=cwd or os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10)
        rev = out.stdout.strip()
        return rev if out.returncode == 0 and rev else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_metadata() -> Dict[str, Any]:
    """One flat dict of run provenance: python, host, git revision, torch
    and its CUDA runtime, and the card (`device_kind`, the name
    `torch.cuda.get_device_name` gives; "cpu" without a card). Never
    raises: a broken CUDA runtime degrades the dict (`torch_error`)."""
    meta: Dict[str, Any] = {
        "ts": round(time.time(), 3),
        "python": platform.python_version(),
        "hostname": platform.node(),
        "git_rev": git_rev(),
    }
    try:
        import torch

        meta["torch_version"] = torch.__version__
        meta["cuda_version"] = torch.version.cuda or "none"
        if torch.cuda.is_available():
            meta["backend"] = "cuda"
            meta["device_kind"] = torch.cuda.get_device_name(0)
            meta["n_devices"] = torch.cuda.device_count()
        else:
            meta["backend"] = "cpu"
            meta["device_kind"] = "cpu"
            meta["n_devices"] = 0
        meta["world_size"] = int(os.environ.get("WORLD_SIZE", 1))
    except Exception as e:  # provenance must never take a run down
        meta["torch_error"] = str(e)
    return meta


def register_build_info(registry: MetricsRegistry) -> None:
    """Export run provenance as the `sparknet_build_info` gauge."""
    m = run_metadata()
    labels = {k: str(m.get(k, "unknown"))
              for k in ("torch_version", "cuda_version", "backend",
                        "device_kind", "git_rev")}
    registry.gauge("sparknet_build_info",
                   "constant 1; run provenance in the labels",
                   labels=tuple(sorted(labels))).set(1, **labels)
